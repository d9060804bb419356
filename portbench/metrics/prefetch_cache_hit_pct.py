"""The share of the overlap loop's window items that the Session's shared
decoded-frame cache served, in %: the counters prefetch.cache_hit and
prefetch.cache_miss of the traced window (runtime/prefetch.py: a miss is
an item sent to the decode threads, a hit any other; the two sum to the
window; image_denoising_filter_tpu_torch/utils/timing.py). None where no
item was counted, as in a program whose prefetcher keeps no such counters."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    totals = getattr(timing, "totals", {})
    hits = totals.get("prefetch.cache_hit", [0, 0])[1]
    misses = totals.get("prefetch.cache_miss", [0, 0])[1]
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
