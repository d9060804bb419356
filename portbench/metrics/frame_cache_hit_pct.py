"""The share of Session._load's lookups in the shared decoded-frame cache
that found the frame, in %: the counters frame_cache.hit and
frame_cache.miss of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py). None where no lookup was
counted, as in a program without counters."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    totals = getattr(timing, "totals", {})
    hits = totals.get("frame_cache.hit", [0, 0])[1]
    misses = totals.get("frame_cache.miss", [0, 0])[1]
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
