"""Host ms a target's overlap loop spends staging its frames in pinned
memory: the span idf.prefetch.pin (runtime/prefetch.py, around
`pin_memory()` in FramePrefetcher._copy, on a CUDA device only) over the
window's targets. Read from the program's own totals of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py); None where the span
never ran, as in a program without it."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.prefetch.pin")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
