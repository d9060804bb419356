"""Host ms a target's overlap loop waits for its decoded frames: the span
idf.prefetch.wait (runtime/prefetch.py, around FramePrefetcher._host: the
native loader's get, its copy out of the loader's buffer, or the Python
loader) over the window's targets. Read from the program's own totals of
the traced window (image_denoising_filter_tpu_torch/utils/timing.py); None
where the span never ran, as in a program without it."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.prefetch.wait")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
