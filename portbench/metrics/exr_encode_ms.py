"""Host ms a frame spends encoding its output EXR: the span idf.exr.encode
(utils/imageio.py:_write_exr, native or Python; the file write is outside
it) over the window's frames. Read from the program's own totals of the
traced window (image_denoising_filter_tpu_torch/utils/timing.py); None where
the span never ran, as in a program without it."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.exr.encode")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
