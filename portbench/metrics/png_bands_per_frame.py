"""The row bands the port's PNG save encodes a frame in: the counter
png_encode.bands of the traced window over its frames
(image_denoising_filter_tpu_torch/utils/timing.py, counted by
utils/png.py:encode_bands). None where no band was counted, as in a program
without the counter."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    bands = getattr(timing, "totals", {}).get("png_encode.bands", [0, 0])[1]
    if not bands or not r.frames:
        return None
    return bands / r.frames
