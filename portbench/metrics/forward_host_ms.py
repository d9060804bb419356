"""Host ms a call of a model's forward takes (the span idf.model.forward,
models/denoiser.py): issuing the frame's launches, its allocations and
Python, over the calls of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py). None where the span
never ran, as in a program without spans."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.model.forward")
    if not total or not total[1]:
        return None
    return total[0] / total[1] / 1e6
