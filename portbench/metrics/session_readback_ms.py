"""Host ms a frame spends in the Session's readback phase, the span
idf.session.readback: the output's readback, which the TimingReport counts
as transfer. Read from the program's own totals of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py); None where the span
never ran, as in a program without spans."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.session.readback")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
