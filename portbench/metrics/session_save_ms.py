"""Host ms a frame spends in the Session's save phase, the span
idf.session.save: the output's quantize, encode and write. Read from the
program's own totals of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py); None where the span
never ran, as in a program without spans."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.session.save")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
