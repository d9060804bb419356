"""Host ms a frame spends in the Session's upload phase, the span
idf.session.upload: the uploads the Session's TimingReport counts as
transfer. Read from the program's own totals of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py); None where the span
never ran, as in a program without spans."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.session.upload")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
