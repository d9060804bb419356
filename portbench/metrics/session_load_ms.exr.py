"""Host ms a frame spends in the Session's load phase in the EXR files cell,
the span idf.session.load: the frames' cache lookups, and each shot's first
target's wait for its EXR decodes on the native decode threads. Read from
the program's own totals of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py); None where the span
never ran, as in a program without spans."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.session.load")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
