"""Host ms a target's G-buffer layers take to stack and upload in the layers
config: the span idf.layers.upload (runtime/session.py, Session._run_layers:
np.stack of the decoded layers and their host-to-device copy) over the
window's targets. Read from the program's own totals of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py); None where the span
never ran, as in a program without it."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.layers.upload")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
