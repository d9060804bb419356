"""Host ms a target's G-buffer layers take to load in the layers config: the
span idf.layers.load (runtime/session.py, Session._run_layers: the shared
cache's lookups and the decodes of the target's layers) over the window's
targets. Read from the program's own totals of the traced window
(image_denoising_filter_tpu_torch/utils/timing.py); None where the span
never ran, as in a program without it."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    total = getattr(timing, "totals", {}).get("idf.layers.load")
    if not total or not total[1] or not r.frames:
        return None
    return total[0] / r.frames / 1e6
