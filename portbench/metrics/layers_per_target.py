"""G-buffer layers the layers config hands its model a target: the counter
layers.loaded (runtime/session.py, Session._run_layers) of the traced
window over its targets. The layers the scan finds (utils/dataset.py): 3.0
in the 1080p layers configuration; a scan that drops or adds a layer shows
here. None where no layer was counted, as in a program without the
counter."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    layers = getattr(timing, "totals", {}).get("layers.loaded", [0, 0])[1]
    if not layers or not r.frames:
        return None
    return layers / r.frames
