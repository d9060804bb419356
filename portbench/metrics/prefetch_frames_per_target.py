"""Frames the overlap loop's FramePrefetcher hands out a target: the
counter prefetch.frames (runtime/prefetch.py) of the traced window over its
targets. The overlap window's length (9 in the 1080p configuration): a
change that drops or adds a frame shows here. None where no frame was
counted, as in a program without the counter."""

from image_denoising_filter_tpu_torch.utils import timing


def read(r):
    frames = getattr(timing, "totals", {}).get("prefetch.frames", [0, 0])[1]
    if not frames or not r.frames:
        return None
    return frames / r.frames
