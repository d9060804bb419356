"""The saved EXR's size as a share of the frame's float32 RGBA pixels: the
counter exr_encode.bytes (utils/imageio.py:_write_exr) over the window's
frames, over 16 H W bytes, in percent; H and W are those of the
configuration in BENCHMARK.json whose family is the run's. A faster save
that deflates less shows here as a larger file. None where no byte was
counted, as in a program without the counter."""

from image_denoising_filter_tpu_torch.utils import timing
from portbench import harness


def frame_bytes(family: str):
    """16 H W of the configuration of this family, or None."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        if cfg.get("family") == family:
            return 16 * cfg["height"] * cfg["width"]
    return None


def read(r):
    encoded = getattr(timing, "totals", {}).get("exr_encode.bytes", [0, 0])[1]
    raw = frame_bytes(r.family)
    if not encoded or not raw or not r.frames:
        return None
    return 100.0 * encoded / r.frames / raw
