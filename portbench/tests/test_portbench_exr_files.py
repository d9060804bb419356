"""The HDR configuration's cell from disk, `tnlm-1080p-exr-files`: found by
name with its metrics, its step's work by hand, the benchmark's own EXR
reader and writer against the port's codecs, its traced run's EXR spans,
and a comparison that fails where the run or its save is wrong: the control
(bf16 taps), a target returned unchanged, a half-float save, a save without
alpha, a save clamped to [0, 1], and one output value off by twice the
relative limit. The runs take the port's plain versions on the CPU at a
tiny size (conftest.py)."""

import struct

import numpy as np
import pytest

from image_denoising_filter_tpu_torch.models import denoiser
from image_denoising_filter_tpu_torch.runtime import session as session_mod
from image_denoising_filter_tpu_torch.utils import exr as port_exr
from image_denoising_filter_tpu_torch.utils import imageio, native
from portbench import harness, work
from portbench.reference import exr
from portbench.tests.conftest import run_tiny

CELL = "tnlm-1080p-exr-files"
METRICS = {"exr_encode_ms", "exr_size_pct", "session_load_ms.exr", "roofline_pct.tnlm.exr"}
CHECKS = ("max_rel_err", "exr_format_mismatch", "saved_readback_mismatch_share")


def test_the_cell_resolves_with_its_metrics():
    cell = harness.find_cell(harness.ROOT, CELL)
    assert cell.chips == 1 and cell.config["family"] == "temporal_nlm_hdr"
    assert cell.traffic["feed"] == "files_exr" and cell.traffic["shots"] == 7
    assert cell.traffic["shots"] * cell.config["shot_frames"] > 32   # each shot starts cold
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s.files", "peak_work_mib",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert all(m["moves"] == "frames_per_s.files" for m in cell.per_layer)
    assert set(cell.config["limits"]) == set(CHECKS)


def test_temporal_nlm_hdr_step_bound_by_hand():
    """The temporal NLM's step: F = 6 frames and the target in, the output
    out; 24 operations a candidate, pixel and frame over 196 candidates,
    and the normalize's 5 a pixel."""
    cell = harness.find_cell(harness.ROOT, CELL)
    px = 1920 * 1080
    nbytes, ops = harness.family(harness.ROOT, cell).step_work(cell.config)
    assert nbytes == 16 * 6 * px + 16 * px
    assert ops == 24 * 6 * 196 * px + 5 * px
    ms, by = work.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(0.8737, abs=1e-4)


def _image(h=13, w=21, seed=3) -> np.ndarray:
    """An HDR image with every kind of float32 value the saves carry: below
    0, above 1, tens, -0.0, a non-uniform alpha."""
    rng = np.random.default_rng(seed)
    img = (rng.normal(0, 3, (h, w, 4)) * rng.choice([0.1, 1, 50], (h, w, 4))).astype(np.float32)
    img[0, 0, 0] = -0.0
    return img


@pytest.mark.parametrize("compression", [exr.NONE, exr.ZIP])
def test_the_writer_round_trips_through_both_readers(compression):
    img = _image(h=37)   # three ZIP blocks, the last one short
    data = exr.encode(img, compression, 1)
    got = exr.decode(data)
    assert (got.channels, got.types, got.compression) == (
        ["A", "B", "G", "R"], ["FLOAT"] * 4, compression)
    assert np.array_equal(got.rgba.view(np.uint32), img.view(np.uint32))
    assert np.array_equal(port_exr.decode(data).view(np.uint32), img.view(np.uint32))


@pytest.fixture(scope="module")
def native_codec(tmp_path_factory):
    if native._cxx() is None:
        pytest.skip("no C++ compiler found (set CXX or put g++ on PATH)")
    root = tmp_path_factory.mktemp("native_root")
    path, _, _ = native.build(root)
    return path


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("compression", [exr.NONE, exr.ZIPS, exr.ZIP])
@pytest.mark.parametrize("codec", ["python", "native"])
def test_the_reader_reads_the_ports_saves_value_for_value(monkeypatch, codec, compression,
                                                          half, request):
    """Every form the port's two encoders write, decoded by the benchmark's
    reader and by the port's Python decoder alike, bit for bit."""
    img = _image()
    if codec == "native":
        monkeypatch.setattr(native, "_loaded", native._Loaded())
        monkeypatch.setenv("IDF_NATIVE_LIB", str(request.getfixturevalue("native_codec")))
        data = native.exr_encode(img, half=half, compression=compression)
    else:
        data = port_exr.encode(img, half=half, compression=compression)
    got = exr.decode(data)
    assert got.types == ["HALF" if half else "FLOAT"] * 4 and got.compression == compression
    want = img.astype(np.float16).astype(np.float32) if half else img
    assert np.array_equal(got.rgba.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got.rgba.view(np.uint32), port_exr.decode(data).view(np.uint32))


def test_the_reader_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="not an OpenEXR"):
        exr.decode(b"\x89PNG\r\n\x1a\n" + bytes(16))
    data = bytearray(exr.encode(_image(), exr.ZIP))
    data[5] |= 0x02   # the tiled flag, bit 9 of the version field
    with pytest.raises(ValueError, match="single-part scanline"):
        exr.decode(bytes(data))


def test_a_traced_run_reads_the_exr_spans():
    """On the CPU: the encode and its bytes, the load; no kernel there, so
    the roofline reads nothing."""
    result = run_tiny(CELL, trace=True)
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["exr_encode_ms"]["value"] > 0 and metrics["session_load_ms.exr"]["value"] > 0
    assert 0 < metrics["exr_size_pct"]["value"]
    assert "roofline_pct.tnlm.exr" not in metrics


def test_the_program_is_correct():
    result = run_tiny(CELL)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"frames_per_s.files", "setup_s"}  # no card memory here
    assert {k: v["value"] for k, v in result["checks"].items()
            if k != "max_rel_err"} == {"exr_format_mismatch": 0,
                                       "saved_readback_mismatch_share": 0.0}


def _bgr_only(rgba: np.ndarray) -> bytes:
    """rgba's B, G and R as an uncompressed FLOAT EXR, without alpha."""
    h, w, _ = rgba.shape

    def attr(name, kind, body):
        return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(body)) + body

    chlist = b"".join(c + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1) for c in (b"B", b"G", b"R"))
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<iI", exr.MAGIC, 2) + attr("channels", "chlist", chlist + b"\0")
              + attr("compression", "compression", b"\0") + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box) + attr("lineOrder", "lineOrder", b"\0")
              + b"\0")
    rows = np.ascontiguousarray(rgba[..., [2, 1, 0]].transpose(0, 2, 1)).astype("<f4")
    blocks, offsets, pos = [], [], len(header) + 8 * h
    for y in range(h):
        blocks.append(struct.pack("<iI", y, rows[y].nbytes) + rows[y].tobytes())
        offsets.append(pos)
        pos += len(blocks[-1])
    return header + struct.pack(f"<{h}q", *offsets) + b"".join(blocks)


def _save_with(encode):
    def fault(monkeypatch):
        def write(path, rgba):
            with open(path, "wb") as f:
                f.write(encode(np.asarray(rgba, np.float32)))

        monkeypatch.setattr(imageio, "_write_exr", write)
    return fault


def _unchanged(monkeypatch):
    monkeypatch.setattr(session_mod.Session, "_run_multiframe",
                        lambda self, target_dev, *a: (target_dev.clone(), None))


def _off_by_twice_the_limit(monkeypatch):
    limit = harness.find_cell(harness.ROOT, CELL).config["limits"]["max_rel_err"]
    normalize = denoiser._Normalizing._normalize

    def altered(self, wc, nw):
        out = normalize(self, wc, nw)
        out[0, 0, 0] += 2 * limit * max(1.0, abs(float(out[0, 0, 0])))
        return out

    monkeypatch.setattr(denoiser._Normalizing, "_normalize", altered)


# fault -> the checks it must fail
FAULTS = {
    "unchanged": (_unchanged, {"max_rel_err"}),
    "half_float_save": (_save_with(lambda x: port_exr.encode(x, half=True)),
                        set(CHECKS)),
    "save_without_alpha": (_save_with(_bgr_only), set(CHECKS)),
    "save_clamped": (_save_with(lambda x: port_exr.encode(np.clip(x, 0, 1))),
                     {"max_rel_err", "saved_readback_mismatch_share"}),
    "off_by_twice_the_limit": (_off_by_twice_the_limit, {"max_rel_err"}),
}


@pytest.mark.parametrize("fault", ["control", *FAULTS])
def test_a_wrong_run_or_save_or_the_control_is_not_correct(monkeypatch, fault):
    if fault == "control":
        result, failing = run_tiny(CELL, variant="control"), {"max_rel_err"}
    else:
        apply, failing = FAULTS[fault]
        apply(monkeypatch)
        result = run_tiny(CELL)
    assert result["correct"] is False
    failed = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    assert failed == failing
