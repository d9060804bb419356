"""The HDR deployment from disk (`gpu-denoise --all-frames` on `.exr`
targets) on the CPU: a seeded 48x64 HDR shot of three targets, written as
float32 ZIP EXR by the benchmark's own writer (portbench/reference/exr.py),
with values below 0, the emissive ceiling patch and fireflies; each target
through Session.run with the multiframe NLM, under the port's Python codec
and, where a C++ compiler builds it, its native one. The image it reads
back and the EXR it saves, decoded by the benchmark's reader, against the
benchmark's plain reference (portbench/reference/temporal_nlm.py); the
saved file's format and its bits; the EXR codec's spans and counter
(utils/timing.py) and the benchmark's readers of them."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import NlmParams, RunConfig, TilingConfig
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import exr as port_exr
from image_denoising_filter_tpu_torch.utils import native, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from portbench import harness  # noqa: E402
from portbench.feeds import files_exr as feed  # noqa: E402
from portbench.reference import exr  # noqa: E402

torch.set_num_threads(1)

CELL = "tnlm-1080p-exr-files"
TARGETS = 3
MULTIFRAME = RunConfig(nlm=True, multiframe=True)
# The port's plain NLM and the reference sum the same float32 terms in
# another order. Relative to max(1, |value|), since HDR values reach 200,
# their outputs differ by 2.4e-6 to 3.5e-6 (read over seeds 26-30). 3e-5
# leaves 8x room above that and sits 60x under what bf16 taps give (1.8e-3
# to 3.1e-3), which must fail.
TOL = 3e-5


def _cfg():
    cell = harness.find_cell(harness.ROOT, CELL)
    return dict(cell.config, height=48, width=64, shot_frames=TARGETS), cell.traffic


def _family():
    return harness.family(harness.ROOT, harness.find_cell(harness.ROOT, CELL))


@pytest.fixture(scope="module")
def written_shot(tmp_path_factory):
    """One shot of TARGETS HDR frames from seed 26, written as the feed
    writes them: the targets' paths, the frames and the configuration."""
    cfg, traffic = _cfg()
    frames = _family().host_shots(cfg, 1, 26, "cpu")[0]
    root = tmp_path_factory.mktemp("shot")
    paths = []
    for k, frame in enumerate(frames):
        path = root / f"{traffic['prefix']}{k + 1:04d}.exr"
        path.write_bytes(exr.encode(frame, exr.ZIP, traffic["zip_level"]))
        paths.append(str(path))
    return paths, frames, cfg


@pytest.fixture(scope="module")
def native_root(tmp_path_factory):
    if native._cxx() is None:
        pytest.skip("no C++ compiler found (set CXX or put g++ on PATH)")
    path = tmp_path_factory.mktemp("native_root")
    native.build(path)
    return path


@pytest.fixture(params=["python", "native"])
def codec(request, monkeypatch, tmp_path):
    """The port's EXR codec for the test: no native library loaded or found
    (the process's library is left as it was found), or the one built for
    this module."""
    monkeypatch.setattr(native, "_loaded", native._Loaded())
    monkeypatch.delenv("IDF_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "MAKE_LIB", tmp_path / "no_make" / native.LIB_NAME)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "no_build")
    if request.param == "native":
        native.ensure(request.getfixturevalue("native_root"))
    assert native.available() == (request.param == "native")
    return request.param


@pytest.fixture(autouse=True)
def profiler_off():
    """A count with no profiler on, so that a test's first profiled span
    starts a new stretch whatever ran before it in this process."""
    timing.count("tests.profiler_off")


def _run(path: str, cfg: dict, out_dir, tiling=None):
    os.makedirs(out_dir, exist_ok=True)
    return Session(path, device="cpu", nlm_params=NlmParams(**cfg["params"]),
                   nlm_tiling=tiling, output_dir=str(out_dir), frame_cache={}).run(MULTIFRAME)


def _want(frames: np.ndarray, k: int, cfg: dict) -> np.ndarray:
    family = _family()
    return family.reference(cfg, family.window_item(torch.from_numpy(frames), k)).numpy()


def test_the_shot_holds_hdr_values(written_shot):
    """Values below 0 (noise left unclipped), the emissive patch above 4,
    and in every frame its fireflies: the pixels where a shot made with a
    firefly gain of 1, from the same seed, differs."""
    _, frames, cfg = written_shot
    assert frames.dtype == np.float32 and frames.shape == (TARGETS, 48, 64, 4)
    assert frames[..., :3].min() < 0 and np.all(frames[..., 3] == 1)
    assert np.median(frames[:, 0, 26:38, :3]) > 4          # the ceiling patch
    plain = _family().host_shots(dict(cfg, firefly_gain=1.0), 1, 26, "cpu")[0]
    fired = np.any(frames != plain, axis=-1).reshape(TARGETS, -1).sum(axis=1)
    assert fired.tolist() == [max(1, round(cfg["firefly_share"] * 48 * 64))] * TARGETS


@pytest.mark.parametrize("k", range(TARGETS))
def test_each_target_matches_the_reference_and_saves_its_readback(written_shot, codec,
                                                                   tmp_path, k):
    """The read-back image and the saved EXR within TOL of the reference;
    the file A, B, G, R FLOAT ZIP, its values the read-back's bit for bit,
    and its bytes the port's encoder's."""
    paths, frames, cfg = written_shot
    result = _run(paths[k], cfg, tmp_path)
    want = _want(frames, k, cfg)
    assert result.output_path.endswith(".exr")
    assert feed.rel_err(result.image, want) <= TOL
    data = Path(result.output_path).read_bytes()
    saved = exr.decode(data)
    assert (saved.channels, saved.types, saved.compression) == (
        ["A", "B", "G", "R"], ["FLOAT"] * 4, exr.ZIP)
    assert feed.format_mismatch(saved, cfg) == 0
    assert feed.bits_mismatch_share(saved.rgba, result.image) == 0.0
    assert feed.rel_err(saved.rgba, want) <= TOL
    encode = native.exr_encode if codec == "native" else port_exr.encode
    assert data == encode(result.image)


@pytest.mark.parametrize("k", range(TARGETS))
def test_bf16_taps_fail_the_tolerance(written_shot, tmp_path, k):
    """The program's own lower-precision path, bf16 taps, is outside TOL:
    it is tight enough to tell the precision apart."""
    paths, frames, cfg = written_shot
    result = _run(paths[k], cfg, tmp_path, tiling=TilingConfig(compute_dtype="bfloat16"))
    assert feed.rel_err(result.image, _want(frames, k, cfg)) > TOL


def test_the_encode_span_counts_one_a_save_inside_the_save(written_shot, codec, tmp_path):
    """Under the profiler: one idf.exr.encode a save, which leaves
    idf.session.save whole (another layer); exr_encode.bytes the file's
    size; idf.exr.decode once a miss decoded on the loop's thread (the
    Python codec's three), none where the native threads decode them."""
    paths, _, cfg = written_shot
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        result = _run(paths[1], cfg, tmp_path)
    t = timing.totals
    assert t[timing.EXR_ENCODE][1] == 1 and t[timing.SAVE][1] == 1
    assert 0 < t[timing.EXR_ENCODE][0] <= t[timing.SAVE][0]
    assert t[timing.EXR_BYTES] == [0, os.path.getsize(result.output_path)]
    decodes = t.get(timing.EXR_DECODE, [0, 0])[1]
    assert decodes == (0 if codec == "native" else TARGETS)
    assert t.get(timing.DECODES_AHEAD, [0, 0])[1] == (TARGETS if codec == "native" else 0)


def test_no_profiler_keeps_no_exr_totals(written_shot, tmp_path):
    paths, _, cfg = written_shot
    timing.totals.clear()
    _run(paths[0], cfg, tmp_path)
    assert timing.totals == {}


def _reading(frames: int, family: str = "temporal_nlm_hdr") -> harness.Reading:
    return harness.Reading(family=family, frames=frames, window=(0.0, 1.0), steps=[],
                           trace=None, step_work=(0, 0), session=None)


FRAME_BYTES = 16 * 1080 * 1920
READER_CASES = [
    ("exr_encode_ms", {"idf.exr.encode": [9_000_000, 3], "idf.session.save": [1, 3]}, 3.0),
    ("exr_size_pct", {"exr_encode.bytes": [0, 3 * FRAME_BYTES // 2],
                      "idf.exr.encode": [1, 3]}, 50.0),
    ("session_load_ms.exr", {"idf.session.load": [6_000_000, 18]}, 2.0),
]


@pytest.mark.parametrize("name,totals,want", READER_CASES, ids=[c[0] for c in READER_CASES])
def test_reader_of_the_program_totals(monkeypatch, name, totals, want):
    """Three frames' totals, each reader's value a frame (the size against
    the 1080p configuration's 16 H W bytes)."""
    monkeypatch.setattr(timing, "totals", totals)
    assert harness.metric(harness.ROOT, name).read(_reading(3)) == pytest.approx(want)


@pytest.mark.parametrize("name", [c[0] for c in READER_CASES])
def test_reader_finds_nothing_where_its_span_never_ran(monkeypatch, name):
    """None where the totals hold none of its spans or counters, and where
    the program keeps no totals (a program without spans)."""
    reader = harness.metric(harness.ROOT, name)
    monkeypatch.setattr(timing, "totals", {"idf.other.span": [7, 1], "other.count": [0, 4]})
    assert reader.read(_reading(3)) is None
    monkeypatch.delattr(timing, "totals")
    assert reader.read(_reading(3)) is None


def test_the_size_reader_finds_no_size_outside_a_configured_family(monkeypatch):
    monkeypatch.setattr(timing, "totals", {"exr_encode.bytes": [0, 100]})
    assert harness.metric(harness.ROOT, "exr_size_pct").read(_reading(3, "no_family")) is None


def test_the_roofline_reads_only_its_family():
    reader = harness.metric(harness.ROOT, "roofline_pct.tnlm.exr")
    step = (0.0, 1.0)
    for family in ("temporal_nlm", "layer_guided_files"):
        r = harness.Reading(family=family, frames=1, window=step, steps=[step], trace=None,
                            step_work=(1, 1), session=None)
        assert reader.read(r) is None
