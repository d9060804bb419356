"""The reference's sixth configuration, multiframe NLM with copy/compute
overlap (`config.GPU_BATTERY[5]`, the benchmark's
`temporal_nlm_overlap_1080p`), through the port on the CPU: the plain
reference's window rule against the port's dataset discovery, Session.run
of the overlap config with the Python and the native frame loader against
the plain reference, the prefetcher's native loader closed however its
iteration ends, its spans and counter, and the benchmark's readers of
them."""

import contextlib
import copy
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import (
    GPU_BATTERY,
    NlmParams,
    RunConfig,
    TilingConfig,
)
from image_denoising_filter_tpu_torch.runtime import FramePrefetcher, Session
from image_denoising_filter_tpu_torch.utils import dataset, imageio, native, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from portbench import harness, trace  # noqa: E402
from portbench.compare import mismatch_share  # noqa: E402
from portbench.reference import png  # noqa: E402
from portbench.reference import temporal_nlm_overlap as reference  # noqa: E402

torch.set_num_threads(1)

with open(os.path.join(REPO, "portbench", "configs", "temporal_nlm_overlap_1080p.json")) as f:
    CONFIG = json.load(f)
OVERLAP = RunConfig(nlm=True, multiframe=True, overlap=True, max_frames=CONFIG["max_frames"])
MULTIFRAME = RunConfig(nlm=True, multiframe=True)
NLM = NlmParams(**CONFIG["params"])
N_FRAMES, TARGET, H, W = 10, 3, 24, 40
WINDOW = 9  # the target, then the shot's first 8 frames
# The port's plain version and the reference compute the same float32
# filter, with the same adds in another order: outputs in [0, 1] agree to a
# few ulps of 1. bf16 taps miss by ~1e-3 (test_other_runs_miss_the_tolerance).
TOL = 2e-5


def test_the_configuration_is_the_batterys_sixth():
    assert OVERLAP == GPU_BATTERY[5] and CONFIG["max_frames"] == reference.FRAMES_TO_USE


@pytest.mark.parametrize("k", [0, 3, 8, 9])
@pytest.mark.parametrize("n", [10, 12])
def test_the_reference_window_is_the_overlap_loops(tmp_path, n, k):
    """The reference's rule against dataset.discover's list less its last
    entry, which the overlap loop uploads and never filters: a target among
    the first eight frames counted twice, a later one once."""
    paths = [str(tmp_path / f"frame_{i:04d}.png") for i in range(n)]
    for p in paths:
        open(p, "wb").close()
    ds = dataset.discover(paths[k], multiframe=True, max_frames=10)
    want = [paths.index(p) for p in ds.frames[:-1]]
    got = reference.window(k, n)
    assert got == want and len(got) == WINDOW
    assert got.count(k) == (2 if k < 8 else 1)


def _shot_u8():
    """(N_FRAMES, H, W, 4) uint8 frames: smooth content panning a pixel a
    frame with seeded noise, opaque."""
    rng = np.random.default_rng(22)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = []
    for i in range(N_FRAMES):
        x = xx + i
        base = np.stack([0.5 + 0.4 * np.sin(x / 5.0), 0.5 + 0.4 * np.cos(yy / 4.0),
                         np.where(x > W / 2, 0.8, 0.2), np.ones((H, W))], -1)
        noisy = base + np.concatenate([rng.normal(0, 0.08, (H, W, 3)), np.zeros((H, W, 1))], -1)
        frames.append(np.round(np.clip(noisy, 0, 1) * 255).astype(np.uint8))
    return np.stack(frames)


@pytest.fixture(scope="module")
def shot(tmp_path_factory):
    """The shot's PNG files (one directory), its target's path, and the
    plain reference's output for the target."""
    root = tmp_path_factory.mktemp("shot")
    u8 = _shot_u8()
    paths = [root / f"frame_{i:04d}.png" for i in range(N_FRAMES)]
    for p, img in zip(paths, u8):
        p.write_bytes(png.encode(img, 1))
    want = reference.temporal_nlm_overlap(torch.from_numpy(png.to_float(u8)), TARGET,
                                          CONFIG["params"]).numpy()
    return types.SimpleNamespace(target=str(paths[TARGET]), want=want)


@pytest.fixture(scope="module")
def native_root(tmp_path_factory):
    if native._cxx() is None:
        pytest.skip("no C++ compiler found (set CXX or put g++ on PATH)")
    path = tmp_path_factory.mktemp("native_root")
    native.build(path)
    return path


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """No native library loaded or found: the process's library is left as
    it was found."""
    monkeypatch.setattr(native, "_loaded", native._Loaded())
    monkeypatch.delenv("IDF_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "MAKE_LIB", tmp_path / "no_make" / native.LIB_NAME)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "no_build")


@pytest.fixture(params=["python", "native"])
def loader(request, no_library):
    if request.param == "native":
        native.ensure(request.getfixturevalue("native_root"))
    return request.param


@pytest.fixture(autouse=True)
def profiler_off():
    """A count with no profiler on, so that a test's first profiled span
    starts a new stretch whatever ran before it in this process."""
    timing.count("tests.profiler_off")


def _run(shot, tmp_path, cfg=OVERLAP, **kw):
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    return Session(shot.target, device="cpu", output_dir=str(out), nlm_params=NLM,
                   **kw).run(cfg)


def test_session_run_matches_the_plain_reference(shot, tmp_path, loader):
    """Session.run of the overlap config with either frame loader: the image
    within TOL of the reference, and the saved PNG's bytes the reference's
    cast as the upstream reference casts it, within the configuration's
    share."""
    result = _run(shot, tmp_path)
    assert result.frame_loader == loader
    np.testing.assert_allclose(result.image, shot.want, rtol=0, atol=TOL)
    with open(result.output_path, "rb") as f:
        saved = png.decode(f.read())
    assert mismatch_share(saved, png.quantize(shot.want)) <= CONFIG["limits"][
        "png_mismatch_share"]


@pytest.mark.parametrize("case", ["bf16_taps", "without_overlap"])
def test_other_runs_miss_the_tolerance(shot, tmp_path, no_library, case):
    """bf16 taps on the same window, and the non-overlap multiframe loop
    (the target and all ten frames, one more norm seed each), each differ
    from the reference by more than TOL."""
    if case == "bf16_taps":
        result = _run(shot, tmp_path, nlm_tiling=TilingConfig(compute_dtype="bfloat16"))
    else:
        result = _run(shot, tmp_path, cfg=MULTIFRAME)
    assert np.abs(result.image - shot.want).max() > 10 * TOL


@pytest.mark.parametrize("end", ["full", "break", "raise"])
def test_the_native_loader_is_closed_however_the_iteration_ends(tmp_path, no_library,
                                                                native_root, monkeypatch, end):
    """The prefetcher closes its native loader (four C++ threads) when its
    iteration runs out, is abandoned by a break, or raises; a get after
    that raises rather than reaching the closed loader."""
    native.ensure(native_root)
    closed = []
    close = native.FrameLoader.close
    monkeypatch.setattr(native.FrameLoader, "close",
                        lambda self: (closed.append(self._handle is not None), close(self)))
    paths = []
    for i in range(5):
        paths.append(str(tmp_path / f"frame_{i:04d}.png"))
        imageio.save(paths[-1], np.full((6, 7, 4), i / 8.0, np.float32))
    pf = FramePrefetcher(paths, lambda p: imageio.load(p)[0], "cpu", native_paths=True)
    assert pf.loader == "native"
    seen = 0
    with pytest.raises(KeyError) if end == "raise" else contextlib.nullcontext():
        for frame in pf:
            seen += 1
            if end == "break" and seen == 2:
                break
            if end == "raise" and seen == 2:
                raise KeyError("the consumer failed")
    assert seen == (5 if end == "full" else 2)
    assert closed == [True]
    with pytest.raises(ValueError, match="closed"):
        pf._native.get(4)


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_a_profiled_run_counts_the_window_and_its_waits(shot, tmp_path, no_library):
    """Under a profiler: nine frames handed out and eight waits (the target,
    twice in its window, is decoded once), no pinned staging on the CPU, and the Session's spans as before the prefetcher had
    spans: the load (the target and the nine frames) keeps the waits nested
    in it, and upload and readback are the report's transfer. With the
    profiler off the totals are left alone."""
    with _profiler():
        report = _run(shot, tmp_path).report
    t = timing.totals
    assert t[timing.PREFETCH_FRAMES] == [0, WINDOW]
    assert t[timing.PREFETCH_WAIT][1] == WINDOW - 1 and t[timing.PREFETCH_WAIT][0] > 0
    assert timing.PREFETCH_PIN not in t
    assert t[timing.LOAD][1] == 1 + WINDOW
    assert t[timing.LOAD][0] >= t[timing.PREFETCH_WAIT][0]
    assert t[timing.UPLOAD][0] + t[timing.READBACK][0] == report.transfer_ns
    kept = copy.deepcopy(t)
    _run(shot, tmp_path)
    assert timing.totals == kept


@pytest.mark.parametrize("inner, outer_ns", [(timing.PREFETCH_WAIT, 100), (timing.UPLOAD, 70)])
def test_a_prefetch_span_is_not_taken_out_of_the_sessions(monkeypatch, inner, outer_ns):
    """On a clock that reads 0, 10, 40, 100: the prefetcher's span (its own
    layer) inside the Session's load leaves the load's 100 ns whole; a
    Session span there (the same layer) is taken out of it."""
    ticks = iter([0, 10, 40, 100])
    monkeypatch.setattr(timing, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(ticks)))
    with _profiler():
        with timing.span(timing.LOAD):
            with timing.span(inner):
                pass
    assert timing.totals[timing.LOAD] == [outer_ns, 1]
    assert timing.totals[inner] == [30, 1]


# The benchmark's readers of the prefetcher's totals: (metric, totals,
# targets, value).
READER_CASES = [
    ("prefetch_wait_ms", {"idf.prefetch.wait": [6_000_000, 18], "idf.session.load": [1, 1]},
     2, 3.0),
    ("prefetch_pin_ms", {"idf.prefetch.pin": [9_000_000, 18]}, 2, 4.5),
    ("prefetch_frames_per_target", {"prefetch.frames": [0, 18]}, 2, 9.0),
    ("prefetch_cache_hit_pct", {"prefetch.cache_hit": [0, 83], "prefetch.cache_miss": [0, 7]},
     10, 100 * 83 / 90),
]


def _reading(frames, family="temporal_nlm_overlap", tr=None, steps=()):
    return harness.Reading(family=family, frames=frames, window=(0.0, 1.0), steps=list(steps),
                           trace=tr, step_work=(0, 67e9), session=None)


@pytest.mark.parametrize("name,totals,frames,want", READER_CASES, ids=[c[0] for c in READER_CASES])
def test_prefetch_readers(monkeypatch, name, totals, frames, want):
    reader = harness.metric(harness.ROOT, name)
    monkeypatch.setattr(timing, "totals", totals)
    assert reader.read(_reading(frames)) == pytest.approx(want)
    monkeypatch.setattr(timing, "totals", {"idf.session.load": [7, 1], "frame_cache.miss": [0, 4]})
    assert reader.read(_reading(frames)) is None
    monkeypatch.delattr(timing, "totals")
    assert reader.read(_reading(frames)) is None


def test_the_overlap_roofline_reader():
    """67 G operations a step (1 ms at the float32 peak) over a 20 ms
    kernel inside the step: 5%; None for another family, with no step, or
    with no kernel."""
    reader = harness.metric(harness.ROOT, "roofline_pct.tnlm.overlap")
    tr = trace.Trace(spans={}, device=[{"cat": "kernel", "name": "nlm", "ts": 1000.0,
                                        "dur": 20000.0}], host=[])
    assert reader.read(_reading(1, tr=tr, steps=[(0.0, 50000.0)])) == pytest.approx(5.0)
    assert reader.read(_reading(1, "temporal_nlm", tr=tr, steps=[(0.0, 50000.0)])) is None
    assert reader.read(_reading(1, tr=tr)) is None
    empty = trace.Trace(spans={}, device=[], host=[])
    assert reader.read(_reading(1, tr=empty, steps=[(0.0, 50000.0)])) is None
