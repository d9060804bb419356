"""The port's spans and counters (utils/timing.py) on the CPU: every phase
of Session.run and the models' forward under torch.profiler, in the
program's totals and in the exported trace, the totals of the last profiled
stretch only, nothing kept and nothing changed with no profiler, and the
benchmark's readers of those totals (portbench/metrics/)."""

import contextlib
import copy
import importlib.util
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch import cli, models
from image_denoising_filter_tpu_torch.config import (
    GPU_BATTERY,
    BilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
)
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import imageio, timing
from image_denoising_filter_tpu_torch.utils.timing import TimingReport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from portbench import harness  # noqa: E402

torch.set_num_threads(1)

PHASES = (timing.OPEN, timing.LOAD, timing.UPLOAD, timing.WARMUP, timing.EXEC,
          timing.READBACK, timing.SAVE)
PARAMS = dict(bilateral_params=BilateralParams(radius=2), layers_params=LayersParams(radius=2),
              nlm_params=NlmParams(search_radius=2, patch_radius=1))
MULTIFRAME = RunConfig(nlm=True, multiframe=True)
N_FRAMES = 3


def _frame(seed, h=20, w=28):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.1, 0.9, (h, w, 4)).astype(np.float32)
    img[..., 3] = 1.0
    return img


@pytest.fixture(scope="module")
def shot(tmp_path_factory):
    """A shot of N_FRAMES PNG frames with two G-buffer layers of the target,
    frame_0001 (the target's path)."""
    root = tmp_path_factory.mktemp("shot")
    (root / "RenderElements").mkdir()
    for i in range(N_FRAMES):
        imageio.save(str(root / f"frame_{i:04d}.png"), _frame(i))
    for i, name in enumerate(("albedo", "normal")):
        imageio.save(str(root / "RenderElements" / f"{name}_0001.png"), _frame(10 + i))
    return str(root / "frame_0001.png")


@pytest.fixture(scope="module")
def layered_shot(tmp_path_factory):
    """A target, frame_0001, with three G-buffer layers (its path)."""
    root = tmp_path_factory.mktemp("layered")
    (root / "RenderElements").mkdir()
    imageio.save(str(root / "frame_0001.png"), _frame(0))
    for i, name in enumerate(("albedo", "normal", "depth")):
        imageio.save(str(root / "RenderElements" / f"{name}_0001.png"), _frame(20 + i))
    return str(root / "frame_0001.png")


@pytest.fixture(autouse=True)
def profiler_off():
    """A count with no profiler on, so that the test's first profiled span
    starts a new stretch whatever ran before it in this process."""
    timing.count("tests.profiler_off")


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _run(target, out_dir, profile, cache=None, cfg=MULTIFRAME, **kw):
    """Session(...) + Session.run(cfg), under the profiler or not: the
    RunResult, the wall ns around both, and the profiler."""
    os.makedirs(out_dir, exist_ok=True)
    with _profiler() if profile else contextlib.nullcontext() as prof:
        t0 = time.perf_counter_ns()
        result = Session(target, device="cpu", output_dir=out_dir, frame_cache=cache,
                         **PARAMS, **kw).run(cfg)
        wall = time.perf_counter_ns() - t0
    return result, wall, prof


def _session_ns():
    return sum(ns for name, (ns, n) in timing.totals.items() if name.startswith(timing.SESSION))


def test_a_profiled_run_fills_every_session_phase(shot, tmp_path):
    """The multiframe NLM with a new shared cache: every phase once or once
    a frame, the cache's lookups as counted by hand, upload + readback the
    report's transfer, exec the report's exec, and the disjoint phases
    within the wall time around the run."""
    result, wall, _ = _run(shot, str(tmp_path / "out"), True, cache={})
    t = timing.totals
    frames = N_FRAMES + 1  # the target, then every frame of the shot (itself again)
    assert {name: t[name][1] for name in PHASES} == {
        timing.OPEN: 1, timing.LOAD: 1 + frames, timing.UPLOAD: 1 + frames,
        timing.WARMUP: 1, timing.EXEC: frames + 1, timing.READBACK: 1, timing.SAVE: 1}
    assert all(t[name][0] > 0 for name in PHASES)
    # the target misses, then hits as the window's first frame and again in
    # its place among the shot's frames; the other frames miss once each
    assert t[timing.CACHE_HIT] == [0, 2] and t[timing.CACHE_MISS] == [0, N_FRAMES]
    assert t[timing.UPLOAD][0] + t[timing.READBACK][0] == result.report.transfer_ns
    assert t[timing.EXEC][0] == result.report.exec_ns
    assert _session_ns() <= wall
    assert timing.FORWARD not in t  # the Session folds frames with accumulate_one


def test_the_trace_holds_each_phase_as_a_user_annotation(shot, tmp_path):
    _, _, prof = _run(shot, str(tmp_path / "out"), True, cache={})
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = smoke.program_spans(path, timing.SESSION)
    counts = {name: sum(n == name for n, _, _ in spans) for name in PHASES}
    assert counts == {name: n for name, (_, n) in timing.totals.items() if name in PHASES}
    with open(path) as f:
        cats = {e["cat"] for e in json.load(f)["traceEvents"]
                if e.get("name", "").startswith(timing.SESSION)}
    assert cats == {"user_annotation"}


def test_a_second_profiled_stretch_resets_the_totals(shot, tmp_path):
    """A stretch, a run with no profiler, a second stretch on the now warm
    cache: the totals are the second stretch's alone."""
    cache = {}
    _run(shot, str(tmp_path / "a"), True, cache=cache)
    first = copy.deepcopy(timing.totals)
    _run(shot, str(tmp_path / "b"), False, cache=cache)
    _run(shot, str(tmp_path / "c"), True, cache=cache)
    assert timing.CACHE_MISS not in timing.totals
    assert timing.totals[timing.CACHE_HIT] == [0, N_FRAMES + 2]
    assert {n: timing.totals[n][1] for n in PHASES} == {n: first[n][1] for n in PHASES}


def test_no_profiler_keeps_no_totals_and_changes_no_output(shot, tmp_path):
    """With no profiler on, the totals of the last stretch stay as they
    were, and the run saves the profiled run's file and image byte for
    byte."""
    profiled, _, _ = _run(shot, str(tmp_path / "on"), True, cache={})
    kept = copy.deepcopy(timing.totals)
    plain, _, _ = _run(shot, str(tmp_path / "off"), False, cache={})
    assert timing.totals == kept
    assert plain.image.tobytes() == profiled.image.tobytes()
    with open(plain.output_path, "rb") as a, open(profiled.output_path, "rb") as b:
        assert a.read() == b.read()
    assert plain.report.transfer_ns > 0 and plain.report.exec_ns > 0


# Every path of a one-device Session on the CPU: (how it runs, its phases).
PATHS = {
    "bilateral": (lambda s: s.run(GPU_BATTERY[0]), PHASES),
    "layers": (lambda s: s.run(GPU_BATTERY[1]), PHASES),
    "linear": (lambda s: s.run(GPU_BATTERY[2]), PHASES),
    "nlm": (lambda s: s.run(GPU_BATTERY[3]), PHASES),
    "overlap": (lambda s: s.run(GPU_BATTERY[5]), PHASES),
    "turbo": (lambda s: s.run_turbo(GPU_BATTERY[0], downsample=2), PHASES),
    "turbo_layers": (lambda s: s.run_turbo(GPU_BATTERY[1], downsample=2), PHASES),
    "cpu": (lambda s: s.run_cpu(1), (timing.OPEN, timing.LOAD, timing.EXEC, timing.SAVE)),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_every_session_path_spans_its_phases(shot, tmp_path, path):
    how, phases = PATHS[path]
    with _profiler():
        t0 = time.perf_counter_ns()
        how(Session(shot, device="cpu", output_dir=str(tmp_path), **PARAMS))
        wall = time.perf_counter_ns() - t0
    assert {n for n in timing.totals if n.startswith(timing.SESSION)} == set(phases)
    assert _session_ns() <= wall


def test_batched_frames_warm_up_and_upload_once_a_chunk(shot, tmp_path):
    result, _, _ = _run(shot, str(tmp_path), True, cache={}, batch_frames=True)
    t = timing.totals
    assert {n for n in t if n.startswith(timing.SESSION)} == set(PHASES)
    assert t[timing.WARMUP][1] == 1 and t[timing.UPLOAD][1] == 2  # the target, the stack
    assert t[timing.UPLOAD][0] + t[timing.READBACK][0] == result.report.transfer_ns


def test_a_layers_run_spans_its_layers_once(layered_shot, tmp_path):
    """The layers config: one idf.layers.load around the three layers'
    loads, one idf.layers.upload around their stack and copy, three layers
    counted. The Session's phases keep the spans of their own layer whole:
    the target's and the three layers' loads, the target's and the stack's
    uploads, which with the readback are the report's transfer."""
    result, wall, _ = _run(layered_shot, str(tmp_path), True, cache={}, cfg=GPU_BATTERY[1])
    t = timing.totals
    assert t[timing.LAYERS_LOAD][1] == 1 and t[timing.LAYERS_UPLOAD][1] == 1
    assert t[timing.LAYERS_LOADED] == [0, 3]
    assert t[timing.LOAD][1] == 1 + 3 and t[timing.UPLOAD][1] == 2
    assert t[timing.UPLOAD][0] + t[timing.READBACK][0] == result.report.transfer_ns
    assert 0 < t[timing.LAYERS_UPLOAD][0] <= t[timing.UPLOAD][0]
    assert 0 < t[timing.LAYERS_LOAD][0] <= wall


@pytest.mark.parametrize("outer, inner", [(timing.LAYERS_LOAD, timing.LOAD),
                                          (timing.UPLOAD, timing.LAYERS_UPLOAD)])
def test_a_layers_span_and_a_session_span_keep_their_totals(monkeypatch, outer, inner):
    """On a clock that reads 0, 10, 40, 100: a span of the layers' layer
    around a Session span, or inside one, takes nothing out of the other:
    the outer keeps its 100 ns, the inner its 30."""
    ticks = iter([0, 10, 40, 100])
    monkeypatch.setattr(timing, "time", types.SimpleNamespace(perf_counter_ns=lambda: next(ticks)))
    with _profiler():
        with timing.span(outer):
            with timing.span(inner):
                pass
    assert timing.totals[outer] == [100, 1] and timing.totals[inner] == [30, 1]


def test_a_multiframe_run_opens_no_layers_span(shot, tmp_path):
    _run(shot, str(tmp_path), True, cache={})
    assert timing.LOAD in timing.totals
    assert not [n for n in timing.totals if n.startswith(timing.LAYERS)]
    assert timing.LAYERS_LOADED not in timing.totals


def _inputs(family):
    img = torch.from_numpy(_frame(0))
    if family == "layers":
        return models.LayerGuidedDenoiser(PARAMS["layers_params"]), (img, img[None])
    if family == "temporal":
        return models.TemporalNlmDenoiser(PARAMS["nlm_params"]), (img, img[None].repeat(2, 1, 1, 1))
    if family == "nlm":
        return models.NlmDenoiser(PARAMS["nlm_params"]), (img,)
    return models.BilateralDenoiser(PARAMS["bilateral_params"]), (img,)


@pytest.mark.parametrize("family", ["bilateral", "layers", "nlm", "temporal"])
def test_forward_is_one_span_a_call(family):
    model, args = _inputs(family)
    want = model(*args)
    with _profiler():
        got = model(*args)
        model(*args)
    assert timing.totals[timing.FORWARD][1] == 2 and timing.totals[timing.FORWARD][0] > 0
    kept = copy.deepcopy(timing.totals)
    model(*args)
    assert timing.totals == kept and torch.equal(got, want)


def test_nested_spans_leave_the_outer_span_of_their_layer():
    """An upload inside exec is taken out of exec's total as out of the
    report's exec_ns; the model's forward inside exec, a layer below, is
    not."""
    report = TimingReport()
    with _profiler():
        with report.execute():
            with report.transfer(timing.UPLOAD):
                time.sleep(0.002)
            with timing.span(timing.FORWARD):
                time.sleep(0.002)
    t = timing.totals
    assert t[timing.UPLOAD][0] == report.transfer_ns
    assert t[timing.EXEC][0] == report.exec_ns >= t[timing.FORWARD][0] >= 2_000_000


def _cli_spans_inside_their_configs(shot, tmp_path, keys, waits):
    """gpu-denoise --profile over `keys` on the CPU: each idf.session.* span
    but the Session's construction (before the first config) lies inside the
    span of its config, and chip_smoke's phase 8 reads the device's idle ms
    under each (all of a span's ms here, where no device event runs). The
    configs in `waits` wait on the prefetcher (no pin, on the CPU). Returns
    the configs' spans and the program's."""
    prof = tmp_path / "prof"
    assert cli.main([shot, "--device", "cpu", "--output-dir", str(tmp_path / "out"),
                     "--configs", ",".join(keys), "--radius", "2", "--search-radius", "2",
                     "--patch-radius", "1", "--profile", str(prof)]) == 0
    path = str(prof / cli.TRACE_NAME)
    configs, device = smoke.read_trace(path, keys)
    ours = smoke.program_spans(path)
    assert sorted(configs) == sorted(keys) and device == []
    first = min(start for start, _ in configs.values())
    for name, start, end in ours:
        inside = [k for k, (a, b) in configs.items() if a <= start and end <= b]
        assert (inside == []) == (name == timing.OPEN), (name, inside)
        if name == timing.OPEN:
            assert end <= first
    for key, (a, b) in configs.items():
        idle, busy, under = smoke.idle_under_spans(ours, device, a, b)
        assert busy == under == 0.0
        names = {timing.LOAD, timing.EXEC, timing.SAVE}
        if key != "cpu1":
            names |= {timing.UPLOAD, timing.WARMUP, timing.READBACK}
        if key == "bilateral":
            names.add(timing.FORWARD)  # the model's forward, under warmup and exec
        if key in waits:
            names.add(timing.PREFETCH_WAIT)  # the prefetcher's waits, under load
        assert set(idle) == names
        assert all(ms == pytest.approx(span_ms) for span_ms, ms in idle.values())
    return configs, ours


def test_profile_cli_overlap_alone_waits_inside_its_config_span(shot, tmp_path):
    """The overlap config alone: the target's load cached the target, so the
    window's other frame misses, and its decode's wait lies inside the
    config's span, all idle."""
    _cli_spans_inside_their_configs(shot, tmp_path, ("overlap",), waits={"overlap"})


def test_profile_cli_spans_lie_inside_their_config_span(shot, tmp_path):
    """The battery's configs through gpu-denoise --profile, and a kernel put
    under a span: phase 8 reads less idle there by the kernel's ms. The
    overlap config waits on no decode: the multiframe config before it put
    every window frame in the run's shared cache."""
    configs, ours = _cli_spans_inside_their_configs(
        shot, tmp_path, ("bilateral", "multiframe", "overlap", "cpu1"), waits=set())
    (_, e0, e1), = [s for s in ours if s[0] == timing.EXEC and configs["bilateral"][0] <= s[1]
                    < configs["bilateral"][1]]
    kernel = [{"cat": "kernel", "name": "void k()", "ts": e0, "dur": (e1 - e0) / 2}]
    idle, busy, under = smoke.idle_under_spans(ours, kernel, *configs["bilateral"])
    assert busy == pytest.approx((e1 - e0) / 2e3) and under == pytest.approx(busy)
    span_ms, idle_ms = idle[timing.EXEC]
    assert idle_ms == pytest.approx(span_ms - (e1 - e0) / 2e3)


# The benchmark's readers of the program's totals: (metric, totals, frames,
# the feed's host ns, the value). The files feed counts two frames here.
HOST_NS = 900_000_000
READER_CASES = [
    *[(f"session_{p}_ms", {f"idf.session.{p}": [3_000_000, 5]}, 2, None, 1.5)
      for p in ("open", "load", "upload", "warmup", "readback", "save")],
    ("session_unspanned_ms", {"idf.session.open": [1_000_000, 2], "idf.session.save": [
        800_000_000, 2], "idf.model.forward": [50_000_000, 4], "frame_cache.hit": [0, 9]},
     2, HOST_NS, 49.5),
    ("frame_cache_hit_pct", {"frame_cache.hit": [0, 30], "frame_cache.miss": [0, 5]}, 2,
     None, 100.0 * 30 / 35),
    ("forward_host_ms", {"idf.model.forward": [3_000_000, 4], "idf.session.exec": [1, 1]}, 2,
     None, 0.75),
    ("layer_load_ms", {"idf.layers.load": [9_000_000, 2], "idf.session.load": [1, 8]}, 2,
     None, 4.5),
    ("layer_upload_ms", {"idf.layers.upload": [5_000_000, 2], "idf.session.upload": [1, 4]}, 2,
     None, 2.5),
    ("layers_per_target", {"layers.loaded": [0, 6], "frame_cache.miss": [0, 8]}, 2, None, 3.0),
]


def _reading(frames, host_ns):
    session = None if host_ns is None else {"host_ns": host_ns, "transfer_ns": 0, "exec_ns": 0}
    return harness.Reading(family="temporal_nlm", frames=frames, window=(0.0, 1.0), steps=[],
                           trace=None, step_work=(0, 0), session=session)


@pytest.mark.parametrize("name,totals,frames,host_ns,want", READER_CASES,
                         ids=[c[0] for c in READER_CASES])
def test_reader_of_the_program_totals(monkeypatch, name, totals, frames, host_ns, want):
    monkeypatch.setattr(timing, "totals", totals)
    got = harness.metric(harness.ROOT, name).read(_reading(frames, host_ns))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", [c[0] for c in READER_CASES])
def test_reader_finds_nothing_where_its_span_never_ran(monkeypatch, name):
    """None where the totals hold none of its spans or counters, and where
    the program keeps no totals (a program without spans)."""
    reader = harness.metric(harness.ROOT, name)
    monkeypatch.setattr(timing, "totals", {"idf.other.span": [7, 1], "other.count": [0, 4]})
    assert reader.read(_reading(2, HOST_NS)) is None
    monkeypatch.delattr(timing, "totals")
    assert reader.read(_reading(2, HOST_NS)) is None
