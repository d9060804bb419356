"""The benchmark's metric arithmetic: the tail over all frames, the busy
union, the step bounds by hand, the trace's breakdown and the readers."""

import json
import math

import pytest

from portbench import harness, trace, work
from portbench.tests.conftest import CELLS, run_tiny


@pytest.mark.parametrize("n, want", [(1, 1), (19, 19), (20, 19), (21, 20), (100, 95), (101, 96)])
def test_p95_is_the_nearest_rank_over_every_frame(n, want):
    values = list(range(n, 0, -1))  # n .. 1, out of order on purpose
    assert harness.p95(values) == want


@pytest.mark.parametrize("intervals, ms", [
    ([], 0.0),
    ([(0, 1000)], 1.0),
    ([(0, 1000), (500, 1500)], 1.5),          # overlap counted once
    ([(2000, 3000), (0, 1000)], 2.0),        # out of order
    ([(0, 3000), (1000, 2000)], 3.0),        # nested
    ([(0, 1000), (1000, 2000)], 2.0),        # touching
])
def test_busy_is_the_union_of_the_intervals(intervals, ms):
    assert trace.busy_ms(intervals) == pytest.approx(ms)


def _trace(events, spans=()):
    return {"traceEvents": [
        *({"cat": "user_annotation", "name": n, "ts": s, "dur": d} for n, s, d in spans),
        *events]}


def _kernel(name, ts, dur, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.fixture
def traced(tmp_path):
    """A window [0, 100) with two steps [10, 40) and [50, 95); kernels at
    [12, 30) and [52, 70), a copy at [70, 80), a kernel outside the window,
    and a host operator over [30, 50)."""
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(_trace(
        [_kernel("nlm_kernel", 12, 18), _kernel("nlm_kernel", 52, 18),
         _kernel("Memcpy HtoD", 70, 10, cat="gpu_memcpy"), _kernel("late", 120, 5),
         {"cat": "cpu_op", "name": "aten::empty", "ts": 30, "dur": 20}],
        [(harness.WINDOW_SPAN, 0, 100), (harness.STEP_SPAN, 10, 30),
         (harness.STEP_SPAN, 50, 45)])))
    return trace.read_trace(str(path), (harness.WINDOW_SPAN, harness.STEP_SPAN))


def _reading(tr, family="temporal_nlm", frames=2, session=None, work_=(0, 67e9)):
    return harness.Reading(family=family, frames=frames,
                           window=tr.spans[harness.WINDOW_SPAN][0],
                           steps=tr.spans.get(harness.STEP_SPAN, []), trace=tr,
                           step_work=work_, session=session)


def test_trace_keeps_every_span_of_a_name(traced):
    assert traced.spans[harness.STEP_SPAN] == [(10, 40), (50, 95)]
    assert traced.device_in(0, 100) == [(12, 30), (52, 70), (70, 80)]
    assert traced.device_in(20, 60, cats=("kernel",)) == [(20, 30), (52, 60)]


def test_readers_on_a_known_trace(traced):
    r = _reading(traced)
    assert harness.metric(harness.ROOT, "kernels_per_frame").read(r) == 1.0
    assert harness.metric(harness.ROOT, "device_idle_pct").read(r) == pytest.approx(54.0)
    # 67 G operations a step bound by operations: 1 ms a step, over 36 us
    assert harness.metric(harness.ROOT, "roofline_pct.tnlm").read(r) == pytest.approx(
        100 * 2 * 1e3 / 36)
    assert harness.metric(harness.ROOT, "roofline_pct.xbf").read(r) is None
    assert harness.metric(harness.ROOT, "session_host_ms").read(r) is None
    for name in ("kernels_per_frame", "device_idle_pct", "roofline_pct.tnlm"):
        assert (harness.metric(harness.ROOT, name + ".files").read(r)
                == harness.metric(harness.ROOT, name).read(r))


def test_session_readers_divide_by_the_frames(traced):
    r = _reading(traced, session={"host_ns": 10_000_000, "transfer_ns": 3_000_000,
                                  "exec_ns": 1_000_000})
    assert harness.metric(harness.ROOT, "session_host_ms").read(r) == pytest.approx(3.0)
    assert harness.metric(harness.ROOT, "session_transfer_ms").read(r) == pytest.approx(1.5)


def test_readers_find_nothing_in_an_empty_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_trace([], [(harness.WINDOW_SPAN, 0, 100)])))
    tr = trace.read_trace(str(path), (harness.WINDOW_SPAN, harness.STEP_SPAN))
    r = _reading(tr)
    for name in ("kernels_per_frame", "device_idle_pct", "roofline_pct.tnlm"):
        assert harness.metric(harness.ROOT, name).read(r) is None


def test_breakdown_names_the_host_in_each_gap(traced):
    out = trace.breakdown(traced, (0, 100), {harness.STEP_SPAN: [(10, 40), (50, 95)]})
    assert out["device_ops"] == [["nlm_kernel", pytest.approx(36e-6)],
                                 ["Memcpy HtoD", pytest.approx(10e-6)]]
    assert out["idle_gaps"] == [["harness/aten::empty", pytest.approx(22e-6)],     # [30, 52)
                                [f"{harness.STEP_SPAN}/python", pytest.approx(20e-6)],  # [80, 100)
                                ["harness/python", pytest.approx(12e-6)]]          # [0, 12)


def _cfg(name):
    return json.loads((harness.ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_temporal_nlm_step_bound_by_hand():
    fam = harness.load_module(harness.ROOT / "portbench/families/temporal_nlm.py", "f_tnlm")
    px = 1920 * 1080
    nbytes, ops = fam.step_work(_cfg("temporal_nlm_1080p"))
    assert nbytes == 16 * 6 * px + 16 * px          # six frames in, one frame out
    assert ops == 24 * 6 * 196 * px + 5 * px        # 196 offsets, six frames, normalize
    ms, by = work.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(ops / 67e12 * 1e3)
    assert ms == pytest.approx(0.8737, abs=1e-4)


def test_layer_guided_step_bound_by_hand():
    fam = harness.load_module(harness.ROOT / "portbench/families/layer_guided.py", "f_xbf")
    px = 3840 * 2160
    r2 = 2 * 2.0**2 * math.log(1e8)
    disk = sum(1 for dy in range(-20, 21) for dx in range(-20, 21) if dy * dy + dx * dx <= r2)
    assert disk == 465
    nbytes, ops = fam.step_work(_cfg("layer_guided_4k"))
    assert nbytes == 16 * 5 * px                    # target and 3 layers in, output out
    assert ops == 3 * 20 * 465 * px + 2 * 5 * px + 5 * px
    ms, by = work.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(3.4558, abs=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_a_run_reports_its_cells_metrics(name):
    result = run_tiny(name)
    cell = harness.find_cell(harness.ROOT, name)
    assert result["correct"] is True
    want = {m["name"] for m in cell.end_to_end} - {"peak_work_mib"}  # no card memory here
    assert set(result["metrics"]) == want
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
