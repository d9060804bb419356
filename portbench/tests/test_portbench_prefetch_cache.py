"""The overlap cell's `prefetch_cache_hit_pct`: its reader over the
prefetcher's counters, and a traced run of the cell on the CPU at a tiny
size (conftest.py) that reports it."""

import pytest

from image_denoising_filter_tpu_torch.utils import timing
from portbench import harness
from portbench.tests.conftest import run_tiny

CELL = "tnlm-1080p-overlap-files"


def test_the_metric_is_the_overlap_cells():
    cell = harness.find_cell(harness.ROOT, CELL)
    metric, = [m for m in cell.per_layer if m["name"] == "prefetch_cache_hit_pct"]
    assert metric["moves"] == "frames_per_s.files" and metric["unit"] == "%"


@pytest.mark.parametrize("totals, want", [
    ({"prefetch.cache_hit": [0, 83], "prefetch.cache_miss": [0, 7]}, 100 * 83 / 90),
    ({"prefetch.cache_hit": [0, 9]}, 100.0),
    ({"prefetch.cache_miss": [0, 9], "frame_cache.hit": [0, 7]}, 0.0),
    ({"prefetch.frames": [0, 9], "frame_cache.hit": [0, 7], "frame_cache.miss": [0, 3]}, None),
    ({}, None),
], ids=["shot", "all_hits", "all_misses", "no_counters", "nothing"])
def test_the_cache_hit_reader(monkeypatch, totals, want):
    """The prefetcher's hits over its lookups in %; None where the
    prefetcher counted none (the Session's own cache counters are not its)."""
    reader = harness.metric(harness.ROOT, "prefetch_cache_hit_pct")
    monkeypatch.setattr(timing, "totals", totals)
    got = reader.read(None)
    assert got == (None if want is None else pytest.approx(want))


def test_a_traced_run_reports_the_hit_share():
    """At least the first target's two of nine (the window's first frame,
    twice, which the target's own load cached), and nine frames a target."""
    result = run_tiny(CELL, trace=True)
    assert result["correct"] is True
    metrics = result["metrics"]
    assert 100 * 2 / 9 <= metrics["prefetch_cache_hit_pct"]["value"] <= 100
    assert metrics["prefetch_frames_per_target"]["value"] == 9.0
