"""The overlap configuration's cell, `tnlm-1080p-overlap-files`: found by
name with its metrics, its family's window against the plain reference's
rule, its step's work by hand, and a comparison that fails where the
window is wrong. The runs take the port's plain versions on the CPU at a
tiny size (conftest.py)."""

import dataclasses

import pytest
import torch

from image_denoising_filter_tpu_torch.runtime import session as session_mod
from portbench import harness, work
from portbench.reference import temporal_nlm_overlap as reference
from portbench.tests.conftest import run_tiny

CELL = "tnlm-1080p-overlap-files"
METRICS = {"prefetch_wait_ms", "prefetch_pin_ms", "prefetch_frames_per_target",
           "roofline_pct.tnlm.overlap"}


def _family():
    return harness.family(harness.ROOT, harness.find_cell(harness.ROOT, CELL))


def test_the_cell_resolves_with_its_metrics():
    cell = harness.find_cell(harness.ROOT, CELL)
    assert cell.chips == 1 and cell.config["family"] == "temporal_nlm_overlap"
    assert cell.traffic["feed"] == "files_all_frames"
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s.files", "peak_work_mib",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert all(m["moves"] == "frames_per_s.files" for m in cell.per_layer)


@pytest.mark.parametrize("k", [0, 3, 8, 9])
def test_the_familys_window_is_the_references(k):
    """window_item's frames are the reference's window, and the family's
    reference of the item is the reference's output for target k."""
    cell = harness.find_cell(harness.ROOT, CELL)
    cfg = dict(cell.config, height=9, width=11)
    shot = torch.rand((cfg["shot_frames"], 9, 11, 4), generator=torch.Generator().manual_seed(k))
    fam = _family()
    item = fam.window_item(shot, k)
    assert torch.equal(item["target"], shot[k])
    assert torch.equal(item["frames"], shot[reference.window(k, cfg["shot_frames"])])
    assert len(item["frames"]) == 9
    want = reference.temporal_nlm_overlap(shot, k, cfg["params"])
    assert torch.equal(fam.reference(cfg, item), want)
    # the program's device entry on the same window is the reference's
    got = fam.entry(cfg, "program")(item)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_a_config_off_the_upstreams_frame_cap_is_refused():
    cfg = dict(harness.find_cell(harness.ROOT, CELL).config, max_frames=8)
    with pytest.raises(ValueError, match="framesToUse"):
        _family().session(cfg, "program")


def test_overlap_step_bound_by_hand():
    cfg = harness.find_cell(harness.ROOT, CELL).config
    px = 1920 * 1080
    nbytes, ops = _family().step_work(cfg)
    assert nbytes == 16 * 9 * px + 16 * px          # nine frames in, one frame out
    assert ops == 24 * 9 * 196 * px + 5 * px        # 196 offsets, nine frames, normalize
    ms, by = work.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(1.3104, abs=1e-4)


def test_a_traced_run_reports_the_prefetchers_metrics():
    """On the CPU: nine frames a target and the waits; no pinned staging and
    no kernel there, so those two read nothing."""
    result = run_tiny(CELL, trace=True)
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["prefetch_frames_per_target"]["value"] == 9.0
    assert metrics["prefetch_wait_ms"]["value"] > 0
    assert "prefetch_pin_ms" not in metrics and "roofline_pct.tnlm.overlap" not in metrics


def _window(monkeypatch, frames_of):
    """Session's dataset discovery, with its frame list replaced by
    frames_of(the uncapped list: the target, then the whole shot)."""
    discover = session_mod.dataset_mod.discover

    def wrong(*args, **kwargs):
        ds = discover(*args, **dict(kwargs, max_frames=None))
        return dataclasses.replace(ds, frames=tuple(frames_of(ds.frames)))

    monkeypatch.setattr(session_mod.dataset_mod, "discover", wrong)


WRONG_WINDOWS = {
    "eight_frames": lambda frames: frames[:9],
    "ten_frames": lambda frames: frames[:11],
    "no_duplicate_target": lambda frames: frames[1:11],
}


@pytest.mark.parametrize("fault", ["control", *WRONG_WINDOWS])
def test_a_wrong_window_or_the_control_is_not_correct(monkeypatch, fault):
    """The control (bf16 taps), and a window of 8 or 10 frames or one
    without the duplicate target, each fail the configuration's limits."""
    if fault == "control":
        result = run_tiny(CELL, variant="control")
    else:
        _window(monkeypatch, WRONG_WINDOWS[fault])
        result = run_tiny(CELL)
    assert result["correct"] is False
    assert result["checks"]["max_abs_err"]["value"] > result["checks"]["max_abs_err"]["limit"]

