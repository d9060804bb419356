"""The layers configuration's cell from disk, `xbf-1080p-files`: found by name
with its metrics, its step's work by hand, its traced run's layer count, and
a comparison that fails where the run is wrong: the control (bf16 taps), a
target given two of its three layers, a target returned unchanged, and one
output value off by one 8-bit step. The runs take the port's plain versions
on the CPU at a tiny size (conftest.py)."""

import dataclasses
import math
import tempfile

import pytest

from image_denoising_filter_tpu_torch.models import denoiser
from image_denoising_filter_tpu_torch.runtime import session as session_mod
from portbench import harness, work
from portbench.tests.conftest import run_tiny

CELL = "xbf-1080p-files"
METRICS = {"layer_load_ms", "layer_upload_ms", "layers_per_target", "roofline_pct.xbf.files"}


def test_the_cell_resolves_with_its_metrics():
    cell = harness.find_cell(harness.ROOT, CELL)
    assert cell.chips == 1 and cell.config["family"] == "layer_guided_files"
    assert cell.traffic["feed"] == "files_layers"
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s.files", "peak_work_mib",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert all(m["moves"] == "frames_per_s.files" for m in cell.per_layer)


def test_layer_guided_files_step_bound_by_hand():
    cell = harness.find_cell(harness.ROOT, CELL)
    px = 1920 * 1080
    r2 = 2 * 2.0**2 * math.log(1e8)
    disk = sum(1 for dy in range(-20, 21) for dx in range(-20, 21) if dy * dy + dx * dx <= r2)
    assert disk == 465
    nbytes, ops = harness.family(harness.ROOT, cell).step_work(cell.config)
    assert nbytes == 16 * 5 * px                    # target and 3 layers in, output out
    assert ops == 3 * 20 * 465 * px + 2 * 5 * px + 5 * px
    ms, by = work.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(0.8639, abs=1e-4)


def test_a_traced_run_counts_three_layers_a_target():
    """On the CPU: three layers a target, and the layers' load and upload;
    no kernel there, so the roofline reads nothing."""
    result = run_tiny(CELL, trace=True)
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["layers_per_target"]["value"] == 3.0
    assert metrics["layer_load_ms"]["value"] > 0 and metrics["layer_upload_ms"]["value"] > 0
    assert "roofline_pct.xbf.files" not in metrics


def test_the_program_is_correct():
    result = run_tiny(CELL)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"frames_per_s.files", "setup_s"}  # no card memory here


def test_the_program_is_correct_under_a_tmpdir_with_a_dot_and_a_frame_id(monkeypatch, tmp_path):
    """TMPDIR's name never reaches the layer scan: the feed runs the
    Sessions from the shots' root."""
    tmp = tmp_path / "tmp.AbC0001"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    assert run_tiny(CELL)["correct"] is True


def _two_layers(monkeypatch):
    """The Session's layers run given the first two of the target's three
    layers (after set-up, whose scan check holds)."""
    run_layers = session_mod.Session._run_layers

    def two(self, target_dev, ds, *args):
        return run_layers(self, target_dev, dataclasses.replace(ds, layers=ds.layers[:2]), *args)

    monkeypatch.setattr(session_mod.Session, "_run_layers", two)


def _unchanged(monkeypatch):
    monkeypatch.setattr(denoiser.LayerGuidedDenoiser, "forward",
                        lambda self, target, layers: target.clone())


def _altered(monkeypatch):
    normalize = denoiser._Normalizing._normalize

    def altered(self, wc, nw):
        out = normalize(self, wc, nw)
        out[0, 0, 0] += 1.0 / 255.0
        return out

    monkeypatch.setattr(denoiser._Normalizing, "_normalize", altered)


FAULTS = {"two_layers": _two_layers, "unchanged": _unchanged, "altered": _altered}


@pytest.mark.parametrize("fault", ["control", *FAULTS])
def test_a_wrong_run_or_the_control_is_not_correct(monkeypatch, fault):
    if fault == "control":
        result = run_tiny(CELL, variant="control")
    else:
        FAULTS[fault](monkeypatch)
        result = run_tiny(CELL)
    assert result["correct"] is False
    assert result["checks"]["max_abs_err"]["value"] > result["checks"]["max_abs_err"]["limit"]
