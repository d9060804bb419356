"""The harness finds every part of a cell by name, guards against JAX, and
refuses to run without a card."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import guard, harness
from portbench.tests.conftest import CELLS, run_tiny

NEW_METRIC = '''"""Frames in the traced window (a test's metric)."""


def read(r):
    return float(r.frames)
'''


def test_cells_report_the_metrics_listed_for_them():
    """The files cell reports its throughput and its layers under names of
    their own (a bound of their own: its host path spreads more)."""
    for name in CELLS:
        cell = harness.find_cell(harness.ROOT, name)
        e2e = {m["name"] for m in cell.end_to_end}
        layers = {m["name"] for m in cell.per_layer}
        suffix = ".files" if name.endswith("-files") else ""
        assert {"frames_per_s" + suffix, "peak_work_mib", "setup_s"} <= e2e
        assert ("frame_ms_p95" in e2e) == (not suffix)
        assert {"kernels_per_frame" + suffix, "device_idle_pct" + suffix} <= layers
        assert ("session_host_ms" in layers) == bool(suffix)
        assert all(m["moves"] in e2e for m in cell.per_layer)


def test_a_new_config_traffic_and_metric_need_only_new_files(tmp_path):
    """A cell of a new configuration under a new traffic mix, with a new
    per-layer metric, added as new files and new BENCHMARK.json entries:
    the harness runs it, and its result carries the new metric."""
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((harness.ROOT / "portbench/configs/temporal_nlm_1080p.json").read_text())
    cfg.update(height=16, width=20, shot_frames=3)
    (tmp_path / "portbench/configs/temporal_nlm_tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/device_one_shot.json").write_text(
        json.dumps({"feed": "device_stream", "pool_shots": 1}))
    (tmp_path / "portbench/metrics/frames_in_window.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "temporal_nlm_tiny", "source": "test",
                             "file": "portbench/configs/temporal_nlm_tiny.json",
                             "reduced": ["height", "width"], "why": "test"})
    bench["workloads"].append({"name": "tnlm-tiny", "config": "temporal_nlm_tiny",
                               "traffic": "device_one_shot", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_in_window", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "frames_per_s", "workloads": ["tnlm-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    result = run_tiny("tnlm-tiny", trace=True, root=tmp_path,
                      cell=harness.find_cell(tmp_path, "tnlm-tiny"))
    assert result["correct"] is True
    assert result["metrics"]["frames_in_window"]["value"] == result["attempted"]
    run_py = (harness.ROOT / "portbench/run.py").read_text()
    harness_py = (harness.ROOT / "portbench/harness.py").read_text()
    for entry in bench["workloads"] + bench["configs"] + bench["per_layer"]:
        assert entry["name"] not in run_py and entry["name"] not in harness_py


@pytest.mark.parametrize("names, found", [
    (["image_denoising_filter_tpu_torch", "image_denoising_filter_tpu_torch.ops.stencils"], []),
    (["image_denoising_filter_tpu.ops"], ["image_denoising_filter_tpu"]),
    (["image_denoising_filter_tpu"], ["image_denoising_filter_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen", "jaxtyping", "jax_extra"], ["flax", "jax", "jaxlib"]),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def test_a_run_that_loads_the_jax_package_is_refused(monkeypatch):
    monkeypatch.setitem(sys.modules, "image_denoising_filter_tpu", object())
    with pytest.raises(harness.ForbiddenImport, match="image_denoising_filter_tpu"):
        run_tiny("tnlm-1080p-device")


def test_a_run_leaves_no_jax_behind():
    run_tiny("tnlm-1080p-files")
    assert guard.forbidden_modules() == []


def test_without_a_card_the_command_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "tnlm-1080p-device", "--seed",
         "4294967301", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr
