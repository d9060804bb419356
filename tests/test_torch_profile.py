"""`gpu-denoise --profile DIR` on the CPU: one Chrome trace of the battery in
DIR, a span named after each config, outputs equal to the run without the
profiler, and an error (exit code 1), never a quiet run, where no trace can
be written. tests/test_torch_cuda.py counts the card's kernel events."""

import json
import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch import cli
from image_denoising_filter_tpu_torch.utils import imageio

torch.set_num_threads(1)

ARGV = ["--device", "cpu", "--radius", "2", "--search-radius", "2", "--patch-radius", "1"]
CONFIGS = ("linear", "nlm")


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    root = tmp_path_factory.mktemp("anim")
    img = np.random.default_rng(0).uniform(0, 1, (20, 28, 4)).astype(np.float32)
    imageio.save(str(root / "frame_0000.png"), img)
    return str(root / "frame_0000.png")


def _spans(trace_path, program=False):
    """The config spans of the trace, in order; with program, the program's
    own spans (idf.*, utils/timing.py) instead."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("idf.") == program]


def _run(target, out_dir, *extra):
    return cli.main([target, *ARGV, "--output-dir", out_dir, "--configs", ",".join(CONFIGS),
                     *extra])


def test_profile_writes_one_span_per_config(target, tmp_path, capsys):
    prof = str(tmp_path / "prof")
    assert _run(target, str(tmp_path / "out"), "--profile", prof) == 0
    assert f"profile trace written to {prof}" in capsys.readouterr().out
    assert os.listdir(prof) == [cli.TRACE_NAME]
    assert sorted(_spans(os.path.join(prof, cli.TRACE_NAME))) == sorted(CONFIGS)


def test_profile_spans_the_cpu_configs(target, tmp_path):
    prof = str(tmp_path / "prof")
    rc = cli.main([target, "--device", "cpu", "--output-dir", str(tmp_path / "out"),
                   "--configs", "cpu1,cpu8", "--profile", prof])
    assert rc == 0
    assert _spans(os.path.join(prof, cli.TRACE_NAME)) == ["cpu1", "cpu8"]
    assert set(_spans(os.path.join(prof, cli.TRACE_NAME), program=True)) == {
        "idf.session.open", "idf.session.load", "idf.session.exec", "idf.session.save"}


def test_profile_leaves_the_outputs_unchanged(target, tmp_path):
    plain, profiled = str(tmp_path / "plain"), str(tmp_path / "profiled")
    assert _run(target, plain) == 0
    assert _run(target, profiled, "--profile", str(tmp_path / "prof")) == 0
    assert sorted(os.listdir(plain)) == sorted(os.listdir(profiled))
    for name in os.listdir(plain):
        with open(os.path.join(plain, name), "rb") as a, open(os.path.join(profiled, name), "rb") as b:
            assert a.read() == b.read(), name


def test_profile_dir_that_cannot_be_written_is_an_error(target, tmp_path, capsys):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    out = tmp_path / "out"
    assert _run(target, str(out), "--profile", str(blocker / "prof")) == 1
    assert "error:" in capsys.readouterr().err
    assert not os.listdir(out)  # refused before any config ran


def test_profile_that_writes_no_trace_is_an_error(target, tmp_path, capsys, monkeypatch):
    """An exporter that only logs its failure still fails the run."""
    monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace", lambda self, path: None)
    assert _run(target, str(tmp_path / "out"), "--profile", str(tmp_path / "prof")) == 1
    assert "wrote no trace" in capsys.readouterr().err
