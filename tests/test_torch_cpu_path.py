"""The CPU bilateral configs (cpu1, cpu8) of the port: `Session.run_cpu` and
`gpu-denoise --configs cpu1,cpu8`, against the JAX package's `Session.run_cpu`
and `tpu-denoise` on the same files.

Both packages filter with the native OpenMP oracle where
native/libidf_native.so is built, else with the same NumPy oracle
(ops/reference.py:cpu_bilateral_reference), and save with the same codecs:
the files are byte for byte alike.
"""

import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import cli as jcli
from image_denoising_filter_tpu.runtime import Session as JaxSession
from image_denoising_filter_tpu_torch import cli
from image_denoising_filter_tpu_torch.config import CpuBilateralParams
from image_denoising_filter_tpu_torch.ops import stencils
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import imageio

torch.set_num_threads(1)

R = CpuBilateralParams().radius


def _frame(seed, h=32, w=40):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([0.5 + 0.4 * np.sin(xx / 5.0), 0.5 + 0.4 * np.cos(yy / 4.0),
                     np.where(xx > w / 2, 0.8, 0.2), np.ones((h, w))], -1)
    return np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1).astype(np.float32)


def _write_frames(root, n=1, ext="png", scale=1.0):
    """n frames frame_0000.. under root; returns the path of frame 0000."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        imageio.save(os.path.join(root, f"frame_{i:04d}.{ext}"), _frame(i) * scale)
    return os.path.join(root, f"frame_0000.{ext}")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_cpu_output(path, h=32, w=40):
    """The CPU path's frame: zero outside rows and columns [R, dim - R]
    (src/main.cpp:1823-1828), alpha 1 inside."""
    out, _ = imageio.load(path)
    assert out.shape == (h, w, 4)
    inside = np.zeros((h, w), bool)
    inside[R : h - R + 1, R : w - R + 1] = True
    assert np.all(out[~inside] == 0.0)
    assert np.all(out[inside][:, 3] == 1.0)
    assert np.all(out[inside][:, :3] > 0.0)


@pytest.mark.parametrize("threads", [1, 8])
def test_session_run_cpu_writes_a_zero_border(tmp_path, threads):
    target = _write_frames(str(tmp_path / "anim"))
    path, secs = Session(target, device="cpu", output_dir=str(tmp_path)).run_cpu(threads)
    assert path == os.path.join(str(tmp_path), "output-cpu.png")
    assert secs > 0.0
    _assert_cpu_output(path)


def test_session_run_cpu_exr_target(tmp_path):
    target = _write_frames(str(tmp_path / "anim"), ext="exr", scale=3.0)
    path, _ = Session(target, device="cpu", output_dir=str(tmp_path)).run_cpu(1)
    assert path.endswith("output-cpu.exr")
    out, hdr = imageio.load(path)
    assert hdr and out.shape == (32, 40, 4)
    assert np.all(out[:R] == 0.0) and np.all(out[:, :R] == 0.0)
    assert out[..., :3].max() > 1.0  # HDR values kept, not quantized


@pytest.mark.parametrize("ext", ["png", "exr"])
def test_session_run_cpu_equals_jax_session_bytes(tmp_path, ext):
    target = _write_frames(str(tmp_path / "anim"), ext=ext)
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got, _ = Session(target, device="cpu", output_dir=str(tmp_path / "port")).run_cpu(1)
    want, _ = JaxSession(target, output_dir=str(tmp_path / "jax")).run_cpu(1)
    assert os.path.basename(got) == os.path.basename(want) == f"output-cpu.{ext}"
    assert _read(got) == _read(want)


def test_session_run_cpu_touches_no_device(tmp_path, monkeypatch):
    """The CPU configs run the host oracle alone: no upload and no kernel
    wrapper, whatever the session's device."""
    target = _write_frames(str(tmp_path / "anim"))
    session = Session(target, device="cpu", output_dir=str(tmp_path))

    def refuse(*args, **kwargs):
        raise AssertionError("run_cpu took the device path")

    monkeypatch.setattr(Session, "_upload", refuse)
    monkeypatch.setattr(stencils, "bilateral", refuse)
    _assert_cpu_output(session.run_cpu(1)[0])


@pytest.mark.parametrize("configs", ["linear,cpu1", "cpu8", "cpu1,cpu8"])
def test_cli_cpu_configs_match_tpu_denoise(tmp_path, capsys, configs):
    """gpu-denoise writes the files tpu-denoise writes (tests/test_cli.py:
    13-28), the CPU one byte for byte, with one `Time taken:` a CPU config."""
    target = _write_frames(str(tmp_path / "anim"))
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    assert jcli.main([target, "--output-dir", want, "--configs", configs]) == 0
    capsys.readouterr()
    assert cli.main([target, "--device", "cpu", "--output-dir", got, "--configs", configs]) == 0
    out = capsys.readouterr().out
    n_cpu = sum(k.startswith("cpu") for k in configs.split(","))
    assert out.count("Time taken:") == n_cpu
    assert out.count("bilateral filter on cpu") == n_cpu
    assert ("execution time:" in out) == ("linear" in configs)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert _read(os.path.join(got, "output-cpu.png")) == _read(os.path.join(want, "output-cpu.png"))
    _assert_cpu_output(os.path.join(got, "output-cpu.png"))


def test_cli_cpu_banners_name_the_threads(tmp_path, capsys):
    target = _write_frames(str(tmp_path / "anim"))
    assert cli.main([target, "--device", "cpu", "--output-dir", str(tmp_path / "o"),
                     "--configs", "cpu8,cpu1"]) == 0
    out = capsys.readouterr().out
    # cpu1 runs before cpu8 whatever the order asked for, as in tpu-denoise
    assert out.index("bilateral filter on cpu (1 thread) ") < out.index(
        "bilateral filter on cpu (8 threads)")


def test_cli_all_frames_cpu_config(tmp_path):
    target = _write_frames(str(tmp_path / "anim"), n=3)
    out = str(tmp_path / "serve")
    rc = cli.main([target, "--device", "cpu", "--output-dir", out, "--all-frames",
                   "--configs", "cpu1"])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["frame_0000", "frame_0001", "frame_0002"]
    for stem in os.listdir(out):
        assert os.listdir(os.path.join(out, stem)) == ["output-cpu.png"]
        _assert_cpu_output(os.path.join(out, stem, "output-cpu.png"))


@pytest.mark.parametrize("configs", ["cpu1", "cpu8", "bilateral,cpu8"])
def test_cli_cpu_configs_under_device_cuda_need_the_card(tmp_path, capsys, configs):
    """The CLI opens the device before any config runs: --device cuda
    without a card is an error for the CPU configs too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    target = _write_frames(str(tmp_path / "anim"))
    out = str(tmp_path / "out")
    rc = cli.main([target, "--device", "cuda", "--output-dir", out, "--configs", configs])
    assert rc == 1
    assert "error:" in capsys.readouterr().err
    assert not os.listdir(out)
