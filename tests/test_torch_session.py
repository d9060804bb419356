"""The port's Session, prefetcher and CLI end to end on the CPU, against the
JAX package's Session on the same tiny animation directory.

The port runs with device="cpu", so every kernel wrapper takes its plain
PyTorch version; the JAX side runs its Pallas kernels in interpret mode.
With tiling=bf16 the port's bilateral colour distance is given XLA's CPU
rounding of the JAX kernel's (tests/test_torch_stencils.py), under which the
two Sessions agree at the exact tolerance.
"""

import os
import time

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import (
    GPU_BATTERY,
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    RunConfig,
    TilingConfig,
)
from image_denoising_filter_tpu.ops import reference as ref
from image_denoising_filter_tpu.runtime import Session as JaxSession
from image_denoising_filter_tpu_torch import cli
from image_denoising_filter_tpu_torch.models import TemporalNlmDenoiser
from image_denoising_filter_tpu_torch.ops import stencils
from image_denoising_filter_tpu_torch.runtime import FramePrefetcher, Session
from image_denoising_filter_tpu_torch.utils import dataset as dataset_mod
from image_denoising_filter_tpu_torch.utils import imageio
from test_torch_config import jax_params
from test_torch_stencils import xla_cpu_bilateral_sq_diff

torch.set_num_threads(1)

BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
PARAMS = dict(bilateral_params=BP, layers_params=LP, nlm_params=NP_)
JAX_PARAMS = {k: jax_params(v) for k, v in PARAMS.items()}
IDS = ["bilateral", "layers", "linear", "nlm", "multiframe", "overlap"]
BF16 = TilingConfig(compute_dtype="bfloat16")
# Each battery config with float32 taps, and the tiled bilateral and layers
# configs with bf16 taps (Session(tiling=...)).
BATTERY_CASES = [(cfg, None) for cfg in GPU_BATTERY] + [(GPU_BATTERY[0], BF16),
                                                        (GPU_BATTERY[1], BF16)]
BATTERY_IDS = IDS + ["bilateral_bf16", "layers_bf16"]


def _frame(seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack(
        [
            0.5 + 0.4 * np.sin(xx / 5.0),
            0.5 + 0.4 * np.cos(yy / 4.0),
            np.where(xx > w / 2, 0.8, 0.2).astype(np.float32),
            np.ones((h, w), np.float32),
        ],
        axis=-1,
    )
    return np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1).astype(np.float32)


def _make_anim(root, n_frames=3, with_layers=True, alpha_noise_frame=None):
    """Frames frame_0000.. plus (optionally) two G-buffer layers of frame
    0001; returns the target path (frame 0001)."""
    root = str(root)
    os.makedirs(root + "/RenderElements", exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n_frames):
        f = _frame(i)
        if i == alpha_noise_frame:
            f[..., 3] = rng.uniform(0, 1, f.shape[:2]).astype(np.float32)
        imageio.save(f"{root}/frame_{i:04d}.png", f)
    if with_layers:
        imageio.save(f"{root}/RenderElements/albedo_0001.png", _frame(50))
        imageio.save(f"{root}/RenderElements/normal_0001.png", _frame(51))
    return f"{root}/frame_{min(1, n_frames - 1):04d}.png"


def _out_dir(tmp_path, name):
    # outputs never go into the frames' directory: discover() would take
    # them for frames
    path = tmp_path / name
    path.mkdir(exist_ok=True)
    return str(path)


@pytest.fixture(scope="module")
def anim(tmp_path_factory):
    return _make_anim(tmp_path_factory.mktemp("anim"))


@pytest.mark.parametrize("cfg,tiling", BATTERY_CASES, ids=BATTERY_IDS)
def test_battery_config_matches_jax_session(anim, tmp_path, cfg, tiling, monkeypatch):
    """Every battery config, and the bilateral and layers configs with bf16
    taps: the port's output equals the JAX Session's and lands under the
    flag-encoded name (src/main.cpp:1677-1682)."""
    if tiling is not None:
        monkeypatch.setattr(stencils, "_bilateral_sq_diff_bf16", xla_cpu_bilateral_sq_diff)
    want = JaxSession(
        anim, output_dir=_out_dir(tmp_path, "jax"), warmup=False, tiling=jax_params(tiling),
        **JAX_PARAMS
    ).run(jax_params(cfg))
    got = Session(anim, device="cpu", output_dir=_out_dir(tmp_path, "port"), tiling=tiling,
                  **PARAMS).run(cfg)
    assert os.path.basename(got.output_path) == cfg.output_name(False)
    out, hdr = imageio.load(got.output_path)
    assert not hdr and out.shape == (24, 32, 4)
    np.testing.assert_allclose(got.image, want.image, rtol=1e-4, atol=1e-5)
    assert got.report.exec_ns > 0 and got.report.transfer_ns > 0


def test_tiling_reaches_the_bilateral_kernels_and_nlm_falls_back_to_it(anim, tmp_path):
    """Session(tiling=bf16) runs the tiled bilateral and layers configs with
    bf16 taps (unlike float32 ones), leaves the linear layout alone, and is
    the NLM's tiling unless nlm_tiling is given, as in the JAX Session."""
    port = Session(anim, device="cpu", output_dir=_out_dir(tmp_path, "t"), tiling=BF16, **PARAMS)
    exact = Session(anim, device="cpu", output_dir=_out_dir(tmp_path, "e"), **PARAMS)
    assert port.tiling is BF16 and port.nlm_tiling is BF16 and exact.nlm_tiling is None
    f32 = TilingConfig()
    assert Session(anim, device="cpu", tiling=BF16, nlm_tiling=f32).nlm_tiling is f32
    for i in (0, 1, 3):  # bilateral, layers, nlm: bf16 taps move the output
        assert not np.array_equal(port.run(GPU_BATTERY[i]).image, exact.run(GPU_BATTERY[i]).image)
    np.testing.assert_array_equal(port.run(GPU_BATTERY[2]).image, exact.run(GPU_BATTERY[2]).image)
    nlm_only = Session(anim, device="cpu", output_dir=_out_dir(tmp_path, "n"), nlm_tiling=BF16,
                       **PARAMS)
    np.testing.assert_array_equal(port.run(GPU_BATTERY[3]).image,
                                  nlm_only.run(GPU_BATTERY[3]).image)


def test_overlap_drops_last_frame(tmp_path):
    """The overlap loop dispatches on the previous frame while copying the
    next (src/main.cpp:1554-1572): the last frame is never filtered."""
    target = _make_anim(tmp_path / "anim", n_frames=4, with_layers=False)
    session = Session(target, device="cpu", nlm_params=NP_, output_dir=_out_dir(tmp_path, "o"))
    b = session.run(RunConfig(nlm=True, multiframe=True, overlap=True))

    ds = dataset_mod.discover(target, multiframe=True)
    timg = torch.from_numpy(imageio.load(target)[0])
    frames = torch.from_numpy(np.stack([imageio.load(p)[0] for p in ds.frames[:-1]]))
    want = TemporalNlmDenoiser(NP_)(timg, frames).numpy()
    np.testing.assert_allclose(b.image, want, rtol=1e-5, atol=1e-6)
    a = session.run(RunConfig(nlm=True, multiframe=True))
    assert not np.allclose(a.image, b.image)  # one fewer norm seed


@pytest.mark.parametrize("alpha_noise_frame", [None, 2], ids=["uniform", "mixed_alpha"])
def test_batch_frames_equals_streamed(tmp_path, alpha_noise_frame):
    """batch_frames (one stacked upload + one frame-batched launch) gives the
    streamed per-frame run's output; a varying-alpha frame forces the full
    kernel for the whole batch."""
    target = _make_anim(
        tmp_path / "anim", n_frames=4, with_layers=False, alpha_noise_frame=alpha_noise_frame
    )
    cfg = RunConfig(nlm=True, multiframe=True)
    streamed = Session(
        target, device="cpu", nlm_params=NP_, output_dir=_out_dir(tmp_path, "a")
    ).run(cfg)
    batched = Session(
        target, device="cpu", nlm_params=NP_, output_dir=_out_dir(tmp_path, "b"),
        batch_frames=True,
    ).run(cfg)
    np.testing.assert_allclose(batched.image, streamed.image, rtol=1e-5, atol=1e-6)


def test_multiframe_mixed_alpha_frames_exact(tmp_path):
    """Per-frame uniform-alpha pick: constant-alpha frames take the fast
    kernel, the varying-alpha frame the full one, and the mix equals the
    all-full-path model and the JAX Session."""
    target = _make_anim(tmp_path / "anim", n_frames=3, with_layers=False, alpha_noise_frame=2)
    cfg = RunConfig(nlm=True, multiframe=True)
    got = Session(target, device="cpu", nlm_params=NP_, output_dir=_out_dir(tmp_path, "p")).run(cfg)
    ds = dataset_mod.discover(target, multiframe=True, max_frames=None)
    timg = torch.from_numpy(imageio.load(target)[0])
    stack = torch.from_numpy(np.stack([imageio.load(p)[0] for p in ds.frames]))
    want = TemporalNlmDenoiser(NP_)(timg, stack).numpy()
    np.testing.assert_allclose(got.image, want, rtol=1e-5, atol=1e-6)
    jax_out = JaxSession(
        target, nlm_params=jax_params(NP_), output_dir=_out_dir(tmp_path, "j"), warmup=False
    ).run(jax_params(cfg))
    np.testing.assert_allclose(got.image, jax_out.image, rtol=1e-4, atol=1e-5)


def test_uniform_alpha_not_applied_with_zero_border(tmp_path):
    """ZERO border injects alpha-0 taps, so the uniform-alpha shortcut would
    corrupt border alpha: Session must not switch it on."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (24, 32, 4)).astype(np.float32)
    img[..., 3] = 1.0
    target = str(tmp_path / "z_0000.png")
    imageio.save(target, img)
    img_q = imageio.to_float(imageio.quantize(img))
    p = BilateralParams(radius=3, border=BorderPolicy.ZERO)
    r = Session(target, device="cpu", bilateral_params=p, output_dir=str(tmp_path)).run(RunConfig())
    want = ref.bilateral_reference(img_q, jax_params(p))
    np.testing.assert_allclose(r.image, want, rtol=1e-4, atol=1e-5)


def test_exr_target_round_trips(tmp_path):
    """EXR target => EXR output, HDR values and alpha preserved."""
    root = tmp_path / "hdr"
    root.mkdir()
    img = _frame(0) * 3.0
    img[..., 3] = 0.5
    imageio.save(str(root / "shot_0000.exr"), img)
    result = Session(
        str(root / "shot_0000.exr"), device="cpu", bilateral_params=BP, output_dir=str(root)
    ).run(RunConfig())
    assert result.output_path.endswith("output-nonlinear-bialteral.exr")
    out, hdr = imageio.load(result.output_path)
    assert hdr
    np.testing.assert_allclose(out[..., 3], 0.5, atol=1e-5)
    assert out[..., :3].max() > 1.0
    np.testing.assert_allclose(out, result.image, rtol=1e-3, atol=1e-3)  # half-float file


def test_timing_counters_disjoint(tmp_path):
    """Overlap run: prefetch uploads under the kernels are credited to
    transfer and kept out of exec, so the two stay within the wall time."""
    target = _make_anim(tmp_path / "anim", n_frames=4, with_layers=False)
    session = Session(target, device="cpu", nlm_params=NP_, output_dir=_out_dir(tmp_path, "t"))
    t0 = time.perf_counter_ns()
    rep = session.run(RunConfig(nlm=True, multiframe=True, overlap=True)).report
    wall = time.perf_counter_ns() - t0
    assert rep.exec_ns > 0 and rep.transfer_ns > 0
    assert rep.exec_ns + rep.transfer_ns <= wall


def test_debug_weights_prints_samples(tmp_path, capsys):
    target = _make_anim(tmp_path / "anim", n_frames=2, with_layers=False)
    Session(
        target, device="cpu", nlm_params=NP_, output_dir=_out_dir(tmp_path, "d"),
        debug_weights=True,
    ).run(RunConfig(nlm=True, multiframe=True))
    assert "=> |" in capsys.readouterr().out


def test_prefetcher_order_on_cpu():
    items = list(range(7))
    pf = FramePrefetcher(items, lambda i: np.full((2, 2, 4), float(i), np.float32), "cpu")
    assert len(pf) == 7
    assert [float(t[0, 0, 0]) for t in pf] == [float(i) for i in items]


def test_cli_runs_battery_on_cpu(tmp_path, capsys):
    target = _make_anim(tmp_path / "anim")
    out = _out_dir(tmp_path, "out")
    stencils.reset_launches()
    rc = cli.main([
        target, "--device", "cpu", "--output-dir", out, "--clamp",
        "--radius", "3", "--search-radius", "2", "--patch-radius", "1",
    ])
    assert rc == 0
    for cfg in GPU_BATTERY:
        img, _ = imageio.load(os.path.join(out, cfg.output_name(False)))
        assert img.shape == (24, 32, 4)
    assert os.path.exists(os.path.join(out, "output-cpu.png"))
    text = capsys.readouterr().out
    assert text.count("execution time:") == 6
    # all: the CPU configs cpu1 and cpu8 after the six device configs
    assert text.count("Time taken:") == 2
    assert text.rindex("execution time:") < text.index("bilateral filter on cpu (1 thread)")
    assert all(n == 0 for n in stencils.launches.values())  # plain versions on the CPU


def test_cli_all_frames_serving_loop(tmp_path):
    target = _make_anim(tmp_path / "anim", n_frames=2, with_layers=False)
    out = _out_dir(tmp_path, "serve")
    rc = cli.main([
        target, "--device", "cpu", "--output-dir", out, "--all-frames",
        "--configs", "bilateral", "--radius", "2",
    ])
    assert rc == 0
    for stem in ("frame_0000", "frame_0001"):
        assert os.path.exists(os.path.join(out, stem, "output-nonlinear-bialteral.png"))


def test_cli_device_cuda_without_card_fails(tmp_path, capsys):
    """No fallback: --device cuda with no card is an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    target = _make_anim(tmp_path / "anim", n_frames=1, with_layers=False)
    out = _out_dir(tmp_path, "out")
    rc = cli.main([target, "--device", "cuda", "--output-dir", out, "--configs", "bilateral"])
    assert rc == 1
    assert "error:" in capsys.readouterr().err
    assert not os.listdir(out)


@pytest.mark.parametrize("configs", ["tiled"])
def test_cli_refuses_configs_not_ported(tmp_path, configs, capsys):
    """An unknown config key is an error (the CPU configs cpu1 and cpu8 run:
    tests/test_torch_cpu_path.py)."""
    target = _make_anim(tmp_path / "anim", n_frames=1, with_layers=False)
    rc = cli.main([target, "--device", "cpu", "--output-dir", str(tmp_path), "--configs", configs])
    assert rc == 1
    assert "error:" in capsys.readouterr().err
