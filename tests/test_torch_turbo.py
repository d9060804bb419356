"""The turbo battery on the CPU against the JAX package: the turbo NLM (the
frame-batched NLM with bf16 taps and a stride-2 search) and `gpu-denoise
--turbo D` end to end.

The turbo NLM. The JAX kernel casts the target and neighbour RGB to bf16 and
computes e = d0*d0 + d1*d1 + d2*d2 in bf16 before widening e to float32
(stencils.py:532-534, 560-563). The port rounds each of those operations to
bf16, as the code reads and the card kernel does. XLA on the CPU, which
evaluates the Pallas kernel here, may skip a rounding it deems excess
precision: it fuses the last bf16 add with the cast to float32 into one
float32 add. So the comparison is made twice:

  * with the port's squared difference given XLA's CPU rounding, the port
    equals the JAX kernel at the exact NLM's tolerance (rtol 2e-4 / atol
    1e-4): candidates, stride compensation, masks and sums all agree;
  * as shipped, the port differs from the JAX kernel by that one rounding of
    e, at most 2^-8 of each patch sum. A weight m exp(-x) moves by at most
    m x exp(-x) 2^-8 <= m 2^-8 / e, so each partial moves by at most
    2^-8 / e times the sum of the candidates' multipliers m (1 for the zero
    offset, stride^2 for the others) over the valid frames.

End to end, both CLIs write 8-bit PNGs with --clamp on one small animation.
The layers config differs from the JAX CLI by the reference's telescoped
delta rounding and the blur's bf16 flips (tests/test_torch_guided.py), the
NLM configs by the rounding above. Each output is held to the reference's
within one 8-bit step. The share of values a step apart is bounded by what
the two differences give on this animation: at most 1% for the NLM configs
(measured 0.17-0.23%), at most 10% for layers (measured 5.8-7.5%: the delta
rounding, ~1e-3 after the divide, carries a quarter of the values it meets
near a rounding boundary across it).
"""

import functools
import math
import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import cli as jcli
from image_denoising_filter_tpu import ops as jops
from image_denoising_filter_tpu_torch import cli
from image_denoising_filter_tpu_torch.config import (
    GPU_BATTERY,
    BorderPolicy,
    NlmParams,
    TilingConfig,
)
from image_denoising_filter_tpu_torch.ops import eager, stencils
from image_denoising_filter_tpu_torch.utils import imageio
from test_torch_config import jax_params

torch.set_num_threads(2)

BF16 = TilingConfig(compute_dtype="bfloat16")
TOL_NLM = dict(rtol=2e-4, atol=1e-4)
# The share of 8-bit values one step from tpu-denoise's (module docstring).
STEP_FRACTION = {"layers": 0.10, "nlm": 0.01, "multiframe": 0.01, "overlap": 0.01}

# (params, frames, valid): the turbo NLM's candidate sets, F = 1 and F = 3
# with a masked frame.
NLM_CASES = {
    "stride2": (NlmParams(search_stride=2), 1, None),
    "stride2_disk": (NlmParams(search_stride=2, search_disk=True), 1, None),
    "stride2_uniform_alpha": (NlmParams(search_stride=2, uniform_alpha=True), 1, None),
    "stride2_zero": (NlmParams(search_radius=5, patch_radius=2, search_stride=2,
                               border=BorderPolicy.ZERO), 1, None),
    "stride2_F3_mask": (NlmParams(search_stride=2), 3, (1.0, 0.0, 1.0)),
    "stride2_disk_F3_mask": (NlmParams(search_stride=2, search_disk=True), 3, (1.0, 1.0, 0.0)),
}


def _frame(seed, h=24, w=40):
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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _xla_cpu_sq_diff(t, n):
    """The squared difference as XLA rounds the JAX kernel's on the CPU: the
    last bf16 add and its cast to float32 become one float32 add."""
    d = t - n
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]).float() + (d[..., 2] * d[..., 2]).float()


@functools.lru_cache(maxsize=None)
def _nlm_case(name):
    """The inputs of one case and the JAX kernel's bf16 partials."""
    params, n_frames, valid = NLM_CASES[name]
    target = _frame(0)
    frames = np.stack([_frame(0), _frame(99), _frame(7)][:n_frames])
    if params.uniform_alpha:
        frames[..., 3] = 1.0
    valid = None if valid is None else np.array(valid, np.float32)
    jwc, jnw = jops.nlm_accumulate_frames(
        target, frames, jax_params(params), jax_params(BF16), valid
    )
    return params, target, frames, valid, np.asarray(jwc), np.asarray(jnw)


def _port_nlm(name):
    params, target, frames, valid, _, _ = _nlm_case(name)
    return stencils.nlm_accumulate_frames(
        _t(target), _t(frames), params, BF16, None if valid is None else _t(valid)
    )


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """A CPU tensor takes the plain version: no wrapper launches a kernel."""
    stencils.reset_launches()
    yield
    assert all(n == 0 for n in stencils.launches.values()), stencils.launches


@pytest.mark.parametrize("name", NLM_CASES)
def test_turbo_nlm_matches_jax_under_its_cpu_rounding(name, monkeypatch):
    monkeypatch.setattr(eager, "_sq_diff_bf16", _xla_cpu_sq_diff)
    *_, jwc, jnw = _nlm_case(name)
    wc, nw = _port_nlm(name)
    np.testing.assert_allclose(wc.numpy(), jwc, **TOL_NLM)
    np.testing.assert_allclose(nw.numpy(), jnw, **TOL_NLM)


@pytest.mark.parametrize("name", NLM_CASES)
def test_turbo_nlm_matches_jax(name):
    """As shipped: within the bound of one bf16 rounding of each squared
    difference (module docstring); and the bf16 taps are live, the float32
    kernel computes something else."""
    params, target, frames, valid, jwc, jnw = _nlm_case(name)
    n_cands = len(stencils.nlm_candidates(params))
    stride2 = params.search_stride**2
    frames_on = frames.shape[0] if valid is None else int(valid.sum())
    bound = 2.0**-8 / math.e * (1 + stride2 * (n_cands - 1)) * frames_on
    wc, nw = _port_nlm(name)
    np.testing.assert_allclose(wc.numpy(), jwc, rtol=0, atol=bound)
    np.testing.assert_allclose(nw.numpy(), jnw, rtol=0, atol=bound)
    f32 = stencils.nlm_accumulate_frames(
        _t(target), _t(frames), params, None, None if valid is None else _t(valid)
    )
    assert not torch.equal(f32[1], nw)


def test_turbo_nlm_candidates():
    """The turbo NLM evaluates 49 of the 196 candidates at stride 2, 37 with
    the disk (the --turbo and --search-disk help)."""
    assert len(stencils.nlm_candidates(NlmParams(search_stride=2))) == 49
    assert len(stencils.nlm_candidates(NlmParams(search_stride=2, search_disk=True))) == 37


# ---------------------------------------------------------------------------
# gpu-denoise --turbo D against tpu-denoise --turbo D
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def anim(tmp_path_factory):
    """Three frames and two G-buffer layers of the target frame 0001."""
    root = tmp_path_factory.mktemp("anim")
    os.makedirs(root / "RenderElements")
    for i in range(3):
        imageio.save(str(root / f"frame_{i:04d}.png"), _frame(i, 40, 56))
    for seed, name in ((50, "albedo"), (51, "normal")):
        imageio.save(str(root / "RenderElements" / f"{name}_0001.png"), _frame(seed, 40, 56))
    return str(root / "frame_0001.png")


@functools.lru_cache(maxsize=None)
def _jax_cli(target, out_dir, argv):
    rc = jcli.main([target, "--clamp", "--output-dir", out_dir, *argv])
    assert rc == 0
    return out_dir


def _assert_outputs_match(got_dir, want_dir, keys):
    for key in keys:
        name = GPU_BATTERY[cli.CONFIG_KEYS.index(key)].output_name(False)
        got, _ = imageio.load(os.path.join(got_dir, name))
        want, _ = imageio.load(os.path.join(want_dir, name))
        steps = np.abs(got - want) * 255.0
        assert steps.max() <= 1.0 + 1e-3, f"{key}: {steps.max():.2f} 8-bit steps apart"
        frac = float((steps > 0.5).mean())
        assert frac <= STEP_FRACTION[key], f"{key}: {frac:.2%} of values a step apart"


@pytest.mark.parametrize(
    "argv",
    [
        ("--turbo", "1", "--configs", "bilateral,layers,linear"),
        ("--turbo", "2", "--configs", "bilateral,layers,linear"),
        ("--turbo", "4", "--configs", "bilateral,layers,linear"),
        ("--turbo", "8", "--configs", "bilateral,layers,linear"),
        ("--turbo", "2", "--configs", "nlm,multiframe,overlap"),
        ("--turbo", "4", "--configs", "nlm", "--search-disk"),
    ],
    ids=["d1_grid", "d2_grid", "d4_grid", "d8_grid", "d2_nlm", "d4_nlm_disk"],
)
def test_cli_turbo_matches_jax_cli(anim, tmp_path_factory, capsys, argv):
    """Every config under --turbo runs and exits 0; layers and the NLM
    configs match tpu-denoise's files (module docstring). The bilateral and
    linear files are held to the JAX Pallas pipeline in
    tests/test_torch_fast.py: tpu-denoise takes its XLA lattice on the CPU."""
    keys = argv[argv.index("--configs") + 1].split(",")
    want = _jax_cli(anim, str(tmp_path_factory.mktemp("jax")), argv)
    got = str(tmp_path_factory.mktemp("port"))
    capsys.readouterr()
    assert cli.main([anim, "--device", "cpu", "--clamp", "--output-dir", got, *argv]) == 0
    assert capsys.readouterr().out.count("execution time:") == len(keys)
    _assert_outputs_match(got, want, [k for k in keys if k not in ("bilateral", "linear")])
    for key in keys:
        name = GPU_BATTERY[cli.CONFIG_KEYS.index(key)].output_name(False)
        assert os.path.exists(os.path.join(got, name))


def test_cli_weights_halfres_is_refused(anim, tmp_path, capsys):
    """Without --turbo, --weights-halfres fails as tpu-denoise does
    (tests/test_torch_hrw.py runs it with --turbo)."""
    out = tmp_path / "out"
    rc = cli.main([anim, "--device", "cpu", "--output-dir", str(out), "--weights-halfres"])
    assert rc == 1
    assert "--weights-halfres requires --turbo (stride-2 search)" in capsys.readouterr().err
    assert not out.exists()  # refused before anything ran
