"""The half-row NLM on the CPU against the JAX package: the NLM with its
weight field at half row resolution (NlmParams.weights_halfres), the plain
version of the half-row kernel, and `gpu-denoise --turbo D --weights-halfres`
end to end.

Tolerances, each with its reason:

  * float32, against the XLA oracle (xla.py:nlm_xla's halfres branch): rtol
    1e-5 / atol 1e-6, the bound the JAX package holds its Pallas kernel to
    (tests/test_kernels.py) -- the same cells, sums in another order;
  * bf16 taps, against the JAX Pallas kernel in interpret mode. The kernel
    rounds the pooled target and neighbour to bf16 (bf16(0.5 (bf16(a) +
    bf16(b)))), each squared difference operation, and each weight cell
    before its upsample matmul. XLA on the CPU keeps the pooled and the
    weight roundings, and skips the last bf16 add of the squared difference
    (fused with its cast to float32, as for the full-resolution turbo NLM,
    tests/test_torch_turbo.py). So:
      - with the port's squared difference given XLA's CPU rounding, the port
        equals the JAX kernel at the exact NLM's tolerance (rtol 2e-4 / atol
        1e-4);
      - as shipped, they differ by that one rounding of each squared
        difference, 2^-8 of it at most, which moves x = kappa ssd / h^2 by at
        most x 2^-8, and by the bf16 rounding of the weight cell that follows,
        which then lands at most one bf16 step (2^-7 of the cell) further
        apart. A candidate with multiplier m (1 for the zero offset, stride^2
        for the others) moves by at most m e^-x (x 2^-8 + 2^-7) <= m 2^-7,
        through the convex upsample; each partial by at most 2^-7 times the
        sum of the multipliers over the valid frames.
  * end to end, both CLIs write 8-bit PNGs with --clamp: each output within
    one 8-bit step of tpu-denoise's, at most 1% of the values a step apart
    (the rounding above; measured 0.29-0.37%).
"""

import functools
import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import cli as jcli
from image_denoising_filter_tpu import ops as jops
from image_denoising_filter_tpu.ops import xla
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
from test_torch_turbo import _frame, _xla_cpu_sq_diff

torch.set_num_threads(2)

BF16 = TilingConfig(compute_dtype="bfloat16")
TOL_NLM = dict(rtol=2e-4, atol=1e-4)
STEP_FRACTION = 0.01
CLAMP, ZERO = BorderPolicy.CLAMP, BorderPolicy.ZERO


def _hrw(**kw):
    return NlmParams(search_stride=2, weights_halfres=True, **kw)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """A CPU tensor takes the plain version: no wrapper launches a kernel."""
    stencils.reset_launches()
    yield
    assert all(n == 0 for n in stencils.launches.values()), stencils.launches


# ---------------------------------------------------------------------------
# float32: the plain version against the XLA oracle
# ---------------------------------------------------------------------------

# (params, rows): the disk on and off, both borders, uniform alpha, and an
# odd H, whose last cell pools the last row with a border row.
F32_CASES = {
    "clamp": (_hrw(), 24),
    "zero": (_hrw(border=ZERO), 24),
    "disk": (_hrw(search_disk=True), 24),
    "uniform_alpha": (_hrw(uniform_alpha=True), 24),
    "odd_clamp": (_hrw(), 23),
    "odd_zero_disk": (_hrw(border=ZERO, search_disk=True), 23),
    "odd_zero_uniform_alpha": (_hrw(border=ZERO, uniform_alpha=True), 23),
    "s5": (_hrw(search_radius=5), 23),
}


@pytest.mark.parametrize("name", F32_CASES)
def test_hrw_plain_matches_xla(name):
    params, h = F32_CASES[name]
    target, nbr = _frame(0, h), _frame(99, h)
    if params.uniform_alpha:
        nbr[..., 3] = 1.0
    wc, nw = stencils.nlm_accumulate(_t(target), _t(nbr), params)
    xwc, xnw = xla.nlm_xla(target, nbr, jax_params(params))
    np.testing.assert_allclose(wc.numpy(), np.asarray(xwc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(nw.numpy(), np.asarray(xnw), rtol=1e-5, atol=1e-6)


def test_hrw_weights_are_live():
    """Half-row weights differ from the full-resolution ones."""
    img = _t(_frame(0))
    hrw = eager.nlm_eager(img, img, _hrw())[1]
    full = eager.nlm_eager(img, img, NlmParams(search_stride=2))[1]
    assert not torch.allclose(hrw, full, rtol=1e-3, atol=0)


def test_hrw_odd_rows_pool_a_border_row():
    """At odd H the last cell pools the last row with a border row: the edge
    row under CLAMP, zero under ZERO. The last output row then depends on the
    border policy, and the oracle agrees on both (test_hrw_plain_matches_xla)."""
    img = _t(_frame(0, 23))
    clamp = eager.nlm_eager(img, img, _hrw())[1]
    zero = eager.nlm_eager(img, img, _hrw(border=ZERO))[1]
    assert not torch.equal(clamp[-1], zero[-1])


# ---------------------------------------------------------------------------
# bf16 taps: the plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

# (params, frames, valid, rows), as the turbo NLM's NLM_CASES.
BF16_CASES = {
    "F1": (_hrw(), 1, None, 24),
    "F1_disk": (_hrw(search_disk=True), 1, None, 24),
    "F1_zero_odd": (_hrw(border=ZERO), 1, None, 23),
    "F1_uniform_alpha": (_hrw(uniform_alpha=True), 1, None, 24),
    "F3_mask": (_hrw(), 3, (1.0, 0.0, 1.0), 24),
    "F3_disk_mask_odd": (_hrw(search_disk=True), 3, (1.0, 1.0, 0.0), 23),
}


@functools.lru_cache(maxsize=None)
def _bf16_case(name):
    """The inputs of one case and the JAX kernel's bf16 partials."""
    params, n_frames, valid, h = BF16_CASES[name]
    target = _frame(0, h)
    frames = np.stack([_frame(0, h), _frame(99, h), _frame(7, h)][:n_frames])
    if params.uniform_alpha:
        frames[..., 3] = 1.0
    valid = None if valid is None else np.array(valid, np.float32)
    jwc, jnw = jops.nlm_accumulate_frames(
        target, frames, jax_params(params), jax_params(BF16), valid
    )
    return params, target, frames, valid, np.asarray(jwc), np.asarray(jnw)


def _port_bf16(name, tiling=BF16):
    params, target, frames, valid, _, _ = _bf16_case(name)
    return stencils.nlm_accumulate_frames(
        _t(target), _t(frames), params, tiling, None if valid is None else _t(valid)
    )


@pytest.mark.parametrize("name", BF16_CASES)
def test_hrw_bf16_matches_pallas_under_its_cpu_rounding(name, monkeypatch):
    monkeypatch.setattr(eager, "_sq_diff_bf16", _xla_cpu_sq_diff)
    *_, jwc, jnw = _bf16_case(name)
    wc, nw = _port_bf16(name)
    np.testing.assert_allclose(wc.numpy(), jwc, **TOL_NLM)
    np.testing.assert_allclose(nw.numpy(), jnw, **TOL_NLM)


@pytest.mark.parametrize("name", BF16_CASES)
def test_hrw_bf16_matches_pallas(name):
    """As shipped: within the bound of the module docstring; and the bf16
    taps are live, the float32 kernel computes something else."""
    params, target, frames, valid, jwc, jnw = _bf16_case(name)
    n_cands = len(stencils.nlm_candidates(params))
    frames_on = frames.shape[0] if valid is None else int(valid.sum())
    bound = 2.0**-7 * (1 + params.search_stride**2 * (n_cands - 1)) * frames_on
    wc, nw = _port_bf16(name)
    np.testing.assert_allclose(wc.numpy(), jwc, rtol=0, atol=bound)
    np.testing.assert_allclose(nw.numpy(), jnw, rtol=0, atol=bound)
    assert not torch.equal(_port_bf16(name, None)[1], nw)


@pytest.mark.parametrize(
    "rounding", ["_pool_rows_bf16", "_weights_bf16"], ids=["pooled", "weight_cells"]
)
def test_hrw_bf16_roundings_are_the_kernels(rounding, monkeypatch):
    """Each bf16 rounding of the half-row path that XLA keeps on the CPU is
    one the Pallas kernel makes: without it the port leaves the exact NLM's
    tolerance of the kernel."""
    monkeypatch.setattr(eager, "_sq_diff_bf16", _xla_cpu_sq_diff)
    skip = {
        "_pool_rows_bf16": lambda x: 0.5 * (x.to(torch.bfloat16).float()[0::2]
                                            + x.to(torch.bfloat16).float()[1::2]),
        "_weights_bf16": lambda wh: wh,
    }[rounding]
    monkeypatch.setattr(eager, rounding, skip)
    *_, jwc, jnw = _bf16_case("F1")
    _, nw = _port_bf16("F1")
    assert not np.allclose(nw.numpy(), jnw, **TOL_NLM)


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "params",
    [NlmParams(weights_halfres=True), NlmParams(search_stride=2, patch_radius=2,
                                                weights_halfres=True)],
    ids=["stride1", "patch2"],
)
def test_hrw_refuses_other_strides_and_patches(params):
    """Stride 2 and patch radius 3 only, as both JAX lowerings raise."""
    img = _t(_frame(0))
    with pytest.raises(ValueError, match="search_stride=2 and patch_radius=3"):
        eager.nlm_eager(img, img, params)
    with pytest.raises(ValueError, match="search_stride=2 and patch_radius=3"):
        stencils.nlm_accumulate(img, img, params, BF16)
    with pytest.raises(ValueError, match="search_stride=2 and patch_radius=3"):
        xla.nlm_xla(_frame(0), _frame(0), jax_params(params))


# ---------------------------------------------------------------------------
# gpu-denoise --turbo D --weights-halfres against tpu-denoise
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def anim(tmp_path_factory):
    """Three frames of 40 x 56 (the turbo battery's animation); target 0001."""
    root = tmp_path_factory.mktemp("anim")
    for i in range(3):
        imageio.save(str(root / f"frame_{i:04d}.png"), _frame(i, 40, 56))
    return str(root / "frame_0001.png")


@pytest.mark.parametrize(
    "argv",
    [
        ("--turbo", "2", "--weights-halfres", "--configs", "nlm,multiframe,overlap"),
        ("--turbo", "2", "--weights-halfres", "--search-disk", "--configs",
         "nlm,multiframe,overlap"),
    ],
    ids=["d2", "d2_disk"],
)
def test_cli_weights_halfres_matches_jax_cli(anim, tmp_path_factory, capsys, argv):
    keys = argv[argv.index("--configs") + 1].split(",")
    want = str(tmp_path_factory.mktemp("jax"))
    assert jcli.main([anim, "--clamp", "--output-dir", want, *argv]) == 0
    got = str(tmp_path_factory.mktemp("port"))
    capsys.readouterr()
    assert cli.main([anim, "--device", "cpu", "--clamp", "--output-dir", got, *argv]) == 0
    assert capsys.readouterr().out.count("execution time:") == len(keys)
    for key in keys:
        name = GPU_BATTERY[cli.CONFIG_KEYS.index(key)].output_name(False)
        a, _ = imageio.load(os.path.join(got, name))
        b, _ = imageio.load(os.path.join(want, name))
        steps = np.abs(a - b) * 255.0
        assert steps.max() <= 1.0 + 1e-3, f"{key}: {steps.max():.2f} 8-bit steps apart"
        frac = float((steps > 0.5).mean())
        assert frac <= STEP_FRACTION, f"{key}: {frac:.2%} of values a step apart"
