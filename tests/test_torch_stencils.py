"""The port's kernel module on the CPU: each wrapper's plain PyTorch version
against the JAX kernel (Pallas in interpret mode), the launch counters, and
the option checks.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is the exact-kernel contract, rtol 1e-4 / atol 1e-5; at the full
reference NLM parameters rtol 2e-4 / atol 1e-4, because 196 candidates x 36
taps summed in another order move the last bits (tests/test_kernels.py).

The bilateral with bf16 taps (TilingConfig.compute_dtype "bfloat16"). The
JAX kernel rounds the centre and tap RGB to bf16, computes the colour
distance dr*dr + dg*dg (+ db*db unless blue_bug) in bf16 and widens it to
float32 (stencils.py:220-221, 252-265); the accumulated RGB is the
bf16-rounded tap's. The port rounds every one of those operations, as the
code reads and the card kernel does. XLA on the CPU, which evaluates the
Pallas kernel here, skips the last rounding: the last bf16 add and its cast
to float32 become one float32 add, as for the turbo NLMs
(tests/test_torch_turbo.py). So the comparison is made twice:

  * with the port's colour distance given XLA's CPU rounding, the port
    equals the JAX kernel at the exact bilateral's tolerance (rtol 1e-4 /
    atol 1e-5): taps, value rounding, alpha, sums and divides all agree;
  * as shipped, the distance e of each tap differs by that one rounding, at
    most 2^-8 e. A weight s exp(-k e) (s the tap's spatial weight) then moves
    by at most s k e exp(-k e) 2^-8 <= s 2^-8 / e (Euler's e), so the norm
    and, with values in [0, 1], every weighted colour move by at most S
    2^-8 / e, S the sum of the disk's spatial weights; so does the
    normalized output, whose centre tap weighs exactly 1 (its distance is
    0) and whose values lie within 1 of it.
"""

import math

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import ops as jops
from image_denoising_filter_tpu.ops import reference as ref
from image_denoising_filter_tpu_torch.config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    TilingConfig,
)
from image_denoising_filter_tpu_torch.ops import stencils
from test_torch_config import jax_params

torch.set_num_threads(1)

BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)


def _image(seed, h=24, w=32):
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


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


BF16 = TilingConfig(compute_dtype="bfloat16")


def xla_cpu_bilateral_sq_diff(c, t, blue_bug):
    """The bf16 colour distance as XLA rounds the JAX kernel's on the CPU: the
    last bf16 add and its cast to float32 become one float32 add."""
    d = c - t
    rg = (d[..., 0] * d[..., 0]).float() + (d[..., 1] * d[..., 1]).float()
    if blue_bug:
        return rg
    e = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return e.float() + (d[..., 2] * d[..., 2]).float()


def one_rounding_atol(params):
    """S 2^-8 / e: how far one bf16 rounding of every colour distance moves
    the bilateral's partials and its normalized output (module docstring)."""
    s = sum(
        math.exp(-(dy * dy + dx * dx) / (2 * params.sigma_spatial**2))
        for dy0, n, hw in stencils._circle_runs(params.effective_radius, params.sigma_spatial,
                                                params.truncate_eps)
        for dy in range(dy0, dy0 + n)
        for dx in range(-hw, hw + 1)
    )
    return s * 2.0**-8 / math.e


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """A CPU tensor takes the plain version: no wrapper launches a kernel."""
    stencils.reset_launches()
    yield
    assert all(n == 0 for n in stencils.launches.values()), stencils.launches


@pytest.mark.parametrize(
    "params,h",
    [
        (BP, 24),
        (BilateralParams(radius=3, border=BorderPolicy.ZERO), 24),
        (BilateralParams(radius=3, blue_bug=True), 24),
        (BilateralParams(radius=3, uniform_alpha=True), 24),
        (BP, 29),  # ragged rows
        (BilateralParams(), 24),  # full reference params: radius 20, disk radius 12
    ],
    ids=["clamp", "zero", "blue_bug", "uniform_alpha", "ragged29", "full_params"],
)
def test_bilateral_matches_jax(params, h):
    img = _image(0, h=h)
    if params.uniform_alpha:
        img[..., 3] = 0.625
    _close(stencils.bilateral(_t(img), params), jops.bilateral(img, jax_params(params)))


@pytest.mark.parametrize(
    "params",
    [LP, LayersParams(radius=3, blue_bug=True), LayersParams(radius=3, border=BorderPolicy.ZERO)],
    ids=["clamp", "blue_bug", "zero"],
)
def test_cross_bilateral_layers_matches_jax(params):
    target, layer = _image(0), _image(99)
    wc, nw = stencils.cross_bilateral_layers(_t(target), _t(layer), params)
    jwc, jnw = jops.cross_bilateral_layers(target, layer, jax_params(params))
    _close(wc, jwc)
    _close(nw, jnw)


BF16_BILATERAL = {
    "clamp": BP,
    "zero": BilateralParams(radius=3, border=BorderPolicy.ZERO),
    "blue_bug": BilateralParams(radius=3, blue_bug=True),
    "uniform_alpha": BilateralParams(radius=3, uniform_alpha=True),
    "zero_blue_bug_ragged": BilateralParams(radius=2, border=BorderPolicy.ZERO, blue_bug=True),
}
BF16_LAYERS = {
    "clamp": LP,
    "zero": LayersParams(radius=3, border=BorderPolicy.ZERO),
    "blue_bug": LayersParams(radius=3, blue_bug=True),
    "uniform_alpha": LayersParams(radius=3, uniform_alpha=True),
}


def _bf16_bilateral_case(name):
    params = BF16_BILATERAL[name]
    img = _image(0, h=29 if name.endswith("ragged") else 24)
    if params.uniform_alpha:
        img[..., 3] = 0.625
    return params, img, np.asarray(jops.bilateral(img, jax_params(params), jax_params(BF16)))


def _bf16_layers_case(name):
    params = BF16_LAYERS[name]
    target, layer = _image(0), _image(99)
    if params.uniform_alpha:
        target[..., 3] = 0.625
    jwc, jnw = jops.cross_bilateral_layers(target, layer, jax_params(params), jax_params(BF16))
    return params, target, layer, np.asarray(jwc), np.asarray(jnw)


@pytest.mark.parametrize("xla_rounding", [True, False], ids=["xla_rounding", "as_shipped"])
@pytest.mark.parametrize("name", list(BF16_BILATERAL))
def test_bilateral_bf16_matches_jax(name, xla_rounding, monkeypatch):
    """bf16 taps against the JAX kernel: given XLA's CPU rounding at the
    exact bilateral's tolerance, as shipped within one bf16 rounding of each
    colour distance (module docstring)."""
    params, img, want = _bf16_bilateral_case(name)
    if xla_rounding:
        monkeypatch.setattr(stencils, "_bilateral_sq_diff_bf16", xla_cpu_bilateral_sq_diff)
        tol = {}
    else:
        tol = dict(rtol=0.0, atol=one_rounding_atol(params))
    _close(stencils.bilateral(_t(img), params, BF16), want, **tol)


@pytest.mark.parametrize("xla_rounding", [True, False], ids=["xla_rounding", "as_shipped"])
@pytest.mark.parametrize("name", list(BF16_LAYERS))
def test_cross_bilateral_layers_bf16_matches_jax(name, xla_rounding, monkeypatch):
    """The guided partials with bf16 taps (the layer's and the target's RGB
    rounded) against the JAX kernel, both ways."""
    params, target, layer, jwc, jnw = _bf16_layers_case(name)
    if xla_rounding:
        monkeypatch.setattr(stencils, "_bilateral_sq_diff_bf16", xla_cpu_bilateral_sq_diff)
        tol = {}
    else:
        tol = dict(rtol=0.0, atol=one_rounding_atol(params))
    wc, nw = stencils.cross_bilateral_layers(_t(target), _t(layer), params, BF16)
    _close(wc, jwc, **tol)
    _close(nw, jnw, **tol)


def test_bilateral_bf16_rounds_the_colour_distance():
    """As shipped the port rounds the last add of the distance, which XLA's
    CPU rounding skips: the two differ, so the rounding is live."""
    img = _t(_image(0))
    got = stencils.bilateral(img, BP, BF16)
    stencils._bilateral_sq_diff_bf16, saved = xla_cpu_bilateral_sq_diff, stencils._bilateral_sq_diff_bf16
    try:
        xla = stencils.bilateral(img, BP, BF16)
    finally:
        stencils._bilateral_sq_diff_bf16 = saved
    assert not torch.equal(got, xla)


def test_bf16_bilateral_forms_track_the_oracle():
    """Both bf16 forms against ops/reference.py's float32 oracle at the JAX
    test's own bf16 headroom (tests/test_kernels.py: rtol 0.1 / atol 0.03),
    and unlike their float32 outputs: the knob is live."""
    img, layer = _image(0), _image(99)
    got = stencils.bilateral(_t(img), BP, BF16)
    np.testing.assert_allclose(got.numpy(), ref.bilateral_reference(img, jax_params(BP)),
                               rtol=0.1, atol=0.03)
    assert not torch.equal(got, stencils.bilateral(_t(img), BP))
    wc, nw = stencils.cross_bilateral_layers(_t(img), _t(layer), LP, BF16)
    rwc, rnw = ref.cross_bilateral_layers_reference(img, layer, jax_params(LP))
    np.testing.assert_allclose(wc.numpy(), rwc, rtol=0.1, atol=0.03)
    np.testing.assert_allclose(nw.numpy(), rnw, rtol=0.1, atol=0.03)
    fwc, fnw = stencils.cross_bilateral_layers(_t(img), _t(layer), LP)
    assert not torch.equal(wc, fwc) and not torch.equal(nw, fnw)


@pytest.mark.parametrize(
    "params,tol",
    [
        (NP_, {}),
        (NlmParams(search_radius=2, patch_radius=1, border=BorderPolicy.ZERO), {}),
        (NlmParams(search_radius=5, patch_radius=2, search_stride=2, search_disk=True), {}),
        (NlmParams(search_radius=4, patch_radius=2, search_disk=True), {}),
        (NlmParams(), dict(rtol=2e-4, atol=1e-4)),  # full reference params
    ],
    ids=["exact", "zero", "stride2_disk", "disk", "full_params"],
)
def test_nlm_accumulate_matches_jax(params, tol):
    target, nbr = _image(0), _image(99)
    wc, nw = stencils.nlm_accumulate(_t(target), _t(nbr), params)
    jwc, jnw = jops.nlm_accumulate(target, nbr, jax_params(params))
    _close(wc, jwc, **tol)
    _close(nw, jnw, **tol)


def test_nlm_uniform_alpha_matches_jax():
    target, nbr = _image(0), _image(99)
    nbr[..., 3] = 1.0
    params = NlmParams(search_radius=2, patch_radius=1, uniform_alpha=True)
    wc, nw = stencils.nlm_accumulate(_t(target), _t(nbr), params)
    jwc, jnw = jops.nlm_accumulate(target, nbr, jax_params(params))
    _close(wc, jwc)
    _close(nw, jnw)


def test_nlm_accumulate_frames_valid_mask_matches_jax():
    """F=3 with valid=[1,0,1]: the masked frame adds neither weights nor its
    norm seed."""
    target = _image(0)
    frames = np.stack([_image(0), _image(99), _image(7)])
    valid = np.array([1.0, 0.0, 1.0], np.float32)
    wc, nw = stencils.nlm_accumulate_frames(_t(target), _t(frames), NP_, None, _t(valid))
    jwc, jnw = jops.nlm_accumulate_frames(target, frames, jax_params(NP_), None, valid)
    _close(wc, jwc)
    _close(nw, jnw)
    # and the mask is live: without it the second frame's seed shows up
    _, nw_all = stencils.nlm_accumulate_frames(_t(target), _t(frames), NP_)
    assert float((nw_all - nw).min()) >= NP_.norm_seed - 1e-6


def test_normalize_matches_jax_with_sentinel():
    rng = np.random.default_rng(3)
    wc = rng.uniform(0, 5, (24, 32, 4)).astype(np.float32)
    nw = rng.uniform(0.5, 3, (24, 32)).astype(np.float32)
    nw[3, 5] = 0.0
    nw[10, :4] = 0.0
    got = stencils.normalize(_t(wc), _t(nw))
    _close(got, jops.normalize(wc, nw), rtol=1e-6, atol=0.0)
    np.testing.assert_array_equal(got[3, 5].numpy(), [1.0, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(got[10, :4].numpy(), np.tile([1.0, 0.0, 1.0, 1.0], (4, 1)))


def test_options_not_ported_are_refused():
    """A tap dtype no kernel takes (float16) is refused by the bilateral,
    layers and NLM wrappers instead of computing something else; bf16 taps
    are ported for all three, and normalize divides in float32 whatever the
    tiling says, as in JAX."""
    img = _t(_image(0))
    fp16 = TilingConfig(compute_dtype="float16")
    with pytest.raises(NotImplementedError):
        stencils.bilateral(img, BP, fp16)
    with pytest.raises(NotImplementedError):
        stencils.cross_bilateral_layers(img, img, LP, fp16)
    with pytest.raises(NotImplementedError):
        stencils.nlm_accumulate(img, img, NP_, fp16)
    with pytest.raises(NotImplementedError):
        stencils.nlm_accumulate_frames(img, img[None], NP_, fp16)
    stencils.bilateral(img, BP, BF16)
    stencils.cross_bilateral_layers(img, img, LP, BF16)
    stencils.nlm_accumulate(img, img, NP_, BF16)
    for tiling in (BF16, fp16):
        torch.testing.assert_close(stencils.normalize(img, img[..., 0] + 1, tiling=tiling),
                                   stencils.normalize(img, img[..., 0] + 1), rtol=0, atol=0)


def test_wrappers_check_inputs():
    img = _t(_image(0))
    with pytest.raises(TypeError):
        stencils.bilateral(img.double(), BP)
    with pytest.raises(ValueError):
        stencils.bilateral(img[..., :3], BP)
    with pytest.raises(ValueError):
        stencils.cross_bilateral_layers(img, img[:-1], LP)
    with pytest.raises(ValueError):
        stencils.nlm_accumulate_frames(img, img, NP_)
    with pytest.raises(ValueError):
        stencils.nlm_accumulate_frames(img, img[None], NP_, None, torch.ones(2))
    with pytest.raises(ValueError):
        stencils.normalize(img, img[:-1, :, 0])
    with pytest.raises(ValueError):
        stencils.bilateral(img.to("meta"), BP)
