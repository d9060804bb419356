"""The port's kernel module on the CPU: each wrapper's plain PyTorch version
against the JAX kernel (Pallas in interpret mode), the launch counters, and
the option checks.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is the exact-kernel contract, rtol 1e-4 / atol 1e-5; at the full
reference NLM parameters rtol 2e-4 / atol 1e-4, because 196 candidates x 36
taps summed in another order move the last bits (tests/test_kernels.py).
"""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import ops as jops
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
    """bf16 taps of the bilateral kernels (no gpu-denoise path runs them) are
    not ported: the wrappers refuse them instead of computing something else.
    bf16 NLM taps are ported (the turbo NLM), and normalize divides in
    float32 whatever the tiling says, as in JAX."""
    img = _t(_image(0))
    bf16 = TilingConfig(compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        stencils.bilateral(img, BP, bf16)
    with pytest.raises(NotImplementedError):
        stencils.cross_bilateral_layers(img, img, LP, bf16)
    with pytest.raises(NotImplementedError):
        stencils.nlm_accumulate(img, img, NP_, TilingConfig(compute_dtype="float16"))
    stencils.nlm_accumulate(img, img, NP_, bf16)
    torch.testing.assert_close(stencils.normalize(img, img[..., 0] + 1, tiling=bf16),
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
