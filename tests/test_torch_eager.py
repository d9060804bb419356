"""ops/eager.py (the linear-layout config) against the JAX ops/xla.py.

Same inputs from a numpy seed into both packages; rtol 1e-4 / atol 1e-5, and
rtol 2e-4 / atol 1e-4 at the full reference NLM parameters.
"""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    NormalizeParams,
)
from image_denoising_filter_tpu.ops import xla
from image_denoising_filter_tpu_torch.ops import eager
from test_torch_config import jax_params

torch.set_num_threads(1)


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


@pytest.mark.parametrize(
    "params",
    [
        BilateralParams(radius=3),
        BilateralParams(radius=3, border=BorderPolicy.ZERO),
        BilateralParams(radius=3, blue_bug=True),
        BilateralParams(radius=3, uniform_alpha=True),
        BilateralParams(),  # full reference params
        BilateralParams(radius=6, sigma_spatial=10.0, truncate_eps=0.0),  # full window
    ],
    ids=["clamp", "zero", "blue_bug", "uniform_alpha", "full_params", "no_truncation"],
)
def test_bilateral_eager_matches_xla(params):
    img = _image(0, h=29)
    if params.uniform_alpha:
        img[..., 3] = 0.625
    _close(eager.bilateral_eager(_t(img), params), xla.bilateral_xla(img, jax_params(params)))


@pytest.mark.parametrize(
    "params",
    [
        LayersParams(radius=3),
        LayersParams(radius=3, blue_bug=True),
        LayersParams(radius=3, border=BorderPolicy.ZERO),
        LayersParams(radius=3, uniform_alpha=True),
    ],
    ids=["clamp", "blue_bug", "zero", "uniform_alpha"],
)
def test_cross_bilateral_layers_eager_matches_xla(params):
    target, layer = _image(0), _image(99)
    if params.uniform_alpha:
        target[..., 3] = 1.0
    wc, nw = eager.cross_bilateral_layers_eager(_t(target), _t(layer), params)
    xwc, xnw = xla.cross_bilateral_layers_xla(target, layer, jax_params(params))
    _close(wc, xwc)
    _close(nw, xnw)


@pytest.mark.parametrize(
    "params,tol",
    [
        (NlmParams(search_radius=2, patch_radius=1), {}),
        (NlmParams(search_radius=2, patch_radius=1, border=BorderPolicy.ZERO), {}),
        (NlmParams(search_radius=2, patch_radius=1, uniform_alpha=True), {}),
        (NlmParams(search_radius=6, patch_radius=3, search_stride=2), {}),
        (NlmParams(search_radius=7, patch_radius=3, search_stride=2, search_disk=True), {}),
        (NlmParams(search_radius=4, patch_radius=2, search_disk=True), {}),
        (NlmParams(), dict(rtol=2e-4, atol=1e-4)),  # full reference params
    ],
    ids=["exact", "zero", "uniform_alpha", "stride2", "stride2_disk", "disk", "full_params"],
)
def test_nlm_eager_matches_xla(params, tol):
    target, nbr = _image(0), _image(99)
    if params.uniform_alpha:
        nbr[..., 3] = 1.0
    wc, nw = eager.nlm_eager(_t(target), _t(nbr), params)
    xwc, xnw = xla.nlm_xla(target, nbr, jax_params(params))
    _close(wc, xwc, **tol)
    _close(nw, xnw, **tol)


def test_normalize_eager_matches_xla():
    rng = np.random.default_rng(3)
    wc = rng.uniform(0, 5, (24, 32, 4)).astype(np.float32)
    nw = rng.uniform(0.5, 3, (24, 32)).astype(np.float32)
    nw[3, 5] = 0.0
    params = NormalizeParams(sentinel_g=0.5)
    got = eager.normalize_eager(_t(wc), _t(nw), params)
    _close(got, xla.normalize_xla(wc, nw, jax_params(params)), rtol=1e-6, atol=0.0)
    np.testing.assert_array_equal(got[3, 5].numpy(), [1.0, 0.5, 1.0, 1.0])
