"""The four denoiser families of the port against the JAX models, in both
layouts, and a temporal accumulation carried from one package to the other.

Tiled models run the kernels' plain versions here (CPU tensors), against the
JAX Pallas kernels in interpret mode; linear models run ops/eager.py against
ops/xla.py. rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import models as jmodels
from image_denoising_filter_tpu_torch.config import (
    BilateralParams,
    LayersParams,
    NlmParams,
)
from image_denoising_filter_tpu_torch import models
from test_torch_config import jax_params

torch.set_num_threads(1)

BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
LAYOUTS = [models.TILED, models.LINEAR]


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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_bilateral_denoiser_matches_jax(layout):
    img = _frame(0)
    got = models.BilateralDenoiser(BP, layout=layout)(_t(img))
    _close(got, jmodels.BilateralDenoiser(jax_params(BP), layout=layout)(img))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layer_guided_denoiser_matches_jax(layout):
    target = _frame(0)
    layers = np.stack([_frame(7), _frame(8)])
    got = models.LayerGuidedDenoiser(LP, layout=layout)(_t(target), _t(layers))
    _close(got, jmodels.LayerGuidedDenoiser(jax_params(LP), layout=layout)(target, layers))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_nlm_denoiser_matches_jax(layout):
    img = _frame(0)
    got = models.NlmDenoiser(NP_, layout=layout)(_t(img))
    _close(got, jmodels.NlmDenoiser(jax_params(NP_), layout=layout)(img))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_temporal_nlm_denoiser_matches_jax(layout):
    target = _frame(0)
    frames = np.stack([_frame(i) for i in range(3)])
    model = models.TemporalNlmDenoiser(NP_, layout=layout)
    jmodel = jmodels.TemporalNlmDenoiser(jax_params(NP_), layout=layout)
    _close(model(_t(target), _t(frames)), jmodel(target, frames))
    # the streaming form folds the same partials
    carry = None
    for f in frames:
        carry = model.accumulate_one(_t(target), _t(f), carry)
    _close(model.finalize(carry), jmodel(target, frames), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_temporal_state_carried_from_jax(layout):
    """JAX accumulates frames 0-1; the carry goes to numpy, then into the
    port, which folds frames 2-3 and finalizes: equal to the all-JAX run."""
    target = _frame(0)
    frames = [_frame(i) for i in range(4)]
    jmodel = jmodels.TemporalNlmDenoiser(jax_params(NP_), layout=layout)
    jcarry = None
    for f in frames[:2]:
        jcarry = jmodel.accumulate_one(target, f, jcarry)
    carry = models.carry_from_numpy(np.asarray(jcarry[0]), np.asarray(jcarry[1]), "cpu")
    model = models.TemporalNlmDenoiser(NP_, layout=layout)
    for f in frames[2:]:
        carry = model.accumulate_one(_t(target), _t(f), carry)
    _close(model.finalize(carry), jmodel(target, np.stack(frames)))


def test_unknown_layout_is_refused():
    with pytest.raises(ValueError):
        models.BilateralDenoiser(BP, layout="planar")
    with pytest.raises(ValueError):
        models.TemporalNlmDenoiser(NP_, layout="planar")
