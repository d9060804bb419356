"""The port's NumPy oracles (image_denoising_filter_tpu_torch/ops/reference.py)
equal the JAX package's bit for bit, and the parity reading: the port's
bilateral at the CPU path's parameters against the CPU bilateral oracle, over
interior RGB, as bench.py:1104-1119 takes it and tests/test_parity.py:27-43
gates it (at least 59 dB; float roundoff, at least 100 dB, on the CPU).

Each package's parameters come from its own config (`jax_params`); on the CPU
the port's `stencils.bilateral` takes its plain PyTorch version.
"""

import inspect

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu.ops import reference as jref
from image_denoising_filter_tpu_torch import config as pconfig
from image_denoising_filter_tpu_torch.config import BilateralParams, CpuBilateralParams
from image_denoising_filter_tpu_torch.ops import reference as ref
from image_denoising_filter_tpu_torch.ops import stencils
from test_torch_config import jax_params

torch.set_num_threads(1)


def _img(seed, h=20, w=24):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 4)).astype(np.float32)


def _norm_with_zeros():
    nw = np.random.default_rng(3).uniform(0.5, 2.0, (20, 24)).astype(np.float32)
    nw[::5, ::7] = 0.0
    return nw


# (function, its arguments from the port's dataclasses): each case runs once
# with the port's arguments through the port and once with the same values
# built from the JAX package's config through the JAX package.
CASES = {
    "_pad_clamp": ("_pad", lambda: (_img(0), 3, pconfig.BorderPolicy.CLAMP)),
    "_pad_zero": ("_pad", lambda: (_img(0), 2, pconfig.BorderPolicy.ZERO)),
    "_spatial_weight": ("_spatial_weight", lambda: (3, -2, 2.0)),
    "_color_ssd": ("_color_ssd", lambda: (_img(0), _img(1), False)),
    "_color_ssd_blue_bug": ("_color_ssd", lambda: (_img(0), _img(1), True)),
    "bilateral": ("bilateral_reference", lambda: (_img(0), BilateralParams(radius=3))),
    "bilateral_zero_blue_bug": ("bilateral_reference", lambda: (
        _img(0), BilateralParams(radius=2, border=pconfig.BorderPolicy.ZERO, blue_bug=True))),
    "cpu_bilateral": ("cpu_bilateral_reference", lambda: (_img(0, 32, 40), CpuBilateralParams())),
    "cpu_bilateral_default_params": ("cpu_bilateral_reference", lambda: (_img(1, 24, 30),)),
    "layers": ("cross_bilateral_layers_reference", lambda: (
        _img(0), _img(1), pconfig.LayersParams(radius=3))),
    "nlm": ("nlm_reference", lambda: (
        _img(0), _img(1), pconfig.NlmParams(search_radius=2, patch_radius=1))),
    "nlm_stride2_disk": ("nlm_reference", lambda: (
        _img(0), _img(1), pconfig.NlmParams(search_radius=3, patch_radius=1, search_stride=2,
                                            search_disk=True))),
    "normalize": ("normalize_reference", lambda: (_img(0), _norm_with_zeros())),
    "normalize_params": ("normalize_reference", lambda: (
        _img(0), _norm_with_zeros(), pconfig.NormalizeParams())),
    "ssim": ("ssim", lambda: (_img(0)[..., :3], _img(1)[..., :3])),
    "ssim_2d": ("ssim", lambda: (_img(0)[..., 0], _img(1)[..., 0], 2.0)),
    "psnr": ("psnr", lambda: (_img(0), _img(1))),
    "psnr_identical": ("psnr", lambda: (_img(0), _img(0))),
}


def _jax_args(args):
    return tuple(jax_params(a) if hasattr(a, "__dataclass_fields__") else a for a in args)


def _assert_identical(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_identical(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_every_oracle_is_copied():
    """The port's module has every function of the JAX package's, and the
    cases below call each of them."""
    def names(mod):
        return {n for n, f in inspect.getmembers(mod, inspect.isfunction)
                if f.__module__ == mod.__name__}

    assert names(ref) == names(jref)
    assert {fn for fn, _ in CASES.values()} == names(jref)


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_equals_jax_bit_for_bit(case):
    fn, make_args = CASES[case]
    args = make_args()
    _assert_identical(getattr(ref, fn)(*args), getattr(jref, fn)(*_jax_args(args)))


def _kernel_params(cp: CpuBilateralParams) -> BilateralParams:
    """The bilateral kernel at the CPU path's parameters, field by field as
    bench.py:1108-1113 builds it: radius 10, sigma_s 10, sigma_c 0.2, the
    blue-channel bug."""
    return BilateralParams(radius=cp.radius, sigma_spatial=cp.sigma_spatial,
                           sigma_color=cp.sigma_color, blue_bug=cp.blue_bug)


def _parity_reading(rng):
    img = rng.uniform(0, 1, (48, 64, 4)).astype(np.float32)
    cp = CpuBilateralParams()
    got = stencils.bilateral(torch.from_numpy(img), _kernel_params(cp)).numpy()
    r = cp.radius
    interior = (slice(r, -r), slice(r, -r), slice(0, 3))
    return img, got, interior


def test_psnr_parity_vs_cpu_reference(rng):
    """The 59 dB gate (BASELINE.md:15) on the interior: the CPU path zeroes a
    radius-wide border (src/main.cpp:1823-1828)."""
    img, got, interior = _parity_reading(rng)
    want = ref.cpu_bilateral_reference(img, CpuBilateralParams())
    db = ref.psnr(got[interior], want[interior])
    assert db >= 59.0, f"PSNR parity {db:.1f} dB < 59 dB"
    assert db >= 100.0  # float roundoff only: exp2 and a float32 sum in another order


def test_psnr_parity_through_the_jax_oracle_agrees(rng):
    img, got, interior = _parity_reading(rng)
    want = jref.cpu_bilateral_reference(img, jax_params(CpuBilateralParams()))
    db = jref.psnr(got[interior], want[interior])
    assert db >= 100.0
    assert db == ref.psnr(got[interior], ref.cpu_bilateral_reference(img)[interior])
