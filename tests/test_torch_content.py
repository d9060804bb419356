"""The port's render generator (image_denoising_filter_tpu_torch/utils/
content.py): `synthetic_render_device` is the scene of `synthetic_render`
(tests/test_content.py's three tests, with the device twin on the CPU), and
agrees with the JAX package's `synthetic_render_device`.

The port's twin compares the surface masks in float64, as numpy does with the
float64 parameter draws; the JAX twin compares them in float32, which moves
a surface edge by a pixel where a coordinate falls between a draw and its
float32 rounding (120x200, seed 25 below; ROADMAP.md queue C).
"""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu.utils import content as jcontent
from image_denoising_filter_tpu_torch.utils.content import (
    synthetic_render,
    synthetic_render_device,
)

torch.set_num_threads(1)


def _device(h, w, seed):
    img = synthetic_render_device(h, w, seed, device="cpu")
    assert img.device.type == "cpu" and img.dtype == torch.float32
    return img.numpy()


def test_host_generator_equals_jax_package():
    np.testing.assert_array_equal(synthetic_render(64, 96, seed=4),
                                  jcontent.synthetic_render(64, 96, seed=4))


@pytest.mark.parametrize("h,w,seed", [(96, 160, 1), (120, 200, 25), (7, 3, 0)])
def test_device_generator_matches_host(h, w, seed):
    host = synthetic_render(h, w, seed=seed)
    dev = _device(h, w, seed)
    assert dev.shape == host.shape == (h, w, 4)
    assert dev.dtype == np.float32
    # Same parameter draws, same elementwise math: float32 rounding only.
    assert np.max(np.abs(dev - host)) < 2e-6


def test_device_generator_seeds_differ():
    a = _device(64, 128, 1)
    b = _device(64, 128, 2)
    assert np.max(np.abs(a - b)) > 0.05


def test_device_generator_range_and_alpha():
    img = _device(64, 128, 3)
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert np.all(img[..., 3] == 1.0)


def test_device_generator_matches_jax_device_generator():
    jax_img = np.asarray(jcontent.synthetic_render_device(96, 160, seed=1))
    assert np.max(np.abs(_device(96, 160, 1) - jax_img)) < 2e-6

