"""The CUDA kernels on the card, at small shapes: each wrapper's kernel
against its plain version on the same device, the launch counts, the input
checks the kernels depend on, and one Session run on the card.

These tests need an NVIDIA GPU and nvcc; without a card they skip. On the
machine with the card: python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu.config import (
    GPU_BATTERY,
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    NormalizeParams,
)
from image_denoising_filter_tpu.utils import imageio
from image_denoising_filter_tpu_torch.ops import stencils
from image_denoising_filter_tpu_torch.runtime import Session

pytestmark = pytest.mark.cuda

BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    stencils.reset_launches()
    return torch.device("cuda")


def _image(seed, device, h=29, w=37):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    img[..., 3] = 1.0
    return torch.from_numpy(img).to(device)


def _close(got, want, rtol=1e-4, atol=1e-5):
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "params",
    [
        BP,
        BilateralParams(),
        BilateralParams(border=BorderPolicy.ZERO, blue_bug=True),
        BilateralParams(radius=3, uniform_alpha=True),
    ],
    ids=["small", "reference", "zero_blue_bug", "uniform_alpha"],
)
def test_bilateral_kernel_matches_plain(cuda, params):
    img = _image(0, cuda)
    _close(stencils.bilateral(img, params), stencils.bilateral_plain(img, None, params, True)[0])
    assert stencils.launches["bilateral"] == 1


def test_guided_kernel_matches_plain(cuda):
    target, layer = _image(0, cuda), _image(1, cuda)
    wc, nw = stencils.cross_bilateral_layers(target, layer, LP)
    pwc, pnw = stencils.bilateral_plain(target, layer, LP, False)
    _close(wc, pwc)
    _close(nw, pnw)
    assert stencils.launches["bilateral_guided"] == 1


@pytest.mark.parametrize(
    "params,tol",
    [
        (NP_, {}),
        (NlmParams(search_radius=5, patch_radius=2, search_stride=2, search_disk=True,
                   border=BorderPolicy.ZERO), {}),
        (NlmParams(uniform_alpha=True), dict(rtol=2e-4, atol=1e-4)),
    ],
    ids=["small", "stride2_disk_zero", "reference_uniform_alpha"],
)
def test_nlm_kernel_matches_plain(cuda, params, tol):
    target = _image(0, cuda)
    frames = torch.stack([_image(i, cuda) for i in range(3)])
    valid = torch.tensor([1.0, 0.0, 1.0], device=cuda)
    wc, nw = stencils.nlm_accumulate_frames(target, frames, params, None, valid)
    pwc, pnw = stencils.nlm_plain(target, frames, params, valid)
    _close(wc, pwc, **tol)
    _close(nw, pnw, **tol)
    assert stencils.launches["nlm"] == 1


def test_normalize_kernel_matches_plain_exactly(cuda):
    wc = torch.rand(29, 37, 4, device=cuda) * 5
    nw = torch.rand(29, 37, device=cuda) + 0.5
    nw[::4, ::3] = 0.0
    got = stencils.normalize(wc, nw)
    torch.testing.assert_close(got, stencils.normalize_plain(wc, nw, NormalizeParams()),
                               rtol=0, atol=0)
    assert stencils.launches["normalize"] == 1


def test_kernels_refuse_what_they_cannot_take(cuda):
    img = _image(0, cuda)
    with pytest.raises(ValueError):  # not contiguous
        stencils.bilateral(img.transpose(0, 1), BP)
    with pytest.raises(ValueError):  # mixed devices
        stencils.cross_bilateral_layers(img, img.cpu(), LP)
    with pytest.raises(ValueError):  # more candidates than the kernel's table
        stencils.nlm_accumulate(img, img, NlmParams(search_radius=17, patch_radius=1))
    assert all(n == 0 for n in stencils.launches.values())


@pytest.mark.parametrize("cfg", GPU_BATTERY, ids=lambda c: c.output_name(False))
def test_session_on_card_matches_cpu(cuda, tmp_path, cfg):
    root = tmp_path / "anim"
    (root / "RenderElements").mkdir(parents=True)
    for i in range(3):
        imageio.save(str(root / f"frame_{i:04d}.png"), _image(i, "cpu").numpy())
    imageio.save(str(root / "RenderElements" / "albedo_0001.png"), _image(9, "cpu").numpy())
    target = str(root / "frame_0001.png")
    params = dict(bilateral_params=BP, layers_params=LP, nlm_params=NP_)
    out_gpu, out_cpu = tmp_path / "gpu", tmp_path / "cpu"
    out_gpu.mkdir()
    out_cpu.mkdir()
    got = Session(target, device=cuda, output_dir=str(out_gpu), **params).run(cfg)
    want = Session(target, device="cpu", output_dir=str(out_cpu), **params).run(cfg)
    np.testing.assert_allclose(got.image, want.image, rtol=1e-4, atol=1e-5)
    if not cfg.linear:
        assert sum(stencils.launches.values()) > 0
