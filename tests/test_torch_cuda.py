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
from image_denoising_filter_tpu_torch.ops import fast, stencils
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


def _assert_bf16_close(got, want):
    """The stored-grid bf16 contract (tests/test_sharding.py): at most 2 bf16
    ulps apart, at most 1% of cells differing."""

    def key(x):
        b = x.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)

    assert int((key(got) - key(want)).abs().max()) <= 2
    assert float((got != want).float().mean()) <= 0.01


def _grid_inputs(img, d, border=BorderPolicy.CLAMP, levels=5):
    small = fast.pool_plain(img, d, border)
    return (small, *fast.grid_range(small, levels), fast._grid_taps(2.0, d))


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_pool_kernel_matches_plain(cuda, d, border):
    img = _image(0, cuda)
    _close(fast.pool(img, d, border), fast.pool_plain(img, d, border), rtol=1e-6, atol=0)
    assert stencils.launches["pool"] == 1


@pytest.mark.parametrize("ua", [False, True])
@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_build_grid_kernel_matches_plain(cuda, d, border, ua):
    small, lmin, step, taps = _grid_inputs(_image(0, cuda), d, border)
    args = (small, lmin, step, 5, taps, border, 12.5, ua)
    _assert_bf16_close(fast.build_grid(*args), fast.build_grid_plain(*args))
    assert stencils.launches["build_grid"] == 1


def test_build_grid_kernel_matches_plain_at_sigma_s_6(cuda):
    """d = 8 at sigma_s 6, as `--turbo 8 --sigma-spatial 6` runs it: 7 blur
    taps where sigma_s 2 gives 3."""
    img = _image(0, cuda, 61, 83)
    small = fast.pool_plain(img, 8, BorderPolicy.CLAMP)
    taps = fast._grid_taps(6.0, 8)
    assert taps.size == 7
    args = (small, *fast.grid_range(small, 6), 6, taps, BorderPolicy.CLAMP, 12.5)
    _assert_bf16_close(fast.build_grid(*args), fast.build_grid_plain(*args))
    assert stencils.launches["build_grid"] == 1


@pytest.mark.parametrize("ua", [False, True])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_slice_grid_kernel_matches_plain(cuda, d, ua):
    img = _image(0, cuda)
    small, lmin, step, taps = _grid_inputs(img, d)
    grid = fast.build_grid_plain(small, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5, ua)
    args = (img, grid, lmin, 1.0 / step, d, img[0, 0, 3] if ua else None)
    _close(fast.slice_grid(*args), fast.slice_grid_plain(*args), rtol=1e-5, atol=1e-6)
    assert stencils.launches["slice_grid"] == 1


@pytest.mark.parametrize("d", [2, 4, 8])
def test_turbo_pipeline_on_card_matches_plain(cuda, d):
    img = _image(0, cuda)
    got = fast.bilateral_fast(img, BilateralParams(), 5, d)
    want = fast.grid_pipeline_plain(img, BilateralParams(), 5, d)
    # a build flip (at most 2 bf16 ulps, the grid contract) reaches the
    # output through the slice's convex weights
    _close(got, want, rtol=0, atol=2 * 2.0**-8)
    assert {k: stencils.launches[k] for k in ("pool", "build_grid", "slice_grid")} == {
        "pool": 1, "build_grid": 1, "slice_grid": 1}


def test_grid_kernels_refuse_what_they_cannot_take(cuda):
    img = _image(0, cuda)
    small, lmin, step, taps = _grid_inputs(img, 2)
    grid = fast.build_grid_plain(small, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5)
    with pytest.raises(ValueError):  # not contiguous
        fast.pool(img.transpose(0, 1), 2)
    with pytest.raises(TypeError):  # not float32
        fast.pool(img.half(), 2)
    with pytest.raises(ValueError):  # more taps than the kernel's table
        fast.build_grid(small, lmin, step, 5, np.ones(65, np.float32) / 65,
                        BorderPolicy.CLAMP, 12.5)
    with pytest.raises(ValueError):  # d outside {2, 4, 8}
        fast.pool(img, 3)
    with pytest.raises(ValueError):  # not contiguous
        fast.slice_grid(img, grid.transpose(1, 2).contiguous().transpose(1, 2), lmin,
                        1.0 / step, 2)
    assert all(n == 0 for n in stencils.launches.values())


@pytest.mark.parametrize("d", [1, 2])
def test_run_turbo_on_card_matches_cpu(cuda, tmp_path, d):
    root = tmp_path / "anim"
    root.mkdir()
    img = _image(3, "cpu").numpy()
    img[..., :3] = 0.3 + 0.4 * img[..., :3]
    target = str(root / "frame_0001.png")
    imageio.save(target, img)
    out_gpu, out_cpu = tmp_path / "gpu", tmp_path / "cpu"
    out_gpu.mkdir()
    out_cpu.mkdir()
    got = Session(target, device=cuda, output_dir=str(out_gpu)).run_turbo(GPU_BATTERY[0], downsample=d)
    want = Session(target, device="cpu", output_dir=str(out_cpu)).run_turbo(
        GPU_BATTERY[0], downsample=d
    )
    np.testing.assert_allclose(got.image, want.image, rtol=0, atol=2 * 2.0**-8)
    turbo = [stencils.launches[k] for k in ("pool", "build_grid", "slice_grid")]
    assert all(n > 0 for n in turbo) if d > 1 else sum(stencils.launches.values()) == 0


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
