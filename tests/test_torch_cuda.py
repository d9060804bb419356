"""The CUDA kernels on the card, at small shapes: each wrapper's kernel
against its plain version on the same device, the launch counts, the input
checks the kernels depend on, and one Session run on the card; the parity
reading at the CPU path's parameters, the render generator on the card, and
the kernel events of a `gpu-denoise --profile` trace.

These tests need an NVIDIA GPU and nvcc; without a card they skip. On the
machine with the card: python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import (
    GPU_BATTERY,
    BilateralParams,
    BorderPolicy,
    CpuBilateralParams,
    LayersParams,
    NlmParams,
    NormalizeParams,
    TilingConfig,
)
from image_denoising_filter_tpu_torch.models import LayerGuidedDenoiser
from image_denoising_filter_tpu_torch.ops import fast, reference, stencils
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import content, imageio

pytestmark = pytest.mark.cuda

BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
# NLM at wide patches sums many candidates in another order than the plain
# version (chip_smoke.py: TOL_NLM)
TOL_NLM = dict(rtol=2e-4, atol=1e-4)


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


def _smooth_image(seed, device, h=40, w=56):
    """Smooth RGB ramps and an edge with a little noise, alpha 1."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 5.0), 0.5 + 0.4 * np.cos(yy / 4.0),
                    np.where(xx > w / 2, 0.8, 0.2), np.ones((h, w))], -1)
    img[..., :3] += rng.normal(0, 0.03, (h, w, 3))
    return torch.from_numpy(np.clip(img, 0, 1).astype(np.float32)).to(device)


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
    "params,tol,shape",
    [
        (NP_, {}, (29, 37)),
        (NlmParams(search_radius=5, patch_radius=2, search_stride=2, search_disk=True,
                   border=BorderPolicy.ZERO), {}, (29, 37)),
        (NlmParams(uniform_alpha=True), dict(rtol=2e-4, atol=1e-4), (29, 37)),
        (NP_, {}, (1, 64)),
        (NlmParams(search_radius=3, patch_radius=2, uniform_alpha=True), {}, (7, 300)),
        (NlmParams(search_radius=4, patch_radius=3, border=BorderPolicy.ZERO,
                   uniform_alpha=True), {}, (40, 5)),
        (NlmParams(search_radius=16, patch_radius=1), {}, (29, 37)),
        (NlmParams(search_radius=3, patch_radius=5, h=4.0), TOL_NLM, (29, 37)),
        (NlmParams(search_radius=2, patch_radius=6, h=4.0, border=BorderPolicy.ZERO,
                   uniform_alpha=True), TOL_NLM, (40, 5)),
        (NlmParams(search_radius=4, patch_radius=7, h=5.0, search_stride=2, search_disk=True),
         TOL_NLM, (7, 300)),
        (NlmParams(search_radius=16, patch_radius=8, h=6.0), TOL_NLM, (29, 37)),
    ],
    ids=["small", "stride2_disk_zero", "reference_uniform_alpha", "small_1x64",
         "clamp_ua_7x300", "zero_ua_40x5", "s16_1024_candidates", "p5", "p6_zero_ua_40x5",
         "p7_stride2_disk_7x300", "p8_s16_1024_candidates"],
)
def test_nlm_kernel_matches_plain(cuda, params, tol, shape):
    """F = 3 with the middle frame masked, on shapes that are not multiples
    of the kernel's tiles (one row; narrower than 2s), both borders,
    uniform alpha, and the largest table (s = 16, 1024 candidates, its
    window above 48 KB of shared memory); patch radii 5 to 8, which take the
    staged body (h raised so that the random patches still weigh)."""
    target = _image(0, cuda, *shape)
    frames = torch.stack([_image(i, cuda, *shape) for i in range(3)])
    valid = torch.tensor([1.0, 0.0, 1.0], device=cuda)
    wc, nw = stencils.nlm_accumulate_frames(target, frames, params, None, valid)
    pwc, pnw = stencils.nlm_plain(target, frames, params, valid)
    _close(wc, pwc, **tol)
    _close(nw, pnw, **tol)
    assert stencils.launches["nlm"] == 1


@pytest.mark.parametrize(
    "params,shape,bf16",
    [
        (NlmParams(), (55, 39), False),
        (NlmParams(uniform_alpha=True), (82, 70), False),
        (NlmParams(search_radius=4, patch_radius=1), (32, 41), False),
        (NlmParams(search_radius=3, patch_radius=2, border=BorderPolicy.ZERO), (30, 45), False),
        (NlmParams(search_radius=5, patch_radius=4, h=4.0), (26, 35), False),
        (NlmParams(border=BorderPolicy.ZERO), (28, 33), False),
        (NlmParams(search_stride=2), (55, 39), True),
        (NlmParams(search_stride=2, search_disk=True, border=BorderPolicy.ZERO), (28, 70), True),
        (NlmParams(search_stride=2, uniform_alpha=True), (3, 130), True),
        (NlmParams(search_radius=9, patch_radius=2, search_stride=3), (40, 37), False),
        (NlmParams(search_radius=0), (55, 39), False),
        (NlmParams(search_radius=0, border=BorderPolicy.ZERO), (55, 39), True),
    ],
    ids=["reference_55x39", "reference_ua_82x70", "p1_32x41", "p2_zero_30x45", "p4_26x35",
         "reference_zero_28x33", "stride2_bf16_55x39", "stride2_disk_zero_bf16_28x70",
         "stride2_ua_bf16_3x130", "stride3_40x37", "s0_55x39", "s0_zero_bf16_55x39"],
)
def test_nlm_sliding_body_matches_plain(cuda, params, shape, bf16):
    """The sliding body (patch radii 1-4) on shapes whose rows are not a
    multiple of a warp's 33 - 2p output rows and whose columns are not a
    multiple of a lane's segment, F = 4 with the second frame masked, each
    frame's alpha its own random plane (general alpha; 1 where alpha is
    uniform), both borders and tap forms, strides 1-3 (a stride of 3 slides
    the ring three columns a candidate) and search radius 0 (the seeds
    only)."""
    gen = np.random.default_rng(5)
    imgs = []
    for i in range(5):
        img = _smooth_image(i, "cpu", *shape)
        if not params.uniform_alpha:
            img[..., 3] = torch.from_numpy(gen.uniform(0.25, 1.0, shape).astype(np.float32))
        imgs.append(img.to(cuda))
    target, frames = imgs[0], torch.stack(imgs[1:])
    valid = torch.tensor([1.0, 0.0, 1.0, 1.0], device=cuda)
    tiling = TilingConfig(compute_dtype="bfloat16") if bf16 else None
    wc, nw = stencils.nlm_accumulate_frames(target, frames, params, tiling, valid)
    pwc, pnw = stencils.nlm_plain(target, frames, params, valid,
                                  "bfloat16" if bf16 else "float32")
    _close(wc, pwc, **TOL_NLM)
    _close(nw, pnw, **TOL_NLM)
    assert stencils.launches["nlm_bf16" if bf16 else "nlm"] == 1


def test_nlm_launcher_refuses_a_window_that_misses_a_tap(cuda):
    """The C launcher checks the tile against every candidate before it
    launches: a window one row short is refused with cudaErrorInvalidValue
    (1)."""
    img = _image(0, cuda)
    out, nw = torch.empty_like(img), torch.empty(img.shape[:2], device=cuda)
    valid = torch.ones(1, device=cuda)
    tile = stencils.nlm_tile(NP_, False, stencils.max_shared_bytes(img.device))
    short = tile.launch_args()
    short[4] -= 1  # win_h
    short[7:] = stencils.nlm_layout(tile.th, tile.tw, tile.p, tile.win_h - 1, tile.pitch, False)
    cands = np.asarray(stencils.nlm_candidates(NP_), np.int32).reshape(-1)
    lib = stencils._build.library()
    for geom, want in ((tile.launch_args(), 0), (short, 1)):
        rc = lib.idf_nlm(img.data_ptr(), img.data_ptr(), valid.data_ptr(), out.data_ptr(),
                         nw.data_ptr(), 29, 37, 1, NP_.patch_radius, cands.ctypes.data,
                         cands.size // 2, -1.0, 0.0, 0.001, 0, 0, 0, geom.ctypes.data,
                         stencils._stream(img))
        assert rc == want
    torch.cuda.synchronize()


@pytest.mark.parametrize("kernel,params", [("nlm", NlmParams()),
                                           ("nlm_bf16", NlmParams(search_stride=2)),
                                           ("nlm", NlmParams(patch_radius=6))])
def test_nlm_kernel_info(cuda, kernel, params):
    """The reference tiles (the sliding body's 27 x 32 at p = 3), and a patch
    radius above the unrolled ones (the staged body's 16 x 32), launch:
    registers without spills, and at least two blocks a multiprocessor."""
    info = stencils.kernel_info(kernel, cuda, params)
    assert info["tile"] == ("16x32" if params.patch_radius > 4 else "27x32")
    assert info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= 2 and 0 < info["registers"] <= 255


@pytest.mark.parametrize("shape", [(29, 37), (1, 1023), (2160, 3840)],
                         ids=["29x37", "1x1023", "4K"])
def test_normalize_kernel_matches_plain_exactly(cuda, shape):
    """Pixel counts that are not a multiple of the 256 pixels a block takes
    (a ragged last block), and a 4K frame."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    wc = torch.rand(*shape, 4, device=cuda, generator=gen) * 5
    nw = torch.rand(*shape, device=cuda, generator=gen) + 0.5
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
    with pytest.raises(ValueError):  # no box to sum
        stencils.nlm_accumulate(img, img, NlmParams(search_radius=2, patch_radius=0))
    with pytest.raises(ValueError):  # no tile of this patch radius fits the card
        stencils.nlm_accumulate(img, img, NlmParams(search_radius=16, patch_radius=26))
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
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_build_grid_kernel_matches_plain(cuda, d, border, ua):
    small, lmin, step, taps = _grid_inputs(_image(0, cuda), d, border)
    args = (small, lmin, step, 5, taps, border, 12.5, ua)
    _assert_bf16_close(fast.build_grid(*args, d=d), fast.build_grid_plain(*args))
    assert stencils.launches[_form("build_grid", d)] == 1


def test_build_grid_kernel_matches_plain_at_sigma_s_6(cuda):
    """d = 8 at sigma_s 6, as `--turbo 8 --sigma-spatial 6` runs it: 7 blur
    taps where sigma_s 2 gives 3."""
    img = _image(0, cuda, 61, 83)
    small = fast.pool_plain(img, 8, BorderPolicy.CLAMP)
    taps = fast._grid_taps(6.0, 8)
    assert taps.size == 7
    args = (small, *fast.grid_range(small, 6), 6, taps, BorderPolicy.CLAMP, 12.5)
    _assert_bf16_close(fast.build_grid(*args, d=8), fast.build_grid_plain(*args))
    assert stencils.launches["build_grid"] == 1


@pytest.mark.parametrize("ua", [False, True])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_slice_grid_kernel_matches_plain(cuda, d, ua):
    img = _image(0, cuda)
    small, lmin, step, taps = _grid_inputs(img, d)
    grid = fast.build_grid_plain(small, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5, ua)
    args = (img, grid, lmin, 1.0 / step, d, img[0, 0, 3] if ua else None)
    _close(fast.slice_grid(*args), fast.slice_grid_plain(*args), rtol=1e-5, atol=1e-6)
    assert stencils.launches[_form("slice_grid", d)] == 1


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


@pytest.mark.parametrize("sigma_s", [2.0, 6.0])
def test_grid_pipeline_at_d1_on_card_matches_plain(cuda, sigma_s):
    """The sharded turbo's pipeline at d = 1 on one device (17 blur taps at
    sigma_s 2, 49 at 6): the three kernels, within a build flip of the
    plain pipeline; bilateral_fast at d = 1 stays the eager lattice and
    launches none of them."""
    img = _image(0, cuda, 61, 83)
    bp = BilateralParams(sigma_spatial=sigma_s)
    got = fast.grid_pipeline(img, bp, 6, 1)
    _close(got, fast.grid_pipeline_plain(img, bp, 6, 1), rtol=0, atol=2 * 2.0**-8)
    counts = {k: n for k, n in stencils.launches.items() if n}
    assert counts == {"pool": 1, "build_grid_d1": 1, "slice_grid_d1": 1}
    stencils.reset_launches()
    fast.bilateral_fast(img, bp, 6, 1)
    assert all(n == 0 for n in stencils.launches.values())


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
                        BorderPolicy.CLAMP, 12.5, d=2)
    with pytest.raises(ValueError):  # d outside {1, 2, 4, 8}
        fast.pool(img, 3)
    with pytest.raises(ValueError):  # no fused bilateral kernel at d = 1
        fast.fused_grid(img, img, lmin, step, 1.0 / step, 5, fast._grid_taps(2.0, 1),
                        BorderPolicy.CLAMP, 12.5, 1)
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


# ---------------------------------------------------------------------------
# The guided grid (turbo layers) and the bf16 NLM taps (turbo NLM)
# ---------------------------------------------------------------------------


def _guided_inputs(d, border=BorderPolicy.CLAMP, levels=5, sigma_s=2.0, h=29, w=37):
    target, layer = _image(0, "cuda", h, w), _image(1, "cuda", h, w)
    small_t = fast.pool_plain(target, d, border)
    small_l = fast.pool_plain(layer, d, border)
    lmin, step = fast.grid_range(small_l, levels)
    return target, layer, small_t, small_l, lmin, step, fast._grid_taps(sigma_s, d)


def test_pool_kernel_at_d1_is_a_bf16_round_trip(cuda):
    img = _image(0, cuda)
    got = fast.pool(img, 1)
    torch.testing.assert_close(got, img.to(torch.bfloat16).float(), rtol=0, atol=0)
    assert stencils.launches["pool"] == 1


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_build_guided_grid_kernel_matches_plain(cuda, d, border):
    _, _, small_t, small_l, lmin, step, taps = _guided_inputs(d, border)
    args = (small_t, small_l, lmin, step, 5, taps, border, 12.5)
    _assert_bf16_close(fast.build_guided_grid(*args, d=d), fast.build_guided_grid_plain(*args))
    assert stencils.launches[_form("build_guided_grid", d)] == 1


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_slice_guided_grid_kernel_matches_plain(cuda, d):
    _, layer, small_t, small_l, lmin, step, taps = _guided_inputs(d)
    grid = fast.build_guided_grid_plain(small_t, small_l, lmin, step, 5, taps,
                                        BorderPolicy.CLAMP, 12.5)
    got = fast.slice_guided_grid(layer, grid, lmin, 1.0 / step, d)
    want = fast.slice_guided_grid_plain(layer, grid, lmin, 1.0 / step, d)
    for g, w_ in zip(got, want):
        _close(g, w_, rtol=1e-5, atol=1e-6)
    assert stencils.launches[_form("slice_guided_grid", d)] == 1


def _form(kernel, d):
    """The launch count name of a grid kernel at downsample d: the wrappers
    count d = 1 under "<kernel>_d1"."""
    return f"{kernel}_d1" if d == 1 else kernel


def _slab_of(grid, gy_off, rows):
    """Grid rows [gy_off, gy_off + rows) of a whole-image grid; a row above
    the image (gy_off = -1) is NaN, which the slice must never read."""
    slab = torch.full((grid.shape[0], rows) + tuple(grid.shape[2:]), float("nan"),
                      dtype=grid.dtype, device=grid.device)
    lo, hi = max(gy_off, 0), min(gy_off + rows, grid.shape[1])
    slab[:, lo - gy_off : hi - gy_off] = grid[:, lo:hi]
    return slab


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_slice_kernels_whole_image_offsets_change_nothing(cuda, d):
    """The slab arguments (0, hs, 0) are the whole-image slice, bit for bit."""
    img = _image(0, cuda)
    small, lmin, step, taps = _grid_inputs(img, d)
    grid = fast.build_grid_plain(small, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5)
    hs = grid.shape[1]
    want = fast.slice_grid(img, grid, lmin, 1.0 / step, d)
    got = fast.slice_grid(img, grid, lmin, 1.0 / step, d, None, 0, hs, 0)
    assert torch.equal(got, want)
    _, layer, small_t, small_l, lmin, step, taps = _guided_inputs(d)
    ggrid = fast.build_guided_grid_plain(small_t, small_l, lmin, step, 5, taps,
                                         BorderPolicy.CLAMP, 12.5)
    want = fast.slice_guided_grid(layer, ggrid, lmin, 1.0 / step, d)
    got = fast.slice_guided_grid(layer, ggrid, lmin, 1.0 / step, d, 0, ggrid.shape[1], 0)
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    assert stencils.launches[_form("slice_grid", d)] == 2
    assert stencils.launches[_form("slice_guided_grid", d)] == 2


@pytest.mark.parametrize("ua", [False, True])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_slice_kernels_on_a_slab_equal_the_whole_slice(cuda, d, ua):
    """Each band of a 4-way row split, sliced against its slab of rows_s + 2
    grid rows (the sharded turbo's), equals the whole-image slice's rows bit
    for bit, the outermost bands included (their row above or below the
    image is NaN and unread), and the plain slab slice to its tolerance."""
    h, w = 16 * d, 37
    img = _image(0, cuda, h, w)
    small, lmin, step, taps = _grid_inputs(img, d)
    grid = fast.build_grid_plain(small, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5, ua)
    alpha = img[0, 0, 3] if ua else None
    whole = fast.slice_grid(img, grid, lmin, 1.0 / step, d, alpha)
    _, layer, small_t, small_l, glmin, gstep, gtaps = _guided_inputs(d, h=h, w=w)
    ggrid = fast.build_guided_grid_plain(small_t, small_l, glmin, gstep, 5, gtaps,
                                         BorderPolicy.CLAMP, 12.5)
    gwhole = fast.slice_guided_grid(layer, ggrid, glmin, 1.0 / gstep, d)
    rows, hs = h // 4, h // d
    for i in range(4):
        band = slice(i * rows, (i + 1) * rows)
        offsets = (i * rows, hs, i * rows // d - 1)
        slab = _slab_of(grid, offsets[2], rows // d + 2)
        args = (img[band].contiguous(), slab, lmin, 1.0 / step, d, alpha)
        got = fast.slice_grid(*args, *offsets)
        assert torch.equal(got, whole[band]), f"band {i}"
        _close(got, fast.slice_grid_plain(*args, offsets), rtol=1e-5, atol=1e-6)
        gslab = _slab_of(ggrid, offsets[2], rows // d + 2)
        gargs = (layer[band].contiguous(), gslab, glmin, 1.0 / gstep, d)
        got = fast.slice_guided_grid(*gargs, *offsets)
        assert all(torch.equal(g, w_[band]) for g, w_ in zip(got, gwhole)), f"band {i}"
        for g, w_ in zip(got, fast.slice_guided_grid_plain(*gargs, offsets)):
            _close(g, w_, rtol=1e-5, atol=1e-6)
    assert stencils.launches[_form("slice_grid", d)] == 5
    assert stencils.launches[_form("slice_guided_grid", d)] == 5


def test_slice_launchers_refuse_a_band_off_the_lattice(cuda):
    """y_off must be a multiple of d (the wrapper raises before the C
    launcher, which refuses it too)."""
    img = _image(0, cuda, 32, 37)
    small, lmin, step, taps = _grid_inputs(img, 2)
    grid = fast.build_grid_plain(small, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5)
    with pytest.raises(ValueError):
        fast.slice_grid(img[:8].contiguous(), grid[:, :6].contiguous(), lmin, 1.0 / step, 2,
                        None, 1, 16, 0)
    with pytest.raises(ValueError):  # the slab misses rows the band reads
        fast.slice_grid(img[8:16].contiguous(), grid[:, :4].contiguous(), lmin, 1.0 / step,
                        2, None, 8, 16, 0)
    assert stencils.launches["slice_grid"] == 0


# ---------------------------------------------------------------------------
# The two slices at d = 1: the bilateral grid's own-cell instance, and the
# guided slice's one kernel. The instance is held to its plain version and
# also to the bilinear kernel's bytes (idf_slice_grid_bilinear): the plain
# version is PyTorch's arithmetic, while the bilinear kernel is what wrote
# every --turbo 1 --mesh file before the instance existed, so the second
# comparison shows those files unchanged on the ragged widths, short heights
# and slab bands that tools/torch_kernel_ab.py's 1080p case does not reach.
# ---------------------------------------------------------------------------


def _bilinear(guide, grid, lmin, inv_step, d, alpha, slab=None):
    """slice_grid's launch through idf_slice_grid_bilinear: slice_grid_kernel,
    the d >= 2 kernel, at any d."""
    h, w, _ = guide.shape
    levels, hs, ws, _ = grid.shape
    y_off, hs_all, gy_off = (0, hs, 0) if slab is None else slab
    out = torch.empty_like(guide)
    rc = stencils._build.library().idf_slice_grid_bilinear(
        guide.data_ptr(), grid.data_ptr(), lmin.data_ptr(), inv_step.data_ptr(),
        None if alpha is None else alpha.data_ptr(), out.data_ptr(), h, w, hs, ws, levels, d,
        y_off, hs_all, gy_off, torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


def _same_bits(a, b):
    """torch.equal on the float32 words: -0.0 and +0.0 differ."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _d1_frame(seed, device, h, w, hdr):
    """A frame whose RGB spans [0, 1], or [-5, 40] (HDR), its first pixel at
    the range's low end and its last at the high end."""
    img = _image(seed, device, h, w)
    if hdr:
        img[..., :3] = img[..., :3] * 45.0 - 5.0
    img[0, 0, :3] = img[..., :3].amin((0, 1))
    img[-1, -1, :3] = img[..., :3].amax((0, 1))
    return img


D1_SHAPES = [(1, 1), (1, 31), (9, 33), (9, 37), (1, 97), (9, 64), (29, 37)]


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
@pytest.mark.parametrize("ua", [False, True])
@pytest.mark.parametrize("h,w", D1_SHAPES)
def test_slice_grid_d1_instance_is_plain_and_bilinear_bit_for_bit(cuda, h, w, ua, hdr):
    """slice_grid at d = 1 launches the own-cell instance: its plain version
    bit for bit, and the bilinear kernel's bytes at d = 1 (widths 1, 31, 33
    and others no 32-thread block row divides; heights 1 and 9)."""
    img = _d1_frame(0, cuda, h, w, hdr)
    small, lmin, step, taps = _grid_inputs(img, 1, levels=6)
    grid = fast.build_grid_plain(small, lmin, step, 6, taps, BorderPolicy.CLAMP, 12.5, ua)
    args = (img, grid, lmin, 1.0 / step, 1, img[0, 0, 3] if ua else None)
    got = fast.slice_grid(*args)
    assert stencils.launches["slice_grid_d1"] == 1
    assert _same_bits(got, fast.slice_grid_plain(*args))
    assert _same_bits(got, _bilinear(*args))


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
@pytest.mark.parametrize("h,w", D1_SHAPES)
def test_slice_guided_grid_at_d1_is_plain_bit_for_bit(cuda, h, w, hdr):
    target, layer = _d1_frame(0, cuda, h, w, hdr), _d1_frame(1, cuda, h, w, hdr)
    small_t = fast.pool_plain(target, 1, BorderPolicy.CLAMP)
    small_l = fast.pool_plain(layer, 1, BorderPolicy.CLAMP)
    lmin, step = fast.grid_range(small_l, 6)
    grid = fast.build_guided_grid_plain(small_t, small_l, lmin, step, 6, fast._grid_taps(2.0, 1),
                                        BorderPolicy.CLAMP, 12.5)
    args = (layer, grid, lmin, 1.0 / step, 1)
    got = fast.slice_guided_grid(*args)
    assert stencils.launches["slice_guided_grid_d1"] == 1
    assert all(_same_bits(g, p) for g, p in zip(got, fast.slice_guided_grid_plain(*args)))


@pytest.mark.parametrize("levels", [2, 8])
def test_slices_at_d1_on_a_negative_zero_grid(cuda, levels):
    """K = 2 and 8 on a random bf16 grid N(0, 3) with -0.0 cells, the guide
    at t = 0, K - 1, whole levels and beyond both ends: the bilateral
    instance its plain version and the bilinear kernel bit for bit, the
    guided slice its plain version."""
    rng = np.random.default_rng(levels)
    img = _image(2, cuda, 9, 37)
    lmin = torch.zeros(3, device=cuda)
    inv_step = torch.full((3,), float(levels - 1), device=cuda)
    img[0, :8, :3] = torch.tensor([0.0, 1.0, 0.5, -1.0, 2.0, 0.25, 1.0 / (levels - 1), 0.75],
                                  device=cuda)[:, None]
    for planes in (4, 8):
        cells = rng.normal(0, 3, (levels, 9, 37, planes)).astype(np.float32)
        cells[:, ::3, ::4] = -0.0
        grid = torch.from_numpy(cells).to(cuda).to(torch.bfloat16)
        if planes == 4:
            args = (img, grid, lmin, inv_step, 1, None)
            got = fast.slice_grid(*args)
            assert _same_bits(got, fast.slice_grid_plain(*args))
            assert _same_bits(got, _bilinear(*args))
        else:
            args = (img, grid, lmin, inv_step, 1)
            got, want = fast.slice_guided_grid(*args), fast.slice_guided_grid_plain(*args)
            assert all(_same_bits(g, w_) for g, w_ in zip(got, want))


def test_slice_grid_d1_instance_reads_no_level_its_tents_skip(cuda):
    """Where the two kernels differ: on a grid with non-finite cells. A cell
    at a level no channel's tent touches, or a channel's plane at a level
    only another channel's tent touches, enters the sums over levels as
    0 * inf = NaN (slice_grid_plain every level, the bilinear kernel the
    levels any channel touches); the instance never reads it, so its output
    is the finite grid's. A finite frame builds a finite grid (the build
    clamps its normaliser), so no path of the port meets this."""
    levels = 6
    img = _image(3, cuda, 9, 37)
    img[..., :3] = torch.tensor([0.1, 0.7, 0.8], device=cuda)  # t = 0.5, 3.5, 4
    lmin = torch.zeros(3, device=cuda)
    inv_step = torch.full((3,), float(levels - 1), device=cuda)
    cells = np.random.default_rng(3).normal(0, 3, (levels, 9, 37, 4)).astype(np.float32)
    finite = torch.from_numpy(cells).to(cuda).to(torch.bfloat16)
    grid = finite.clone()
    grid[2] = float("inf")  # no channel's level
    grid[3, ..., 0] = float("inf")  # red's plane at green's level
    args = (lmin, inv_step, 1, None)
    got = fast.slice_grid(img, grid, *args)
    assert _same_bits(got, fast.slice_grid_plain(img, finite, *args))
    assert fast.slice_grid_plain(img, grid, *args).isnan().all()
    old = _bilinear(img, grid, *args)
    assert old[..., 0].isnan().all() and _same_bits(old[..., 1:], got[..., 1:])


@pytest.mark.parametrize("ua", [False, True])
def test_slices_at_d1_on_four_slab_bands(cuda, ua):
    """The slab form at d = 1 on the four bands of a 1x4 split (y_off, hs_all,
    gy_off as the sharded turbo gives them): each band of the bilateral grid
    the plain slab slice and the bilinear kernel's bit for bit, each band of
    the guided grid its plain slab slice."""
    h, w = 36, 37
    img = _d1_frame(0, cuda, h, w, True)
    small, lmin, step, taps = _grid_inputs(img, 1, levels=6)
    grid = fast.build_grid_plain(small, lmin, step, 6, taps, BorderPolicy.CLAMP, 12.5, ua)
    alpha = img[0, 0, 3] if ua else None
    _, layer, small_t, small_l, glmin, gstep, gtaps = _guided_inputs(1, levels=6, h=h, w=w)
    ggrid = fast.build_guided_grid_plain(small_t, small_l, glmin, gstep, 6, gtaps,
                                         BorderPolicy.CLAMP, 12.5)
    rows = h // 4
    for i in range(4):
        band = slice(i * rows, (i + 1) * rows)
        offsets = (i * rows, h, i * rows - 1)
        args = (img[band].contiguous(), _slab_of(grid, offsets[2], rows + 2), lmin, 1.0 / step,
                1, alpha)
        got = fast.slice_grid(*args, *offsets)
        assert _same_bits(got, fast.slice_grid_plain(*args, offsets)), f"band {i}"
        assert _same_bits(got, _bilinear(*args, slab=offsets)), f"band {i}"
        gargs = (layer[band].contiguous(), _slab_of(ggrid, offsets[2], rows + 2), glmin,
                 1.0 / gstep, 1)
        got = fast.slice_guided_grid(*gargs, *offsets)
        want = fast.slice_guided_grid_plain(*gargs, offsets)
        assert all(_same_bits(g, w_) for g, w_ in zip(got, want)), f"band {i}"
    assert stencils.launches["slice_grid_d1"] == stencils.launches["slice_guided_grid_d1"] == 4


def test_slice_grid_d1_launcher_refuses_a_grid_of_another_width(cuda):
    """The own-cell instance takes ws == w (d = 1); the C launcher refuses a
    grid whose width is not the image's, so a caller that bypasses the
    wrapper's checks gets an error, not a read past the grid."""
    img = _image(0, cuda, 9, 37)
    small, lmin, step, taps = _grid_inputs(img, 1, levels=6)
    grid = fast.build_grid_plain(small, lmin, step, 6, taps, BorderPolicy.CLAMP, 12.5)
    out, inv_step = torch.empty_like(img), 1.0 / step
    rc = stencils._build.library().idf_slice_grid(
        img.data_ptr(), grid.data_ptr(), lmin.data_ptr(), inv_step.data_ptr(), None,
        out.data_ptr(), 9, 37, 9, 36, 6, 1, 0, 9, 0, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


def test_sharded_dryrun_on_card(cuda):
    """parallel.dryrun on four ranks sharing the card over gloo: the
    temporal NLM, bilateral and layers against the oracles, the turbo grids
    bit for bit the single-device pipelines."""
    from image_denoising_filter_tpu_torch.parallel import dryrun

    counts = dryrun.dryrun(4, "cuda", "gloo")
    for kernel in ("bilateral", "bilateral_guided", "nlm", "nlm_hrw", "normalize", "pool",
                   "build_grid", "slice_grid", "build_guided_grid", "slice_guided_grid"):
        assert counts[kernel] > 0, kernel


@pytest.mark.parametrize(
    "d,border,shape",
    [(2, BorderPolicy.CLAMP, (29, 37)), (2, BorderPolicy.ZERO, (61, 300)),
     (4, BorderPolicy.CLAMP, (61, 300)), (8, BorderPolicy.ZERO, (61, 300))],
)
def test_fused_guided_kernel_equals_the_two_kernels(cuda, d, border, shape):
    """Each cell's sums in the build kernel's order and each pixel's in the
    slice kernel's: the fused kernel equals the two kernels bit for bit, on
    several tiles and ragged edges."""
    _, layer, small_t, small_l, lmin, step, taps = _guided_inputs(d, border, 6, 2.0, *shape)
    grid = fast.build_guided_grid(small_t, small_l, lmin, step, 6, taps, border, 12.5, d=d)
    two = fast.slice_guided_grid(layer, grid, lmin, 1.0 / step, d)
    got = fast.fused_guided(small_t, small_l, layer, lmin, step, 1.0 / step, 6, taps, border,
                            12.5, d)
    torch.cuda.synchronize()
    assert torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
    assert stencils.launches["fused_guided"] == 1


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_turbo_layers_on_card_match_plain(cuda, d):
    """cross_bilateral_layers_fast dispatches as the reference does: fused at
    d = 2 and 4, the two guided kernels at d = 1 and 8; against the same
    entry on CPU copies, which runs the plain versions."""
    target, layer = _image(0, cuda, 61, 83), _image(1, cuda, 61, 83)
    got = fast.cross_bilateral_layers_fast(target, layer, LayersParams(), 5, d)
    want = fast.cross_bilateral_layers_fast(target.cpu(), layer.cpu(), LayersParams(), 5, d)
    for g, w_ in zip(got, want):
        g = g.cpu()
        # a build flip (2 bf16 ulps of cells up to ~1) through the convex slice
        _close(g, w_, rtol=0, atol=2 * 2.0**-8)
    fused = stencils.launches["fused_guided"]
    two = (stencils.launches[_form("build_guided_grid", d)],
           stencils.launches[_form("slice_guided_grid", d)])
    assert (fused, two) == ((1, (0, 0)) if d in (2, 4) else (0, (1, 1)))
    assert stencils.launches["pool"] == 2


@pytest.mark.parametrize("d,n_taps,fits", [(2, 9, True), (4, 5, True), (8, 3, True),
                                           (2, 41, True), (2, 43, True), (2, 45, True),
                                           (2, 49, True), (4, 63, True), (1, 17, True),
                                           (2, 57, True), (2, 59, False), (2, 63, False)])
def test_fused_guided_shared_memory(cuda, d, n_taps, fits):
    """The fused kernel's window fits a block's shared memory on the H100 at
    the turbo battery's settings, up to 57 taps (radius 28) at d = 2, its
    tile shrinking from 16 x 64 pixels as the taps widen, and every tap table
    at d = 4; d = 1 (17 taps at sigma_s 2) fits too."""
    assert fast.fused_guided_fits(d, n_taps, cuda) == fits


def test_turbo_layers_at_wide_sigma_on_card_take_the_two_kernels(cuda):
    """At d = 2 and sigma_s 15.1 (63 taps; from 59 up) the fused window does
    not fit: the entry takes the guided build and slice, and the fused
    wrapper refuses."""
    target, layer = _image(0, cuda, 61, 83), _image(1, cuda, 61, 83)
    params = LayersParams(sigma_spatial=15.1)
    assert fast._grid_taps(15.1, 2).size == 63
    got = fast.cross_bilateral_layers_fast(target, layer, params, 5, 2)
    want = fast.cross_bilateral_layers_fast(target.cpu(), layer.cpu(), params, 5, 2)
    for g, w_ in zip(got, want):
        _close(g.cpu(), w_, rtol=0, atol=2 * 2.0**-8)
    assert stencils.launches["fused_guided"] == 0
    assert stencils.launches["build_guided_grid"] == stencils.launches["slice_guided_grid"] == 1
    _, _, small_t, small_l, lmin, step, _ = _guided_inputs(2, BorderPolicy.CLAMP, 5, 2.0, 61, 83)
    with pytest.raises(ValueError, match="shared memory"):
        fast.fused_guided(small_t, small_l, layer, lmin, step, 1.0 / step, 5,
                          fast._grid_taps(15.1, 2), BorderPolicy.CLAMP, 12.5, 2)


@pytest.mark.parametrize(
    "params,shape",
    [(NlmParams(search_stride=2), (40, 56)),
     (NlmParams(search_stride=2, search_disk=True), (40, 56)),
     (NlmParams(search_radius=5, patch_radius=2, search_stride=2, border=BorderPolicy.ZERO,
                uniform_alpha=True), (40, 56)),
     (NlmParams(search_stride=2), (29, 37)),
     (NlmParams(search_stride=2, border=BorderPolicy.ZERO), (1, 64)),
     (NlmParams(search_stride=2, search_disk=True, uniform_alpha=True), (7, 300)),
     (NlmParams(search_radius=5, patch_radius=2, search_stride=2), (40, 5)),
     (NlmParams(search_radius=16, patch_radius=1), (29, 37)),
     (NlmParams(search_radius=3, patch_radius=5), (29, 37)),
     (NlmParams(search_radius=2, patch_radius=6, border=BorderPolicy.ZERO, uniform_alpha=True),
      (40, 5)),
     (NlmParams(search_radius=4, patch_radius=7, search_stride=2, search_disk=True), (7, 300)),
     (NlmParams(search_radius=16, patch_radius=8), (29, 37))],
    ids=["stride2", "stride2_disk", "small_zero_ua", "stride2_29x37", "stride2_zero_1x64",
         "stride2_disk_ua_7x300", "small_40x5", "s16_1024_candidates", "p5",
         "p6_zero_ua_40x5", "p7_stride2_disk_7x300", "p8_s16_1024_candidates"],
)
def test_nlm_bf16_kernel_matches_plain(cuda, params, shape):
    """On smooth content, where many candidates carry weight, so one bf16
    rounding of a squared difference that the kernel skipped (a contracted
    multiply-add) would show. F = 3 with the middle frame masked; shapes
    that are not multiples of the kernel's tiles, both borders, uniform alpha
    and the largest table (s = 16, 1024 candidates); patch radii 5 to 8."""
    target = _smooth_image(0, cuda, *shape)
    frames = torch.stack([_smooth_image(i, cuda, *shape) for i in range(3)])
    valid = torch.tensor([1.0, 0.0, 1.0], device=cuda)
    bf16 = TilingConfig(compute_dtype="bfloat16")
    wc, nw = stencils.nlm_accumulate_frames(target, frames, params, bf16, valid)
    pwc, pnw = stencils.nlm_plain(target, frames, params, valid, "bfloat16")
    _close(wc, pwc, rtol=2e-4, atol=1e-4)
    _close(nw, pnw, rtol=2e-4, atol=1e-4)
    assert stencils.launches["nlm_bf16"] == 1 and stencils.launches["nlm"] == 0


@pytest.mark.parametrize("d", [1, 2, 8])
def test_run_turbo_layers_on_card_matches_cpu(cuda, tmp_path, d):
    root = tmp_path / "anim"
    (root / "RenderElements").mkdir(parents=True)
    imageio.save(str(root / "frame_0001.png"), _image(3, "cpu").numpy())
    for i, name in enumerate(("albedo", "normal")):
        imageio.save(str(root / "RenderElements" / f"{name}_0001.png"), _image(7 + i, "cpu").numpy())
    target = str(root / "frame_0001.png")
    out_gpu, out_cpu = tmp_path / "gpu", tmp_path / "cpu"
    out_gpu.mkdir()
    out_cpu.mkdir()
    got = Session(target, device=cuda, output_dir=str(out_gpu)).run_turbo(GPU_BATTERY[1], downsample=d)
    want = Session(target, device="cpu", output_dir=str(out_cpu)).run_turbo(
        GPU_BATTERY[1], downsample=d
    )
    # the normalized output divides the partials' flips by den (>= ~0.5 here)
    np.testing.assert_allclose(got.image, want.image, rtol=0, atol=4 * 2.0**-8)
    assert stencils.launches["bilateral_guided"] == 0


# ---------------------------------------------------------------------------
# The half-row NLM (--weights-halfres) and the fused bilateral grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "params,h,n_frames",
    [
        (NlmParams(search_stride=2, weights_halfres=True), 40, 1),
        (NlmParams(search_stride=2, weights_halfres=True, border=BorderPolicy.ZERO), 39, 1),
        (NlmParams(search_stride=2, weights_halfres=True, search_disk=True), 39, 3),
        (NlmParams(search_stride=2, weights_halfres=True, border=BorderPolicy.ZERO,
                   uniform_alpha=True), 40, 3),
    ],
    ids=["clamp_F1", "zero_odd_F1", "disk_odd_F3", "zero_ua_F3"],
)
def test_nlm_hrw_kernel_matches_plain(cuda, params, h, n_frames, bf16):
    """On smooth content, where many candidates carry weight: both tap forms,
    both borders, odd H (the last cell pools a border row), a masked frame."""
    target = _smooth_image(0, cuda, h)
    frames = torch.stack([_smooth_image(i, cuda, h) for i in range(n_frames)])
    valid = torch.tensor([1.0, 0.0, 1.0][:n_frames], device=cuda)
    tiling = TilingConfig(compute_dtype="bfloat16") if bf16 else None
    wc, nw = stencils.nlm_accumulate_frames(target, frames, params, tiling, valid)
    pwc, pnw = stencils.nlm_plain(target, frames, params, valid,
                                  "bfloat16" if bf16 else "float32")
    _close(wc, pwc, rtol=2e-4, atol=1e-4)
    _close(nw, pnw, rtol=2e-4, atol=1e-4)
    kernel = "nlm_hrw_bf16" if bf16 else "nlm_hrw"
    assert stencils.launches[kernel] == 1
    assert sum(stencils.launches.values()) == 1


@pytest.mark.parametrize(
    "d,border,ua,shape",
    [(2, BorderPolicy.CLAMP, False, (29, 37)), (2, BorderPolicy.ZERO, True, (61, 300)),
     (4, BorderPolicy.CLAMP, True, (61, 300)), (4, BorderPolicy.ZERO, False, (97, 131)),
     (8, BorderPolicy.CLAMP, False, (97, 131)), (8, BorderPolicy.ZERO, True, (61, 300))],
)
def test_fused_grid_kernel_equals_the_two_kernels(cuda, d, border, ua, shape):
    """Each cell's sums in the build kernel's order and each pixel's in the
    slice kernel's: grid_pipeline(fused=True) equals pool + build + slice bit
    for bit, on several tiles and ragged edges."""
    img = _image(0, cuda, *shape)
    bp = BilateralParams(border=border, uniform_alpha=ua)
    two = fast.grid_pipeline(img, bp, 6, d)
    assert stencils.launches["fused_grid"] == 0
    stencils.reset_launches()
    got = fast.grid_pipeline(img, bp, 6, d, fused=True)
    torch.cuda.synchronize()
    assert torch.equal(got, two)
    assert {k: n for k, n in stencils.launches.items() if n} == {"pool": 1, "fused_grid": 1}


@pytest.mark.parametrize("d,n_taps,fits", [(2, 9, True), (4, 5, True), (8, 7, True),
                                           (2, 63, True), (2, 65, False), (3, 9, False)])
def test_fused_grid_shared_memory(cuda, d, n_taps, fits):
    """The fused bilateral kernel stages one pooled image: its window fits a
    block's shared memory on the H100 for every tap table it takes at d = 2,
    4 and 8; more taps than its table, or a d it has no tile for, it does
    not take. The answer is the Python tile rule's (fast.fused_tile with the
    device's opt-in limit)."""
    assert fast.fused_grid_fits(d, n_taps, cuda) == fits
    limit = stencils.max_shared_bytes(cuda)
    if fits:
        assert fast.fused_tile(d, n_taps, limit, 1).shared_bytes + fast.STATIC_SHARED_RESERVE <= (
            limit)
    else:
        with pytest.raises(ValueError):
            fast.fused_tile(d, n_taps, limit, 1)


# ---------------------------------------------------------------------------
# The redesigned half-row NLM and guided build kernels; search radius 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "params,shape,n_frames",
    [
        (NlmParams(search_radius=0, search_stride=2, weights_halfres=True), (29, 37), 3),
        (NlmParams(search_stride=2, weights_halfres=True), (37, 70), 3),
        (NlmParams(search_stride=2, weights_halfres=True, border=BorderPolicy.ZERO,
                   uniform_alpha=True), (17, 45), 3),
        (NlmParams(search_radius=16, search_stride=2, weights_halfres=True), (29, 37), 3),
        (NlmParams(search_radius=16, search_stride=2, weights_halfres=True,
                   border=BorderPolicy.ZERO, search_disk=True), (40, 33), 1),
        (NlmParams(search_stride=2, weights_halfres=True), (1, 64), 3),
        (NlmParams(search_stride=2, weights_halfres=True, border=BorderPolicy.ZERO), (1, 64), 1),
        (NlmParams(search_radius=32, search_stride=2, weights_halfres=True), (35, 40), 1),
    ],
    ids=["s0", "s7_odd", "s7_zero_ua_odd", "s16_odd", "s16_zero_disk", "s7_1x64",
         "s7_zero_1x64", "s32_1024_candidates"],
)
def test_nlm_hrw_redesigned_kernel_matches_plain(cuda, params, shape, n_frames, bf16):
    """The redesigned half-row kernel on smooth content: s = 0 (no candidate:
    the seeds alone), 7, 16 and 32 (1024 candidates, its windows above 48 KB
    of shared memory), both borders, odd heights, one row, images narrower
    and wider than the 16 x 32 tile, F = 3 with the middle frame masked."""
    target = _smooth_image(0, cuda, *shape)
    frames = torch.stack([_smooth_image(i, cuda, *shape) for i in range(n_frames)])
    valid = torch.tensor([1.0, 0.0, 1.0][:n_frames], device=cuda)
    tiling = TilingConfig(compute_dtype="bfloat16") if bf16 else None
    wc, nw = stencils.nlm_accumulate_frames(target, frames, params, tiling, valid)
    pwc, pnw = stencils.nlm_plain(target, frames, params, valid,
                                  "bfloat16" if bf16 else "float32")
    _close(wc, pwc, rtol=2e-4, atol=1e-4)
    _close(nw, pnw, rtol=2e-4, atol=1e-4)
    if params.search_radius == 0:
        torch.testing.assert_close(nw, torch.full_like(nw, 2 * params.norm_seed), rtol=0, atol=0)
        assert not wc.any()
    assert stencils.launches["nlm_hrw_bf16" if bf16 else "nlm_hrw"] == 1
    assert sum(stencils.launches.values()) == 1


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ua", [False, True])
def test_nlm_at_search_radius_0_writes_the_seeds(cuda, bf16, ua):
    """An empty candidate table launches the kernel, which writes what the
    JAX package writes: wc = 0 and nw = the sum of valid[f] times the seed
    (F = 2, the second frame masked), uniform alpha included."""
    params = NlmParams(search_radius=0, uniform_alpha=ua)
    target = _image(0, cuda)
    frames = torch.stack([_image(1, cuda), _image(2, cuda)])
    valid = torch.tensor([1.0, 0.0], device=cuda)
    tiling = TilingConfig(compute_dtype="bfloat16") if bf16 else None
    wc, nw = stencils.nlm_accumulate_frames(target, frames, params, tiling, valid)
    pwc, pnw = stencils.nlm_plain(target, frames, params, valid,
                                  "bfloat16" if bf16 else "float32")
    torch.testing.assert_close(wc, pwc, rtol=0, atol=0)
    torch.testing.assert_close(nw, pnw, rtol=0, atol=0)
    torch.testing.assert_close(nw, torch.full_like(nw, params.norm_seed), rtol=0, atol=0)
    assert stencils.launches["nlm_bf16" if bf16 else "nlm"] == 1


def test_cli_at_search_radius_0_on_card_matches_cpu(cuda, tmp_path):
    """gpu-denoise --search-radius 0 on the card writes the seed-only result
    that --device cpu writes."""
    from image_denoising_filter_tpu_torch import cli

    root = tmp_path / "anim"
    root.mkdir()
    for i in range(3):
        imageio.save(str(root / f"frame_{i:04d}.png"), _image(i, "cpu").numpy())
    target = str(root / "frame_0001.png")
    outs = {}
    for device in ("cuda", "cpu"):
        out = tmp_path / device
        rc = cli.main([target, "--device", device, "--search-radius", "0", "--configs",
                       "nlm,multiframe", "--output-dir", str(out)])
        assert rc == 0
        outs[device] = {p.name: imageio.load(str(p))[0] for p in out.iterdir()}
    assert sorted(outs["cuda"]) == sorted(outs["cpu"]) and len(outs["cuda"]) == 2
    for name, img in outs["cuda"].items():
        np.testing.assert_array_equal(img, outs["cpu"][name])
    assert stencils.launches["nlm"] > 0


@pytest.mark.parametrize("kernel,params", [
    ("nlm_hrw", NlmParams(search_stride=2, weights_halfres=True)),
    ("nlm_hrw_bf16", NlmParams(search_stride=2, weights_halfres=True)),
    ("nlm_hrw", NlmParams(search_stride=2, weights_halfres=True, border=BorderPolicy.ZERO)),
])
def test_nlm_hrw_kernel_info(cuda, kernel, params):
    """The turbo tile launches: registers without spills, and at least two
    blocks a multiprocessor."""
    info = stencils.kernel_info(kernel, cuda, params)
    assert info["tile"] == "16x32" and info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= 2 and 0 < info["registers"] <= 255


@pytest.mark.parametrize(
    "d,sigma_s,n_taps,border,shape",
    [(1, 2.0, 17, BorderPolicy.CLAMP, (61, 83)), (1, 2.0, 17, BorderPolicy.ZERO, (40, 37)),
     (2, 2.0, 9, BorderPolicy.CLAMP, (97, 131)), (2, 2.0, 9, BorderPolicy.ZERO, (61, 300)),
     (8, 6.0, 7, BorderPolicy.CLAMP, (97, 131)), (8, 6.0, 7, BorderPolicy.ZERO, (61, 83)),
     (1, 7.6, 63, BorderPolicy.CLAMP, (29, 70)), (2, 15.1, 63, BorderPolicy.ZERO, (61, 83))],
    ids=["d1_17taps", "d1_17taps_zero", "d2", "d2_zero", "d8_7taps", "d8_7taps_zero",
         "d1_63taps", "d2_63taps_zero"],
)
def test_build_guided_grid_kernel_equals_plain_bit_for_bit(cuda, d, sigma_s, n_taps, border,
                                                           shape):
    """The redesigned guided build keeps the plain version's products and sum
    order, so its bf16 grid is the plain version's bit for bit: the main
    path's d = 1 (17 taps), d = 2, d = 8 at sigma_s 6 (7 taps) and the
    widest table (63 taps), both borders, grids smaller than, at and larger
    than one tile."""
    _, _, small_t, small_l, lmin, step, taps = _guided_inputs(d, border, 6, sigma_s, *shape)
    assert taps.size == n_taps
    args = (small_t, small_l, lmin, step, 6, taps, border, 12.5)
    got = fast.build_guided_grid(*args, d=d)
    torch.cuda.synchronize()
    assert torch.equal(got, fast.build_guided_grid_plain(*args))
    assert stencils.launches[_form("build_guided_grid", d)] == 1


@pytest.mark.parametrize("n_taps,tile", [(9, "16x32"), (17, "16x32"), (63, "1x16")])
def test_build_guided_grid_kernel_info(cuda, n_taps, tile):
    """The guided build's tiles launch: registers without spills, and at
    least one block a multiprocessor (two at the main path's 17 taps)."""
    info = fast.build_grid_info(cuda, n_taps, BorderPolicy.CLAMP, guided=True)
    assert info["tile"] == tile and info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= (2 if n_taps <= 17 else 1)
    assert 0 < info["registers"] <= 255


def test_nlm_hrw_launcher_refuses_a_window_that_misses_a_tap(cuda):
    """The half-row launcher checks the tile against every candidate before it
    launches: a value window one row short, or a cell window one lane short,
    is refused with cudaErrorInvalidValue (1)."""
    params = NlmParams(search_stride=2, weights_halfres=True)
    img = _image(0, cuda)
    out, nw = torch.empty_like(img), torch.empty(img.shape[:2], device=cuda)
    valid = torch.ones(1, device=cuda)
    tile = stencils.hrw_tile(params, False, stencils.max_shared_bytes(img.device))
    cands = np.asarray(stencils.nlm_candidates(params), np.int32).reshape(-1)
    lib = stencils._build.library()
    short_rows, short_lanes = tile.launch_args(), tile.launch_args()
    short_rows[3] -= 1  # win_h
    short_lanes[6] -= 1  # cell_w
    for geom, want in ((tile.launch_args(), 0), (short_rows, 1), (short_lanes, 1)):
        rc = lib.idf_nlm_hrw(img.data_ptr(), img.data_ptr(), valid.data_ptr(), out.data_ptr(),
                             nw.data_ptr(), 29, 37, 1, cands.ctypes.data, cands.size // 2, -1.0,
                             4.0, 0.001, 0, 0, 0, geom.ctypes.data, stencils._stream(img))
        assert rc == want
    torch.cuda.synchronize()


def test_build_guided_grid_launcher_refuses_a_short_layout(cuda):
    """The guided build's launcher refuses a layout whose vertical sums
    overrun the block's shared memory (cudaErrorInvalidValue, 1)."""
    _, _, small_t, small_l, lmin, step, taps = _guided_inputs(2)
    grid = torch.empty((5, *small_t.shape[:2], 8), dtype=torch.bfloat16, device=cuda)
    tile = fast.build_tile(taps.size, stencils.max_shared_bytes(small_t.device), 2)
    short = tile.launch_args()
    short[-1] -= 4  # shared bytes
    lib = stencils._build.library()
    for geom, want in ((tile.launch_args(), 0), (short, 1)):
        rc = lib.idf_build_guided_grid(
            small_t.data_ptr(), small_l.data_ptr(), lmin.data_ptr(), step.data_ptr(),
            grid.data_ptr(), small_t.shape[0], small_t.shape[1], 5, taps.ctypes.data, taps.size,
            1.0, 0, geom.ctypes.data, stencils._stream(small_t))
        assert rc == want
    torch.cuda.synchronize()


@pytest.mark.parametrize("ua", [False, True])
@pytest.mark.parametrize(
    "d,sigma_s,n_taps,border,shape",
    [(2, 2.0, 9, BorderPolicy.CLAMP, (97, 131)), (2, 2.0, 9, BorderPolicy.ZERO, (61, 300)),
     (4, 2.0, 5, BorderPolicy.CLAMP, (7, 9)), (8, 6.0, 7, BorderPolicy.ZERO, (300, 61)),
     (2, 15.1, 63, BorderPolicy.CLAMP, (29, 70)), (2, 15.1, 63, BorderPolicy.ZERO, (61, 83)),
     (1, 2.0, 17, BorderPolicy.CLAMP, (97, 131)), (1, 6.0, 49, BorderPolicy.ZERO, (61, 83))],
    ids=["d2", "d2_zero", "d4_below_a_tile", "d8_7taps_zero", "d2_63taps", "d2_63taps_zero",
         "d1_17taps", "d1_49taps_zero"],
)
def test_build_grid_kernel_equals_plain_bit_for_bit(cuda, d, sigma_s, n_taps, border, shape, ua):
    """The bilateral build shares the guided build's body with one staged
    image: the plain version's products, sums and divides in its order, so
    its bf16 grid is the plain version's bit for bit, on grids smaller than
    one tile, at it and beyond it with ragged edges, at the widest table (63
    taps, 8 x 32 cells), with uniform alpha (a zero alpha slot)."""
    img = _image(0, cuda, *shape)
    small = fast.pool_plain(img, d, border)
    taps = fast._grid_taps(sigma_s, d)
    assert taps.size == n_taps
    args = (small, *fast.grid_range(small, 6), 6, taps, border, 12.5, ua)
    got = fast.build_grid(*args, d=d)
    torch.cuda.synchronize()
    assert torch.equal(got, fast.build_grid_plain(*args))
    assert not ua or bool((got[..., 3] == 0).all())
    assert stencils.launches[_form("build_grid", d)] == 1


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
def test_build_grid_kernel_at_one_tap(cuda, border):
    """A one-tap table (no blur, halo 0): each cell normalized on its own."""
    small = fast.pool_plain(_image(0, cuda, 40, 70), 2, border)
    args = (small, *fast.grid_range(small, 5), 5, np.ones(1, np.float32), border, 12.5)
    got = fast.build_grid(*args, d=2)
    torch.cuda.synchronize()
    assert torch.equal(got, fast.build_grid_plain(*args))


@pytest.mark.parametrize("n_taps,tile", [(5, "16x32"), (9, "16x32"), (63, "8x32")])
def test_build_grid_kernel_info(cuda, n_taps, tile):
    """The bilateral build's tiles launch: registers without spills, at least
    three blocks a multiprocessor at the main path's tap counts."""
    info = fast.build_grid_info(cuda, n_taps, BorderPolicy.CLAMP)
    assert info["tile"] == tile and info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= (3 if n_taps <= 9 else 1)
    assert 0 < info["registers"] <= 255


def test_build_grid_launcher_refuses_a_short_layout(cuda):
    """The bilateral build's launcher refuses a layout whose vertical sums
    overrun the block's shared memory, or one that stages a second image
    (cudaErrorInvalidValue, 1)."""
    small, lmin, step, taps = _grid_inputs(_image(0, cuda), 2)
    grid = torch.empty((5, *small.shape[:2], 4), dtype=torch.bfloat16, device=cuda)
    tile = fast.build_tile(taps.size, stencils.max_shared_bytes(small.device), 1)
    short, two = tile.launch_args(), fast.build_tile(taps.size, tile.shared_bytes * 2, 2)
    short[-1] -= 4  # shared bytes
    lib = stencils._build.library()
    for geom, want in ((tile.launch_args(), 0), (short, 1), (two.launch_args(), 1)):
        rc = lib.idf_build_grid(
            small.data_ptr(), lmin.data_ptr(), step.data_ptr(), grid.data_ptr(),
            small.shape[0], small.shape[1], 5, taps.ctypes.data, taps.size, 1.0, 0, 0,
            geom.ctypes.data, stencils._stream(small))
        assert rc == want
    torch.cuda.synchronize()


@pytest.mark.parametrize(
    "d,sigma_s,n_taps,border,shape",
    [(2, 10.5, 43, BorderPolicy.CLAMP, (61, 300)), (2, 10.5, 43, BorderPolicy.ZERO, (29, 37)),
     (4, 30.1, 63, BorderPolicy.ZERO, (97, 131)), (4, 30.1, 63, BorderPolicy.CLAMP, (40, 200)),
     (1, 2.0, 17, BorderPolicy.CLAMP, (40, 150)), (2, 12.0, 49, BorderPolicy.CLAMP, (70, 70))],
    ids=["d2_43taps", "d2_43taps_zero", "d4_63taps_zero", "d4_63taps", "d1_17taps",
         "d2_49taps"],
)
def test_fused_guided_kernel_equals_the_two_kernels_at_wide_tables(cuda, d, sigma_s, n_taps,
                                                                   border, shape):
    """At wide tables (43 taps at d = 2, the widest before; 49 at d = 2, on
    the shrunk 16 x 32 tile; 63 at d = 4, on 8 x 32) and at d = 1, which it
    now takes: the fused kernel equals the two kernels bit for bit."""
    _, layer, small_t, small_l, lmin, step, taps = _guided_inputs(d, border, 6, sigma_s, *shape)
    assert taps.size == n_taps
    grid = fast.build_guided_grid(small_t, small_l, lmin, step, 6, taps, border, 12.5, d=d)
    two = fast.slice_guided_grid(layer, grid, lmin, 1.0 / step, d)
    got = fast.fused_guided(small_t, small_l, layer, lmin, step, 1.0 / step, 6, taps, border,
                            12.5, d)
    torch.cuda.synchronize()
    assert torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
    assert stencils.launches["fused_guided"] == 1


@pytest.mark.parametrize("d,n_taps,tile", [(2, 9, "16x64"), (4, 5, "16x64"), (4, 63, "8x32")])
def test_fused_guided_kernel_info(cuda, d, n_taps, tile):
    """The fused guided kernel launches without spills, three blocks a
    multiprocessor at the main path's settings (it is compiled for three)."""
    info = fast.fused_guided_info(cuda, d, n_taps, BorderPolicy.CLAMP)
    assert info["tile"] == tile and info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= (3 if n_taps <= 9 else 1)
    assert 0 < info["registers"] <= 255


def test_fused_guided_launcher_refuses_a_short_layout(cuda):
    """The fused guided launcher refuses a tile whose cells overrun its
    shared bytes, or whose window is one row short of what the tile's
    pixels read (cudaErrorInvalidValue, 1)."""
    _, layer, small_t, small_l, lmin, step, taps = _guided_inputs(2)
    wc = torch.empty_like(layer)
    nw = torch.empty((*layer.shape[:2], 3), device=cuda)
    tile = fast.fused_tile(2, taps.size, stencils.max_shared_bytes(layer.device), 2)
    short_bytes, short_rows = tile.launch_args(), tile.launch_args()
    short_bytes[-1] -= 16
    short_rows[2] -= 1  # rows
    lib = stencils._build.library()
    h, w = layer.shape[:2]
    for geom, want in ((tile.launch_args(), 0), (short_bytes, 1), (short_rows, 1)):
        rc = lib.idf_fused_guided(
            small_t.data_ptr(), small_l.data_ptr(), layer.data_ptr(), lmin.data_ptr(),
            step.data_ptr(), (1.0 / step).data_ptr(), wc.data_ptr(), nw.data_ptr(), h, w,
            small_t.shape[0], small_t.shape[1], 5, taps.ctypes.data, taps.size, 1.0, 2, 0,
            geom.ctypes.data, stencils._stream(layer))
        assert rc == want
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The redesigned fused bilateral grid kernel
# ---------------------------------------------------------------------------

GRID_SHAPES = [(29, 37), (61, 300), (97, 131), (7, 9), (300, 61), (1, 200)]


@pytest.mark.parametrize("n_taps", range(1, fast.MAX_TAPS, 2))
def test_fused_grid_kernel_equals_build_and_slice_at_every_table(cuda, n_taps):
    """Every odd tap table from 1 to 63, cycling through d = 2, 4, 8, both
    borders, uniform alpha on and off and ragged images (below one tile, at
    it and beyond it, one row): the fused kernel's output equals the build
    kernel's grid sliced by the slice kernel, bit for bit."""
    i = n_taps // 2
    d = fast.FUSED_GRID_DOWNSAMPLES[i % 3]
    border = (BorderPolicy.CLAMP, BorderPolicy.ZERO)[i % 2]
    ua = i % 4 >= 2
    img = _image(i, cuda, *GRID_SHAPES[i % len(GRID_SHAPES)])
    small = fast.pool(img, d, border)
    lmin, step = fast.grid_range(small, 6)
    taps = fast._gauss_taps(max(0.5, n_taps / 8.0), n_taps // 2)
    alpha = img[0, 0, 3] if ua else None
    grid = fast.build_grid(small, lmin, step, 6, taps, border, 12.5, ua, d=d)
    two = fast.slice_grid(img, grid, lmin, 1.0 / step, d, alpha)
    got = fast.fused_grid(small, img, lmin, step, 1.0 / step, 6, taps, border, 12.5, d, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, two)
    assert stencils.launches["fused_grid"] == 1


@pytest.mark.parametrize("levels", [2, 7, 13])
def test_fused_grid_kernel_levels_in_batches(cuda, levels):
    """More levels than a batch (FUSED_GRID_LEVELS): the first batch leaves
    its partials in the output and the next adds to them in level order,
    bit for bit the slice kernel's sum; on an HDR image (RGB up to 4)."""
    img = _image(3, cuda, 97, 131)
    img[..., :3] *= 4.0
    small = fast.pool(img, 2, BorderPolicy.CLAMP)
    lmin, step = fast.grid_range(small, levels)
    taps = fast._grid_taps(2.0, 2)
    grid = fast.build_grid(small, lmin, step, levels, taps, BorderPolicy.CLAMP, 12.5, d=2)
    two = fast.slice_grid(img, grid, lmin, 1.0 / step, 2)
    got = fast.fused_grid(small, img, lmin, step, 1.0 / step, levels, taps, BorderPolicy.CLAMP,
                          12.5, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, two)


@pytest.mark.parametrize("d,n_taps,ua,tile", [(2, 9, False, "16x64"), (2, 9, True, "16x64"),
                                              (4, 5, False, "32x128"), (8, 7, False, "32x256"),
                                              (2, 63, False, "8x64")])
def test_fused_grid_kernel_info(cuda, d, n_taps, ua, tile):
    """The fused bilateral kernel launches without spills, four blocks a
    multiprocessor at the main path's settings (it is compiled for
    FUSED_GRID_MIN_BLOCKS), on the tile fast.fused_tile gives it at each d."""
    info = fast.fused_grid_info(cuda, d, n_taps, BorderPolicy.CLAMP, ua)
    assert info["tile"] == tile and info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= (fast.FUSED_GRID_MIN_BLOCKS if n_taps <= 9 else 1)
    assert 0 < info["registers"] <= 255
    assert info["shared_bytes"] == fast.fused_tile(d, n_taps, stencils.max_shared_bytes(cuda),
                                                   1).shared_bytes


def test_fused_grid_launcher_refuses_a_short_or_overlapping_layout(cuda):
    """The fused bilateral launcher refuses a tile whose cells overrun its
    shared bytes, whose window is one row short of what the tile's pixels
    read, whose weight planes overlap the staged image, or that stages a
    second image (cudaErrorInvalidValue, 1)."""
    img = _image(0, cuda)
    small, lmin, step, taps = _grid_inputs(img, 2)
    out = torch.empty_like(img)
    tile = fast.fused_tile(2, taps.size, stencils.max_shared_bytes(cuda), 1)
    short_bytes, short_rows, overlap = (tile.launch_args() for _ in range(3))
    short_bytes[-1] -= 8
    short_rows[2] -= 1  # rows
    overlap[5] -= 16  # w_at
    two = fast.fused_tile(2, taps.size, stencils.max_shared_bytes(cuda), 2).launch_args()
    lib = stencils._build.library()
    h, w = img.shape[:2]
    for geom, want in ((tile.launch_args(), 0), (short_bytes, 1), (short_rows, 1), (overlap, 1),
                       (two, 1)):
        rc = lib.idf_fused_grid(
            small.data_ptr(), img.data_ptr(), lmin.data_ptr(), step.data_ptr(),
            (1.0 / step).data_ptr(), None, out.data_ptr(), h, w, small.shape[0], small.shape[1],
            5, taps.ctypes.data, taps.size, 1.0, 2, 0, 1, geom.ctypes.data, stencils._stream(img))
        assert rc == want
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The exact bilateral, staged (redesigned) and direct-load, float32 and bf16
# taps
# ---------------------------------------------------------------------------

BF16 = TilingConfig(compute_dtype="bfloat16")
BILATERAL_FORMS = {  # form: (guided, tiling)
    "bilateral": (False, None), "bilateral_guided": (True, None),
    "bilateral_bf16": (False, BF16), "bilateral_guided_bf16": (True, BF16),
}


def _bilateral_form(form, params, target, layer):
    """(kernel outputs, plain outputs) of one bilateral form."""
    guided, tiling = BILATERAL_FORMS[form]
    dtype = "float32" if tiling is None else "bfloat16"
    if guided:
        got = stencils.cross_bilateral_layers(target, layer, params, tiling)
        return got, stencils.bilateral_plain(target, layer, params, False, dtype)
    got = stencils.bilateral(target, params, tiling)
    return (got,), stencils.bilateral_plain(target, None, params, True, dtype)[:1]


def _direct(form, params, target, layer):
    """The same form through the direct-load instance (a tile of th 0)."""
    guided, tiling = BILATERAL_FORMS[form]
    h, w, _ = target.shape
    runs = np.asarray(stencils._circle_runs(params.effective_radius, params.sigma_spatial,
                                            params.truncate_eps), np.int32).reshape(-1)
    out = torch.empty_like(target)
    nw = torch.empty((h, w), device=target.device) if guided else None
    rc = stencils._build.library().idf_bilateral(
        target.data_ptr(), layer.data_ptr() if guided else None, out.data_ptr(),
        nw.data_ptr() if guided else None, h, w, runs.ctypes.data, runs.size // 3,
        -0.5 / params.sigma_spatial**2 * stencils.LOG2E, 0.5 / params.sigma_color**2 * stencils.LOG2E,
        int(params.blue_bug), int(params.border != BorderPolicy.CLAMP), int(params.uniform_alpha),
        int(not guided), int(tiling is not None), np.zeros(8, np.int32).ctypes.data,
        stencils._stream(target))
    assert rc == 0
    return (out, nw) if guided else (out,)


def _check_bilateral_form(form, params, shape, staged):
    cuda = torch.device("cuda")
    target, layer = _image(0, cuda, *shape), _image(1, cuda, *shape)
    if not params.uniform_alpha:
        target[..., 3] = torch.rand(shape, device=cuda)
    guided, tiling = BILATERAL_FORMS[form]
    tile = stencils.bilateral_tile(params, guided, tiling is not None,
                                   stencils.max_shared_bytes(cuda))
    assert tile.staged == staged
    got, want = _bilateral_form(form, params, target, layer)
    for g, w_ in zip(got, want):
        _close(g, w_)
    for g, d in zip(got, _direct(form, params, target, layer)):
        torch.cuda.synchronize()
        assert torch.equal(g, d)  # the staged kernel computes the direct loop's taps
    assert stencils.launches[form] == 1


@pytest.mark.parametrize("form", list(BILATERAL_FORMS))
@pytest.mark.parametrize(
    "params,shape",
    [
        (BilateralParams(radius=3), (29, 37)),
        (BilateralParams(), (29, 37)),
        (BilateralParams(border=BorderPolicy.ZERO, blue_bug=True), (40, 5)),
        (BilateralParams(uniform_alpha=True), (7, 300)),
        (BilateralParams(radius=5, border=BorderPolicy.ZERO), (1, 200)),
        (BilateralParams(blue_bug=True, uniform_alpha=True), (97, 131)),
        (BilateralParams(), (5, 7)),
        (BilateralParams(border=BorderPolicy.ZERO, uniform_alpha=True), (3, 2)),
    ],
    ids=["r3", "reference", "zero_blue_bug_40x5", "ua_7x300", "r5_zero_1x200",
         "blue_bug_ua_97x131", "below_halo_5x7", "below_halo_zero_ua_3x2"],
)
def test_bilateral_kernel_forms_match_plain(cuda, form, params, shape):
    """Each form against its plain version (the exact tolerance: the bf16
    forms round as the plain version does) and bit for bit against the
    direct-load instance: both borders, blue_bug, uniform alpha, odd and
    ragged sizes, one row, and images smaller than the disk's halo."""
    _check_bilateral_form(form, params, shape, staged=True)


@pytest.mark.parametrize("form", list(BILATERAL_FORMS))
@pytest.mark.parametrize("radius", range(1, 21))
def test_bilateral_kernel_forms_at_every_radius(cuda, form, radius):
    """Radii 1-20 with the full window (truncate_eps 0, the float32 guided
    form's tile shrinking to 8 rows from radius 20); the truncated disk at
    the same radius runs in the reference cases."""
    _check_bilateral_form(form, BilateralParams(radius=radius, truncate_eps=0.0), (19, 23),
                          staged=True)


@pytest.mark.parametrize("form", list(BILATERAL_FORMS))
@pytest.mark.parametrize("radius", [30, 45, 63])
def test_bilateral_direct_instance_takes_wide_radii(cuda, form, radius):
    """Full windows too wide for any staged tile on the H100 take the
    direct-load instance, by shape alone (tests/test_torch_bilateral_tiles.py:
    float32 guided above 23, float32 above 37, bf16 with alpha above 44,
    bf16 guided with alpha above 32); the others stage."""
    guided, tiling = BILATERAL_FORMS[form]
    widest = {"bilateral": 37, "bilateral_guided": 23, "bilateral_bf16": 44,
              "bilateral_guided_bf16": 32}[form]
    params = BilateralParams(radius=radius, truncate_eps=0.0)
    _check_bilateral_form(form, params, (9, 11), staged=radius <= widest)


def _hdr_image(device, h=61, w=131, inf=False):
    """HDR content: noise below 0, a bright patch of 5 beside 0.3, and
    fireflies (RGB times 50); with `inf` one infinite green value."""
    rng = np.random.default_rng(7)
    img = rng.normal(0.3, 0.1, (h, w, 4)).astype(np.float32)
    img[: h // 4, w // 3 : 2 * w // 3, :3] += 4.7
    img.reshape(-1, 4)[rng.choice(h * w, 12, replace=False), :3] *= 50.0
    img[..., 3] = rng.uniform(0.5, 1.0, (h, w))
    if inf:
        img[h // 2, w // 2, 1] = np.inf
    return torch.from_numpy(img).to(device)


@pytest.mark.parametrize("inf", [False, True], ids=["hdr", "hdr_inf"])
@pytest.mark.parametrize("form", list(BILATERAL_FORMS))
def test_bilateral_kernel_forms_on_hdr_blocks(cuda, form, inf):
    """On HDR content most blocks fail the range test and walk their tap rows
    with exp2f (stencils.bilateral_walks); the output is still the
    direct-load instance's bit for bit (NaN where an infinite tap meets a
    zero weight, in both) and, where finite, the plain version's at the
    exact tolerance scaled by max |RGB|."""
    params = BilateralParams()
    guided, tiling = BILATERAL_FORMS[form]
    target = _hdr_image(cuda, inf=inf)
    layer = _image(1, cuda, *target.shape[:2])
    tile = stencils.bilateral_tile(params, guided, tiling is not None,
                                   stencils.max_shared_bytes(cuda))
    walks = stencils.bilateral_walks(layer if guided else target, params, tiling is not None, tile)
    assert (walks["rows_exp2f"] > 0) != guided  # the guide of the guided forms is LDR
    got, want = _bilateral_form(form, params, target, layer)
    for g, d in zip(got, _direct(form, params, target, layer)):
        torch.cuda.synchronize()
        torch.testing.assert_close(g, d, rtol=0, atol=0, equal_nan=True)
    scale = float(target[..., :3][torch.isfinite(target[..., :3])].abs().max())
    for g, w_ in zip(got, want):
        finite = torch.isfinite(w_)
        assert torch.equal(finite, torch.isfinite(g))
        _close(g[finite], w_[finite], atol=1e-5 * scale)


@pytest.mark.parametrize("ua", [False, True], ids=["alpha", "uniform_alpha"])
@pytest.mark.parametrize("form", list(BILATERAL_FORMS))
def test_bilateral_kernel_info(cuda, form, ua):
    """The reference tile as compiled: 16 x 96, no spills, two blocks a SM
    (one for the float32 guided form, 150 KB of staged pixels); the direct
    instance of a wide radius, no spills either."""
    params = BilateralParams(uniform_alpha=ua)
    info = stencils.kernel_info(form, cuda, params)
    assert info["tile"] == "16x96" and info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= (1 if form == "bilateral_guided" else 2)
    assert 0 < info["registers"] <= 128
    wide = stencils.kernel_info(form, cuda, BilateralParams(radius=63, truncate_eps=0.0,
                                                            uniform_alpha=ua))
    assert wide["tile"] == "direct" and wide["shared_bytes"] == 0
    assert wide["spill_bytes"] == 0


def test_bilateral_launcher_refuses_a_short_or_overlapping_layout(cuda):
    """The C launcher checks the tile before it launches: a halo a row or a
    column short of the disk, a target region overlapping the guide's, an
    alpha plane overlapping the target's, spatial terms overlapping the
    alpha plane, ranges overlapping the spatial terms, shared bytes short of the layout or beyond the card, more rows
    than a block takes, and shared bytes for the direct instance are
    refused with cudaErrorInvalidValue (1)."""
    img, layer = _image(0, cuda), _image(1, cuda)
    out, nw = torch.empty_like(img), torch.empty(img.shape[:2], device=cuda)
    p = BilateralParams()
    runs = np.asarray(stencils._circle_runs(p.effective_radius, p.sigma_spatial, p.truncate_eps),
                      np.int32).reshape(-1)
    tile = stencils.bilateral_tile(p, True, True, stencils.max_shared_bytes(cuda))
    good = tile.launch_args()
    bad = []
    for field, delta in ((1, -1), (2, -1), (3, -8), (4, -4), (5, -4), (6, -4), (7, -4)):
        geom = good.copy()
        geom[field] += delta
        bad.append(geom)
    for geom in (np.asarray([17, *good[1:]], np.int32),
                 np.asarray([0, 12, 12, 0, 0, 0, 0, 16], np.int32)):
        bad.append(geom)
    over = good.copy()
    over[7] = stencils.max_shared_bytes(cuda) + 16
    bad.append(over)
    lib = stencils._build.library()
    for geom, want in [(good, 0)] + [(g, 1) for g in bad]:
        rc = lib.idf_bilateral(img.data_ptr(), layer.data_ptr(), out.data_ptr(), nw.data_ptr(),
                               29, 37, runs.ctypes.data, runs.size // 3, -0.5, 1.0, 0, 0, 0, 0, 1,
                               geom.ctypes.data, stencils._stream(img))
        assert rc == want, geom
    torch.cuda.synchronize()


@pytest.mark.parametrize("cfg", GPU_BATTERY[:3], ids=lambda c: c.output_name(False))
def test_session_with_bf16_taps_on_card_matches_cpu(cuda, tmp_path, cfg):
    """Session(tiling=bf16): the tiled bilateral and layers configs launch
    the bf16 forms, whose outputs equal the CPU Session's plain versions at
    the exact tolerance; the linear layout ignores the tiling."""
    root = tmp_path / "anim"
    (root / "RenderElements").mkdir(parents=True)
    for i in range(3):
        imageio.save(str(root / f"frame_{i:04d}.png"), _image(i, "cpu").numpy())
    imageio.save(str(root / "RenderElements" / "albedo_0001.png"), _image(9, "cpu").numpy())
    target = str(root / "frame_0001.png")
    params = dict(bilateral_params=BP, layers_params=LP, tiling=BF16)
    (tmp_path / "gpu").mkdir()
    (tmp_path / "cpu").mkdir()
    got = Session(target, device=cuda, output_dir=str(tmp_path / "gpu"), **params).run(cfg)
    want = Session(target, device="cpu", output_dir=str(tmp_path / "cpu"), **params).run(cfg)
    np.testing.assert_allclose(got.image, want.image, rtol=1e-4, atol=1e-5)
    bf16_launches = stencils.launches["bilateral_bf16"] + stencils.launches["bilateral_guided_bf16"]
    f32_launches = stencils.launches["bilateral"] + stencils.launches["bilateral_guided"]
    assert f32_launches == 0 and (bf16_launches == 0) == cfg.linear


# The parity reading (BASELINE.md:15) on the card: the bilateral kernel at the
# CPU path's parameters (radius 10, sigma_s 10, the full 21x21 window, the
# blue term compiled out) against the NumPy CPU oracle.
CPU_PARAMS = CpuBilateralParams()
CPU_KERNEL_PARAMS = BilateralParams(radius=CPU_PARAMS.radius,
                                    sigma_spatial=CPU_PARAMS.sigma_spatial,
                                    sigma_color=CPU_PARAMS.sigma_color,
                                    blue_bug=CPU_PARAMS.blue_bug)


@pytest.mark.parametrize("h,w", [(48, 64), (97, 131), (1, 200)])
def test_bilateral_kernel_parity_at_cpu_params(cuda, h, w):
    """At least 59 dB over RGB against the oracle: over the whole frame
    against the oracle without its zeroed border, and over the interior
    against the CPU path's own frame where the image has one (not 1x200);
    within the exact tolerance of the plain version."""
    img = np.random.default_rng(h * w).uniform(0, 1, (h, w, 4)).astype(np.float32)
    x = torch.from_numpy(img).to(cuda)
    got = stencils.bilateral(x, CPU_KERNEL_PARAMS)
    assert stencils.launches["bilateral"] == 1
    _close(got, stencils.bilateral_plain(x, None, CPU_KERNEL_PARAMS, True)[0])
    got = got.cpu().numpy()
    whole = reference.cpu_bilateral_reference(
        img, dataclasses.replace(CPU_PARAMS, skip_border=False))
    assert reference.psnr(got[..., :3], whole[..., :3]) >= 59.0
    r = CPU_PARAMS.radius
    if h > 2 * r and w > 2 * r:
        interior = (slice(r, -r), slice(r, -r), slice(0, 3))
        want = reference.cpu_bilateral_reference(img, CPU_PARAMS)
        assert reference.psnr(got[interior], want[interior]) >= 59.0


@pytest.mark.parametrize("h,w,seed", [(96, 160, 1), (120, 200, 25), (1080, 1920, 0)])
def test_synthetic_render_device_on_card_matches_host(cuda, h, w, seed):
    dev = content.synthetic_render_device(h, w, seed, device=cuda)
    assert dev.device.type == "cuda" and dev.dtype == torch.float32
    host = content.synthetic_render(h, w, seed)
    assert float(np.abs(dev.cpu().numpy() - host).max()) < 2e-6


def test_cli_profile_on_card_sees_every_nlm_launch(cuda, tmp_path):
    """gpu-denoise --profile DIR on the card: the trace holds one nlm_kernel
    event a launch, the span of the config, and the Session's phases."""
    import json

    from image_denoising_filter_tpu_torch import cli

    root = tmp_path / "anim"
    root.mkdir()
    imageio.save(str(root / "frame_0000.png"), _image(0, "cpu").numpy())
    prof = tmp_path / "prof"
    rc = cli.main([str(root / "frame_0000.png"), "--device", "cuda", "--configs", "nlm",
                   "--search-radius", "2", "--patch-radius", "1", "--output-dir",
                   str(tmp_path / "out"), "--profile", str(prof)])
    assert rc == 0
    with open(prof / cli.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "nlm_kernel" in e["name"]]
    assert stencils.launches["nlm"] > 0
    assert len(kernels) == stencils.launches["nlm"]
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert [n for n in spans if not n.startswith("idf.")] == ["nlm"]
    assert {n for n in spans if n.startswith("idf.session.")} == {
        "idf.session." + p for p in ("open", "load", "upload", "warmup", "exec", "readback",
                                     "save")}


def test_cuda_session_builds_the_native_library_and_streams_on_its_loader(cuda, tmp_path):
    """A Session on the card loads the native host library with OpenMP
    (building it where none is found); the overlap config's frames come
    from the native FrameLoader, and its output equals the CPU Session's."""
    from image_denoising_filter_tpu_torch.utils import native

    root = tmp_path / "anim"
    root.mkdir()
    for i in range(4):
        imageio.save(str(root / f"frame_{i:04d}.png"), _image(i, "cpu").numpy())
    target = str(root / "frame_0001.png")
    (tmp_path / "gpu").mkdir()
    (tmp_path / "cpu").mkdir()
    session = Session(target, device=cuda, output_dir=str(tmp_path / "gpu"), nlm_params=NP_)
    info = native.ensure()
    assert info.openmp and info.threads >= 1 and imageio.codec() == "native"
    overlap = GPU_BATTERY[5]
    got = session.run(overlap)
    assert got.frame_loader == "native" and stencils.launches["nlm"] > 0
    want = Session(target, device="cpu", output_dir=str(tmp_path / "cpu"),
                   nlm_params=NP_).run(overlap)
    _close(torch.from_numpy(got.image), torch.from_numpy(want.image), **TOL_NLM)


def test_gpu_denoise_on_card_fails_when_the_native_build_fails(cuda, tmp_path):
    """With the build made to fail (CXX=/bin/false: a compiler of its own
    build hash, so no cached library) and no library given, gpu-denoise
    --device cuda exits 1 and names the compiler instead of running the
    Python codec, loader or oracle."""
    import subprocess
    import sys

    from image_denoising_filter_tpu_torch.utils import native

    if native.MAKE_LIB.exists():
        pytest.skip(f"{native.MAKE_LIB} (make -C native) is found before any build")
    root = tmp_path / "anim"
    root.mkdir()
    imageio.save(str(root / "frame_0000.png"), _image(0, "cpu").numpy())
    env = {k: v for k, v in os.environ.items() if k != "IDF_NATIVE_LIB"}
    env["CXX"] = "/bin/false"
    res = subprocess.run(
        [sys.executable, "-m", "image_denoising_filter_tpu_torch.cli",
         str(root / "frame_0000.png"), "--device", "cuda", "--configs", "cpu1",
         "--output-dir", str(tmp_path / "out")],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "error:" in res.stderr and "/bin/false" in res.stderr
    assert not (tmp_path / "out" / "output-cpu.png").exists()


# ---------------------------------------------------------------------------
# The grid build at d = 1: build_grid_d1_kernel, one body for both grids,
# which the wrappers launch at d = 1 (counted as build_grid_d1 and
# build_guided_grid_d1). It keeps the plain versions' products and sum
# order, so each grid is the plain version's bit for bit.
# ---------------------------------------------------------------------------

D1_BUILD_SHAPES = [(1, 1), (1, 97), (7, 300), (300, 7), (61, 83), (97, 131), (270, 1920)]


def _d1_build_args(guided, seed, h, w, n_taps, border, ua=False, hdr=False):
    """The pooled frame(s) at d = 1 (a bf16 round trip), their grid range,
    K = 6 and a table of n_taps Gaussian taps."""
    frames = [_d1_frame(seed + i, "cuda", h, w, hdr) for i in range(2 if guided else 1)]
    small = [fast.pool_plain(f, 1, border) for f in frames]
    lmin, step = fast.grid_range(small[-1], 6)
    taps = fast._gauss_taps(max(0.5, n_taps / 8.0), n_taps // 2)
    tail = (6, taps, border, 12.5) + (() if guided else (ua,))
    return (*small, lmin, step, *tail)


@pytest.mark.parametrize("h,w", D1_BUILD_SHAPES)
@pytest.mark.parametrize("n_taps,border,ua,hdr", [
    (17, BorderPolicy.CLAMP, False, False), (17, BorderPolicy.ZERO, True, True),
    (49, BorderPolicy.CLAMP, True, False), (49, BorderPolicy.ZERO, False, True),
    (1, BorderPolicy.CLAMP, False, True), (5, BorderPolicy.ZERO, False, False),
    (63, BorderPolicy.CLAMP, False, False)],
    ids=["17", "17_zero_ua_hdr", "49_ua", "49_zero_hdr", "1_hdr", "5_zero", "63"])
def test_build_grid_d1_kernel_equals_plain_bit_for_bit(cuda, h, w, n_taps, border, ua, hdr):
    """The bilateral grid at d = 1 (the sharded --turbo 1's build): grids of
    one cell, one row or column, ragged against the band, the ring and the
    strips; 1 to 63 taps, the ring wider than the image; both borders,
    uniform alpha, HDR values."""
    args = _d1_build_args(False, 0, h, w, n_taps, border, ua, hdr)
    got = fast.build_grid(*args, d=1)
    torch.cuda.synchronize()
    assert torch.equal(got, fast.build_grid_plain(*args))
    assert stencils.launches["build_grid_d1"] == 1 and stencils.launches["build_grid"] == 0


@pytest.mark.parametrize("h,w", D1_BUILD_SHAPES)
@pytest.mark.parametrize("n_taps,border,hdr", [
    (17, BorderPolicy.CLAMP, False), (17, BorderPolicy.ZERO, True),
    (49, BorderPolicy.CLAMP, True), (3, BorderPolicy.ZERO, False),
    (63, BorderPolicy.CLAMP, False)],
    ids=["17", "17_zero_hdr", "49_hdr", "3_zero", "63"])
def test_build_guided_grid_d1_kernel_equals_plain_bit_for_bit(cuda, h, w, n_taps, border, hdr):
    """The guided grid at d = 1 (the --turbo 1 layers' build), likewise; at
    49 and 63 taps on the tile of one block a multiprocessor."""
    args = _d1_build_args(True, 2, h, w, n_taps, border, hdr=hdr)
    got = fast.build_guided_grid(*args, d=1)
    torch.cuda.synchronize()
    assert torch.equal(got, fast.build_guided_grid_plain(*args))
    assert stencils.launches["build_guided_grid_d1"] == 1
    assert stencils.launches["build_guided_grid"] == 0


@pytest.mark.parametrize("guided", [False, True], ids=["bilateral", "guided"])
def test_build_d1_kernels_on_a_non_finite_frame(cuda, guided):
    """One +inf, one -inf and one NaN value in the frame(s): the kernel's
    non-finite cells are the plain version's, NaN, +inf and -inf apart, and
    every other cell is its bits; on the finite frame's grid range and on
    the frame's own (not finite)."""
    args = _d1_build_args(guided, 4, 61, 83, 17, BorderPolicy.CLAMP)
    n_small = 2 if guided else 1
    small = []
    for s in args[:n_small]:
        s = s.clone()
        s[10, 20, 0], s[30, 40, 1], s[50, 60, 2] = float("inf"), float("-inf"), float("nan")
        small.append(s)
    build = fast.build_guided_grid if guided else fast.build_grid
    plain = fast.build_guided_grid_plain if guided else fast.build_grid_plain
    for rng in (args[n_small : n_small + 2], fast.grid_range(small[-1], 6)):
        a = (*small, *rng, *args[n_small + 2 :])
        got, want = build(*a, d=1), plain(*a)
        torch.cuda.synchronize()
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(got.float()), f(want.float()))
        finite = torch.isfinite(got.float())
        assert bool((~finite).any())
        assert torch.equal(got.view(torch.int16)[finite], want.view(torch.int16)[finite])


@pytest.mark.parametrize("guided,n_taps,blocks", [(False, 17, 2), (True, 17, 2),
                                                  (False, 49, 2), (True, 49, 1)])
def test_build_d1_kernel_info(cuda, guided, n_taps, blocks):
    """The d = 1 body's tiles launch: registers without spills, and the
    blocks a multiprocessor build_d1_tile counts (two at the main path's tap
    counts, one for the guided grid at 49 taps)."""
    info = fast.build_d1_info(cuda, n_taps, BorderPolicy.CLAMP, guided=guided)
    tile = fast.build_d1_tile(n_taps, stencils.max_shared_bytes(cuda), 2 if guided else 1)
    assert info["spill_bytes"] == 0 and 0 < info["registers"] <= 255
    assert info["blocks_per_sm"] == tile.blocks_per_sm(stencils.max_shared_bytes(cuda)) == blocks
    assert info["shared_bytes"] == tile.shared_bytes


def test_build_d1_launchers_refuse_a_tile_they_cannot_take(cuda):
    """The d = 1 launchers refuse a layout whose taps overrun the block's
    shared memory, more vertical-pass groups than the block's threads
    cover, or a bilateral tile that stages a second image
    (cudaErrorInvalidValue, 1)."""
    small, lmin, step, _, taps = _d1_build_args(False, 0, 61, 83, 17, BorderPolicy.CLAMP)[:5]
    grid = torch.empty((6, 61, 83, 4), dtype=torch.bfloat16, device=cuda)
    limit = stencils.max_shared_bytes(small.device)
    tile = fast.build_d1_tile(taps.size, limit, 1)
    short, few, two = tile.launch_args(), tile.launch_args(), fast.build_d1_tile(taps.size, limit, 2)
    short[-1] -= 4  # shared bytes
    few[1] = 3  # groups: 3 x the staged columns > the block's threads
    lib = stencils._build.library()
    for geom, want in ((tile.launch_args(), 0), (short, 1), (few, 1), (two.launch_args(), 1)):
        rc = lib.idf_build_grid_d1(
            small.data_ptr(), lmin.data_ptr(), step.data_ptr(), grid.data_ptr(), 61, 83, 6,
            taps.ctypes.data, taps.size, 1.0, 0, 0, geom.ctypes.data, stencils._stream(small))
        assert rc == want


def test_build_d1_body_equals_build_grid_kernel(cuda):
    """At d = 1 the wrappers launch the d = 1 body and at d = 2 the 2-D body
    on the same pooled image: the same grid, the one bit for bit the other,
    each under its own count."""
    args = _d1_build_args(False, 6, 97, 131, 17, BorderPolicy.CLAMP)
    assert torch.equal(fast.build_grid(*args, d=1), fast.build_grid(*args, d=2))
    gargs = _d1_build_args(True, 6, 97, 131, 17, BorderPolicy.ZERO)
    assert torch.equal(fast.build_guided_grid(*gargs, d=1), fast.build_guided_grid(*gargs, d=2))
    assert {k: n for k, n in stencils.launches.items() if n} == {
        "build_grid_d1": 1, "build_grid": 1, "build_guided_grid_d1": 1, "build_guided_grid": 1}


def _nonfinite_guide(img):
    """img with NaN, +inf and -inf values, each in its own channel, row and
    column, and a pixel NaN in every channel."""
    out = img.clone()
    out[3, 5, 0], out[7, 11, 1], out[11, 17, 2] = float("nan"), float("inf"), float("-inf")
    out[15, 23, :3] = float("nan")
    return out


def _assert_same_nonfinite(got, want, tol=None):
    """NaN, +inf and -inf at the same positions; the finite values bit for
    bit, or within tol (rtol, atol)."""
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(g), f(w)), f.__name__
        finite = torch.isfinite(g)
        if tol is None:
            assert torch.equal(g[finite].view(torch.int32), w[finite].view(torch.int32))
        else:
            _close(g[finite], w[finite], **tol)


@pytest.mark.parametrize("d", [1, 2, 4])
@pytest.mark.parametrize("nan_range", [False, True], ids=["nan_guide", "nan_range"])
def test_slices_keep_a_nan_level_coordinate(cuda, d, nan_range):
    """A NaN level coordinate (v - lmin) * inv_step, from a NaN guide value
    or a range that is not finite (lmin NaN in green): fminf/fmaxf would clip
    it to 0, the plain versions' clamp keeps it, and every slice kernel gives
    NaN in that channel's sums (alpha's under green's) as its plain version
    does (fast.cu:level_t, tent); +inf and -inf clip to the ends in both. On
    a finite grid, whole and in the slab form; the fused kernels bit for bit
    the two kernels. Each kernel launches: no wrapper hands the frame to its
    plain version."""
    img = _smooth_image(4, cuda, 48, 64)
    guide = _nonfinite_guide(img)
    small, small_l = fast.pool_plain(img, d, BorderPolicy.CLAMP), fast.pool_plain(
        _smooth_image(5, cuda, 48, 64), d, BorderPolicy.CLAMP)
    lmin, step = fast.grid_range(small, 5)
    if nan_range:
        lmin[1] = float("nan")
    taps = fast._grid_taps(2.0, d)
    build = (small, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5)
    grid = fast.build_grid_plain(*build, False)
    args = (guide, grid, lmin, 1.0 / step, d, None)
    got = fast.slice_grid(*args)
    _assert_same_nonfinite(got, fast.slice_grid_plain(*args), None if d == 1 else dict(
        rtol=1e-5, atol=1e-6))
    assert bool(torch.isnan(got[15, 23]).all()) and bool(torch.isnan(got[3, 5, 0]))
    assert bool(torch.isnan(got[..., 1]).all()) == nan_range
    rows = 16 if d == 1 else 24
    band = fast.slice_grid(guide[rows:].contiguous(), grid[:, rows // d - 1 :].contiguous(),
                           lmin, 1.0 / step, d, None, rows, grid.shape[1], rows // d - 1)
    _assert_same_nonfinite(band, got[rows:])
    gbuild = (small, small_l, lmin, step, 5, taps, BorderPolicy.CLAMP, 12.5)
    ggrid = fast.build_guided_grid_plain(*gbuild)
    gargs = (guide, ggrid, lmin, 1.0 / step, d)
    ggot = fast.slice_guided_grid(*gargs)
    _assert_same_nonfinite(ggot, fast.slice_guided_grid_plain(*gargs), dict(rtol=1e-5, atol=1e-6))
    assert bool(torch.isnan(ggot[0][..., 3]).all()) == bool(torch.isnan(ggot[1][..., 1]).all()) \
        == nan_range
    if d > 1:
        fused = fast.fused_grid(small, guide, lmin, step, 1.0 / step, 5, taps,
                                BorderPolicy.CLAMP, 12.5, d)
        _assert_same_nonfinite(fused, fast.slice_grid(guide, fast.build_grid(
            *build, False, d=d), lmin, 1.0 / step, d))
        gfused = fast.fused_guided(small, small_l, guide, lmin, step, 1.0 / step, 5, taps,
                                   BorderPolicy.CLAMP, 12.5, d)
        _assert_same_nonfinite(gfused, fast.slice_guided_grid(
            guide, fast.build_guided_grid(*gbuild, d=d), lmin, 1.0 / step, d))
    names = ("slice_grid", "slice_guided_grid") if d > 1 else ("slice_grid_d1",
                                                               "slice_guided_grid_d1")
    assert all(stencils.launches[k] > 0 for k in names)
    assert d == 1 or stencils.launches["fused_grid"] == stencils.launches["fused_guided"] == 1


def test_slice_d1_kernel_on_a_nan_grid_region(cuda):
    """The d = 1 slice on a grid whose cells are NaN in a region, as a NaN
    pixel builds them on the sharded range (every level, within the blur's
    reach): the kernel's NaN values are its plain version's but the row
    above and the column left of the region, whose zero-weight bilinear
    corner (the cell below, the cell right) the own-cell read skips
    (ROADMAP.md queue C); elsewhere bit for bit."""
    img = _smooth_image(6, cuda, 40, 56)
    small = fast.pool_plain(img, 1, BorderPolicy.CLAMP)
    lmin, step = fast.grid_range(small, 6)
    grid = fast.build_grid_plain(small, lmin, step, 6, fast._grid_taps(2.0, 1),
                                 BorderPolicy.CLAMP, 12.5, False)
    grid[:, 10:20, 30:40, 1] = float("nan")
    args = (img, grid, lmin, 1.0 / step, 1, None)
    got, want = fast.slice_grid(*args), fast.slice_grid_plain(*args)
    torch.cuda.synchronize()
    region = torch.zeros_like(got, dtype=torch.bool)
    region[10:20, 30:40, 1] = True
    fringe = torch.zeros_like(region)
    fringe[9:20, 29:40, 1] = True
    fringe &= ~region
    assert torch.equal(torch.isnan(got), region)
    assert torch.equal(torch.isnan(want), region | fringe)
    finite = ~torch.isnan(want)
    assert torch.equal(got[finite].view(torch.int32), want[finite].view(torch.int32))


def test_overlap_session_at_1080p_on_card(cuda, tmp_path):
    """The benchmark's overlap configuration (`temporal_nlm_overlap_1080p`)
    through one Session.run on the card, a shot of ten 1080p PNGs: the
    prefetcher waits for the eight distinct frames of the window (the
    target is in it twice and decoded once), stages each of the nine in
    pinned memory and hands out nine, and the output is the plain
    reference's within the configuration's max_abs_err."""
    import sys

    from image_denoising_filter_tpu_torch.utils import timing

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from portbench import harness
    from portbench.reference import png
    from portbench.reference import temporal_nlm_overlap as overlap

    cell = harness.find_cell(harness.ROOT, "tnlm-1080p-overlap-files")
    cfg, fam = cell.config, harness.family(harness.ROOT, cell)
    u8 = fam.host_shots(cfg, 1, 2**31 + 22, cuda)[0]
    for i, img in enumerate(u8):
        (tmp_path / f"frame_{i:04d}.png").write_bytes(png.encode(img, 1))
    out = tmp_path / "out"
    out.mkdir()
    kw, run_cfg = fam.session(cfg, "program")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        result = Session(str(tmp_path / "frame_0003.png"), device=cuda, output_dir=str(out),
                         **kw).run(run_cfg)
    t = timing.totals
    assert result.frame_loader == "native"
    assert t[timing.PREFETCH_FRAMES] == [0, 9]
    assert t[timing.PREFETCH_WAIT][1] == 8 and t[timing.PREFETCH_PIN][1] == 9
    assert t[timing.PREFETCH_WAIT][0] > 0 and t[timing.PREFETCH_PIN][0] > 0
    shot = torch.from_numpy(png.to_float(u8)).to(cuda)
    want = overlap.temporal_nlm_overlap(shot, 3, cfg["params"]).cpu().numpy()
    assert np.abs(result.image - want).max() <= cfg["limits"]["max_abs_err"]


def test_layer_guided_forward_peaks_at_two_sets_of_sums(cuda):
    """LayerGuidedDenoiser.forward over three layers folds each layer's
    partials into its sums in place: above its inputs, the call's device
    memory peaks at two sets of sums (weightColor and normWeight) plus its
    output, where summing out of place held three sets."""
    h, w = 256, 384
    target = _image(0, cuda, h, w)
    layers = torch.stack([_image(s, cuda, h, w) for s in (1, 2, 3)])
    model = LayerGuidedDenoiser(LP)
    model(target, layers)  # first use: the kernel library is loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = model(target, layers)
    torch.cuda.synchronize()
    sums = h * w * 4 * 4 + h * w * 4
    assert torch.cuda.max_memory_allocated() - base <= 2 * sums + out.numel() * 4
