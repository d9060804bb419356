"""The two grid slices at d = 1 without a card: the identity the bilateral
grid's own-cell kernel (fast.cu: slice_grid_d1_kernel) rests on, held bit
for bit against both plain slices.

At d = 1 the bilinear taps fall on the pixel's own cell with weight zero on
the others, and channel c's tent is nonzero at levels floor(t_c) and
floor(t_c) + 1 only. So each channel's slice is its own cell at those two
levels, summed from +0 in ascending order: `own_cell_slice` below, which
computes exactly that, equals slice_grid_plain and slice_guided_grid_plain
bit for bit (their float32 words equal, so a -0.0 for a +0.0 shows)."""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.ops import fast

# The planes each RGB channel's tent weighs: the bilateral grid's r, g (and
# alpha under green's tent), b; the guided grid's numerator and norm planes
# (alpha's numerator under green's).
BILATERAL_PLANES = ((0,), (1, 3), (2,))
GUIDED_PLANES = ((0, 4), (1, 3, 5), (2, 6))


def own_cell_slice(guide, grid, lmin, inv_step, planes_of, slab=None):
    """The d = 1 slice as the own-cell kernel computes it: for each RGB
    channel its levels lo = floor(t) and hi = lo + 1 (clamped to K - 1, its
    tent zero there), tents by the kernels' expression, and each plane the
    channel weighs summed as +0 + e_lo * cell[lo], then + e_hi * cell[hi]
    where e_hi is not zero. slab: (y_off, hs_all, gy_off), the cell row
    clamp(y + y_off, 0, hs_all - 1) - gy_off."""
    levels = grid.shape[0]
    h, w, _ = guide.shape
    y_off, hs_all, gy_off = (0, grid.shape[1], 0) if slab is None else slab
    rows = (torch.arange(h) + y_off).clamp(0, hs_all - 1) - gy_off
    cells = grid.float()[:, rows]  # (K, h, w, planes)
    t = ((guide[..., :3] - lmin) * inv_step).clamp(0.0, levels - 1.0)
    out = torch.zeros((h, w, grid.shape[-1]), dtype=torch.float32)
    for c, planes in enumerate(planes_of):
        tc = t[..., c]
        lo = tc.floor().long()
        hi = (lo + 1).clamp(max=levels - 1)
        e_lo = (1.0 - (tc - lo.float()).abs()).clamp_min(0.0)
        e_hi = torch.where(lo + 1 < levels, (1.0 - (tc - (lo + 1).float()).abs()).clamp_min(0.0),
                           torch.zeros_like(tc))
        for p in planes:
            at_lo = cells[..., p].gather(0, lo[None]).squeeze(0)
            at_hi = cells[..., p].gather(0, hi[None]).squeeze(0)
            acc = torch.zeros_like(tc) + e_lo * at_lo
            out[..., p] = torch.where(e_hi != 0.0, acc + e_hi * at_hi, acc)
    return out


def same_bits(a, b):
    """torch.equal on the float32 words: -0.0 and +0.0 differ."""
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _frame(seed, h, w, hdr):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    if hdr:
        img[..., :3] = img[..., :3] * 45.0 - 5.0
    img[..., 3] = 1.0
    return torch.from_numpy(img)


def _grid(seed, levels, h, w, planes):
    """A random bf16 grid N(0, 3) with -0.0 in every third row and fourth
    column of cells."""
    cells = np.random.default_rng(seed).normal(0, 3, (levels, h, w, planes)).astype(np.float32)
    cells[:, ::3, ::4] = -0.0
    return torch.from_numpy(cells).to(torch.bfloat16)


def _range(img, levels):
    lo = img[..., :3].amin((0, 1))
    return lo, (levels - 1) / (img[..., :3].amax((0, 1)) - lo)


def _edges(img, lmin, inv_step, levels):
    """Pixels at t = 0, t = K - 1, whole levels, and beyond both ends."""
    step = 1.0 / inv_step
    for x, k in enumerate((0.0, levels - 1.0, 1.0, levels - 2.0, -3.0, levels + 4.0)):
        img[0, x, :3] = lmin + k * step
    return img


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
@pytest.mark.parametrize("levels", [2, 6, 8])
def test_slice_grid_plain_at_d1_is_the_own_cell_sum(levels, hdr):
    img = _frame(0, 37, 53, hdr)
    lmin, inv_step = _range(img, levels)
    img = _edges(img, lmin, inv_step, levels)
    grid = _grid(levels, levels, 37, 53, 4)
    want = own_cell_slice(img, grid, lmin, inv_step, BILATERAL_PLANES)
    assert same_bits(fast.slice_grid_plain(img, grid, lmin, inv_step, 1), want)
    assert same_bits(fast.slice_grid(img, grid, lmin, inv_step, 1), want)


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
def test_slice_grid_plain_at_d1_uniform_alpha_is_the_own_cell_sum(hdr):
    img = _frame(1, 29, 41, hdr)
    lmin, inv_step = _range(img, 6)
    grid = _grid(1, 6, 29, 41, 4)
    grid[..., 3] = 0.0
    alpha = torch.tensor(0.75)
    want = own_cell_slice(img, grid, lmin, inv_step, BILATERAL_PLANES)
    want[..., 3] = alpha
    assert same_bits(fast.slice_grid_plain(img, grid, lmin, inv_step, 1, alpha), want)


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
@pytest.mark.parametrize("levels", [2, 6, 8])
def test_slice_guided_grid_plain_at_d1_is_the_own_cell_sum(levels, hdr):
    img = _frame(2, 37, 53, hdr)
    lmin, inv_step = _range(img, levels)
    img = _edges(img, lmin, inv_step, levels)
    grid = _grid(levels + 10, levels, 37, 53, 8)
    grid[..., 7] = 0.0
    want = own_cell_slice(img, grid, lmin, inv_step, GUIDED_PLANES)
    wc, nw = fast.slice_guided_grid_plain(img, grid, lmin, inv_step, 1)
    assert same_bits(wc, want[..., :4]) and same_bits(nw, want[..., 4:7])


def test_own_cell_sum_keeps_negative_zero_cells_at_plus_zero():
    """A -0.0 cell enters the sum as +0 + e * (-0) = +0, as the bilinear
    form's a * 1 + b * 0 does; the sum is never -0."""
    img = _frame(3, 9, 16, False)
    lmin, inv_step = _range(img, 6)
    grid = torch.full((6, 9, 16, 4), -0.0, dtype=torch.bfloat16)
    got = fast.slice_grid_plain(img, grid, lmin, inv_step, 1)
    assert same_bits(got, own_cell_slice(img, grid, lmin, inv_step, BILATERAL_PLANES))
    assert not torch.signbit(got).any() and not got.any()


@pytest.mark.parametrize("hdr", [False, True], ids=["ldr", "hdr"])
def test_slab_slices_at_d1_are_the_own_cell_sum(hdr):
    """The slab form at d = 1 on the four bands of a 1x4 split: each band
    against its slab of rows + 2 grid rows (y_off, hs_all, gy_off nonzero
    but for the first band's y_off), both grids."""
    h, w, levels = 36, 23, 6
    img = _frame(4, h, w, hdr)
    lmin, inv_step = _range(img, levels)
    grid, ggrid = _grid(4, levels, h, w, 4), _grid(5, levels, h, w, 8)
    rows = h // 4
    for i in range(4):
        band = img[i * rows : (i + 1) * rows].contiguous()
        lo, hi = max(i * rows - 1, 0), min((i + 1) * rows + 1, h)
        slab = (i * rows, h, lo)
        want = own_cell_slice(band, grid[:, lo:hi], lmin, inv_step, BILATERAL_PLANES, slab)
        got = fast.slice_grid(band, grid[:, lo:hi].contiguous(), lmin, inv_step, 1, None, *slab)
        assert same_bits(got, want), f"band {i}"
        want = own_cell_slice(band, ggrid[:, lo:hi], lmin, inv_step, GUIDED_PLANES, slab)
        wc, nw = fast.slice_guided_grid(band, ggrid[:, lo:hi].contiguous(), lmin, inv_step, 1,
                                        *slab)
        assert same_bits(wc, want[..., :4]) and same_bits(nw, want[..., 4:7]), f"band {i}"
