"""The half-row NLM kernel's tile and staged windows (ops/stencils.py:hrw_tile).

The CUDA kernel trusts this geometry: it stages the windows the tile names
and indexes them with the tile's offsets. These tests walk every block of
small images with the kernel's index arithmetic and check that every output
row reads the weight cells of its row upsample, every weight cell the three
e rows of its 3-cell sum, every squared-difference position and every value
tap of every candidate a staged cell and pixel, landing on the cell and the
pixel the plain version reads (ops/eager.py:_nlm_hrw_weights). Rows and
columns are independent, so each axis is checked over all its offsets at
once. Also: the cell clamp into [-1, hc] reads what the border policy gives.
"""

import itertools

import numpy as np
import pytest

from image_denoising_filter_tpu_torch.config import BorderPolicy, NlmParams
from image_denoising_filter_tpu_torch.ops import stencils

# The shared memory a block of the H100 may opt into, and a block's without
# opting in.
H100_SHARED_OPTIN = 232448
DEFAULT_SHARED = 48 * 1024
LANES = stencils.HRW_LANES


def _hrw(**kw):
    return NlmParams(search_stride=2, weights_halfres=True, **kw)


def _check_rows(h, y0, tile, dys):
    """One block's rows: outputs y0 + [0, th) inside the image, their weight
    cells, the e rows of those cells, the neighbour cells and value rows."""
    assert y0 % 2 == 0
    th = tile.th
    y = np.arange(y0, min(y0 + th, h))
    # the row upsample: row 2i reads cells i-1, i; row 2i+1 cells i, i+1
    ca = y // 2 - 1 + (y & 1)
    pair = (y - y0) // 2
    for k, cell in enumerate((ca, ca + 1)):
        wr = pair + (y & 1) + k  # the weight row the kernel reads
        assert wr.min() >= 0 and wr.max() < th // 2 + 2
        np.testing.assert_array_equal(y0 // 2 - 1 + wr, cell)
    # the weight cells' e rows, c - 1 .. c + 1, at rows wr .. wr + 2 of e
    wr = np.arange(th // 2 + 2)[:, None]
    er = wr + np.arange(3)[None, :]
    assert er.max() < tile.e_h
    np.testing.assert_array_equal(y0 // 2 - 2 + er, (y0 // 2 - 1 + wr) + np.arange(-1, 2))
    # each e row's neighbour cell and each output's value row, per candidate
    r = np.arange(tile.e_h)[:, None]
    d = np.asarray(dys)[None, :]
    staged = r + (d - tile.oy) // 2
    assert staged.min() >= 0 and staged.max() < tile.cell_h
    np.testing.assert_array_equal(y0 // 2 - 2 + tile.oy // 2 + staged, y0 // 2 - 2 + r + d // 2)
    val = (y - y0)[:, None] + d - tile.oy
    assert val.min() >= 0 and val.max() < tile.win_h
    np.testing.assert_array_equal(y0 + tile.oy + val, y[:, None] + d)


def _check_cols(w, x0, tile, dxs):
    """One block's columns: each output's 6 lanes in the e region, each
    lane's neighbour lane and each output's value column, per candidate."""
    x = np.arange(x0, min(x0 + tile.tw, w))[:, None, None]
    j = np.arange(LANES)[None, :, None]
    d = np.asarray(dxs)[None, None, :]
    c = x - x0 + j  # the e lane of the output's lane x - 3 + j
    assert c.min() >= 0 and c.max() < tile.e_w
    np.testing.assert_array_equal(x0 - LANES // 2 + c, x - LANES // 2 + j)
    staged = c + d - tile.ox
    assert staged.min() >= 0 and staged.max() < tile.cell_w
    np.testing.assert_array_equal(x0 - LANES // 2 + tile.ox + staged, x - LANES // 2 + j + d)
    val = (x - x0) + d - tile.ox
    assert val.min() >= 0 and val.max() < tile.win_w
    np.testing.assert_array_equal(x0 + tile.ox + val, x + d)


def _offsets(params):
    cands = stencils.nlm_candidates(params) or [(0, 0)]
    return sorted({dy for dy, _ in cands}), sorted({dx for _, dx in cands})


@pytest.mark.parametrize("s", range(0, 33))
def test_windows_hold_every_tap(s):
    """s 0-32, the disk on and off, both tap forms; images with odd and even
    heights below, at and above the tile, and widths likewise."""
    for disk, bf16 in itertools.product((False, True), (False, True)):
        params = _hrw(search_radius=s, search_disk=disk)
        tile = stencils.hrw_tile(params, bf16, H100_SHARED_OPTIN)
        assert tile.th % 2 == 0 and tile.tw == stencils.HRW_TILE_W
        assert tile.oy % 2 == 0
        # the target's e region fits HRW_E_PER_THREAD a thread
        assert tile.e_h * tile.e_w <= stencils.HRW_E_PER_THREAD * stencils.HRW_THREADS
        assert tile.shared_bytes <= H100_SHARED_OPTIN
        dys, dxs = _offsets(params)
        assert all(dy % 2 == 0 for dy in dys)
        for h in (1, tile.th - 1, tile.th, 2 * tile.th + 3, 2 * tile.th + 4):
            for y0 in range(0, h, tile.th):
                _check_rows(h, y0, tile, dys)
        for w in (5, tile.tw, 2 * tile.tw + 7):
            for x0 in range(0, w, tile.tw):
                _check_cols(w, x0, tile, dxs)


def _pooled_row(img_rows, ci, border):
    """Cell ci of a column of rows under the border policy, unclamped."""
    h = len(img_rows)

    def row(y):
        if border == BorderPolicy.CLAMP:
            return img_rows[min(max(y, 0), h - 1)]
        return img_rows[y] if 0 <= y < h else 0.0

    return 0.5 * (row(2 * ci) + row(2 * ci + 1))


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("h", [1, 2, 7, 8])
def test_cell_clamp_reads_the_border_policy(h, border):
    """Every cell before -1 equals cell -1 and every cell past hc = ceil(h/2)
    equals cell hc under either border policy, so the kernel clamps the cell
    index into [-1, hc] (the cells the plain version pads with)."""
    rows = np.arange(1, h + 1, dtype=np.float64)
    hc = (h + 1) // 2
    for ci in range(-8, hc + 8):
        clamped = min(max(ci, -1), hc)
        assert _pooled_row(rows, clamped, border) == _pooled_row(rows, ci, border)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("s", [0, 1, 7, 16, 32])
def test_shared_bytes_match_the_layout(s, bf16):
    """The value window as float4, the cells as float4 or bf16 RGB, then e,
    the 3-cell sums and the weight cells as float32: back to back, each sized
    for what the kernel indexes and aligned for its loads."""
    tile = stencils.hrw_tile(_hrw(search_radius=s), bf16, H100_SHARED_OPTIN)
    tap = 8 if bf16 else 16
    half = tile.th // 2
    regions = [("window", 0, 16 * tile.win_h * tile.win_w, 16),
               ("cells", tile.cells_at, tap * tile.cell_h * tile.cell_w, 16),
               ("e", tile.e_at, 4 * tile.e_h * tile.e_w, 4),
               ("sums", tile.sums_at, 4 * (half + 2) * tile.e_w, 4),
               ("weights", tile.w_at, 4 * (half + 2) * tile.tw, 4)]
    end = 0
    for name, at, size, align in regions:
        assert at == end and at % align == 0, name
        end = at + size
    assert tile.shared_bytes == end
    assert stencils.hrw_layout(tile.th, tile.win_h, tile.win_w, tile.cell_h, tile.cell_w,
                               bf16) == (tile.cells_at, tile.e_at, tile.sums_at, tile.w_at,
                                         tile.shared_bytes)
    assert list(tile.launch_args()) == [
        tile.th, tile.oy, tile.ox, tile.win_h, tile.win_w, tile.cell_h, tile.cell_w,
        tile.cells_at, tile.e_at, tile.sums_at, tile.w_at, tile.shared_bytes]
    dys, dxs = _offsets(_hrw(search_radius=s))
    assert tile.win_h == tile.th + max(dys) - min(dys)
    assert tile.win_w == tile.tw + max(dxs) - min(dxs)
    assert tile.cell_h == half + 4 + (max(dys) - min(dys)) // 2
    assert tile.cell_w == tile.win_w + LANES - 1


def test_turbo_tiles_on_the_h100():
    """At the turbo parameters (s = 7, 49 candidates) both tap forms take the
    16 x 32 tile under 48 KB; s = 32 (1024 candidates, the table's limit)
    fits the H100 above it; s = 0 has no candidate and stages the self
    match's windows."""
    for bf16, nbytes in ((False, 38360), (True, 31304)):
        tile = stencils.hrw_tile(_hrw(), bf16, H100_SHARED_OPTIN)
        assert (tile.th, tile.win_h, tile.win_w, tile.cell_h, tile.cell_w) == (16, 28, 44, 18, 49)
        assert tile.shared_bytes == nbytes < DEFAULT_SHARED
    wide = _hrw(search_radius=32)
    assert len(stencils.nlm_candidates(wide)) == stencils.MAX_CANDIDATES
    for bf16 in (False, True):
        tile = stencils.hrw_tile(wide, bf16, H100_SHARED_OPTIN)
        assert tile.th == 16 and DEFAULT_SHARED < tile.shared_bytes <= H100_SHARED_OPTIN
    none = _hrw(search_radius=0)
    assert stencils.nlm_candidates(none) == []
    tile = stencils.hrw_tile(none, True, H100_SHARED_OPTIN)
    assert (tile.oy, tile.ox, tile.win_h, tile.win_w) == (0, 0, 16, 32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("s", [7, 32])
def test_tile_shrinks_before_it_refuses(s, bf16):
    """Each height of HRW_TILE_HS is taken at exactly its own bytes, and one
    byte less takes the next shorter one; under the shortest one's bytes
    hrw_tile refuses."""
    params = _hrw(search_radius=s)
    full = stencils.hrw_tile(params, bf16, H100_SHARED_OPTIN)
    dy_range = full.win_h - full.th
    for th in stencils.HRW_TILE_HS:
        nbytes = stencils.hrw_layout(th, th + dy_range, full.win_w, th // 2 + 4 + dy_range // 2,
                                     full.cell_w, bf16)[-1]
        assert stencils.hrw_tile(params, bf16, nbytes).th == th
        if th > min(stencils.HRW_TILE_HS):
            assert stencils.hrw_tile(params, bf16, nbytes - 1).th == th // 2
        else:
            with pytest.raises(ValueError, match="no half-row NLM tile fits"):
                stencils.hrw_tile(params, bf16, nbytes - 1)


def test_hrw_tile_refuses_other_strides_and_patches():
    """The half-row weights take search stride 2 and patch radius 3 only."""
    for params in (NlmParams(weights_halfres=True),
                   NlmParams(search_stride=2, patch_radius=2, weights_halfres=True)):
        with pytest.raises(ValueError, match="weights_halfres requires"):
            stencils.hrw_tile(params, False, H100_SHARED_OPTIN)
