"""The guided build kernel's tile and staged window (ops/fast.py:
build_tile with two staged images).

The CUDA kernel (fast.cu: build_guided_grid_kernel) trusts this geometry: it
stages the pooled target and layer over the tile plus the blur halo with
the build's border rule, and its vertical and horizontal passes index that
window. These tests walk every block of small grids at every downsample with
the kernel's index arithmetic and check that every tap of every cell of the
grid reads a staged pixel, through the strips of the vertical pass and the
columns of the horizontal pass, and that the staged pixel is the one the
plain version (ops/fast.py:build_guided_grid_plain) pads and blurs under
either border policy. Rows and columns are independent, so each axis is
checked over all its offsets at once.
"""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import BorderPolicy
from image_denoising_filter_tpu_torch.ops import fast

H100_SHARED_OPTIN = 232448
DEFAULT_SHARED = 48 * 1024
STRIP = fast.BUILD_STRIP
ODD_TAPS = range(1, fast.MAX_TAPS, 2)  # 1 .. 63, the kernel's table


def _staged(n, t0, r, n_staged, border):
    """The pooled index each staged position of an axis holds, as
    stage_window stages it: clamped into the grid (CLAMP), or -1 for a zero
    pixel (ZERO)."""
    idx = t0 - r + np.arange(n_staged)
    if border == BorderPolicy.CLAMP:
        return np.clip(idx, 0, n - 1)
    return np.where((idx >= 0) & (idx < n), idx, -1)


def _padded(n, r, border):
    """The pooled index each position of the plain version's radius-padded
    axis holds (ops/eager.py:_pad_dim): edge cells, or -1 for a zero."""
    idx = np.arange(-r, n + r)
    if border == BorderPolicy.CLAMP:
        return np.clip(idx, 0, n - 1)
    return np.where((idx >= 0) & (idx < n), idx, -1)


def _check_rows(hs, y0, tile, border):
    """One block's cell rows: the vertical pass's strips of STRIP rows walk
    staged rows cy0 + a for a < n_taps + STRIP - 1 while inside the window;
    cell row cy0 + j reads tap a - j there. Each cell row of the grid gets
    every tap, at the staged row the plain version's padded row holds."""
    n, r = 2 * tile.r + 1, tile.r
    rows = min(tile.th, hs - y0)
    staged = _staged(hs, y0, r, tile.srows, border)
    padded = _padded(hs, r, border)
    for cy0 in range(0, rows, STRIP):
        walked = [a for a in range(n + STRIP - 1) if cy0 + a < tile.srows]
        for j in range(min(STRIP, rows - cy0)):
            taps = [a - j for a in walked if 0 <= a - j < n]
            assert taps == list(range(n))  # every tap, in order
            y = y0 + cy0 + j
            np.testing.assert_array_equal(staged[cy0 + j + np.arange(n)], padded[y + np.arange(n)])
    assert rows <= tile.th  # the vertical sums' planes hold th rows


def _check_cols(ws, x0, tile, border):
    """One block's cell columns: the vertical pass sums staged columns below
    cols + 2r, and cell column cx reads columns cx + b, b < n_taps, at the
    staged column the plain version's padded column holds."""
    n, r = 2 * tile.r + 1, tile.r
    cols = min(tile.tw, ws - x0)
    vcols = cols + 2 * r
    assert vcols <= tile.scols
    staged = _staged(ws, x0, r, tile.scols, border)
    padded = _padded(ws, r, border)
    cx = np.arange(cols)[:, None]
    b = np.arange(n)[None, :]
    assert (cx + b).max() < vcols
    np.testing.assert_array_equal(staged[cx + b], padded[x0 + cx + b])


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("d", fast.DOWNSAMPLES)
def test_window_holds_every_tap(d, border):
    """Every odd tap count of the kernel's table, at each downsample of the
    guided grid, over grids below, at and above one tile in each axis."""
    for n_taps in ODD_TAPS:
        tile = fast.build_tile(n_taps, H100_SHARED_OPTIN, 2)
        assert tile.r == n_taps // 2 and tile.shared_bytes <= H100_SHARED_OPTIN
        for h in (1, 2 * d * tile.th + 3 * d - 1):
            hs = -(-h // d)
            for y0 in range(0, hs, tile.th):
                _check_rows(hs, y0, tile, border)
        for w in (3, d * tile.tw, 2 * d * tile.tw + 5):
            ws = -(-w // d)
            for x0 in range(0, ws, tile.tw):
                _check_cols(ws, x0, tile, border)


@pytest.mark.parametrize("n_taps", [1, 3, 9, 17, 63])
def test_shared_bytes_match_the_layout(n_taps):
    """The staged target and layer as float4, the three weight planes and the
    seven vertical-sum planes as float32: back to back, each sized for what
    the kernel indexes and aligned for its loads."""
    tile = fast.build_tile(n_taps, H100_SHARED_OPTIN, 2)
    n_staged = tile.srows * tile.scols
    regions = [("target", 0, 16 * n_staged, 16), ("layer", tile.l_at, 16 * n_staged, 16),
               ("weights", tile.w_at, 12 * n_staged, 4),
               ("vertical sums", tile.v_at, 28 * tile.th * tile.scols, 4)]
    end = 0
    for name, at, size, align in regions:
        assert at == end and at % align == 0, name
        end = at + size
    assert tile.shared_bytes == end
    assert fast.build_layout(tile.th, tile.tw, tile.r, 2) == (
        tile.l_at, tile.w_at, tile.v_at, tile.shared_bytes)
    assert list(tile.launch_args()) == [tile.th, tile.tw, tile.l_at, tile.w_at, tile.v_at,
                                        tile.shared_bytes]


def test_tiles_on_the_h100():
    """The main path's tap counts take the 16 x 32 tile (d = 8 at sigma_s 2
    and 6: 3 and 7 taps; d = 2: 9; d = 1: 17); the widest table, 63 taps,
    takes one row of 16 cells; every odd tap count fits."""
    for sigma_s, d, n_taps in ((2.0, 8, 3), (6.0, 8, 7), (2.0, 2, 9), (2.0, 1, 17)):
        assert fast._grid_taps(sigma_s, d).size == n_taps
        tile = fast.build_tile(n_taps, H100_SHARED_OPTIN, 2)
        assert (tile.th, tile.tw) == (16, 32)
    assert fast.build_tile(9, H100_SHARED_OPTIN, 2).shared_bytes == 60160
    widest = fast.build_tile(63, H100_SHARED_OPTIN, 2)
    assert (widest.th, widest.tw, widest.shared_bytes) == (1, 16, 218400)


@pytest.mark.parametrize("n_taps", [9, 63])
def test_tile_shrinks_before_it_refuses(n_taps):
    """Each tile of BUILD_TILES is taken at exactly its own bytes, and
    one byte less takes a later one; under the last one's bytes
    build_tile refuses."""
    r = n_taps // 2
    tiles = fast.BUILD_TILES
    for i, (th, tw) in enumerate(tiles):
        nbytes = fast.build_layout(th, tw, r, 2)[-1]
        tile = fast.build_tile(n_taps, nbytes, 2)
        assert (tile.th, tile.tw) in tiles[: i + 1]
        if i + 1 < len(tiles):
            smaller = fast.build_tile(n_taps, nbytes - 1, 2)
            assert tiles.index((smaller.th, smaller.tw)) > i
        else:
            with pytest.raises(ValueError, match="no grid build tile fits"):
                fast.build_tile(n_taps, nbytes - 1, 2)


def test_tiles_shrink_in_area():
    """Each later tile holds fewer cells, so a tighter limit never takes a
    larger tile."""
    areas = [th * tw for th, tw in fast.BUILD_TILES]
    assert areas == sorted(areas, reverse=True) and len(set(areas)) == len(areas)


@pytest.mark.parametrize("n_taps", [0, 2, -1])
def test_even_or_empty_tap_tables_are_refused(n_taps):
    with pytest.raises(ValueError, match="odd number of blur taps"):
        fast.build_tile(n_taps, H100_SHARED_OPTIN, 2)


# ---------------------------------------------------------------------------
# One staged image: the bilateral grid's build (the same kernel body)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("d", fast.DOWNSAMPLES)
def test_one_image_window_holds_every_tap(d, border):
    """The bilateral build stages the pooled image alone: every odd tap count
    of the kernel's table at each downsample of the bilateral grid, over
    grids below, at and above one tile in each axis, reads the pixel the
    plain version (ops/fast.py:build_grid_plain) pads."""
    for n_taps in ODD_TAPS:
        tile = fast.build_tile(n_taps, H100_SHARED_OPTIN, 1)
        assert tile.n_images == 1 and tile.l_at == 0 and tile.r == n_taps // 2
        assert tile.shared_bytes <= H100_SHARED_OPTIN
        for h in (1, 2 * d * tile.th + 3 * d - 1):
            hs = -(-h // d)
            for y0 in range(0, hs, tile.th):
                _check_rows(hs, y0, tile, border)
        for w in (3, d * tile.tw, 2 * d * tile.tw + 5):
            ws = -(-w // d)
            for x0 in range(0, ws, tile.tw):
                _check_cols(ws, x0, tile, border)


@pytest.mark.parametrize("n_taps", [1, 3, 9, 17, 63])
def test_one_image_shared_bytes_match_the_layout(n_taps):
    """The staged image at byte 0 is both payload and layer (l_at 0); the
    three weight planes and the seven vertical-sum planes follow it back to
    back."""
    tile = fast.build_tile(n_taps, H100_SHARED_OPTIN, 1)
    n_staged = tile.srows * tile.scols
    regions = [("image", 0, 16 * n_staged, 16), ("weights", tile.w_at, 12 * n_staged, 4),
               ("vertical sums", tile.v_at, 28 * tile.th * tile.scols, 4)]
    end = 0
    for name, at, size, align in regions:
        assert at == end and at % align == 0, name
        end = at + size
    assert tile.l_at == 0 and tile.shared_bytes == end
    assert fast.build_layout(tile.th, tile.tw, tile.r, 1) == (
        tile.l_at, tile.w_at, tile.v_at, tile.shared_bytes)


def test_one_image_tiles_on_the_h100():
    """The bilateral build's tap counts on the main path (d = 2 and 4 at
    sigma_s 2: 9 and 5 taps; d = 8 at sigma_s 2 and 6: 3 and 7; the sharded
    d = 1 at sigma_s 2 and 6: 17 and 49) take the 16 x 32 tile, at 9 taps in
    44,800 bytes against the guided build's 60,160, at 49 in 179,200; the
    widest table, 63 taps, takes 8 x 32 cells, where the guided build takes
    one row of 16."""
    for sigma_s, d, n_taps in ((2.0, 2, 9), (2.0, 4, 5), (2.0, 8, 3), (6.0, 8, 7),
                               (2.0, 1, 17), (6.0, 1, 49)):
        assert fast._grid_taps(sigma_s, d).size == n_taps
        tile = fast.build_tile(n_taps, H100_SHARED_OPTIN, 1)
        assert (tile.th, tile.tw) == (16, 32)
    assert fast.build_tile(9, H100_SHARED_OPTIN, 1).shared_bytes == 44800
    assert fast.build_tile(49, H100_SHARED_OPTIN, 1).shared_bytes == 179200
    widest = fast.build_tile(63, H100_SHARED_OPTIN, 1)
    assert (widest.th, widest.tw, widest.shared_bytes) == (8, 32, 205296)


@pytest.mark.parametrize("n_taps", [9, 63])
def test_one_image_tile_shrinks_before_it_refuses(n_taps):
    """With one staged image, too, each tile of BUILD_TILES is taken at
    exactly its own bytes and one byte less takes a later one, down to the
    last, under whose bytes build_tile refuses."""
    r = n_taps // 2
    tiles = fast.BUILD_TILES
    for i, (th, tw) in enumerate(tiles):
        nbytes = fast.build_layout(th, tw, r, 1)[-1]
        tile = fast.build_tile(n_taps, nbytes, 1)
        assert (tile.th, tile.tw) in tiles[: i + 1]
        if i + 1 < len(tiles):
            smaller = fast.build_tile(n_taps, nbytes - 1, 1)
            assert tiles.index((smaller.th, smaller.tw)) > i
        else:
            with pytest.raises(ValueError, match="no grid build tile fits"):
                fast.build_tile(n_taps, nbytes - 1, 1)


@pytest.mark.parametrize("n_images", [0, 3])
def test_build_layout_takes_one_or_two_images(n_images):
    with pytest.raises(ValueError, match="1 or 2 images"):
        fast.build_layout(16, 32, 4, n_images)


@pytest.mark.parametrize("n_taps", [65, 127])
def test_taps_beyond_the_table_are_refused(n_taps):
    with pytest.raises(ValueError, match="odd number of blur taps up to 64"):
        fast.build_tile(n_taps, H100_SHARED_OPTIN, 1)


# ---------------------------------------------------------------------------
# The grid build at d = 1 (fast.build_d1_tile; fast.cu: build_grid_d1_kernel)
# ---------------------------------------------------------------------------

H100_BLOCK_RESERVE = 1024  # the card's shared memory a resident block keeps


@pytest.mark.parametrize("n_taps,n_images,blocks", [(17, 1, 2), (17, 2, 2), (49, 1, 2),
                                                    (49, 2, 1)])
def test_d1_tiles_on_the_h100(n_taps, n_images, blocks):
    """The main path's d = 1 builds (sigma_s 2: 17 taps, both grids; the
    sharded --turbo 1 --sigma-spatial 6: 49 taps, the bilateral grid) fit a
    block's shared memory with two blocks a multiprocessor; the guided grid
    at 49 taps, two staged rings of 56 rows, with one. A block's threads
    cover the vertical pass's columns in each of its groups."""
    tile = fast.build_d1_tile(n_taps, H100_SHARED_OPTIN, n_images)
    assert tile.shared_bytes <= H100_SHARED_OPTIN
    assert tile.blocks_per_sm(H100_SHARED_OPTIN) == blocks
    assert (H100_SHARED_OPTIN + H100_BLOCK_RESERVE) // (
        tile.shared_bytes + H100_BLOCK_RESERVE) == blocks
    assert fast.BUILD_D1_THREADS % 32 == 0
    assert fast.BUILD_D1_THREADS >= tile.groups * tile.scols
    assert tile.tw % fast.BUILD_D1_CELLS == 0 and tile.tw >= fast.BUILD_D1_CELLS
    assert tile.ring_rows == n_taps - 1 + tile.rows


@pytest.mark.parametrize("n_images", [1, 2])
@pytest.mark.parametrize("n_taps", ODD_TAPS)
def test_d1_layout_back_to_back_and_aligned(n_taps, n_images):
    """The rings (float4), the seven vertical-sum planes, the strip's cells
    and the taps lie back to back, each 16-byte aligned for its 16-byte
    loads, sized for what
    the kernel indexes: a vertical-sum row holds every column the horizontal
    pass's float4 loads reach, the taps every index its tap windows read."""
    tile = fast.build_d1_tile(n_taps, H100_SHARED_OPTIN, n_images)
    ring = 16 * tile.ring_rows * tile.scols
    regions = [("payload ring", 0, ring), ("layer ring", tile.l_at, ring if n_images == 2 else 0),
               ("vertical sums", tile.v_at, 28 * tile.rows * tile.vstride),
               ("cells", tile.o_at, 16 * tile.rows * tile.tw if n_images == 2 else 0),
               ("taps", tile.t_at, 4 * fast.BUILD_D1_TAP_SLOTS)]
    end = 0
    for name, at, size in regions:
        if size:
            assert at == end and at % 16 == 0, name
            end = at + size
    assert tile.l_at == (ring if n_images == 2 else 0) and tile.shared_bytes == end
    assert fast.build_d1_layout(tile.tw, tile.groups, tile.r, n_images) == (
        tile.l_at, tile.v_at, tile.o_at, tile.t_at, tile.shared_bytes)
    assert list(tile.launch_args()) == [tile.tw, tile.groups, tile.l_at, tile.v_at, tile.o_at,
                                        tile.t_at, tile.shared_bytes]
    # the horizontal pass: cells cx0 .. cx0 + 3 (cx0 <= tw - 4) load float4
    # chunks m < (n + 6) // 4 of their row from column cx0 + 4m
    chunks = (n_taps + 6) // 4
    assert tile.tw - 4 + 4 * chunks <= tile.vstride and tile.vstride % 4 == 0
    assert 4 * chunks <= fast.BUILD_D1_TAP_SLOTS  # and their tap windows
    assert n_taps + fast.BUILD_D1_ROWS - 1 <= fast.BUILD_D1_TAP_SLOTS  # the vertical's
    assert tile.blocks_per_sm(H100_SHARED_OPTIN) >= 1


def test_d1_tile_takes_two_blocks_before_one():
    """Where a tile of BUILD_D1_TILES leaves two blocks a multiprocessor,
    build_d1_tile takes the first such; where none does, the first that
    leaves one; and below any tile's bytes it refuses."""
    for n_taps in ODD_TAPS:
        for n_images in (1, 2):
            tile = fast.build_d1_tile(n_taps, H100_SHARED_OPTIN, n_images)
            fits = []
            for cols, groups in fast.BUILD_D1_TILES:
                tw = (cols - (n_taps - 1)) // 4 * 4
                if tw >= 4 and cols * groups <= fast.BUILD_D1_THREADS:
                    nbytes = fast.build_d1_layout(tw, groups, n_taps // 2, n_images)[-1]
                    fits.append(((tw, groups), (H100_SHARED_OPTIN + H100_BLOCK_RESERVE)
                                 // (nbytes + H100_BLOCK_RESERVE)))
            want = next((t for t, b in fits if b >= 2), None) or next(t for t, b in fits if b)
            assert (tile.tw, tile.groups) == want
    with pytest.raises(ValueError, match="no d = 1 grid build tile fits"):
        fast.build_d1_tile(17, 4096, 1)


def _staged_rows(img, rows, x0, scols, r, border):
    """Rows `rows` of a pooled image at columns x0 - r .. x0 - r + scols - 1
    under the build's border rule, as stage_ring_rows copies them."""
    hs, ws = img.shape[:2]
    ys = torch.as_tensor(rows)
    xs = torch.arange(x0 - r, x0 - r + scols)
    out = img[ys.clamp(0, hs - 1)][:, xs.clamp(0, ws - 1)].clone()
    if border != BorderPolicy.CLAMP:
        out[(ys < 0) | (ys >= hs)] = 0.0
        out[:, (xs < 0) | (xs >= ws)] = 0.0
    return out


def _walk_d1(tile, blocks, small_p, small_l, lmin, step, levels, taps, border, inv2sc, guided,
             ua):
    """build_grid_d1_kernel in torch, at its index arithmetic: `blocks`
    blocks, each its equal run of work items (strip s of band b is item b *
    strips + s), its ring slots (unstaged slots NaN) restaged whole where
    its walk moves to a new band, the vertical pass's groups and tap
    windows, the horizontal pass's float4 chunks (each read within the
    vertical-sum row's stride), the products and sums in the kernel's
    order, each one float32 rounding."""
    n, r, rows_r = taps.size, taps.size // 2, fast.BUILD_D1_ROWS
    hs, ws = small_p.shape[:2]
    rows, ring_rows, scols, vstride = tile.rows, tile.ring_rows, tile.scols, tile.vstride
    strips = -(-hs // rows)
    items = -(-ws // tile.tw) * strips
    coef = torch.tensor(np.float32(inv2sc * 1.4426950408889634))
    s_taps = torch.zeros(fast.BUILD_D1_TAP_SLOTS)
    s_taps[:n] = torch.from_numpy(taps)
    grid = torch.full((levels, hs, ws, 8 if guided else 4), float("nan"))
    for block in range(blocks):
        begin, end = items * block // blocks, items * (block + 1) // blocks
        if begin >= end:
            continue
        ring = torch.full((2, ring_rows, scols, 4), float("nan"))

        def stage(row0, n_rows, x0, origin):
            for i, img in enumerate((small_p, small_l)):
                got = _staged_rows(img, list(range(row0, row0 + n_rows)), x0, scols, r, border)
                for dy in range(n_rows):
                    ring[i, (row0 + dy - origin) % ring_rows] = got[dy]

        ring_row0 = (begin % strips) * rows - r
        stage(ring_row0, ring_rows, (begin // strips) * tile.tw, ring_row0)
        for item in range(begin, end):
            band, y = item // strips, (item % strips) * rows
            x0 = band * tile.tw
            rows_in, cols = min(rows, hs - y), min(tile.tw, ws - x0)
            next_row0 = ring_row0
            for k in range(levels):
                lv = lmin + step * float(k)
                vsum = torch.full((7, rows, vstride), float("nan"))
                for g in range(tile.groups):
                    slot = (y - r + g * rows_r - ring_row0) % ring_rows
                    acc = torch.zeros((rows_r, 7, scols))
                    window = torch.zeros(rows_r)
                    for i in range(n + rows_r - 1):
                        p, l = ring[0, slot], ring[1 if guided else 0, slot]
                        slot = (slot + 1) % ring_rows
                        window = torch.cat([s_taps[i : i + 1], window[:-1]])
                        dc = l[:, :3] - lv
                        w = torch.exp2(-(dc * dc) * coef)
                        f = torch.stack([w[:, 0] * p[:, 0], w[:, 1] * p[:, 1],
                                         w[:, 2] * p[:, 2], w[:, 1] * p[:, 3],
                                         w[:, 0], w[:, 1], w[:, 2]])
                        for j in range(rows_r):
                            if 0 <= i - j < n:
                                acc[j] = acc[j] + window[j] * f
                    vsum[:, g * rows_r : (g + 1) * rows_r, :scols] = acc.transpose(0, 1)
                if k == levels - 1 and item + 1 < end:
                    next_band, next_y = (item + 1) // strips, ((item + 1) % strips) * rows
                    if next_band == band:
                        stage(y + rows + r, rows, x0, ring_row0)
                    else:
                        next_row0 = next_y - r
                        stage(next_row0, ring_rows, next_band * tile.tw, next_row0)
                cx0 = torch.arange(0, tile.tw, fast.BUILD_D1_CELLS)
                out = torch.zeros((rows_in, len(cx0), 4, 7))
                t8 = torch.zeros(8)
                for m in range((n + 6) // 4):
                    t8 = torch.cat([t8[4:], s_taps[4 * m : 4 * m + 4]])
                    for e in range(4):
                        col = cx0 + 4 * m + e
                        assert int(col.max()) < vstride  # the float4 lies in its row
                        v = vsum[:, :rows_in, col].permute(1, 2, 0)  # (rows_in, groups, 7)
                        for c in range(4):
                            if 0 <= 4 * m + e - c < n:
                                out[:, :, c] = out[:, :, c] + t8[4 + e - c] * v
                cells = out.reshape(rows_in, -1, 7)[:, :cols]
                if guided:
                    cell = torch.cat([cells, torch.zeros_like(cells[..., :1])], -1)
                else:
                    den = cells[..., 4:].clamp_min(1e-20)
                    alpha = (torch.zeros_like(den[..., :1]) if ua
                             else cells[..., 3:4] / den[..., 1:2])
                    cell = torch.cat([cells[..., :3] / den, alpha], -1)
                grid[k, y : y + rows_in, x0 : x0 + cols] = cell.to(torch.bfloat16).float()
            ring_row0 = next_row0
    return grid.to(torch.bfloat16)


D1_WALKS = [  # n_taps, n_images, border, (hs, ws), tw, groups, blocks
    (5, 1, BorderPolicy.CLAMP, (37, 21), 8, 1, 2),
    (5, 2, BorderPolicy.ZERO, (29, 19), 4, 2, 3),
    (17, 1, BorderPolicy.ZERO, (45, 30), 12, 1, 4),
    (17, 2, BorderPolicy.CLAMP, (40, 23), 8, 2, 1),
    (3, 1, BorderPolicy.CLAMP, (9, 13), 4, 1, 5),
    (1, 2, BorderPolicy.ZERO, (11, 9), 4, 1, 2),
    (9, 2, BorderPolicy.CLAMP, (33, 17), 8, 1, 99),
    (49, 1, BorderPolicy.CLAMP, (41, 10), 8, 1, 3),
]


@pytest.mark.parametrize("n_taps,n_images,border,shape,tw,groups,blocks,ua",
                         [(*w, False) for w in D1_WALKS]
                         + [(*w, True) for w in D1_WALKS if w[1] == 1])
def test_d1_walk_is_the_plain_build_bit_for_bit(n_taps, n_images, border, shape, tw, groups,
                                                blocks, ua):
    """The d = 1 body's walk (_walk_d1) on small grids, with tiles and
    block counts that make a block wrap its ring down a band, move to the
    next band within its run, start mid-band, end on a ragged strip and
    band, or walk one strip (more blocks than items), with 1 to 49 taps,
    fewer than and more than a thread's rows: the plain build's grid bit for
    bit, both grids, both borders; the bilateral grid with uniform alpha
    too."""
    rng = np.random.default_rng(n_taps + 7 * n_images)
    small_p = torch.from_numpy(rng.uniform(-0.2, 1.5, (*shape, 4)).astype(np.float32))
    small_l = torch.from_numpy(rng.uniform(0.0, 1.0, (*shape, 4)).astype(np.float32))
    if n_images == 1:
        small_l = small_p
    lmin, step = fast.grid_range(small_l, 3)
    taps = fast._gauss_taps(max(0.5, n_taps / 6.0), n_taps // 2)
    r = n_taps // 2
    tile = fast.BuildD1Tile(tw, groups, r, n_images,
                            *fast.build_d1_layout(tw, groups, r, n_images))
    got = _walk_d1(tile, blocks, small_p, small_l, lmin, step, 3, taps, border, 0.3,
                   n_images == 2, ua)
    if n_images == 2:
        want = fast.build_guided_grid_plain(small_p, small_l, lmin, step, 3, taps, border, 0.3)
    else:
        want = fast.build_grid_plain(small_p, lmin, step, 3, taps, border, 0.3, ua)
    assert torch.equal(got, want)
