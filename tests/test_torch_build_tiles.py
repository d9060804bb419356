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
