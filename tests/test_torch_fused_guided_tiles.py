"""The fused kernels' slice tiles, cell windows and shared-memory layouts
(ops/fast.py: fused_tile), for the guided kernel (two staged images) and
the bilateral kernel (one), which share the tile helper and the build passes.

The CUDA kernels (fast.cu: fused_guided_kernel, fused_grid_kernel) trust
this geometry: each block takes a ph x pw tile of pixels, each thread one
column and every (threads / pw)-th row of it; the block builds the cells
its pixels' bilinear taps read (tile_window) from the pooled image(s)
staged over that window plus the blur halo, with the build's border rule. These tests walk every
block of small images at every downsample with the kernel's index
arithmetic: every pixel is one thread's, its bilinear cells lie in the
window, the window fits the layout, and every blur tap of every built cell
reads the staged pixel the plain versions (ops/fast.py:
build_guided_grid_plain, build_grid_plain) pad. Rows and columns are
independent, so each axis is checked over all its offsets at once. Then the
layout, and the fits answers at the H100's opt-in shared memory.
"""

import numpy as np
import pytest

from image_denoising_filter_tpu_torch.config import BorderPolicy
from image_denoising_filter_tpu_torch.ops import fast

H100_SHARED_OPTIN = 232448
THREADS = fast.FUSED_THREADS
STRIP = fast.FUSED_STRIP
ODD_TAPS = range(1, fast.MAX_TAPS, 2)
# (staged images, downsample): the guided kernel's d, the bilateral's
KERNELS = [(2, d) for d in fast.DOWNSAMPLES] + [(1, d) for d in fast.FUSED_GRID_DOWNSAMPLES]
KERNEL_IDS = [f"{'guided' if n == 2 else 'grid'}-d{d}" for n, d in KERNELS]
ALL_TILES = sorted(set(fast.FUSED_GUIDED_TILES).union(*fast.FUSED_GRID_TILES.values()))


def _fits_before(d, n_taps, n_images):
    """The fits rule each kernel had before its tile came from Python, with
    a 16 x 128 tile and no weight planes (the staged images, the vertical
    sums, one level's cells, the static reserve), against which the tile
    may widen but never narrow: for the bilateral kernel, the old C rule
    fused_grid_bytes."""
    r = n_taps // 2
    rows, cols = 16 // d + 2, 128 // d + 2
    staged = n_images * (rows + 2 * r) * (cols + 2 * r) * 16
    vsum = -(-7 * rows * (cols + 2 * r) * 4 // 16) * 16
    cell = 16 if n_images == 2 else 8
    return staged + vsum + rows * cols * cell + 1024 <= H100_SHARED_OPTIN


def _fits(d, n_taps, n_images):
    try:
        fast.fused_tile(d, n_taps, H100_SHARED_OPTIN, n_images)
    except ValueError:
        return False
    return True


def _first_cell(p, d):
    """floor((p + 0.5) / d - 0.5) in float32, as the kernel computes it."""
    g = (np.float32(p) + np.float32(0.5)) * np.float32(1.0 / d) - np.float32(0.5)
    return np.floor(g).astype(np.int64)


def _window(t0, extent, n, ns, d):
    """tile_window along one axis: the first cell and the count of cells the
    tile's pixels [t0, min(t0 + extent, n)) read, clamped into [0, ns)."""
    last = min(t0 + extent, n) - 1
    a0 = int(np.clip(_first_cell(t0, d), 0, ns - 1))
    a1 = int(np.clip(_first_cell(last, d) + 1, 0, ns - 1))
    return a0, a1 - a0 + 1


def _staged(ns, a0, r, n_staged, border):
    """The pooled index each staged position of an axis holds, as
    stage_window_async stages it: clamped (CLAMP), or -1 for a zero pixel
    (ZERO)."""
    idx = a0 - r + np.arange(n_staged)
    if border == BorderPolicy.CLAMP:
        return np.clip(idx, 0, ns - 1)
    return np.where((idx >= 0) & (idx < ns), idx, -1)


def _padded(ns, r, border):
    """The pooled index each position of the plain version's radius-padded
    axis holds (ops/eager.py:_pad_dim)."""
    idx = np.arange(-r, ns + r)
    if border == BorderPolicy.CLAMP:
        return np.clip(idx, 0, ns - 1)
    return np.where((idx >= 0) & (idx < ns), idx, -1)


def _check_axis(n, d, extent, most, tile, border, rows_axis):
    """One axis of every block of an image n pixels long: the window holds
    at most `most` cells and every pixel's two bilinear cells; the cells'
    blur taps read the plain version's padded pixels (rows through the
    vertical pass's strips, columns through the horizontal pass)."""
    ns = -(-n // d)
    r = tile.r
    padded = _padded(ns, r, border)
    for t0 in range(0, n, extent):
        a0, count = _window(t0, extent, n, ns, d)
        assert 1 <= count <= most
        p = np.arange(t0, min(t0 + extent, n))
        f = _first_cell(p, d)
        for c in (np.clip(f, 0, ns - 1), np.clip(f + 1, 0, ns - 1)):
            assert ((c - a0 >= 0) & (c - a0 < count)).all()
        n_staged = count + 2 * r
        staged = _staged(ns, a0, r, n_staged, border)
        n_taps = 2 * r + 1
        if rows_axis:
            for cy0 in range(0, count, STRIP):
                walked = [a for a in range(n_taps + STRIP - 1) if cy0 + a < n_staged]
                for j in range(min(STRIP, count - cy0)):
                    assert [a - j for a in walked if 0 <= a - j < n_taps] == list(range(n_taps))
        cell = np.arange(count)[:, None]
        tap = np.arange(n_taps)[None, :]
        assert (cell + tap).max() < n_staged
        np.testing.assert_array_equal(staged[cell + tap], padded[a0 + cell + tap])


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("n_images,d", KERNELS, ids=KERNEL_IDS)
def test_window_holds_every_tap(d, border, n_images):
    """Every odd tap count that fits, at each downsample each kernel takes,
    over images below, at and above one tile in each axis (ragged edges)."""
    for n_taps in ODD_TAPS:
        if not _fits(d, n_taps, n_images):
            continue
        tile = fast.fused_tile(d, n_taps, H100_SHARED_OPTIN, n_images)
        assert tile.r == n_taps // 2 and tile.n_images == n_images
        assert (tile.rows, tile.cols) == fast.fused_window(tile.ph, tile.pw, d)
        for h in (1, d + 1, tile.ph, 2 * tile.ph + 3 * d - 1):
            _check_axis(h, d, tile.ph, tile.rows, tile, border, True)
        for w in (3, tile.pw, 2 * tile.pw + 5):
            _check_axis(w, d, tile.pw, tile.cols, tile, border, False)


@pytest.mark.parametrize("ph,pw", ALL_TILES)
def test_threads_take_every_pixel_once(ph, pw):
    """Thread i takes column i % pw and rows i // pw + k (threads / pw),
    k = 0, 1, ... below ph: every pixel of the tile once, none outside."""
    assert THREADS % pw == 0 and pw <= THREADS
    step = THREADS // pw
    taken = [(i // pw + step * k) * pw + i % pw
             for i in range(THREADS) for k in range(-(-ph // step)) if i // pw + step * k < ph]
    assert sorted(taken) == list(range(ph * pw))


def test_guided_threads_hold_their_rows():
    """The guided kernel unrolls a thread's rows: at most
    FUSED_GUIDED_PIXELS of them on each of its tiles."""
    for ph, pw in fast.FUSED_GUIDED_TILES:
        assert THREADS // pw * fast.FUSED_GUIDED_PIXELS >= ph


@pytest.mark.parametrize("n_images,d,n_taps", [
    (2, 1, 17), (2, 2, 9), (2, 2, 43), (2, 4, 5), (2, 4, 63), (2, 8, 3), (2, 8, 63),
    (1, 2, 9), (1, 2, 63), (1, 4, 5), (1, 4, 63), (1, 8, 7), (1, 8, 63)])
def test_shared_bytes_match_the_layout(d, n_taps, n_images):
    """The staged payload (and the guided kernel's layer) as float4, the
    three weight planes, the seven vertical-sum planes, then a batch of
    levels' cells (16-byte aligned; 16 bytes a cell and FUSED_GUIDED_LEVELS
    for the guided kernel, 8 and FUSED_GRID_LEVELS for the bilateral):
    back to back, each sized for the largest window the kernel indexes."""
    tile = fast.fused_tile(d, n_taps, H100_SHARED_OPTIN, n_images)
    n_staged = tile.srows * tile.scols
    vsum = 28 * tile.rows * tile.scols
    cell_bytes, levels = (16, fast.FUSED_GUIDED_LEVELS) if n_images == 2 else (
        8, fast.FUSED_GRID_LEVELS)
    assert fast.fused_cells(n_images) == (cell_bytes, levels)
    cells = cell_bytes * levels * tile.rows * tile.cols
    regions = [("payload", 0, 16 * n_staged, 16)]
    if n_images == 2:
        regions.append(("layer", tile.l_at, 16 * n_staged, 16))
    else:
        assert tile.l_at == 0
    regions += [("weights", tile.w_at, 12 * n_staged, 4),
                ("vertical sums", tile.v_at, vsum, 4), ("cells", tile.c_at, cells, 16)]
    end = 0
    for name, at, size, align in regions:
        assert end <= at < end + align and at % align == 0, name
        end = at + size
    assert tile.shared_bytes == end
    assert tile.shared_bytes + fast.STATIC_SHARED_RESERVE <= H100_SHARED_OPTIN
    assert list(tile.launch_args()) == [tile.ph, tile.pw, tile.rows, tile.cols, tile.l_at,
                                        tile.w_at, tile.v_at, tile.c_at, tile.shared_bytes]


@pytest.mark.parametrize("n_images", [2, 1], ids=["guided", "grid"])
def test_fits_never_narrows(n_images):
    """Wherever the kernel's window fitted before its tile came from Python,
    it fits now, at every downsample and odd tap count: for the guided
    kernel 43 taps at d = 2 and every table at d = 4 among them; for the
    bilateral kernel every table at d = 2, 4 and 8."""
    downsamples = fast.DOWNSAMPLES if n_images == 2 else fast.FUSED_GRID_DOWNSAMPLES
    for d in downsamples:
        for n_taps in ODD_TAPS:
            if _fits_before(d, n_taps, n_images):
                assert _fits(d, n_taps, n_images), (d, n_taps)
    if n_images == 2:
        assert max(n for n in ODD_TAPS if _fits_before(2, n, 2)) == 43
        assert all(_fits_before(4, n, 2) for n in ODD_TAPS)
    else:
        assert all(_fits_before(d, n, 1) for d in fast.FUSED_GRID_DOWNSAMPLES for n in ODD_TAPS)


def test_tiles_on_the_h100():
    """The main path's settings (d = 2 and 4 at sigma_s 2: 9 and 5 taps)
    take the 16 x 64 tile, at d = 2 in 72,224 bytes (three blocks a
    multiprocessor by shared memory, five levels' cells among them); d = 2
    fits up to 57 taps, so sigma_s 12 (49 taps) runs fused, on a 16 x 32
    tile, and 59 to 63 taps take the two guided kernels; d = 4 and 8 take
    every table; d = 1 fits up to 45 taps."""
    for sigma_s, d, n_taps in ((2.0, 2, 9), (2.0, 4, 5)):
        assert fast._grid_taps(sigma_s, d).size == n_taps
        tile = fast.fused_tile(d, n_taps, H100_SHARED_OPTIN, 2)
        assert (tile.ph, tile.pw) == (16, 64)
    assert fast.fused_tile(2, 9, H100_SHARED_OPTIN, 2).shared_bytes == 72224
    assert fast._grid_taps(12.0, 2).size == 49
    wide = fast.fused_tile(2, 49, H100_SHARED_OPTIN, 2)
    assert (wide.ph, wide.pw) == (16, 32)
    widest = {d: max(n for n in ODD_TAPS if _fits(d, n, 2)) for d in fast.DOWNSAMPLES}
    assert widest == {1: 45, 2: 57, 4: 63, 8: 63}


def test_grid_tiles_on_the_h100():
    """The bilateral kernel's tile grows with d at the main path's settings
    (9 taps at d = 2, 5 at d = 4, 7 at d = 8 with sigma_s 6), so that its
    window holds 10 x 34 cells at d = 2 and 4 and 6 x 34 at d = 8, in at
    most 49,248 bytes (four blocks a multiprocessor by shared memory, six
    levels' cells among them); every table fits at every d, 63 taps at
    d = 2 and 4 on half-height tiles."""
    for sigma_s, d, n_taps, pixels, cells in ((2.0, 2, 9, (16, 64), (10, 34)),
                                              (2.0, 4, 5, (32, 128), (10, 34)),
                                              (6.0, 8, 7, (32, 256), (6, 34))):
        assert fast._grid_taps(sigma_s, d).size == n_taps
        tile = fast.fused_tile(d, n_taps, H100_SHARED_OPTIN, 1)
        assert ((tile.ph, tile.pw), (tile.rows, tile.cols)) == (pixels, cells)
        assert tile.shared_bytes <= 49248
    assert fast.fused_tile(2, 9, H100_SHARED_OPTIN, 1).shared_bytes == 49248
    assert all(_fits(d, n, 1) for d in fast.FUSED_GRID_DOWNSAMPLES for n in ODD_TAPS)
    for d, pixels in ((2, (8, 64)), (4, (16, 128)), (8, (32, 256))):
        tile = fast.fused_tile(d, 63, H100_SHARED_OPTIN, 1)
        assert (tile.ph, tile.pw) == pixels


@pytest.mark.parametrize("n_images,d,n_taps", [(2, 2, 9), (2, 2, 57), (2, 1, 45), (1, 2, 9),
                                               (1, 2, 63), (1, 4, 63), (1, 8, 63)])
def test_tile_shrinks_before_it_refuses(d, n_taps, n_images):
    """Each of the kernel's tiles is taken at exactly its own bytes beside
    the reserve, and one byte less takes a later one; under the last one's,
    fused_tile refuses."""
    r = n_taps // 2
    tiles = fast.fused_tiles(d, n_images)
    for i, (ph, pw) in enumerate(tiles):
        limit = fast.fused_layout(ph, pw, d, r, n_images)[-1] + fast.STATIC_SHARED_RESERVE
        tile = fast.fused_tile(d, n_taps, limit, n_images)
        assert (tile.ph, tile.pw) in tiles[: i + 1]
        if i + 1 < len(tiles):
            smaller = fast.fused_tile(d, n_taps, limit - 1, n_images)
            assert tiles.index((smaller.ph, smaller.pw)) > i
        else:
            kind = "guided" if n_images == 2 else "grid"
            with pytest.raises(ValueError, match=f"no fused {kind} tile"):
                fast.fused_tile(d, n_taps, limit - 1, n_images)


@pytest.mark.parametrize("n_images,d", KERNELS, ids=KERNEL_IDS)
def test_tiles_shrink_in_area(n_images, d):
    tiles = fast.fused_tiles(d, n_images)
    areas = [ph * pw for ph, pw in tiles]
    assert areas and areas == sorted(areas, reverse=True) and len(set(areas)) == len(areas)
    assert all(ph % d == 0 and pw % d == 0 and THREADS % pw == 0 for ph, pw in tiles)


@pytest.mark.parametrize("n_images,d,n_taps", [
    (2, 2, 0), (2, 2, 8), (2, 2, 65), (2, 3, 9), (2, 32, 9),
    (1, 2, 0), (1, 2, 8), (1, 2, 65), (1, 3, 9), (1, 1, 9), (1, 16, 9)])
def test_arguments_the_kernel_does_not_take_are_refused(d, n_taps, n_images):
    """Even, empty or too wide tap tables, and a downsample for which the
    kernel has no tile (the fused bilateral kernel none at d = 1)."""
    with pytest.raises(ValueError):
        fast.fused_tile(d, n_taps, H100_SHARED_OPTIN, n_images)


def test_a_third_staged_image_is_refused():
    with pytest.raises(ValueError, match="1 or 2 images"):
        fast.fused_layout(16, 64, 2, 4, 3)
