"""The NLM kernel's tile and staged window (ops/stencils.py:nlm_tile).

The CUDA kernel trusts this geometry: it stages the window the tile names
and indexes it with the tile's offsets. These tests walk every block of
small images with the kernel's index arithmetic and check that every
squared-difference position, every candidate's neighbour tap over every
patch offset, and every value tap falls inside the block's e region and
staged window, and lands on the pixel the plain version reads. Rows and
columns are independent (a tap is inside the window when its row and its
column are), so each axis is checked over all its offsets at once.
"""

import itertools

import numpy as np
import pytest

from image_denoising_filter_tpu_torch.config import NlmParams
from image_denoising_filter_tpu_torch.ops import stencils

# The shared memory a block of the H100 may opt into
# (cudaDevAttrMaxSharedMemoryPerBlockOptin), and a block's without opting in.
H100_SHARED_OPTIN = 232448
DEFAULT_SHARED = 48 * 1024


def _check_axis(n, t0, tile_n, e_n, p, origin, win_n, offsets):
    """One axis of one block: outputs t0 + [0, tile_n) inside the image's n
    pixels, the squared-difference rows (or columns) each output's patch
    reads, and each candidate offset's neighbour and value taps."""
    out = np.arange(t0, min(t0 + tile_n, n))[:, None, None]  # output pixel
    patch = np.arange(-p, p)[None, :, None]  # patch offset
    d = np.asarray(offsets)[None, None, :]  # candidate offset
    d_min = min(offsets)
    e = out + patch - (t0 - p)  # the e position the patch tap reads
    assert e.min() >= 0 and e.max() < e_n
    nbr = e + d - d_min  # its neighbour's window index
    assert nbr.min() >= 0 and nbr.max() < win_n
    np.testing.assert_array_equal(t0 + origin + nbr, out + patch + d)
    val = (out - t0) + p + d - d_min  # the value tap's window index
    assert val.min() >= 0 and val.max() < win_n
    np.testing.assert_array_equal(t0 + origin + val, out + d)


def _check_image(tile, params, h, w):
    cands = stencils.nlm_candidates(params)
    dys = sorted({dy for dy, _ in cands})
    dxs = sorted({dx for _, dx in cands})
    p = params.patch_radius
    for y0 in range(0, h, tile.th):
        _check_axis(h, y0, tile.th, tile.e_h, p, tile.oy, tile.win_h, dys)
    for x0 in range(0, w, tile.tw):
        _check_axis(w, x0, tile.tw, tile.e_w, p, tile.ox, tile.win_w, dxs)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("s", range(1, 17))
def test_window_holds_every_tap(s, p):
    """Strides 1-3, disk on and off, both tap forms; images below, at and
    above the tile in each axis. Radii 1-4 keep the target in registers,
    wider ones in shared memory."""
    for stride, disk, bf16 in itertools.product((1, 2, 3), (False, True), (False, True)):
        params = NlmParams(search_radius=s, patch_radius=p, search_stride=stride,
                           search_disk=disk)
        tile = stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN)
        assert tile.tw == stencils.NLM_TILE_W and tile.p == p
        if p <= stencils.NLM_REGISTER_PATCH:
            # the target's e positions fit NLM_E_PER_THREAD a thread
            assert tile.e_h * tile.e_w <= stencils.NLM_E_PER_THREAD * stencils.NLM_THREADS
        assert tile.shared_bytes <= H100_SHARED_OPTIN
        for h, w in itertools.product((max(1, tile.th - 3), tile.th, 2 * tile.th + 3),
                                      (5, tile.tw, 2 * tile.tw + 7)):
            _check_image(tile, params, h, w)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize(
    "params",
    [NlmParams(), NlmParams(search_stride=2), NlmParams(search_stride=2, search_disk=True),
     NlmParams(search_radius=16, patch_radius=4), NlmParams(search_radius=1, patch_radius=1),
     NlmParams(patch_radius=5), NlmParams(search_radius=16, patch_radius=8)],
    ids=["reference", "stride2", "stride2_disk", "s16_p4", "s1_p1", "p5", "s16_p8"],
)
def test_shared_bytes_match_the_layout(params, bf16):
    """The window as float4, with bf16 taps its RGB as 4 x bf16, for radii
    above NLM_REGISTER_PATCH the target's e region as window taps, then e
    and the row sums as float32: back to back, each sized for what the
    kernel indexes and aligned for its loads."""
    tile = stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN)
    n_win, n_e = tile.win_h * tile.win_w, tile.e_h * tile.e_w
    tap = 8 if bf16 else 16
    regions = [("window", 0, 16 * n_win, 16)]
    if bf16:
        regions.append(("taps", tile.taps_at, 8 * n_win, 8))
    else:
        assert tile.taps_at == 0  # the window itself
    if tile.p > stencils.NLM_REGISTER_PATCH:
        regions.append(("target", tile.tgt_at, tap * n_e, tap))
    regions += [("e", tile.e_at, 4 * n_e, 4), ("rows", tile.rows_at, 4 * tile.th * tile.e_w, 4)]
    end = 0
    for name, at, size, align in regions:
        assert at == end and at % align == 0, name
        end = at + size
    assert tile.shared_bytes == end
    assert stencils.nlm_layout(tile.th, tile.p, tile.win_h, tile.win_w, bf16) == (
        tile.taps_at, tile.tgt_at, tile.e_at, tile.rows_at, tile.shared_bytes)
    assert list(tile.launch_args()) == [tile.th, tile.oy, tile.ox, tile.win_h, tile.win_w,
                                        tile.taps_at, tile.tgt_at, tile.e_at, tile.rows_at,
                                        tile.shared_bytes]
    cands = stencils.nlm_candidates(params)
    assert tile.win_h == tile.e_h + max(dy for dy, _ in cands) - min(dy for dy, _ in cands)
    assert tile.win_w == tile.e_w + max(dx for _, dx in cands) - min(dx for _, dx in cands)


def test_reference_tiles():
    """At the reference parameters both tap forms take the full 16 x 32 tile
    below 48 KB (no opt-in); s = 16 (1024 candidates) fits the H100 above
    it."""
    exact = stencils.nlm_tile(NlmParams(), False, H100_SHARED_OPTIN)
    turbo = stencils.nlm_tile(NlmParams(search_stride=2), True, H100_SHARED_OPTIN)
    assert (exact.th, exact.win_h, exact.win_w, exact.shared_bytes) == (16, 34, 50, 32676)
    assert (turbo.th, turbo.win_h, turbo.win_w, turbo.shared_bytes) == (16, 33, 49, 44284)
    wide = NlmParams(search_radius=16)
    assert len(stencils.nlm_candidates(wide)) == stencils.MAX_CANDIDATES
    for bf16 in (False, True):
        tile = stencils.nlm_tile(wide, bf16, H100_SHARED_OPTIN)
        assert tile.th == 16 and DEFAULT_SHARED < tile.shared_bytes <= H100_SHARED_OPTIN


def _check_shrinks(params, bf16):
    """Each height of NLM_TILE_HS is taken at exactly its own bytes, and one
    byte less takes the next shorter one; under the shortest one's bytes
    nlm_tile refuses."""
    p = params.patch_radius
    dys = [dy for dy, _ in stencils.nlm_candidates(params)]
    win_w = stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN).win_w
    for th in stencils.NLM_TILE_HS:
        win_h = th + 2 * p - 1 + max(dys) - min(dys)
        nbytes = stencils.nlm_layout(th, p, win_h, win_w, bf16)[-1]
        assert stencils.nlm_tile(params, bf16, nbytes).th == th
        if th > 1:
            assert stencils.nlm_tile(params, bf16, nbytes - 1).th == th // 2
        else:
            with pytest.raises(ValueError, match="no NLM tile fits"):
                stencils.nlm_tile(params, bf16, nbytes - 1)


def test_tile_shrinks_before_it_refuses():
    """Under a smaller shared-memory limit the tile loses rows, down to one,
    before nlm_tile refuses (s = 16, p = 4, bf16 taps)."""
    _check_shrinks(NlmParams(search_radius=16, patch_radius=4), True)


@pytest.mark.parametrize("bf16", [False, True])
def test_wide_patch_tile_shrinks_before_it_refuses(bf16):
    """The same with the target's taps in shared memory (s = 16, p = 8)."""
    _check_shrinks(NlmParams(search_radius=16, patch_radius=8), bf16)


@pytest.mark.parametrize("p", [0, 5, 9])
def test_patch_radius_outside_the_kernel_is_refused(p):
    """A radius of 0 has no box to sum; a wider radius is refused only where
    no tile height fits the card's shared memory: p = 5 and 9 at s = 16 fit
    the H100's opt-in limit but no block of 48 KB."""
    params = NlmParams(search_radius=16, patch_radius=p)
    if p == 0:
        with pytest.raises(ValueError, match="patch radius 1 or more"):
            stencils.nlm_tile(params, False, H100_SHARED_OPTIN)
        return
    assert stencils.nlm_tile(params, False, H100_SHARED_OPTIN).th == 16
    with pytest.raises(ValueError, match="no NLM tile fits"):
        stencils.nlm_tile(params, False, DEFAULT_SHARED)


@pytest.mark.parametrize("bf16,widest,th", [(False, 25, 2), (True, 22, 1)])
def test_widest_patch_radius_on_the_h100(bf16, widest, th):
    """At s = 16 the H100 takes patch radii up to the widest for which some
    tile height fits its 227 KB; one more is refused."""
    params = NlmParams(search_radius=16, patch_radius=widest)
    assert stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN).th == th
    with pytest.raises(ValueError, match="no NLM tile fits"):
        stencils.nlm_tile(NlmParams(search_radius=16, patch_radius=widest + 1), bf16,
                          H100_SHARED_OPTIN)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("p", [1, 3, 5])
def test_search_radius_0_stages_the_self_match(p, bf16):
    """At search radius 0 the table is empty (the JAX package and the plain
    version return each frame's seed): the tile stages the window of the
    self match (0, 0) alone, the tile plus the patch halo, and the kernel
    runs no candidate."""
    params = NlmParams(search_radius=0, patch_radius=p)
    assert stencils.nlm_candidates(params) == []
    tile = stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN)
    assert (tile.th, tile.oy, tile.ox) == (16, -p, -p)
    assert (tile.win_h, tile.win_w) == (tile.e_h, tile.e_w)
    for h, w in ((3, 5), (16, 32), (35, 71)):
        for y0 in range(0, h, tile.th):
            _check_axis(h, y0, tile.th, tile.e_h, p, tile.oy, tile.win_h, [0])
        for x0 in range(0, w, tile.tw):
            _check_axis(w, x0, tile.tw, tile.e_w, p, tile.ox, tile.win_w, [0])
