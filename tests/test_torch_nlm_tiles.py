"""The NLM kernel's tile and staged window (ops/stencils.py:nlm_tile).

The CUDA kernel trusts this geometry: it stages the window the tile names
and indexes it with the tile's offsets. These tests walk every block of
small images with the kernel's index arithmetic and check that every
squared-difference position, every candidate's neighbour tap over every
patch offset, and every value tap falls inside the block's e region and
staged window, and lands on the pixel the plain version reads. Rows and
columns are independent (a tap is inside the window when its row and its
column are), so each axis is checked over all its offsets at once.

Up to patch radius NLM_REGISTER_PATCH the sliding body runs: a warp's 32
lanes are the block's 32 e rows, and each lane slides a segment of NLM_SEG
+ 2p - 1 e columns along each row of candidates in a ring of registers
(_sweep mirrors its candidate loop). Wider radii take the staged body.
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
    reads, and each candidate offset's neighbour and value taps; and every
    e position the block computes reads inside the window."""
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
    every = np.arange(e_n)[:, None] + np.asarray(offsets)[None, :] - d_min
    assert every.min() >= 0 and every.max() < win_n


def _offsets(params):
    """The dy and dx the window spans: the candidates' and the self match's,
    whose value tap the kernel reads for the uniform alpha."""
    cands = stencils.nlm_candidates(params) + [(0, 0)]
    return sorted({dy for dy, _ in cands}), sorted({dx for _, dx in cands})


def _check_image(tile, params, h, w):
    dys, dxs = _offsets(params)
    p = params.patch_radius
    for y0 in range(0, h, tile.th):
        _check_axis(h, y0, tile.th, tile.e_h, p, tile.oy, tile.win_h, dys)
    for x0 in range(0, w, tile.tw):
        _check_axis(w, x0, tile.tw, tile.e_w, p, tile.ox, tile.win_w, dxs)


def _check_segments(tile):
    """The sliding body's columns: warp k's lanes compute e columns NLM_SEG *
    k + [0, NLM_SEG + 2p - 1) of the block's e region, which together are
    the region, and own output columns NLM_SEG * k + [0, NLM_SEG); its rows
    are the 32 lanes, the first th of them output rows."""
    seg = stencils.NLM_SEG
    warps = tile.tw // seg
    assert tile.tw % seg == 0 and tile.threads == 32 * warps
    assert warps in stencils.NLM_SLIDE_WARPS
    assert tile.e_h == 32 and tile.th == 33 - 2 * tile.p
    cols = np.arange(warps)[:, None] * seg + np.arange(seg + 2 * tile.p - 1)[None, :]
    assert cols.max() == tile.e_w - 1
    assert np.array_equal(np.unique(cols), np.arange(tile.e_w))
    assert tile.pitch >= tile.win_w and tile.pitch % 2 == 1


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("s", range(1, 17))
def test_window_holds_every_tap(s, p):
    """Strides 1-3, disk on and off, both tap forms; images below, at and
    above the tile in each axis. Radii 1-4 take the sliding body, wider ones
    the staged body."""
    for stride, disk, bf16 in itertools.product((1, 2, 3), (False, True), (False, True)):
        params = NlmParams(search_radius=s, patch_radius=p, search_stride=stride,
                           search_disk=disk)
        tile = stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN)
        assert tile.p == p and tile.sliding == (p <= stencils.NLM_REGISTER_PATCH)
        if tile.sliding:
            _check_segments(tile)
        else:
            assert (tile.tw, tile.pitch, tile.threads) == (stencils.NLM_TILE_W, tile.win_w,
                                                           stencils.NLM_THREADS)
        assert tile.shared_bytes <= H100_SHARED_OPTIN
        for h, w in itertools.product((max(1, tile.th - 3), tile.th, 2 * tile.th + 3),
                                      (5, tile.tw, 2 * tile.tw + 7)):
            _check_image(tile, params, h, w)


def _sweep(cands, kw):
    """The sliding body's candidate loop (stencils.cu: nlm_kernel) on window
    columns: yields (k, rot, ring, loads) for each candidate it runs, where
    ring[slot] is the window column (relative to the segment's first e
    column at dx = 0) that the slot holds, e column c reads slot (c + rot) %
    kw, and `loads` is the taps loaded for the candidate."""
    n, k = len(cands), 0

    def slide(k, dy, dx):
        if k >= n or cands[k][0] != dy:
            return 0
        step = cands[k][1] - dx
        return step if 0 < step < kw else 0

    while k < n:
        dy, dx = cands[k]
        ring = [dx + c for c in range(kw)]
        nxt = dx + kw
        yield k, 0, list(ring), kw
        k += 1
        step = slide(k, dy, dx)
        while step > 0:
            for u in range(1, kw + 1):
                if step > 0:
                    ring[(u - 1) % kw] = nxt
                    nxt += 1
                    step -= 1
                    if step == 0:
                        dx = cands[k][1]
                        yield k, u % kw, list(ring), cands[k][1] - cands[k - 1][1]
                        k += 1
                        step = slide(k, dy, dx)


@pytest.mark.parametrize("disk", [False, True], ids=["square", "disk"])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_ring_holds_each_candidates_taps(p, stride, disk):
    """At search radii 1-16, every candidate runs once and in the table's
    order, and each e column reads the window column of its candidate from
    the ring; a candidate that slides loads one tap a column it moves, so a
    row of the table loads the ring once and then one tap a stride."""
    kw = stencils.NLM_SEG + 2 * p - 1
    for s in range(1, 17):
        cands = stencils.nlm_candidates(NlmParams(search_radius=s, patch_radius=p,
                                                  search_stride=stride, search_disk=disk))
        seen = []
        loads = 0
        for k, rot, ring, loaded in _sweep(cands, kw):
            seen.append(k)
            loads += loaded
            for c in range(kw):
                assert ring[(c + rot) % kw] == cands[k][1] + c
        assert seen == list(range(len(cands)))
        rows = {}
        for dy, dx in cands:
            rows.setdefault(dy, []).append(dx)
        if stride < kw:
            assert loads == sum(kw + max(r) - min(r) for r in rows.values())


@pytest.mark.parametrize("shape", [(1080, 1920), (1, 1), (29, 37), (31, 300), (40, 5),
                                   (97, 131)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8])
def test_every_output_is_owned_once(p, shape):
    """The launch grid's blocks, warps, lanes and segment columns (staged
    body: threads and rows) own every pixel of the image exactly once, at
    1080p and at ragged sizes."""
    h, w = shape
    tile = stencils.nlm_tile(NlmParams(patch_radius=p), False, H100_SHARED_OPTIN)
    by, bx = np.meshgrid(np.arange(-(-h // tile.th)), np.arange(-(-w // tile.tw)),
                         indexing="ij")
    if tile.sliding:
        seg = stencils.NLM_SEG
        warp, lane, j = np.meshgrid(np.arange(tile.tw // seg), np.arange(32), np.arange(seg),
                                    indexing="ij")
        row, col = lane, warp * seg + j
        owns = lane < tile.th
    else:
        t, q = np.meshgrid(np.arange(stencils.NLM_THREADS),
                           np.arange(stencils.NLM_TILE_HS[0] * stencils.NLM_TILE_W
                                     // stencils.NLM_THREADS), indexing="ij")
        row = t // stencils.NLM_TILE_W + q * (stencils.NLM_THREADS // stencils.NLM_TILE_W)
        col = t % stencils.NLM_TILE_W
        owns = row < tile.th
    y = by.reshape(-1, 1) * tile.th + row[owns].reshape(1, -1)
    x = bx.reshape(-1, 1) * tile.tw + col[owns].reshape(1, -1)
    inside = (y < h) & (x < w)
    counts = np.zeros((h, w), np.int64)
    np.add.at(counts, (y[inside], x[inside]), 1)
    assert (counts == 1).all()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize(
    "params",
    [NlmParams(), NlmParams(search_stride=2), NlmParams(search_stride=2, search_disk=True),
     NlmParams(search_radius=16, patch_radius=4), NlmParams(search_radius=1, patch_radius=1),
     NlmParams(patch_radius=5), NlmParams(search_radius=16, patch_radius=8)],
    ids=["reference", "stride2", "stride2_disk", "s16_p4", "s1_p1", "p5", "s16_p8"],
)
def test_shared_bytes_match_the_layout(params, bf16):
    """The window as float4, with bf16 taps its RGB as 4 x bf16, win_h rows
    of `pitch` pixels each; then the sliding body's frame sums (a float4 and
    a float an output), or for radii above NLM_REGISTER_PATCH the target's e
    region as window taps, e and the row sums as float32: back to back, each
    sized for what the kernel indexes and aligned for its loads."""
    tile = stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN)
    n_win, n_e = tile.win_h * tile.pitch, tile.e_h * tile.e_w
    tap = 8 if bf16 else 16
    regions = [("window", 0, 16 * n_win, 16)]
    if bf16:
        regions.append(("taps", tile.taps_at, 8 * n_win, 8))
    else:
        assert tile.taps_at == 0  # the window itself
    if tile.sliding:
        outputs = stencils.NLM_SEG * tile.threads  # each thread's NLM_SEG outputs
        regions += [("sums", tile.sums_at, 20 * outputs, 16)]
        assert tile.tgt_at == tile.e_at == tile.rows_at == tile.shared_bytes
        assert outputs == 32 * tile.tw
    else:
        assert tile.sums_at == tile.tgt_at
        regions += [("target", tile.tgt_at, tap * n_e, tap), ("e", tile.e_at, 4 * n_e, 4),
                    ("rows", tile.rows_at, 4 * tile.th * tile.e_w, 4)]
    end = 0
    for name, at, size, align in regions:
        assert at == -(-end // align) * align, name
        end = at + size
    assert tile.shared_bytes == end
    assert stencils.nlm_layout(tile.th, tile.tw, tile.p, tile.win_h, tile.pitch, bf16) == (
        tile.taps_at, tile.sums_at, tile.tgt_at, tile.e_at, tile.rows_at, tile.shared_bytes)
    assert list(tile.launch_args()) == [tile.th, tile.tw, tile.oy, tile.ox, tile.win_h,
                                        tile.win_w, tile.pitch, tile.taps_at, tile.sums_at,
                                        tile.tgt_at, tile.e_at, tile.rows_at,
                                        tile.shared_bytes]
    cands = stencils.nlm_candidates(params)
    assert tile.win_h == tile.e_h + max(dy for dy, _ in cands) - min(dy for dy, _ in cands)
    assert tile.win_w == tile.e_w + max(dx for _, dx in cands) - min(dx for _, dx in cands)


def test_reference_tiles():
    """At the reference parameters the sliding body takes 27 x 32 tiles, 4
    warps, with the opt-in above 48 KB (the window, 20 KB of frame sums, and
    in the turbo form the window's bf16 copy), three blocks a multiprocessor
    within its 227 KB; s = 16 (1024 candidates) fits the H100 too."""
    exact = stencils.nlm_tile(NlmParams(), False, H100_SHARED_OPTIN)
    turbo = stencils.nlm_tile(NlmParams(search_stride=2), True, H100_SHARED_OPTIN)
    assert (exact.th, exact.tw, exact.win_h, exact.win_w, exact.pitch, exact.shared_bytes) == (
        27, 32, 45, 50, 51, 57200)
    assert (turbo.th, turbo.tw, turbo.win_h, turbo.win_w, turbo.pitch, turbo.shared_bytes) == (
        27, 32, 44, 49, 49, 72224)
    assert 3 * turbo.shared_bytes <= H100_SHARED_OPTIN
    assert exact.threads == turbo.threads == 128
    wide = NlmParams(search_radius=16)
    assert len(stencils.nlm_candidates(wide)) == stencils.MAX_CANDIDATES
    for bf16 in (False, True):
        tile = stencils.nlm_tile(wide, bf16, H100_SHARED_OPTIN)
        assert tile.tw == 32 and DEFAULT_SHARED < tile.shared_bytes <= H100_SHARED_OPTIN


def _check_shrinks(params, bf16):
    """Each shape of nlm_tile_shapes is taken at exactly its own bytes, and
    one byte less takes the next one; under the last one's bytes nlm_tile
    refuses."""
    p = params.patch_radius
    shapes = stencils.nlm_tile_shapes(p)
    full = stencils.nlm_tile(params, bf16, H100_SHARED_OPTIN)
    for i, (th, tw) in enumerate(shapes):
        win_h = th + 2 * p - 1 + full.win_h - full.e_h
        win_w = tw + 2 * p - 1 + full.win_w - full.e_w
        pitch = win_w | 1 if p <= stencils.NLM_REGISTER_PATCH else win_w
        nbytes = stencils.nlm_layout(th, tw, p, win_h, pitch, bf16)[-1]
        assert (stencils.nlm_tile(params, bf16, nbytes).th,
                stencils.nlm_tile(params, bf16, nbytes).tw) == (th, tw)
        if i + 1 < len(shapes):
            assert (stencils.nlm_tile(params, bf16, nbytes - 1).th,
                    stencils.nlm_tile(params, bf16, nbytes - 1).tw) == shapes[i + 1]
        else:
            with pytest.raises(ValueError, match="no NLM tile fits"):
                stencils.nlm_tile(params, bf16, nbytes - 1)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_tile_shrinks_before_it_refuses(p, bf16):
    """Under a smaller shared-memory limit the sliding body's tile loses
    warps, 4 down to 1, before nlm_tile refuses (s = 16)."""
    assert [tw for _, tw in stencils.nlm_tile_shapes(p)] == [
        w * stencils.NLM_SEG for w in stencils.NLM_SLIDE_WARPS]
    _check_shrinks(NlmParams(search_radius=16, patch_radius=p), bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_wide_patch_tile_shrinks_before_it_refuses(bf16):
    """The staged body's tile loses rows, 16 down to 1 (s = 16, p = 8)."""
    assert stencils.nlm_tile_shapes(8) == [(th, stencils.NLM_TILE_W)
                                           for th in stencils.NLM_TILE_HS]
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
    assert (tile.th, tile.oy, tile.ox) == (33 - 2 * p if p <= 4 else 16, -p, -p)
    assert (tile.win_h, tile.win_w) == (tile.e_h, tile.e_w)
    for h, w in ((3, 5), (16, 32), (35, 71)):
        for y0 in range(0, h, tile.th):
            _check_axis(h, y0, tile.th, tile.e_h, p, tile.oy, tile.win_h, [0])
        for x0 in range(0, w, tile.tw):
            _check_axis(w, x0, tile.tw, tile.e_w, p, tile.ox, tile.win_w, [0])
