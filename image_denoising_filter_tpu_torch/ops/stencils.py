"""Hand-written CUDA kernels for the exact stencils: bilateral and
layer-guided cross-bilateral (with float32 or bf16 taps), frame-batched NLM
(with float32 or bf16 taps, and with the weights at full or at half row
resolution) and the normalize epilogue.

Counterpart of image_denoising_filter_tpu/ops/stencils.py. The kernels are in
ops/csrc/stencils.cu and are built by ops/_build.py at first use. Beside each
kernel this module holds:

  * the static tables the kernel iterates, ported from the JAX module:
    `_circle_runs` (the bilateral truncation disk) and `_sdx_steps` (the NLM
    search candidates, with the stride and disk subsets);
  * the kernels' blocks (compiled into the kernels from here), tiles,
    staged windows and shared-memory layouts (`bilateral_tile`, `nlm_tile`,
    `hrw_tile`), index arithmetic in pure Python that the CPU tests check;
  * its plain PyTorch version, the same tap set and candidate table as
    whole-image tensor ops (`bilateral_plain`, `nlm_plain`,
    `normalize_plain`);
  * a launch counter in `launches`, raised by one where the wrapper launches
    the kernel and nowhere else.

The public wrappers keep the JAX signatures and the (H, W, 4) float32
layout. On a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it checks dtype, shape, contiguity and options, then launches the kernel or
raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    NormalizeParams,
    TilingConfig,
)

from . import _build
from .eager import NLM_HRW_KAPPA, _pad2d, check_hrw_params, nlm_eager, normalize_eager

# exp(x) == exp2(x * log2(e)): log2(e) is folded into the weight constants.
LOG2E = math.log2(math.e)

# Table sizes the kernels take by value (stencils.cu: kMaxRuns, kMaxCands).
MAX_RUNS = 128
MAX_CANDIDATES = 1024

# The NLM kernel's blocks, compiled into stencils.cu (nvcc_defines). Up to
# patch radius NLM_REGISTER_PATCH the sliding body, unrolled for the radius: a
# warp's 32 lanes are 32 consecutive rows of squared differences, the first
# 33 - 2p of them output rows, each lane owning NLM_SEG output columns of its
# row, and a block is one of NLM_SLIDE_WARPS warps side by side. Wider radii
# take the staged body: NLM_THREADS threads own an output tile of NLM_TILE_W
# columns and one of NLM_TILE_HS rows.
NLM_THREADS = 256
NLM_SEG = 8
NLM_SLIDE_WARPS = (4, 2, 1)
# The sliding body's __launch_bounds__ minimum of blocks a multiprocessor:
# with none, ptxas trims some bf16 instances to 128 registers and spills.
NLM_MIN_BLOCKS = 2
NLM_TILE_W = 32
NLM_TILE_HS = (16, 8, 4, 2, 1)
NLM_REGISTER_PATCH = 4
# The half-row NLM kernel's block, likewise: 256 threads own an output tile
# of 32 columns and one of HRW_TILE_HS rows (even: the tile starts on the
# absolute even-row lattice of the half-row cells), each thread one pixel
# pair of a column; each keeps the target's cells of HRW_E_PER_THREAD
# squared-difference positions in registers. HRW_LANES is the 2p-lane box
# at patch radius 3, the one radius the half-row weights take.
HRW_THREADS = 256
HRW_TILE_W = 32
HRW_TILE_HS = (16, 8, 4, 2)
HRW_E_PER_THREAD = 2
HRW_LANES = 6
# The exact bilateral kernel's staged block: a warp owns BIL_TILE_W
# neighbouring pixels of one output row, each thread BIL_PX of them side by
# side (odd: a warp's loads then fall on distinct shared-memory banks), and a
# block of th warps owns th rows, th one of BIL_TILE_HS.
BIL_PX = 3
BIL_TILE_W = 32 * BIL_PX
BIL_TILE_HS = (16, 8, 4, 2, 1)
# exp2f's range test: from this exponent up, exp2f is MUFU.EX2 of the
# exponent itself, ex2.approx.ftz.f32, which the staged bilateral takes for
# a tap row whose block cannot reach below it (bilateral_row_walks).
BIL_EXP2_MIN = -126.0


def nvcc_defines() -> tuple[str, ...]:
    """The blocks above as the macros stencils.cu is compiled with."""
    return (
        f"-DIDF_NLM_THREADS={NLM_THREADS}",
        f"-DIDF_NLM_SEG={NLM_SEG}",
        f"-DIDF_NLM_SLIDE_THREADS={32 * max(NLM_SLIDE_WARPS)}",
        f"-DIDF_NLM_MIN_BLOCKS={NLM_MIN_BLOCKS}",
        f"-DIDF_NLM_TILE_W={NLM_TILE_W}",
        f"-DIDF_NLM_MAX_TILE_H={max(NLM_TILE_HS)}",
        f"-DIDF_NLM_REGISTER_PATCH={NLM_REGISTER_PATCH}",
        f"-DIDF_HRW_THREADS={HRW_THREADS}",
        f"-DIDF_HRW_TILE_W={HRW_TILE_W}",
        f"-DIDF_HRW_MAX_TILE_H={max(HRW_TILE_HS)}",
        f"-DIDF_HRW_E_PER_THREAD={HRW_E_PER_THREAD}",
        f"-DIDF_HRW_LANES={HRW_LANES}",
        f"-DIDF_BIL_PX={BIL_PX}",
        f"-DIDF_BIL_MAX_TILE_H={max(BIL_TILE_HS)}",
        f"-DIDF_BIL_EXP2_MIN={BIL_EXP2_MIN!r}f",
    )


#: Kernel launches since the last reset_launches(), by kernel form:
#: "bilateral" and "bilateral_guided" with float32 taps, "bilateral_bf16" and
#: "bilateral_guided_bf16" with bf16 taps; "nlm" with float32 taps,
#: "nlm_bf16" with bf16 taps, "nlm_hrw" and "nlm_hrw_bf16" the same with the
#: weights at half row resolution; the turbo grids' kernels (ops/fast.py)
#: count here too, each grid build and slice at d = 1 (the sharded --turbo
#: 1's bilateral grid, the --turbo 1 layers' guided grid) under its own
#: "_d1" name, so that each launch counts once under the form that ran.
launches = {
    "bilateral": 0, "bilateral_guided": 0, "bilateral_bf16": 0, "bilateral_guided_bf16": 0,
    "nlm": 0, "nlm_bf16": 0,
    "nlm_hrw": 0, "nlm_hrw_bf16": 0, "normalize": 0,
    "pool": 0, "build_grid": 0, "slice_grid": 0, "fused_grid": 0,
    "build_guided_grid": 0, "slice_guided_grid": 0, "fused_guided": 0,
    "build_grid_d1": 0, "slice_grid_d1": 0, "build_guided_grid_d1": 0,
    "slice_guided_grid_d1": 0,
}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------


def _circle_runs(
    radius: int, sigma_spatial: float, truncate_eps: float, max_extra: int = 2
) -> list[tuple[int, int, int]]:
    """(dy_start, n_rows, half_width) row runs covering the truncation disk
    {dy^2 + dx^2 <= R^2}, R^2 = 2 ss^2 ln(1/eps) (stencils.py:_circle_runs).

    Rows are grouped greedily into runs whose shared half width exceeds no
    member row's exact width by more than `max_extra`; the slack taps are
    real window taps, so both packages iterate exactly the same tap set."""
    if truncate_eps > 0.0:
        r2_max = 2.0 * sigma_spatial * sigma_spatial * math.log(1.0 / truncate_eps)
    else:
        r2_max = float("inf")
    rows = []
    for dy in range(-radius, radius + 1):
        if dy * dy <= r2_max:
            k = radius if math.isinf(r2_max) else int(math.sqrt(r2_max - dy * dy))
            rows.append((dy, min(radius, k)))
    runs = []
    cur = None  # (dy_start, widths)
    for dy, k in rows:
        if cur is not None:
            merged = cur[1] + [k]
            if max(merged) - min(merged) <= max_extra:
                cur = (cur[0], merged)
                continue
            runs.append((cur[0], len(cur[1]), max(cur[1])))
        cur = (dy, [k])
    if cur is not None:
        runs.append((cur[0], len(cur[1]), max(cur[1])))
    return runs


def _sdx_steps(params: NlmParams) -> tuple[tuple[int, ...], ...]:
    """Per search row, the candidate columns sdx = dx + s
    (stencils.py:903-912): the stride subset keeps the zero offset, the disk
    trim drops the grid corners."""
    s, stride = params.search_radius, params.search_stride
    sdx_all = tuple(range(s % stride, 2 * s, stride))
    return tuple(
        tuple(
            sdx
            for sdx in sdx_all
            if not params.search_disk or (sdy - s) ** 2 + (sdx - s) ** 2 <= s * s
        )
        for sdy in sdx_all
    )


def nlm_candidates(params: NlmParams) -> list[tuple[int, int]]:
    """The (dy, dx) search offsets of `_sdx_steps`, row by row: none at
    search radius 0."""
    s = params.search_radius
    sdy_all = range(s % params.search_stride, 2 * s, params.search_stride)
    return [
        (sdy - s, sdx - s)
        for sdy, row in zip(sdy_all, _sdx_steps(params))
        for sdx in row
    ]


# ---------------------------------------------------------------------------
# The bilateral kernel's tile
# ---------------------------------------------------------------------------


def disk_halo(runs: list[tuple[int, int, int]]) -> tuple[int, int]:
    """(rows, columns) the disk of `runs` reaches from its centre: the
    largest |dy| of a row and the largest half width."""
    hy = max(max(-dy0, dy0 + n - 1) for dy0, n, _ in runs)
    return hy, max(hw for _, _, hw in runs)


@dataclasses.dataclass(frozen=True)
class BilateralTile:
    """One block's geometry in the bilateral kernel. The block owns output
    rows [y0, y0 + th) and columns [x0, x0 + tw), one warp a row, and stages
    the image's pixels (y0 - hy + i, x0 - hx + j), i < th + 2 hy, j < tw + 2
    hx, with the border applied: the disk's halo around the tile. The
    block's dynamic shared memory (bilateral_layout) holds the weight
    source's staged pixels at byte 0 (the guide's when guided), from
    vals_at the target's (guided), from alpha_at the float32 alpha plane
    (bf16 taps, unless alpha is uniform), from sp_at the disk square's
    spatial terms ((2 hy + 1) x (2 hx + 1) floats), from range_at th x 6
    floats where the warps reduce the staged channel ranges; shared_bytes
    in all. th == 0 is the direct-load instance, which stages nothing:
    bilateral_tile takes it where no staged tile of the disk fits."""

    th: int
    tw: int
    hy: int
    hx: int
    vals_at: int
    alpha_at: int
    sp_at: int
    range_at: int
    shared_bytes: int

    @property
    def staged(self) -> bool:
        return self.th > 0

    @property
    def n_staged(self) -> int:
        """Staged pixels of one image (0 for the direct-load instance)."""
        return (self.th + 2 * self.hy) * (self.tw + 2 * self.hx) if self.staged else 0

    def launch_args(self) -> np.ndarray:
        """The ints idf_bilateral takes (stencils.cu: BilTile, then the bytes)."""
        return np.asarray(
            [self.th, self.hy, self.hx, self.vals_at, self.alpha_at, self.sp_at, self.range_at,
             self.shared_bytes],
            np.int32,
        )


def bilateral_layout(
    th: int, hy: int, hx: int, guided: bool, bf16: bool, alpha: bool
) -> tuple[int, int, int, int, int]:
    """The bilateral kernel's shared memory, in this order: the weight
    source's staged pixels, as float4 (16 bytes) or as bf16 RGB (8 bytes)
    with bf16 taps; when guided the target's, likewise; with bf16 taps and
    `alpha` (alpha accumulated, not uniform) the target's alpha as float32
    (4 bytes); the disk square's (2 hy + 1) x (2 hx + 1) spatial terms as
    float32; th x 6 floats of channel ranges. Returns (vals_at, alpha_at,
    sp_at, range_at, shared bytes); an offset is 0 where its region is
    absent."""
    n = (th + 2 * hy) * (BIL_TILE_W + 2 * hx)
    px = 8 if bf16 else 16
    at = px * n
    vals_at = at if guided else 0
    at += px * n if guided else 0
    alpha_at = at if bf16 and alpha else 0
    at += 4 * n if bf16 and alpha else 0
    range_at = at + 4 * (2 * hy + 1) * (2 * hx + 1)
    return vals_at, alpha_at, at, range_at, range_at + 24 * th


@functools.lru_cache(maxsize=None)
def bilateral_tile(
    params: BilateralParams, guided: bool, bf16: bool, shared_limit: int
) -> BilateralTile:
    """The bilateral kernel's tile for these parameters on a card whose
    blocks may hold `shared_limit` bytes of shared memory (max_shared_bytes):
    the tallest of BIL_TILE_HS whose staged disk halo fits; where none fits,
    the direct-load instance (th 0), which reads every tap from device
    memory and takes any disk of the runs table."""
    hy, hx = disk_halo(_circle_runs(params.effective_radius, params.sigma_spatial,
                                    params.truncate_eps))
    for th in BIL_TILE_HS:
        *offsets, nbytes = bilateral_layout(th, hy, hx, guided, bf16, not params.uniform_alpha)
        if nbytes <= shared_limit:
            return BilateralTile(th, BIL_TILE_W, hy, hx, *offsets, nbytes)
    return BilateralTile(0, BIL_TILE_W, hy, hx, 0, 0, 0, 0, 0)


def bilateral_ssd_max(lo: torch.Tensor, hi: torch.Tensor, blue_bug: bool,
                      bf16: bool) -> torch.Tensor:
    """The largest colour distance any tap of a staged block can have, from
    the block's channel ranges lo and hi ((..., 3) float32): the kernel's
    ssd_max, its tap's own operations on hi - lo. With bf16 taps every
    operation rounds to bf16 (`_bilateral_sq_diff_bf16`); in float32 dr*dr
    + dg*dg is one fused multiply-add (emulated in float64: the product is
    exact there) and db*db is added after its own rounding unless blue_bug.
    Each operation is monotone in the ranges, so no tap's distance exceeds
    the result."""
    if bf16:
        return _bilateral_sq_diff_bf16(hi.to(torch.bfloat16), lo.to(torch.bfloat16), blue_bug)
    d = hi - lo
    dr = d[..., 0].double()
    e = (dr * dr + (d[..., 1] * d[..., 1]).double()).float()
    return e if blue_bug else e + d[..., 2] * d[..., 2]


def bilateral_row_walks(ssd_max: torch.Tensor, params: BilateralParams) -> torch.Tensor:
    """For blocks whose largest colour distance is ssd_max (any shape), which
    tap rows of the disk (its `_circle_runs` rows, in order; the last axis)
    the staged kernel walks with ex2.approx.ftz.f32, the others with exp2f:
    the farthest tap of a row (dx = +-hw, the row's least spatial term, as
    the kernel's table holds it) must keep its exponent sp - ssd_max *
    col_coef at BIL_EXP2_MIN or above. The fused multiply-add is emulated in
    float64 and rounded to float32 once more, which moves the test only at
    a tie. An infinite or NaN distance fails every row."""
    sp_coef = np.float32(-0.5 / params.sigma_spatial**2 * LOG2E)
    col_coef = np.float32(0.5 / params.sigma_color**2 * LOG2E)
    far = []
    for dy0, n_rows, hw in _circle_runs(params.effective_radius, params.sigma_spatial,
                                        params.truncate_eps):
        for dy in range(dy0, dy0 + n_rows):
            row = np.float32(sp_coef * np.float32(dy * dy))
            far.append(np.float32(float(hw * hw) * float(sp_coef) + float(row)))
    far = torch.tensor(np.asarray(far, np.float64), device=ssd_max.device)
    x = (far - ssd_max.double()[..., None] * float(col_coef)).float()
    return x >= BIL_EXP2_MIN


def bilateral_walks(guide: torch.Tensor, params: BilateralParams, bf16: bool,
                    tile: BilateralTile) -> dict:
    """How one launch of the staged kernel with `tile` walks the tap rows of
    `guide`, its weight source (the image, or the layer of a guided call):
    each block reduces its staged pixels (the tile and the disk's halo, the
    border applied; RGB, rounded to bf16 with bf16 taps) to channel ranges,
    as the kernel does (fminf and fmaxf pass NaN by), and each tap row takes
    `bilateral_row_walks`' verdict. Returns the blocks, the tap rows of all
    blocks, those walked with exp2f, and the blocks with at least one such
    row."""
    if not tile.staged:
        raise ValueError("the direct-load instance stages no block: every tap takes exp2f")
    h, w, _ = guide.shape
    nby, nbx = -(-h // tile.th), -(-w // tile.tw)
    dev = guide.device
    ys = torch.arange(-tile.hy, nby * tile.th + tile.hy, device=dev)
    xs = torch.arange(-tile.hx, nbx * tile.tw + tile.hx, device=dev)
    staged = guide[..., :3][ys.clamp(0, h - 1)][:, xs.clamp(0, w - 1)]
    if params.border != BorderPolicy.CLAMP:
        inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None]
        staged = torch.where(inside[..., None], staged, torch.zeros((), device=dev))
    if bf16:
        staged = staged.to(torch.bfloat16).float()
    window = dict(kernel_size=(tile.th + 2 * tile.hy, tile.tw + 2 * tile.hx),
                  stride=(tile.th, tile.tw))
    planes = staged.permute(2, 0, 1)[None]
    inf = dict(posinf=math.inf, neginf=-math.inf)
    hi = torch.nn.functional.max_pool2d(planes.nan_to_num(-math.inf, **inf), **window)
    lo = -torch.nn.functional.max_pool2d(-planes.nan_to_num(math.inf, **inf), **window)
    ssd_max = bilateral_ssd_max(lo[0].permute(1, 2, 0), hi[0].permute(1, 2, 0),
                                params.blue_bug, bf16)
    slow = ~bilateral_row_walks(ssd_max, params)
    return {"blocks": nby * nbx, "rows": slow.numel(), "rows_exp2f": int(slow.sum()),
            "blocks_exp2f": int(slow.any(-1).sum())}


# ---------------------------------------------------------------------------
# The NLM kernels' tiles and staged windows
# ---------------------------------------------------------------------------


def _window_offsets(params: NlmParams) -> tuple[list[int], list[int]]:
    """The candidates' dy and dx, and the self match's (0, 0), which the
    staged windows span: every table of a positive search radius holds the
    self match, and the NLM kernel reads each frame's own pixels there (the
    uniform alpha). An empty table (search radius 0) takes the window of the
    self match alone: the kernel then runs no candidate and writes each
    frame's seed, as the JAX package does."""
    cands = nlm_candidates(params) + [(0, 0)]
    return [dy for dy, _ in cands], [dx for _, dx in cands]


@dataclasses.dataclass(frozen=True)
class NlmTile:
    """One block's geometry in the NLM kernel. The block owns output rows
    [y0, y0 + th) and columns [x0, x0 + tw) and computes the squared
    difference e(r, c) of target pixel (y0 - p + r, x0 - p + c) for r <
    e_h = th + 2p - 1, c < e_w = tw + 2p - 1. Per frame it stages the
    neighbour's pixels (y0 + oy + i, x0 + ox + j), i < win_h, j < win_w, at
    window index i * pitch + j: with (dy_min, dx_min) the table's least
    offsets, oy = dy_min - p, ox = dx_min - p, candidate (dy, dx) reads e(r,
    c)'s neighbour at window row r + dy - dy_min, column c + dx - dx_min, and
    output (y0 + i, x0 + j)'s value tap at (i + p + dy - dy_min, j + p + dx -
    dx_min).

    Up to NLM_REGISTER_PATCH (sliding): th = 33 - 2p, so that e_h is a
    warp's 32 lanes, tw / NLM_SEG warps side by side, each lane sliding the
    NLM_SEG + 2p - 1 columns of its e row from column NLM_SEG * warp, and an
    odd pitch (a warp's loads, one row apart, fall on distinct banks). Above it (staged): th of NLM_TILE_HS, tw = NLM_TILE_W,
    pitch = win_w. The block's dynamic shared memory (nlm_layout) holds the
    window as float4 at byte 0, and from the byte offsets taps_at, sums_at,
    tgt_at, e_at and rows_at the window's bf16 RGB (with float32 taps the
    window itself, taps_at 0), then the sliding body's frame sums, or the
    staged body's target taps, e and row sums (each body's other regions
    empty); shared_bytes in all."""

    th: int
    tw: int
    p: int
    oy: int
    ox: int
    win_h: int
    win_w: int
    pitch: int
    taps_at: int
    sums_at: int
    tgt_at: int
    e_at: int
    rows_at: int
    shared_bytes: int

    @property
    def sliding(self) -> bool:
        return self.p <= NLM_REGISTER_PATCH

    @property
    def e_h(self) -> int:
        return self.th + 2 * self.p - 1

    @property
    def e_w(self) -> int:
        return self.tw + 2 * self.p - 1

    @property
    def threads(self) -> int:
        """The block's threads: a warp a segment, or NLM_THREADS."""
        return 32 * self.tw // NLM_SEG if self.sliding else NLM_THREADS

    def launch_args(self) -> np.ndarray:
        """The ints idf_nlm takes (stencils.cu: NlmTile, then the bytes)."""
        return np.asarray(
            [self.th, self.tw, self.oy, self.ox, self.win_h, self.win_w, self.pitch,
             self.taps_at, self.sums_at, self.tgt_at, self.e_at, self.rows_at,
             self.shared_bytes],
            np.int32,
        )


def nlm_layout(th: int, tw: int, p: int, win_h: int, pitch: int,
               bf16: bool) -> tuple[int, ...]:
    """The NLM kernel's shared memory, in this order: the window as float4
    (win_h rows of `pitch` pixels, 16 bytes a pixel); with bf16 taps its RGB
    in bf16 (8 bytes a pixel); up to NLM_REGISTER_PATCH the sliding body's
    sums of the frames so far, NLM_SEG outputs a thread (float4 weighted
    colours, then float weights; from a 16-byte boundary); above it the
    staged body's target taps over the e region (one window tap each), e (th
    + 2p - 1 rows of e_w floats) and the row sums (th rows of e_w floats).
    Returns (taps_at, sums_at, tgt_at, e_at, rows_at, shared bytes)."""
    n_win = win_h * pitch
    at = 16 * n_win
    taps_at = at if bf16 else 0
    at += 8 * n_win if bf16 else 0
    if p <= NLM_REGISTER_PATCH:
        sums_at = -(-at // 16) * 16
        # 16 + 4 bytes an output, NLM_SEG outputs a thread, 32 * tw / NLM_SEG threads
        end = sums_at + 20 * 32 * tw
        return taps_at, sums_at, end, end, end, end
    e_w = tw + 2 * p - 1
    n_e = (th + 2 * p - 1) * e_w
    tgt_at = at
    e_at = tgt_at + (8 if bf16 else 16) * n_e
    rows_at = e_at + 4 * n_e
    return taps_at, at, tgt_at, e_at, rows_at, rows_at + 4 * th * e_w


def nlm_tile_shapes(p: int) -> list[tuple[int, int]]:
    """The (th, tw) a block of patch radius p may take, widest first:
    nlm_tile takes the first whose window fits."""
    if p <= NLM_REGISTER_PATCH:
        return [(33 - 2 * p, warps * NLM_SEG) for warps in NLM_SLIDE_WARPS]
    return [(th, NLM_TILE_W) for th in NLM_TILE_HS]


@functools.lru_cache(maxsize=None)
def nlm_tile(params: NlmParams, bf16: bool, shared_limit: int) -> NlmTile:
    """The NLM kernel's tile for these parameters on a card whose blocks may
    hold `shared_limit` bytes of shared memory (max_shared_bytes): the first
    of nlm_tile_shapes whose window fits; ValueError where none fits, or for
    a patch radius under 1 (no box to sum)."""
    p = params.patch_radius
    if p < 1:
        raise ValueError(f"the NLM kernel takes patch radius 1 or more, got {p}")
    dys, dxs = _window_offsets(params)
    for th, tw in nlm_tile_shapes(p):
        win_h = th + 2 * p - 1 + max(dys) - min(dys)
        win_w = tw + 2 * p - 1 + max(dxs) - min(dxs)
        pitch = win_w | 1 if p <= NLM_REGISTER_PATCH else win_w
        *offsets, nbytes = nlm_layout(th, tw, p, win_h, pitch, bf16)
        if nbytes <= shared_limit:
            return NlmTile(th, tw, p, min(dys) - p, min(dxs) - p, win_h, win_w, pitch,
                           *offsets, nbytes)
    raise ValueError(
        f"no NLM tile fits patch radius {p} and search radius {params.search_radius} "
        f"in {shared_limit} bytes of shared memory"
    )


@dataclasses.dataclass(frozen=True)
class HrwTile:
    """One block's geometry in the half-row NLM kernel. The block owns output
    rows [y0, y0 + th), th even, and columns [x0, x0 + tw). Its squared
    differences e(r, c) pair the target's half-row cell y0/2 - 2 + r with
    lane x0 - 3 + c, for r < e_h = th/2 + 4 and c < e_w = tw + HRW_LANES - 1;
    row r of the 3-cell sums (th/2 + 2 rows of e_w) is weight cell y0/2 - 1 +
    r, and output rows y0 + 2i, y0 + 2i + 1 read weight rows i .. i + 2.
    Per frame it stages the neighbour's value window, pixels (y0 + oy + i, x0
    + ox + j) for i < win_h, j < win_w, and its half-row cells (y0/2 - 2 +
    oy/2 + i, lane x0 - 3 + ox + j) for i < cell_h, j < cell_w: with (oy,
    ox) the table's least offsets (oy even), candidate (dy, dx) reads e(r,
    c)'s neighbour at cell (r + (dy - oy)/2, c + dx - ox) and output (y0 + i,
    x0 + j)'s value tap at (i + dy - oy, j + dx - ox). The block's dynamic
    shared memory (hrw_layout) holds the value window as float4 at byte 0,
    and from the byte offsets cells_at, e_at, sums_at and w_at the cells
    (float4, or bf16 RGB with bf16 taps), e, the 3-cell sums and the weight
    cells (th/2 + 2 rows of tw floats); shared_bytes in all."""

    th: int
    tw: int
    oy: int
    ox: int
    win_h: int
    win_w: int
    cell_h: int
    cell_w: int
    cells_at: int
    e_at: int
    sums_at: int
    w_at: int
    shared_bytes: int

    @property
    def e_h(self) -> int:
        return self.th // 2 + 4

    @property
    def e_w(self) -> int:
        return self.tw + HRW_LANES - 1

    def launch_args(self) -> np.ndarray:
        """The ints idf_nlm_hrw takes (stencils.cu: HrwTile, then the bytes)."""
        return np.asarray(
            [self.th, self.oy, self.ox, self.win_h, self.win_w, self.cell_h, self.cell_w,
             self.cells_at, self.e_at, self.sums_at, self.w_at, self.shared_bytes],
            np.int32,
        )


def hrw_layout(
    th: int, win_h: int, win_w: int, cell_h: int, cell_w: int, bf16: bool
) -> tuple[int, ...]:
    """The half-row NLM kernel's shared memory, in this order: the value
    window as float4 (16 bytes a pixel); the half-row cells as float4, or as
    bf16 RGB (8 bytes) with bf16 taps; e ((th/2 + 4) rows of e_w floats); the
    3-cell sums ((th/2 + 2) rows of e_w floats); the weight cells ((th/2 + 2)
    rows of HRW_TILE_W floats). Returns (cells_at, e_at, sums_at, w_at,
    shared bytes)."""
    e_w = HRW_TILE_W + HRW_LANES - 1
    cells_at = 16 * win_h * win_w
    e_at = cells_at + (8 if bf16 else 16) * cell_h * cell_w
    sums_at = e_at + 4 * (th // 2 + 4) * e_w
    w_at = sums_at + 4 * (th // 2 + 2) * e_w
    return cells_at, e_at, sums_at, w_at, w_at + 4 * (th // 2 + 2) * HRW_TILE_W


@functools.lru_cache(maxsize=None)
def hrw_tile(params: NlmParams, bf16: bool, shared_limit: int) -> HrwTile:
    """The half-row NLM kernel's tile for these parameters (search stride 2,
    patch radius 3) on a card whose blocks may hold `shared_limit` bytes of
    shared memory: the tallest of HRW_TILE_HS whose windows fit; ValueError
    where none fits."""
    check_hrw_params(params)
    dys, dxs = _window_offsets(params)
    dy_range, dx_range = max(dys) - min(dys), max(dxs) - min(dxs)
    win_w = HRW_TILE_W + dx_range
    cell_w = win_w + HRW_LANES - 1
    for th in HRW_TILE_HS:
        win_h = th + dy_range
        cell_h = th // 2 + 4 + dy_range // 2
        *offsets, nbytes = hrw_layout(th, win_h, win_w, cell_h, cell_w, bf16)
        if nbytes <= shared_limit:
            return HrwTile(th, HRW_TILE_W, min(dys), min(dxs), win_h, win_w, cell_h, cell_w,
                           *offsets, nbytes)
    raise ValueError(
        f"no half-row NLM tile fits search radius {params.search_radius} "
        f"in {shared_limit} bytes of shared memory"
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (same taps and candidates as the kernels)
# ---------------------------------------------------------------------------


def _bilateral_sq_diff_bf16(c: torch.Tensor, t: torch.Tensor, blue_bug: bool) -> torch.Tensor:
    """The bilateral's colour distance with bf16 taps (stencils.py:252-265
    with cdtype bfloat16): c and t are bf16 (..., 3); dr*dr + dg*dg, then +
    db*db unless blue_bug, with a bf16 rounding after every operation,
    widened to float32."""
    d = c - t
    e = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    if not blue_bug:
        e = e + d[..., 2] * d[..., 2]
    return e.float()


def bilateral_plain(
    img: torch.Tensor,
    guide: Optional[torch.Tensor],
    params: BilateralParams,
    fuse_normalize: bool,
    compute_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The bilateral kernel as tensor ops over the `_circle_runs` disk.
    Weights come from `guide` when given, else from `img`; values from
    `img`. compute_dtype "bfloat16" takes the kernel's bf16 taps: the colour
    distance of the bf16-rounded centre and tap RGB with every operation
    rounded (`_bilateral_sq_diff_bf16`), and the tap's RGB rounded to bf16 as
    the accumulated value (stencils.py:220-221, 266-274); alpha, weights and
    sums stay float32. Returns (out or wc (H,W,4), nw (H,W))."""
    h, w, _ = img.shape
    r = params.effective_radius
    bf16 = compute_dtype == "bfloat16"
    padded_v = _pad2d(img, r, params.border)
    padded_g = padded_v if guide is None else _pad2d(guide, r, params.border)
    center = (img if guide is None else guide)[..., :3]
    if bf16:
        center = center.to(torch.bfloat16)
        padded_g = padded_g[..., :3].to(torch.bfloat16)
        padded_v = torch.cat([padded_v[..., :3].to(torch.bfloat16).float(), padded_v[..., 3:]], -1)
    nrgb = 2 if params.blue_bug else 3
    sp_coef = -0.5 / params.sigma_spatial**2 * LOG2E
    col_coef = 0.5 / params.sigma_color**2 * LOG2E
    wc = torch.zeros((h, w, 4), dtype=torch.float32, device=img.device)
    nw = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for dy0, n_rows, hw in _circle_runs(r, params.sigma_spatial, params.truncate_eps):
        for dy in range(dy0, dy0 + n_rows):
            for dx in range(-hw, hw + 1):
                tap_g = padded_g[dy + r : dy + r + h, dx + r : dx + r + w]
                if bf16:
                    ssd = _bilateral_sq_diff_bf16(center, tap_g, params.blue_bug)
                else:
                    d = center[..., :nrgb] - tap_g[..., :nrgb]
                    ssd = (d * d).sum(-1)
                spatial = float(np.float32(sp_coef * (dy * dy + dx * dx)))
                wgt = torch.exp2(spatial - ssd * col_coef)
                wc += padded_v[dy + r : dy + r + h, dx + r : dx + r + w] * wgt[..., None]
                nw += wgt
    if params.uniform_alpha:
        wc[..., 3] = img[..., 3] * nw
    if fuse_normalize:
        wc = wc / nw[..., None]
    return wc, nw


def nlm_plain(
    target: torch.Tensor,
    frames: torch.Tensor,
    params: NlmParams,
    valid: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The NLM kernel as tensor ops: the sum over frames of each frame's
    partials (ops/eager.py:nlm_eager, which iterates the same
    `nlm_candidates` table, seeds nw with the norm seed and takes the same
    tap dtype), each scaled by valid[f], seed included."""
    total_wc = torch.zeros_like(target)
    total_nw = torch.zeros(target.shape[:2], dtype=torch.float32, device=target.device)
    for f in range(frames.shape[0]):
        wc, nw = nlm_eager(target, frames[f], params, compute_dtype)
        vf = 1.0 if valid is None else valid[f]
        total_wc += wc * vf
        total_nw += nw * vf
    return total_wc, total_nw


# The normalize pass is one division with a sentinel: its plain version is
# the linear config's own (ops/eager.py).
normalize_plain = normalize_eager


# ---------------------------------------------------------------------------
# Checks and launches
# ---------------------------------------------------------------------------


def _compute_dtype(tiling: Optional[TilingConfig], dtypes: tuple[str, ...]) -> str:
    """The kernel's tap dtype: float32, or one of `dtypes` the kernel takes
    (TilingConfig.compute_dtype). The bilateral and NLM kernels take bf16
    taps; any other dtype raises NotImplementedError."""
    dtype = "float32" if tiling is None else tiling.compute_dtype
    if dtype not in dtypes:
        raise NotImplementedError(
            f"compute_dtype={dtype!r} is not ported for this kernel: it takes "
            f"{' or '.join(dtypes)} taps"
        )
    return dtype


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (after checking them for the kernels), False for
    CPU tensors (which take the plain version); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs are on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 tensors, got {t.dtype}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}: use a CUDA or a CPU tensor")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return True


def _check_image(img: torch.Tensor, name: str) -> None:
    if img.dim() != 3 or img.shape[-1] != 4:
        raise ValueError(f"{name} must be (H, W, 4), got {tuple(img.shape)}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {rc}")


@functools.lru_cache(maxsize=None)
def max_shared_bytes(device: torch.device) -> int:
    """The shared memory a block may opt into on that card."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _build.library().idf_max_shared_bytes(ctypes.byref(out))
    _raise_on_error(rc, "max_shared_bytes")
    return out.value


def kernel_info(kernel: str, device: torch.device, params) -> dict:
    """How the kernel form `kernel` runs at `params` on `device`, as
    compiled: registers and spill (local) bytes a thread, its tile (th x tw,
    or "direct" for the bilateral's direct-load instance) and shared bytes,
    and the blocks a multiprocessor holds at once. The bilateral forms
    ("bilateral", "bilateral_guided", "bilateral_bf16",
    "bilateral_guided_bf16") take BilateralParams, the NLM forms ("nlm",
    "nlm_bf16", "nlm_hrw", "nlm_hrw_bf16") NlmParams."""
    info = (ctypes.c_int * 3)()
    bf16 = kernel.endswith("_bf16")
    zero = int(params.border != BorderPolicy.CLAMP)
    lib = _build.library()
    with torch.cuda.device(device):
        if kernel.startswith("bilateral"):
            guided = kernel.startswith("bilateral_guided")
            tile = bilateral_tile(params, guided, bf16, max_shared_bytes(device))
            rc = lib.idf_bilateral_info(int(guided), int(bf16), int(params.uniform_alpha),
                                        int(params.blue_bug), zero, tile.th, tile.shared_bytes,
                                        info)
            _raise_on_error(rc, f"{kernel} info")
            shape = f"{tile.th}x{tile.tw}" if tile.staged else "direct"
            return info_dict(info, shape, tile.shared_bytes)
        if kernel.startswith("nlm_hrw"):
            tile = hrw_tile(params, bf16, max_shared_bytes(device))
            rc = lib.idf_nlm_hrw_info(zero, int(bf16), tile.shared_bytes, info)
        else:
            tile = nlm_tile(params, bf16, max_shared_bytes(device))
            rc = lib.idf_nlm_info(params.patch_radius, zero, int(bf16), tile.threads,
                                  tile.shared_bytes, info)
    _raise_on_error(rc, f"{kernel} info")
    return info_dict(info, f"{tile.th}x{tile.tw}", tile.shared_bytes)


def info_dict(info, tile: str, shared_bytes: int) -> dict:
    """A kernel's C info array (registers, spill bytes, blocks a
    multiprocessor) with its tile and shared bytes, as kernel_info returns
    them."""
    return {"registers": info[0], "spill_bytes": info[1], "tile": tile,
            "shared_bytes": shared_bytes, "blocks_per_sm": info[2]}


def _launch_bilateral(
    img: torch.Tensor,
    guide: Optional[torch.Tensor],
    params: BilateralParams,
    fuse_normalize: bool,
    bf16: bool,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    h, w, _ = img.shape
    r = params.effective_radius
    runs = np.asarray(
        _circle_runs(r, params.sigma_spatial, params.truncate_eps), np.int32
    ).reshape(-1)
    if runs.size // 3 > MAX_RUNS:
        raise ValueError(f"{runs.size // 3} disk runs exceed the kernel's table of {MAX_RUNS}")
    out = torch.empty_like(img)
    nw = None if fuse_normalize else torch.empty((h, w), dtype=torch.float32, device=img.device)
    lib = _build.library()
    with torch.cuda.device(img.device):
        tile = bilateral_tile(params, guide is not None, bf16, max_shared_bytes(img.device))
        geom = tile.launch_args()
        rc = lib.idf_bilateral(
            img.data_ptr(),
            None if guide is None else guide.data_ptr(),
            out.data_ptr(),
            None if nw is None else nw.data_ptr(),
            h,
            w,
            runs.ctypes.data,
            runs.size // 3,
            -0.5 / params.sigma_spatial**2 * LOG2E,
            0.5 / params.sigma_color**2 * LOG2E,
            int(params.blue_bug),
            int(params.border != BorderPolicy.CLAMP),
            int(params.uniform_alpha),
            int(fuse_normalize),
            int(bf16),
            geom.ctypes.data,
            _stream(img),
        )
    kernel = ("bilateral" if guide is None else "bilateral_guided") + ("_bf16" if bf16 else "")
    _raise_on_error(rc, kernel)
    launches[kernel] += 1
    return out, nw


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


def bilateral(
    img: torch.Tensor,
    params: BilateralParams = BilateralParams(),
    tiling: Optional[TilingConfig] = None,
) -> torch.Tensor:
    """Bilateral filter with the normalize fused (shaders/bialteral.comp).
    img: (H, W, 4) float32; returns the filtered (H, W, 4) image.
    tiling.compute_dtype "bfloat16" takes bf16 taps: the colour distance in
    bf16 and the accumulated RGB rounded to bf16, everything else float32."""
    dtype = _compute_dtype(tiling, ("float32", "bfloat16"))
    _check_image(img, "img")
    if not _on_cuda(img):
        return bilateral_plain(img, None, params, True, dtype)[0]
    return _launch_bilateral(img, None, params, True, dtype == "bfloat16")[0]


def cross_bilateral_layers(
    target: torch.Tensor,
    layer: torch.Tensor,
    params: LayersParams = LayersParams(),
    tiling: Optional[TilingConfig] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross-bilateral partials (shaders/bialteral_layers.comp):
    weights from `layer`, colours from `target`. Returns (weightColor
    (H,W,4), normWeight (H,W)). tiling.compute_dtype "bfloat16" takes bf16
    taps, as `bilateral` does: the layer's and the target's RGB in bf16."""
    dtype = _compute_dtype(tiling, ("float32", "bfloat16"))
    _check_image(target, "target")
    if layer.shape != target.shape:
        raise ValueError(f"layer {tuple(layer.shape)} != target {tuple(target.shape)}")
    if not _on_cuda(target, layer):
        return bilateral_plain(target, layer, params, False, dtype)
    return _launch_bilateral(target, layer, params, False, dtype == "bfloat16")


def nlm_accumulate(
    target: torch.Tensor,
    neighbour: torch.Tensor,
    params: NlmParams = NlmParams(),
    tiling: Optional[TilingConfig] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's NLM partials (shaders/nonlocal.comp:30-65); normWeight is
    seeded with params.norm_seed. One launch of the frame-batched kernel;
    tiling.compute_dtype "bfloat16" takes bf16 taps (the turbo NLM), and
    params.weights_halfres the half-row weights."""
    return nlm_accumulate_frames(target, neighbour[None], params, tiling)


def nlm_accumulate_frames(
    target: torch.Tensor,
    frames: torch.Tensor,
    params: NlmParams = NlmParams(),
    tiling: Optional[TilingConfig] = None,
    valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temporal NLM partials over a stacked (F, H, W, 4) frame batch in one
    launch, the accumulators kept in registers across frames. Each frame adds
    its norm seed; `valid` ((F,) float 0/1) masks frames, seed included.
    tiling.compute_dtype "bfloat16" takes bf16 taps: the squared differences
    are computed in bf16, everything else in float32 (the turbo NLM).
    params.weights_halfres computes the weights at half row resolution (the
    half-row kernel, which pools each image's row pairs as it stages them;
    search stride 2 and patch radius 3 only, else ValueError)."""
    dtype = _compute_dtype(tiling, ("float32", "bfloat16"))
    if params.weights_halfres:
        check_hrw_params(params)
    _check_image(target, "target")
    if frames.dim() != 4 or frames.shape[1:] != target.shape:
        raise ValueError(f"frames must be (F, *{tuple(target.shape)}), got {tuple(frames.shape)}")
    n_frames = frames.shape[0]
    if valid is not None and valid.shape != (n_frames,):
        raise ValueError(f"valid must be ({n_frames},), got {tuple(valid.shape)}")
    if not _on_cuda(target, frames, *(() if valid is None else (valid,))):
        return nlm_plain(target, frames, params, valid, dtype)
    if valid is None:
        valid = torch.ones((n_frames,), dtype=torch.float32, device=target.device)
    h, w, _ = target.shape
    cands = np.asarray(nlm_candidates(params), np.int32).reshape(-1)
    if cands.size // 2 > MAX_CANDIDATES:
        raise ValueError(
            f"{cands.size // 2} search candidates exceed the kernel's table of {MAX_CANDIDATES}"
        )
    wc = torch.empty_like(target)
    nw = torch.empty((h, w), dtype=torch.float32, device=target.device)
    lib = _build.library()
    zero = int(params.border != BorderPolicy.CLAMP)
    ua = int(params.uniform_alpha)
    bf16 = int(dtype == "bfloat16")
    with torch.cuda.device(target.device):
        if params.weights_halfres:
            geom = hrw_tile(params, bool(bf16), max_shared_bytes(target.device)).launch_args()
            rc = lib.idf_nlm_hrw(
                target.data_ptr(), frames.data_ptr(), valid.data_ptr(), wc.data_ptr(),
                nw.data_ptr(), h, w, n_frames, cands.ctypes.data, cands.size // 2,
                -NLM_HRW_KAPPA * LOG2E / params.h**2, float(params.search_stride**2),
                params.norm_seed, zero, ua, bf16, geom.ctypes.data, _stream(target),
            )
        else:
            geom = nlm_tile(params, bool(bf16), max_shared_bytes(target.device)).launch_args()
            rc = lib.idf_nlm(
                target.data_ptr(), frames.data_ptr(), valid.data_ptr(), wc.data_ptr(),
                nw.data_ptr(), h, w, n_frames, params.patch_radius, cands.ctypes.data,
                cands.size // 2, -LOG2E / params.h**2, math.log2(params.search_stride**2),
                params.norm_seed, zero, ua, bf16, geom.ctypes.data, _stream(target),
            )
    kernel = ("nlm_hrw" if params.weights_halfres else "nlm") + ("_bf16" if bf16 else "")
    _raise_on_error(rc, kernel)
    launches[kernel] += 1
    return wc, nw


def normalize(
    weight_color: torch.Tensor,
    norm: torch.Tensor,
    params: NormalizeParams = NormalizeParams(),
    tiling: Optional[TilingConfig] = None,
) -> torch.Tensor:
    """Normalization pass (shaders/normalize.comp:30-44): out = wc / nw with a
    magenta sentinel where nw == 0. weight_color: (H,W,4); norm: (H,W).
    `tiling` is accepted for the JAX signature: the division is float32
    whatever its compute_dtype, as in the JAX kernel."""
    _check_image(weight_color, "weight_color")
    if norm.shape != weight_color.shape[:2]:
        raise ValueError(f"norm {tuple(norm.shape)} != {tuple(weight_color.shape[:2])}")
    if not _on_cuda(weight_color, norm):
        return normalize_plain(weight_color, norm, params)
    out = torch.empty_like(weight_color)
    lib = _build.library()
    with torch.cuda.device(out.device):
        rc = lib.idf_normalize(
            weight_color.data_ptr(),
            norm.data_ptr(),
            out.data_ptr(),
            norm.numel(),
            params.sentinel_r,
            params.sentinel_g,
            params.sentinel_b,
            params.sentinel_a,
            _stream(out),
        )
    _raise_on_error(rc, "normalize")
    launches["normalize"] += 1
    return out
