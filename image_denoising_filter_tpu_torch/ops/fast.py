"""Hand-written CUDA kernels of the turbo grids and the pipelines that run
them: the bilateral grid (pool, grid build, grid slice, and the fused
build+slice) and the layer-guided grid (guided build, guided slice, and the
fused guided build+slice).

Counterpart of image_denoising_filter_tpu/ops/fast.py:
  * the bilateral family, `bilateral_fast` -> `_grid_pipeline_planar` ->
    `_pool_pallas`, `_build_grid_pallas`, `_slice_grid_pallas`, or with
    fused=True `_fused_grid_pipeline_planar` (`grid_pipeline(fused=True)`);
  * the guided family, `cross_bilateral_layers_fast` -> `_pool_pallas`,
    `_build_guided_grid_pallas` + `_slice_guided_grid_pallas` (d = 1, 8) or
    `_fused_guided_pipeline_planar` (d = 2, 4), then `normalize_layers_fast`.
The kernels are in ops/csrc/fast.cu and are built by ops/_build.py at first
use. Beside them this module holds:

  * the static tables, ported from the JAX module: `_gauss_taps` and
    `_grid_taps` (the pool-compensated blur taps) and `_bilinear_taps` with
    `_upsample_matrix` (the half-pixel bilinear weights);
  * each kernel's plain PyTorch version (`pool_plain`, `build_grid_plain`,
    `slice_grid_plain`, `fused_grid_plain`, `build_guided_grid_plain`,
    `slice_guided_grid_plain`, `fused_guided_plain`): whole-image tensor ops
    with the kernel's bf16 roundings, taps, summation order and lerp formula;
  * the grid build kernels' and the fused kernels' blocks, tiles, staged
    windows and shared-memory layouts (`build_tile`; `build_d1_tile` for the
    build at d = 1, its own body; `fused_tile`), in pure Python that the CPU
    tests check;
  * launch counts, in `ops.stencils.launches` beside the exact kernels'.

Layouts: images (H, W, 4) float32; the pooled image (hs, ws, 4) float32 with
hs = ceil(H/d), ws = ceil(W/d); the bilateral grid (K, hs, ws, 4) bfloat16,
channels r, g, b, a; the guided grid (K, hs, ws, 8) bfloat16, the planes
num r, g, b, a, den r, g, b and one zero pad, so that one cell is one 16-byte
load. `grid_to_planes`, `guided_grid_to_planes` and their inverses convert
to and from the JAX package's level-major (nc*K, hs, ws) planes. On a CPU
tensor a wrapper runs the plain version; on a CUDA tensor it checks its
inputs, then launches the kernel or raises. There is no fallback from one to
the other.

Not ported, because it is TPU machinery with no value of its own: the per-d
tile defaults, the pad-free slab layout (`extend_to`), `cull_mask` and
`out_dtype`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..config import BilateralParams, BorderPolicy, LayersParams

from . import _build
from .eager import _blur_valid, _pad2d, _pad_to, bilateral_fast_eager
from .stencils import (
    LOG2E,
    _check_image,
    _on_cuda,
    _raise_on_error,
    _stream,
    info_dict,
    launches,
    max_shared_bytes,
)

# Table size the build kernel takes by value (fast.cu: kMaxTaps).
MAX_TAPS = 64
#: Downsamples of the pool, the build and slice kernels of both grids and the
#: fused guided kernel: the JAX package runs its Pallas kernels at d = 1 too
#: (the pool a bf16 round trip of every value), the bilateral grid's on a
#: mesh only (one device takes the eager lattice there, bilateral_fast).
DOWNSAMPLES = (1, 2, 4, 8)
#: Guided grid planes per level: num r, g, b, a; den r, g, b; one zero pad.
GUIDED_PLANES = 8
# The grid build kernels' block (one body for the bilateral and the guided
# grid), compiled into fast.cu from here (nvcc_defines): 256 threads own a
# tile of cells, the first of BUILD_TILES (rows, columns) whose staged window
# fits a block's shared memory, and a vertical-pass thread sums BUILD_STRIP
# cell rows of one staged column.
BUILD_THREADS = 256
BUILD_STRIP = 4
BUILD_TILES = (
    (16, 32), (8, 32), (4, 32), (2, 32), (1, 32), (1, 16), (1, 8), (1, 4), (1, 2), (1, 1),
)
# The grid build at d = 1 (one body for both grids, build_d1_tile): the grid
# is cut into bands of cell columns and strips of groups x BUILD_D1_ROWS cell
# rows, and each block walks an equal run of strips down the bands, keeping
# the rows a strip reads in a ring. A block has BUILD_D1_THREADS threads.
# BUILD_D1_TILES are (staged columns, groups), tried in order: the band is
# the staged columns less the blur halo 2r, rounded down to a multiple of
# BUILD_D1_CELLS (a horizontal-pass thread's cells); the vertical pass takes
# staged columns x groups of the threads, one a staged column and group,
# each summing BUILD_D1_ROWS cell rows, and the horizontal pass all of
# them. The first tile with two blocks a multiprocessor is taken, else the
# first with one. The taps sit in BUILD_D1_TAP_SLOTS floats of shared
# memory, what the passes' tap windows read.
BUILD_D1_ROWS = 8
BUILD_D1_CELLS = 4
BUILD_D1_TILES = ((128, 2), (128, 1), (96, 2), (96, 1), (64, 4), (64, 2), (64, 1), (32, 1),
                  (80, 1))
BUILD_D1_TAP_SLOTS = -(-(MAX_TAPS + max(BUILD_D1_ROWS, 8)) // 4) * 4
BUILD_D1_THREADS = 256
#: Shared memory the card keeps for itself beside each resident block's
#: dynamic bytes (CUDA's reserved shared memory a block, 1 KB on sm_90): a
#: multiprocessor holds (opt-in limit + this) // (bytes + this) blocks.
SHARED_BLOCK_RESERVE = 1024
# The fused kernels' blocks (the guided and the bilateral grid share the
# tile helper, fused_tile, and the build passes), likewise: FUSED_THREADS
# threads own a slice tile of pixels, each thread one column and every
# (FUSED_THREADS / pw)-th row of it; a vertical-pass thread sums FUSED_STRIP
# cell rows.
#   - The guided kernel takes the first of FUSED_GUIDED_TILES (rows,
#     columns) that d divides and whose window fits, at most
#     FUSED_GUIDED_PIXELS rows a thread; it builds FUSED_GUIDED_LEVELS
#     levels' cells (the main path's K at d = 2 and 4) before it slices
#     them, and is compiled for FUSED_GUIDED_MIN_BLOCKS blocks a
#     multiprocessor.
#   - The bilateral kernel takes the first of FUSED_GRID_TILES[d], whose
#     tiles hold about as many cells at every d (so the blur halo does not
#     dominate at d = 8); it builds FUSED_GRID_LEVELS levels (every K of the
#     main path) before it slices them, is compiled for FUSED_GRID_MIN_BLOCKS
#     blocks a multiprocessor (64 registers), and reads each tile's level
#     range from the guide at the d of FUSED_GRID_RANGE_DOWNSAMPLES; at the
#     others, where a tile of the larger pixel tiles touches nearly every
#     level anyway, it builds every level and reads the guide once.
FUSED_THREADS = 256
FUSED_STRIP = 2
FUSED_GUIDED_PIXELS = 4
FUSED_GUIDED_LEVELS = 5
FUSED_GUIDED_MIN_BLOCKS = 3
FUSED_GUIDED_TILES = ((16, 64), (16, 32), (8, 32))
FUSED_GRID_LEVELS = 6
FUSED_GRID_MIN_BLOCKS = 4
FUSED_GRID_RANGE_DOWNSAMPLES = (2,)
FUSED_GRID_TILES = {
    2: ((16, 64), (8, 64), (8, 32)),
    4: ((32, 128), (16, 128), (16, 64)),
    8: ((32, 256), (16, 256), (16, 128)),
}
#: Downsamples of the fused bilateral kernel: the JAX package never fuses at
#: d = 1 (nor on a mesh).
FUSED_GRID_DOWNSAMPLES = tuple(FUSED_GRID_TILES)
#: Shared memory a fused kernel keeps beside its window for its static arrays.
STATIC_SHARED_RESERVE = 1024


def nvcc_defines() -> tuple[str, ...]:
    """The blocks above as the macros fast.cu is compiled with."""
    return (f"-DIDF_BUILD_THREADS={BUILD_THREADS}",
            f"-DIDF_BUILD_STRIP={BUILD_STRIP}",
            f"-DIDF_BUILD_D1_ROWS={BUILD_D1_ROWS}",
            f"-DIDF_BUILD_D1_TAP_SLOTS={BUILD_D1_TAP_SLOTS}",
            f"-DIDF_BUILD_D1_THREADS={BUILD_D1_THREADS}",
            f"-DIDF_FUSED_THREADS={FUSED_THREADS}",
            f"-DIDF_FUSED_STRIP={FUSED_STRIP}",
            f"-DIDF_FUSED_GUIDED_PIXELS={FUSED_GUIDED_PIXELS}",
            f"-DIDF_FUSED_GUIDED_MIN_BLOCKS={FUSED_GUIDED_MIN_BLOCKS}",
            f"-DIDF_FUSED_GRID_MIN_BLOCKS={FUSED_GRID_MIN_BLOCKS}",
            f"-DIDF_FUSED_GUIDED_LEVELS={FUSED_GUIDED_LEVELS}",
            f"-DIDF_FUSED_GRID_LEVELS={FUSED_GRID_LEVELS}",
            f"-DIDF_STATIC_SHARED_RESERVE={STATIC_SHARED_RESERVE}")


# ---------------------------------------------------------------------------
# Static tables
# ---------------------------------------------------------------------------


def _gauss_taps(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-0.5 * (x / sigma) ** 2)
    return (w / w.sum()).astype(np.float32)


def _grid_taps(sigma_spatial: float, d: int) -> np.ndarray:
    """Grid-resolution blur taps with the pooling prefilter compensated
    (fast.py:_grid_taps): the mean of d unit-spaced samples has variance
    (d^2 - 1)/12, so the grid blur supplies sigma_g = sqrt(max(sigma_s^2 -
    (d^2 - 1)/12, 0.04)) / d, over radius ceil(4 sigma_g)."""
    var = sigma_spatial * sigma_spatial - (d * d - 1) / 12.0
    sigma_g = math.sqrt(max(var, 0.04)) / d
    radius = max(1, int(math.ceil(4.0 * sigma_g)))
    return _gauss_taps(sigma_g, radius)


def _bilinear_taps(d: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Half-pixel-centre bilinear taps over grid cells d samples apart:
    output sample x reads cells f = floor(g) and f + 1 at g = (x + 0.5)/d -
    0.5, with weight g - f on the second. Returns (f int64, weight float32)."""
    g = (np.arange(n_out, dtype=np.float64) + 0.5) / d - 0.5
    f = np.floor(g)
    return f.astype(np.int64), (g - f).astype(np.float32)


def _upsample_matrix(d: int, n_in: int, n_out: int) -> np.ndarray:
    """The taps as the (n_in, n_out) matrix of fast.py:_upsample_matrix,
    whose rows start one cell early (row f + 1 is cell f)."""
    f, w1 = _bilinear_taps(d, n_out)
    u = np.zeros((n_in, n_out), np.float32)
    cols = np.arange(n_out)
    np.add.at(u, (f + 1, cols), 1.0 - w1)
    np.add.at(u, (f + 2, cols), w1)
    return u


def _bilinear_up(g: torch.Tensor, d: int, h: int, w: int, slab=None) -> torch.Tensor:
    """Bilinear upsample of (hs, ws, C) grid cells to (h, w) samples over the
    edge-replicated grid: along W first, then along H, each as
    a * (1 - wt) + b * wt (the slice kernel's order). slab = (y_off, hs_all,
    gy_off) slices a band against a slab of grid rows (check_slab)."""
    hs, ws = g.shape[:2]
    y_off, hs_all, gy_off = (0, hs, 0) if slab is None else slab

    def taps(n_out, n_in, cell_off=0, first=0):
        f, wt = _bilinear_taps(d, n_out)
        f = f + cell_off
        i0 = torch.from_numpy(np.clip(f, 0, n_in - 1) - first).to(g.device)
        i1 = torch.from_numpy(np.clip(f + 1, 0, n_in - 1) - first).to(g.device)
        wt = torch.from_numpy(wt).to(g.device)
        return i0, i1, wt

    y0, y1, wy = taps(h, hs_all, y_off // d, gy_off)
    x0, x1, wx = taps(w, ws)
    wx = wx[:, None]
    gx = g[:, x0] * (1.0 - wx) + g[:, x1] * wx  # (hs, w, C)
    wy = wy[:, None, None]
    return gx[y0] * (1.0 - wy) + gx[y1] * wy


# ---------------------------------------------------------------------------
# Plain PyTorch versions (same roundings, taps and order as the kernels)
# ---------------------------------------------------------------------------


def pool_plain(img: torch.Tensor, d: int, border: str) -> torch.Tensor:
    """The pool kernel as tensor ops: pad to multiples of d, cast to bf16,
    mean over the d rows of each column, cast to bf16, mean over d columns."""
    h, w, _ = img.shape
    hs, ws = -(-h // d), -(-w // d)
    x = _pad_to(img, hs * d, ws * d, border).to(torch.bfloat16).float()
    inv_d = 1.0 / d
    rows = x.view(hs, d, ws * d, 4)
    col = rows[:, 0] * inv_d
    for i in range(1, d):
        col = col + rows[:, i] * inv_d
    cols = col.to(torch.bfloat16).float().view(hs, ws, d, 4)
    out = cols[:, :, 0] * inv_d
    for j in range(1, d):
        out = out + cols[:, :, j] * inv_d
    return out


def build_grid_plain(
    small: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
    uniform_alpha: bool = False,
) -> torch.Tensor:
    """The build kernel as tensor ops. The pooled image is padded by the blur
    radius first (edge cells under CLAMP, zero pixels under ZERO, which keep
    their range weight), then per level the seven fields (den r, g, b; num
    r, g, b, a) are blurred along H, then W, over the valid region."""
    r = (len(taps) - 1) // 2
    p = _pad2d(small, r, border)
    coef = float(np.float32(inv2sc * LOG2E))
    out = []
    for k in range(levels):
        dc = p[..., :3] - (lmin + step * float(k))
        wk = torch.exp2(-(dc * dc) * coef)
        nums = wk * p[..., :3]
        fields = torch.cat([wk, nums, wk[..., 1:2] * p[..., 3:]], -1)
        fields = _blur_valid(_blur_valid(fields, taps, 0), taps, 1)
        den = fields[..., :3].clamp_min(1e-20)
        alpha = torch.zeros_like(den[..., :1]) if uniform_alpha else fields[..., 6:] / den[..., 1:2]
        out.append(torch.cat([fields[..., 3:6] / den, alpha], -1).to(torch.bfloat16))
    return torch.stack(out)


def slice_grid_plain(
    guide: torch.Tensor,
    grid: torch.Tensor,
    lmin: torch.Tensor,
    inv_step: torch.Tensor,
    d: int,
    alpha_val: Optional[torch.Tensor] = None,
    slab: Optional[tuple[int, int, int]] = None,
) -> torch.Tensor:
    """The slice kernel as tensor ops: per level, the tent weight of each
    pixel's t_c times the bilinearly upsampled level, summed in level order.
    Alpha takes green's tent, or the constant alpha_val (uniform alpha).
    slab = (y_off, hs_all, gy_off): the kernel's slab form (slice_grid)."""
    h, w, _ = guide.shape
    levels = grid.shape[0]
    t = ((guide[..., :3] - lmin) * inv_step).clamp(0.0, levels - 1.0)
    t = torch.cat([t, t[..., 1:2]], -1)
    acc = torch.zeros((h, w, 4), dtype=torch.float32, device=guide.device)
    for k in range(levels):
        tent = (1.0 - (t - k).abs()).clamp_min(0.0)
        acc = acc + tent * _bilinear_up(grid[k].float(), d, h, w, slab)
    if alpha_val is not None:
        acc[..., 3] = alpha_val
    return acc


def build_guided_grid_plain(
    small_t: torch.Tensor,
    small_l: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
) -> torch.Tensor:
    """The guided build kernel as tensor ops: per level k and RGB channel c,
    w = exp2(-(l_c - lmin_c - k step_c)^2 inv2sc log2 e) from the pooled
    layer, then blur(w t_c) and blur(w) of the pooled target t, unnormalized,
    alpha's numerator under green's weights; blurred along H, then W, over
    the radius-padded pooled images (edge cells under CLAMP, zero pixels
    under ZERO, which keep their range weight). Returns (K, hs, ws, 8)
    bfloat16: num r, g, b, a, den r, g, b, and a zero pad."""
    r = (len(taps) - 1) // 2
    pt = _pad2d(small_t, r, border)
    pl = _pad2d(small_l, r, border)
    coef = float(np.float32(inv2sc * LOG2E))
    pad = torch.zeros_like(pt[..., :1])
    out = []
    for k in range(levels):
        dc = pl[..., :3] - (lmin + step * float(k))
        wk = torch.exp2(-(dc * dc) * coef)
        fields = torch.cat([wk * pt[..., :3], wk[..., 1:2] * pt[..., 3:], wk, pad], -1)
        out.append(_blur_valid(_blur_valid(fields, taps, 0), taps, 1).to(torch.bfloat16))
    return torch.stack(out)


def slice_guided_grid_plain(
    guide: torch.Tensor,
    grid: torch.Tensor,
    lmin: torch.Tensor,
    inv_step: torch.Tensor,
    d: int,
    slab: Optional[tuple[int, int, int]] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The guided slice kernel as tensor ops: t_c = clip((guide_c - lmin_c)
    inv_step_c, 0, K-1) from the full-resolution layer, and per level the
    tent weight of t times the bilinearly upsampled (edge-replicated) level,
    summed in level order; alpha's numerator rides green's t. Returns the
    partials (wc (H, W, 4), nw (H, W, 3)). slab: as slice_grid_plain's."""
    h, w, _ = guide.shape
    levels = grid.shape[0]
    t = ((guide[..., :3] - lmin) * inv_step).clamp(0.0, levels - 1.0)
    t = torch.cat([t, t[..., 1:2], t, t[..., :1]], -1)  # the pad plane's tent is unused
    acc = torch.zeros((h, w, GUIDED_PLANES), dtype=torch.float32, device=guide.device)
    for k in range(levels):
        tent = (1.0 - (t - k).abs()).clamp_min(0.0)
        acc = acc + tent * _bilinear_up(grid[k].float(), d, h, w, slab)
    return acc[..., :4].contiguous(), acc[..., 4:7].contiguous()


def fused_grid_plain(
    small: torch.Tensor,
    img: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    inv_step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
    d: int,
    alpha_val: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused bilateral kernel's plain version: the build, then the slice
    (the fused kernel keeps each cell's sums and each pixel's in their
    order). alpha_val given is uniform alpha."""
    grid = build_grid_plain(small, lmin, step, levels, taps, border, inv2sc, alpha_val is not None)
    return slice_grid_plain(img, grid, lmin, inv_step, d, alpha_val)


def fused_guided_plain(
    small_t: torch.Tensor,
    small_l: torch.Tensor,
    guide: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    inv_step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
    d: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused guided kernel's plain version: the guided build, then the
    guided slice (the fused kernel keeps each cell's sums in that order)."""
    grid = build_guided_grid_plain(small_t, small_l, lmin, step, levels, taps, border, inv2sc)
    return slice_guided_grid_plain(guide, grid, lmin, inv_step, d)


# ---------------------------------------------------------------------------
# The kernels' tiles and shared-memory layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BuildTile:
    """One block's geometry in the grid build kernel (fast.cu:
    build_grid_kernel). The block owns cells [y0, y0 + th) x [x0, x0 + tw)
    of every level and stages its n_images pooled images (the payload; with
    two, the guided grid's layer too) at cells (y0 - r + i, x0 - r + j), i <
    srows = th + 2r, j < scols = tw + 2r (r = the blur radius), under the
    build's border rule: cell (y, x)'s tap (a, b) of the blur reads staged
    (y - y0 + a, x - x0 + b). The block's dynamic shared memory
    (build_layout) holds the staged payload as float4 at byte 0, and from
    the byte offsets l_at, w_at and v_at the staged layer (float4; l_at = 0
    with one image, the payload being the layer), its three range-weight
    planes and the seven vertical-sum planes (th x scols floats each);
    shared_bytes in all."""

    th: int
    tw: int
    r: int
    n_images: int
    l_at: int
    w_at: int
    v_at: int
    shared_bytes: int

    @property
    def srows(self) -> int:
        return self.th + 2 * self.r

    @property
    def scols(self) -> int:
        return self.tw + 2 * self.r

    def launch_args(self) -> np.ndarray:
        """The ints idf_build_grid and idf_build_guided_grid take (fast.cu:
        BuildTile, then the bytes)."""
        return np.asarray([self.th, self.tw, self.l_at, self.w_at, self.v_at, self.shared_bytes],
                          np.int32)


def build_layout(th: int, tw: int, r: int, n_images: int) -> tuple[int, int, int, int]:
    """The grid build kernel's shared memory, in this order: the n_images
    staged pooled images, float4 each ((th + 2r) x (tw + 2r)); the range
    weights, three float planes of the staged window; the vertical sums,
    seven float planes of th x (tw + 2r). Returns (l_at, w_at, v_at, shared
    bytes), l_at = 0 with one image."""
    if n_images not in (1, 2):
        raise ValueError(f"the grid build stages 1 or 2 images, got {n_images}")
    n_staged = (th + 2 * r) * (tw + 2 * r)
    l_at = 16 * n_staged if n_images == 2 else 0
    w_at = 16 * n_staged * n_images
    v_at = w_at + 12 * n_staged
    return l_at, w_at, v_at, v_at + 4 * 7 * th * (tw + 2 * r)


def _odd_taps(n_taps: int, what: str) -> int:
    """The blur radius of n_taps, which must be odd and within the kernels'
    table."""
    if n_taps < 1 or n_taps % 2 == 0 or n_taps > MAX_TAPS:
        raise ValueError(f"{what} takes an odd number of blur taps up to {MAX_TAPS}, "
                         f"got {n_taps}")
    return n_taps // 2


@functools.lru_cache(maxsize=None)
def build_tile(n_taps: int, shared_limit: int, n_images: int) -> BuildTile:
    """The grid build kernel's tile for n_taps (odd) blur taps and n_images
    staged images (1: the bilateral grid, 2: the guided grid) on a card
    whose blocks may hold `shared_limit` bytes of shared memory: the first of
    BUILD_TILES whose window fits; ValueError where none fits."""
    r = _odd_taps(n_taps, "the grid build")
    for th, tw in BUILD_TILES:
        *offsets, nbytes = build_layout(th, tw, r, n_images)
        if nbytes <= shared_limit:
            return BuildTile(th, tw, r, n_images, *offsets, nbytes)
    raise ValueError(
        f"no grid build tile fits {n_taps} blur taps in {shared_limit} bytes of shared memory"
    )


def _kernel_info(fn: str, device: torch.device, shared_bytes: int, tile: str, *flags) -> dict:
    """The info function fn of the kernel library, which takes the instance's
    flags (the border's first), then the shared bytes."""
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = getattr(_build.library(), fn)(*map(int, flags), shared_bytes, info)
    _raise_on_error(rc, fn)
    return info_dict(info, tile, shared_bytes)


def build_grid_info(device: torch.device, n_taps: int, border: str, guided: bool = False) -> dict:
    """How the grid build kernel (the guided one with guided=True) runs with
    n_taps blur taps on `device`, as compiled: registers and spill (local)
    bytes a thread, its tile (th x tw cells) and shared bytes, and the blocks
    a multiprocessor holds at once (as ops.stencils.kernel_info gives them
    for the NLM kernels)."""
    tile = build_tile(n_taps, max_shared_bytes(device), 2 if guided else 1)
    fn = "idf_build_guided_grid_info" if guided else "idf_build_grid_info"
    return _kernel_info(fn, device, tile.shared_bytes, f"{tile.th}x{tile.tw}",
                        border != BorderPolicy.CLAMP)


@dataclasses.dataclass(frozen=True)
class BuildD1Tile:
    """One block's geometry in the grid build at d = 1 (fast.cu:
    build_grid_d1_kernel). The grid is cut into bands of tw cell columns and
    strips of rows = groups * BUILD_D1_ROWS cell rows (a work item: strip s
    of band b, item b * strips + s); the launcher starts as many blocks as
    the card holds at once, and each walks an equal run of items in order.
    Its ring of ring_rows = 2r + rows staged rows (r = the blur radius)
    holds staged row y - r + i (y the strip's first cell row, i < ring_rows)
    of the n_images pooled images at columns x0 - r + j, j < scols = tw +
    2r (x0 the band's first), under the build's border rule, in slot (y - r
    + i - (y0 - r)) % ring_rows, y0 the first strip the block walks in that
    band: cell (y, x)'s tap (a, b) reads staged row y - r + a, column x - x0
    + b.
    The vertical pass's thread (group g, staged column j) sums cell rows
    g * BUILD_D1_ROWS + i of the strip; a horizontal-pass thread
    BUILD_D1_CELLS cells of one row. The block's dynamic shared memory
    (build_d1_layout) holds the payload's ring as float4 at byte 0, and from
    the byte offsets l_at, v_at and t_at the layer's ring (l_at = 0 with one
    image, the payload being the layer), the seven vertical-sum planes
    (rows x vstride floats each) and the taps (BUILD_D1_TAP_SLOTS floats),
    and from o_at the guided strip's cells of one level (rows x tw, 16
    bytes a cell) on their way out (none for the bilateral grid, whose
    8-byte cells go straight out); shared_bytes in all."""

    tw: int
    groups: int
    r: int
    n_images: int
    l_at: int
    v_at: int
    o_at: int
    t_at: int
    shared_bytes: int

    @property
    def rows(self) -> int:
        return self.groups * BUILD_D1_ROWS

    @property
    def ring_rows(self) -> int:
        return 2 * self.r + self.rows

    @property
    def scols(self) -> int:
        return self.tw + 2 * self.r

    @property
    def vstride(self) -> int:
        """A vertical-sum row's floats: scols rounded up to a multiple of 4,
        so that each float4 load of the horizontal pass lies in its row."""
        return -(-self.scols // 4) * 4

    def blocks_per_sm(self, shared_limit: int) -> int:
        """Blocks a multiprocessor holds at once by shared memory, on a card
        whose blocks may hold shared_limit bytes (the opt-in limit)."""
        return (shared_limit + SHARED_BLOCK_RESERVE) // (self.shared_bytes + SHARED_BLOCK_RESERVE)

    def launch_args(self) -> np.ndarray:
        """The ints idf_build_grid_d1 and idf_build_guided_grid_d1 take
        (fast.cu: BuildD1Tile, then the bytes)."""
        return np.asarray([self.tw, self.groups, self.l_at, self.v_at, self.o_at, self.t_at,
                           self.shared_bytes], np.int32)


def build_d1_layout(tw: int, groups: int, r: int,
                    n_images: int) -> tuple[int, int, int, int, int]:
    """The d = 1 build kernel's shared memory, in this order, each region
    16-byte aligned: the n_images rings of 2r + groups * BUILD_D1_ROWS
    staged rows of tw + 2r float4 pixels; the vertical sums, seven float
    planes of the strip's rows x vstride; with two images the strip's
    cells (rows x tw, 16 bytes a cell); the taps. Returns (l_at, v_at,
    o_at, t_at, shared bytes), l_at = 0 and t_at = o_at with one image."""
    if n_images not in (1, 2):
        raise ValueError(f"the grid build stages 1 or 2 images, got {n_images}")
    rows = groups * BUILD_D1_ROWS
    ring = 16 * (2 * r + rows) * (tw + 2 * r)
    l_at = ring if n_images == 2 else 0
    v_at = ring * n_images
    o_at = v_at + 4 * 7 * rows * (-(-(tw + 2 * r) // 4) * 4)
    t_at = o_at + (16 * rows * tw if n_images == 2 else 0)
    return l_at, v_at, o_at, t_at, t_at + 4 * BUILD_D1_TAP_SLOTS


@functools.lru_cache(maxsize=None)
def build_d1_tile(n_taps: int, shared_limit: int, n_images: int) -> BuildD1Tile:
    """The d = 1 grid build kernel's tile for n_taps (odd) blur taps and
    n_images staged images (1: the bilateral grid, 2: the guided grid) on a
    card whose blocks may hold `shared_limit` bytes of shared memory: the
    first of BUILD_D1_TILES whose band holds a horizontal-pass thread's
    cells, whose vertical pass's threads (staged columns x groups) a block
    of BUILD_D1_THREADS holds and whose layout leaves two blocks a
    multiprocessor, else the first that leaves one; ValueError where none
    fits."""
    r = _odd_taps(n_taps, "the grid build")
    for blocks in (2, 1):
        for cols, groups in BUILD_D1_TILES:
            tw = (cols - 2 * r) // BUILD_D1_CELLS * BUILD_D1_CELLS
            if tw < BUILD_D1_CELLS or cols * groups > BUILD_D1_THREADS:
                continue
            *offsets, nbytes = build_d1_layout(tw, groups, r, n_images)
            tile = BuildD1Tile(tw, groups, r, n_images, *offsets, nbytes)
            if tile.blocks_per_sm(shared_limit) >= blocks:
                return tile
    raise ValueError(
        f"no d = 1 grid build tile fits {n_taps} blur taps in {shared_limit} bytes of shared "
        "memory"
    )


def build_d1_info(device: torch.device, n_taps: int, border: str, guided: bool = False) -> dict:
    """build_grid_info of the d = 1 build kernel: registers and spill bytes
    a thread, its tile (tw cell columns x the strip's rows) and shared
    bytes, and the blocks a multiprocessor holds at once."""
    tile = build_d1_tile(n_taps, max_shared_bytes(device), 2 if guided else 1)
    fn = "idf_build_guided_grid_d1_info" if guided else "idf_build_grid_d1_info"
    return _kernel_info(fn, device, tile.shared_bytes,
                        f"{tile.tw}x{tile.rows}", border != BorderPolicy.CLAMP)


@dataclasses.dataclass(frozen=True)
class FusedTile:
    """One block's geometry in the fused kernels (fast.cu:
    fused_guided_kernel, fused_grid_kernel) at downsample d with blur radius
    r and n_images staged pooled images (2: the guided kernel's target and
    layer; 1: the bilateral kernel's image, payload and layer at once). The
    block owns the slice tile of ph x pw pixels from (by ph, bx pw); thread i
    takes column i % pw and rows i // pw + k (FUSED_THREADS // pw), k = 0,
    1, ... inside the tile. Its pixels' bilinear taps read a window of at
    most rows x cols cells (tile_window), which the block builds at each
    level it touches from the pooled images staged over the window plus the
    blur halo r ((rows + 2r) x (cols + 2r) pixels at most). The dynamic shared memory (fused_layout)
    holds the staged payload as float4 at byte 0, and from l_at, w_at, v_at
    and c_at the staged layer (float4; l_at = 0 with one image), its three
    range-weight planes, the seven vertical-sum planes (rows x (cols + 2r)
    floats each) and a batch of levels' cells (fused_cells); shared_bytes in
    all."""

    d: int
    r: int
    n_images: int
    ph: int
    pw: int
    rows: int
    cols: int
    l_at: int
    w_at: int
    v_at: int
    c_at: int
    shared_bytes: int

    @property
    def srows(self) -> int:
        return self.rows + 2 * self.r

    @property
    def scols(self) -> int:
        return self.cols + 2 * self.r

    def launch_args(self) -> np.ndarray:
        """The ints idf_fused_grid and idf_fused_guided take (fast.cu:
        FusedTile, then the bytes)."""
        return np.asarray([self.ph, self.pw, self.rows, self.cols, self.l_at, self.w_at,
                           self.v_at, self.c_at, self.shared_bytes], np.int32)


def fused_window(ph: int, pw: int, d: int) -> tuple[int, int]:
    """The most cells (rows, columns) the bilinear taps of one ph x pw slice
    tile read at downsample d (d dividing both): pixel y reads cells
    floor((y + 0.5)/d - 0.5) and the next, so a tile from a multiple of d
    reads ph/d + 2 rows (ph + 1 at d = 1), columns alike."""
    halo = 1 if d == 1 else 2
    return ph // d + halo, pw // d + halo


def fused_cells(n_images: int) -> tuple[int, int]:
    """(bytes a cell, levels a batch) of the fused kernel with n_images
    staged images: the guided grid's 16-byte cells (pack_guided),
    FUSED_GUIDED_LEVELS of them; the bilateral grid's 8-byte normalized cells,
    FUSED_GRID_LEVELS."""
    return (16, FUSED_GUIDED_LEVELS) if n_images == 2 else (8, FUSED_GRID_LEVELS)


def fused_layout(ph: int, pw: int, d: int, r: int, n_images: int) -> tuple[int, ...]:
    """The fused kernels' shared memory, in this order: the n_images staged
    pooled images, float4 each over the window plus the halo; the range
    weights, three float planes of it; the vertical sums, seven float planes
    of rows x (cols + 2r); a batch of levels' cells (fused_cells), from a
    16-byte boundary. Returns (rows, cols, l_at, w_at, v_at, c_at, shared
    bytes), l_at = 0 with one image."""
    if n_images not in (1, 2):
        raise ValueError(f"the fused kernels stage 1 or 2 images, got {n_images}")
    rows, cols = fused_window(ph, pw, d)
    n_staged = (rows + 2 * r) * (cols + 2 * r)
    l_at = 16 * n_staged if n_images == 2 else 0
    w_at = 16 * n_staged * n_images
    v_at = w_at + 12 * n_staged
    c_at = -(-(v_at + 4 * 7 * rows * (cols + 2 * r)) // 16) * 16
    cell_bytes, levels = fused_cells(n_images)
    return rows, cols, l_at, w_at, v_at, c_at, c_at + cell_bytes * levels * rows * cols


def fused_tiles(d: int, n_images: int) -> tuple[tuple[int, int], ...]:
    """The slice tiles (ph, pw) the fused kernel with n_images staged images
    tries at downsample d, largest first: FUSED_GUIDED_TILES that d divides,
    or FUSED_GRID_TILES[d] (none at a d the bilateral grid does not take)."""
    if n_images == 2:
        return tuple(t for t in FUSED_GUIDED_TILES if d >= 1 and t[0] % d == 0 and t[1] % d == 0)
    return FUSED_GRID_TILES.get(d, ())


@functools.lru_cache(maxsize=None)
def fused_tile(d: int, n_taps: int, shared_limit: int, n_images: int) -> FusedTile:
    """The fused kernel's tile at downsample d with n_taps (odd) blur taps and
    n_images staged images (1: the bilateral grid, 2: the guided grid) on a
    card whose blocks may hold `shared_limit` bytes of shared memory: the
    first of fused_tiles(d, n_images) whose window fits beside
    STATIC_SHARED_RESERVE; ValueError where none does."""
    kind = "guided" if n_images == 2 else "grid"
    r = _odd_taps(n_taps, f"the fused {kind} kernel")
    for ph, pw in fused_tiles(d, n_images):
        layout = fused_layout(ph, pw, d, r, n_images)
        if layout[-1] + STATIC_SHARED_RESERVE <= shared_limit:
            return FusedTile(d, r, n_images, ph, pw, *layout)
    raise ValueError(
        f"no fused {kind} tile at d = {d} fits {n_taps} blur taps in {shared_limit} bytes of "
        "shared memory"
    )


def fused_guided_info(device: torch.device, d: int, n_taps: int, border: str) -> dict:
    """build_grid_info of the fused guided kernel at downsample d; its tile
    in pixels."""
    tile = fused_tile(d, n_taps, max_shared_bytes(device), 2)
    return _kernel_info("idf_fused_guided_info", device, tile.shared_bytes,
                        f"{tile.ph}x{tile.pw}", border != BorderPolicy.CLAMP)


def fused_grid_info(device: torch.device, d: int, n_taps: int, border: str,
                    uniform_alpha: bool = False) -> dict:
    """build_grid_info of the fused bilateral kernel at downsample d (its
    instance with uniform alpha when asked); its tile in pixels."""
    tile = fused_tile(d, n_taps, max_shared_bytes(device), 1)
    return _kernel_info("idf_fused_grid_info", device, tile.shared_bytes, f"{tile.ph}x{tile.pw}",
                        border != BorderPolicy.CLAMP, uniform_alpha)


# ---------------------------------------------------------------------------
# Checks, layouts and launches
# ---------------------------------------------------------------------------


def _check_downsample(d: int, allowed: tuple = DOWNSAMPLES) -> None:
    if d not in allowed:
        raise ValueError(f"the grid kernels take downsample d in {allowed}, got {d}")


def _check_taps(taps: np.ndarray) -> np.ndarray:
    taps = np.ascontiguousarray(taps, np.float32)
    if taps.ndim != 1 or taps.size % 2 == 0:
        raise ValueError(f"blur taps must be one odd-length row, got shape {taps.shape}")
    if taps.size > MAX_TAPS:
        raise ValueError(f"{taps.size} blur taps exceed the kernel's table of {MAX_TAPS}")
    return taps


def _check_range(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if tuple(t.shape) != (3,):
            raise ValueError(f"grid range tensors must be (3,), got {tuple(t.shape)}")


def _check_grid(grid: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if grid.dtype != torch.bfloat16:
        raise TypeError(f"the grid must be bfloat16, got {grid.dtype}")
    if grid.dim() != 4 or tuple(grid.shape[1:]) != shape:
        raise ValueError(f"grid must be (K, *{shape}), got {tuple(grid.shape)}")
    if grid.device != device:
        raise ValueError(f"grid on {grid.device}, image on {device}")
    if device.type == "cuda" and not grid.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors")


def check_slab(h: int, d: int, slab_rows: int, y_off: int, hs_all: Optional[int],
               gy_off: int) -> tuple[int, int, int]:
    """The slab form of the slice kernels: a band of h rows that starts at
    the image's row y_off (a multiple of d), sliced against slab_rows of the
    image's hs_all grid rows from grid row gy_off. hs_all None is the whole
    image (y_off = gy_off = 0, hs_all = slab_rows = ceil(h/d)). Raises unless
    the slab holds every grid row, clamped to [0, hs_all), that the band's
    bilinear taps read. Returns (y_off, hs_all, gy_off)."""
    if hs_all is None:
        if y_off or gy_off:
            raise ValueError("a band's y_off and gy_off need the image's grid rows hs_all")
        return 0, slab_rows, 0
    if y_off < 0 or y_off % d:
        raise ValueError(f"a band starts on a multiple of d={d}, got y_off={y_off}")
    f, _ = _bilinear_taps(d, h)
    first = int(np.clip(f[0] + y_off // d, 0, hs_all - 1))
    last = int(np.clip(f[-1] + 1 + y_off // d, 0, hs_all - 1))
    if first < gy_off or last >= gy_off + slab_rows:
        raise ValueError(
            f"grid rows [{gy_off}, {gy_off + slab_rows}) miss rows [{first}, {last}] that "
            f"the band at row {y_off} reads"
        )
    return y_off, hs_all, gy_off


def grid_to_planes(grid: torch.Tensor, uniform_alpha: bool) -> torch.Tensor:
    """(K, hs, ws, 4) -> the JAX package's level-major (nc*K, hs, ws) planes,
    nc = 3 under uniform alpha (fast.py:_build_grid_pallas's output)."""
    nc = 3 if uniform_alpha else 4
    levels, hs, ws, _ = grid.shape
    return grid[..., :nc].permute(0, 3, 1, 2).reshape(levels * nc, hs, ws)


def grid_from_planes(planes: torch.Tensor, uniform_alpha: bool) -> torch.Tensor:
    """The inverse of grid_to_planes; the alpha slot is zero under uniform
    alpha."""
    nc = 3 if uniform_alpha else 4
    _, hs, ws = planes.shape
    grid = planes.reshape(-1, nc, hs, ws).permute(0, 2, 3, 1)
    if uniform_alpha:
        grid = torch.cat([grid, grid.new_zeros(grid.shape[:3] + (1,))], -1)
    return grid.contiguous()


def pool(img: torch.Tensor, d: int, border: str = BorderPolicy.CLAMP) -> torch.Tensor:
    """d x d mean pool with bf16 operands (fast.py:_pool_pallas), the input
    padded to multiples of d by `border`. img: (H, W, 4) float32; returns
    (ceil(H/d), ceil(W/d), 4) float32. At d = 1 it is a bf16 round trip of
    every value."""
    _check_image(img, "img")
    _check_downsample(d)
    if not _on_cuda(img):
        return pool_plain(img, d, border)
    h, w, _ = img.shape
    out = torch.empty((-(-h // d), -(-w // d), 4), dtype=torch.float32, device=img.device)
    lib = _build.library()
    with torch.cuda.device(img.device):
        rc = lib.idf_pool(
            img.data_ptr(), out.data_ptr(), h, w, d,
            int(border != BorderPolicy.CLAMP), _stream(img),
        )
    _raise_on_error(rc, "pool")
    launches["pool"] += 1
    return out


def build_grid(
    small: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
    uniform_alpha: bool = False,
    *,
    d: int,
) -> torch.Tensor:
    """Per-channel bilateral grid of the pooled image (fast.py:
    _build_grid_pallas, legacy layout): small (hs, ws, 4) float32, the grid
    range lmin and step ((3,) float32, on small's device), K = levels,
    the odd blur taps, d the downsample small was pooled at. Returns the
    (K, hs, ws, 4) bfloat16 grid. On the card d = 1 launches the d = 1 body
    (build_grid_d1_kernel, counted as "build_grid_d1"), any other d
    build_grid_kernel: the same grid."""
    _check_image(small, "small")
    _check_downsample(d)
    _check_range(lmin, step)
    if levels < 2:
        raise ValueError(f"the grid needs at least 2 levels, got {levels}")
    taps = _check_taps(taps)
    if not _on_cuda(small, lmin, step):
        return build_grid_plain(small, lmin, step, levels, taps, border, inv2sc, uniform_alpha)
    hs, ws, _ = small.shape
    grid = torch.empty((levels, hs, ws, 4), dtype=torch.bfloat16, device=small.device)
    tile_fn, fn, name = ((build_d1_tile, "idf_build_grid_d1", "build_grid_d1") if d == 1
                         else (build_tile, "idf_build_grid", "build_grid"))
    geom = tile_fn(taps.size, max_shared_bytes(small.device), 1).launch_args()
    lib = _build.library()
    with torch.cuda.device(small.device):
        rc = getattr(lib, fn)(
            small.data_ptr(), lmin.data_ptr(), step.data_ptr(), grid.data_ptr(),
            hs, ws, levels, taps.ctypes.data, taps.size, inv2sc * LOG2E,
            int(border != BorderPolicy.CLAMP), int(uniform_alpha), geom.ctypes.data,
            _stream(small),
        )
    _raise_on_error(rc, name)
    launches[name] += 1
    return grid


def slice_grid(
    guide: torch.Tensor,
    grid: torch.Tensor,
    lmin: torch.Tensor,
    inv_step: torch.Tensor,
    d: int,
    alpha_val: Optional[torch.Tensor] = None,
    y_off: int = 0,
    hs_all: Optional[int] = None,
    gy_off: int = 0,
) -> torch.Tensor:
    """Slice the grid at full resolution (fast.py:_slice_grid_pallas with
    pad_edge=True): guide (H, W, 4) float32, whose RGB places each pixel
    between levels; grid (K, ceil(H/d), ceil(W/d), 4) bfloat16; lmin and
    inv_step (3,) float32. alpha_val (one float32) is the output alpha under
    uniform alpha; None slices the grid's alpha. Returns (H, W, 4) float32.
    With hs_all given, guide is a band of the image from row y_off and grid a
    slab of the image's hs_all grid rows from row gy_off (check_slab; the
    sharded turbo's slice, parallel/spatial.py:280-311 of the JAX package):
    the output equals the whole-image slice's rows of the band. On the card
    d = 1 launches slice_grid_d1_kernel, counted as "slice_grid_d1"."""
    _check_image(guide, "guide")
    _check_downsample(d)
    _check_range(lmin, inv_step)
    if alpha_val is not None and alpha_val.numel() != 1:
        raise ValueError(f"alpha_val must be one value, got {tuple(alpha_val.shape)}")
    alpha = () if alpha_val is None else (alpha_val,)
    on_cuda = _on_cuda(guide, lmin, inv_step, *alpha)
    h, w, _ = guide.shape
    hs = -(-h // d) if hs_all is None else grid.shape[1]
    ws = -(-w // d)
    _check_grid(grid, (hs, ws, 4), guide.device)
    slab = check_slab(h, d, hs, y_off, hs_all, gy_off)
    if not on_cuda:
        return slice_grid_plain(guide, grid, lmin, inv_step, d, alpha_val, slab)
    out = torch.empty_like(guide)
    lib = _build.library()
    with torch.cuda.device(guide.device):
        rc = lib.idf_slice_grid(
            guide.data_ptr(), grid.data_ptr(), lmin.data_ptr(), inv_step.data_ptr(),
            None if alpha_val is None else alpha_val.data_ptr(), out.data_ptr(),
            h, w, hs, ws, grid.shape[0], d, *slab, _stream(guide),
        )
    _raise_on_error(rc, "slice_grid")
    launches["slice_grid_d1" if d == 1 else "slice_grid"] += 1
    return out


def guided_grid_to_planes(grid: torch.Tensor) -> torch.Tensor:
    """(K, hs, ws, 8) -> the JAX package's (7K, hs, ws) planes, per level
    num r, g, b, a, den r, g, b (fast.py:_build_guided_grid_pallas's output)."""
    levels, hs, ws, _ = grid.shape
    return grid[..., :7].permute(0, 3, 1, 2).reshape(levels * 7, hs, ws)


def guided_grid_from_planes(planes: torch.Tensor) -> torch.Tensor:
    """The inverse of guided_grid_to_planes; the pad plane is zero."""
    _, hs, ws = planes.shape
    grid = planes.reshape(-1, 7, hs, ws).permute(0, 2, 3, 1)
    return torch.cat([grid, grid.new_zeros(grid.shape[:3] + (1,))], -1).contiguous()


def _check_guided_inputs(small_t, small_l, lmin, step, levels, taps):
    _check_image(small_t, "small_t")
    if small_l.shape != small_t.shape:
        raise ValueError(f"small_l {tuple(small_l.shape)} != small_t {tuple(small_t.shape)}")
    _check_range(lmin, step)
    if levels < 2:
        raise ValueError(f"the grid needs at least 2 levels, got {levels}")
    return _check_taps(taps)


def build_guided_grid(
    small_t: torch.Tensor,
    small_l: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
    *,
    d: int,
) -> torch.Tensor:
    """Unnormalized guided grid (fast.py:_build_guided_grid_pallas): range
    weights from the pooled layer small_l, payload from the pooled target
    small_t (both (hs, ws, 4) float32), the grid range lmin and step ((3,)
    float32, on their device), K = levels, the odd blur taps, d the
    downsample both were pooled at. Returns the (K, hs, ws, 8) bfloat16
    grid. On the card d = 1 launches the d = 1 body (counted as
    "build_guided_grid_d1"), any other d build_grid_kernel: the same grid."""
    taps = _check_guided_inputs(small_t, small_l, lmin, step, levels, taps)
    _check_downsample(d)
    if not _on_cuda(small_t, small_l, lmin, step):
        return build_guided_grid_plain(small_t, small_l, lmin, step, levels, taps, border, inv2sc)
    hs, ws, _ = small_t.shape
    grid = torch.empty((levels, hs, ws, GUIDED_PLANES), dtype=torch.bfloat16, device=small_t.device)
    tile_fn, fn, name = ((build_d1_tile, "idf_build_guided_grid_d1", "build_guided_grid_d1")
                         if d == 1 else (build_tile, "idf_build_guided_grid", "build_guided_grid"))
    geom = tile_fn(taps.size, max_shared_bytes(small_t.device), 2).launch_args()
    lib = _build.library()
    with torch.cuda.device(small_t.device):
        rc = getattr(lib, fn)(
            small_t.data_ptr(), small_l.data_ptr(), lmin.data_ptr(), step.data_ptr(),
            grid.data_ptr(), hs, ws, levels, taps.ctypes.data, taps.size, inv2sc * LOG2E,
            int(border != BorderPolicy.CLAMP), geom.ctypes.data, _stream(small_t),
        )
    _raise_on_error(rc, name)
    launches[name] += 1
    return grid


def slice_guided_grid(
    guide: torch.Tensor,
    grid: torch.Tensor,
    lmin: torch.Tensor,
    inv_step: torch.Tensor,
    d: int,
    y_off: int = 0,
    hs_all: Optional[int] = None,
    gy_off: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Slice the guided grid at full resolution (fast.py:
    _slice_guided_grid_pallas with pad_edge=True): guide (H, W, 4) float32,
    the full-resolution layer whose RGB places each pixel between levels;
    grid (K, ceil(H/d), ceil(W/d), 8) bfloat16; lmin and inv_step (3,)
    float32. Returns the partials (wc (H, W, 4), nw (H, W, 3)) float32.
    y_off, hs_all, gy_off: a band against a slab of grid rows, as
    slice_grid's. On the card a launch at d = 1 counts as
    "slice_guided_grid_d1"."""
    _check_image(guide, "guide")
    _check_downsample(d)
    _check_range(lmin, inv_step)
    on_cuda = _on_cuda(guide, lmin, inv_step)
    h, w, _ = guide.shape
    hs = -(-h // d) if hs_all is None else grid.shape[1]
    ws = -(-w // d)
    _check_grid(grid, (hs, ws, GUIDED_PLANES), guide.device)
    slab = check_slab(h, d, hs, y_off, hs_all, gy_off)
    if not on_cuda:
        return slice_guided_grid_plain(guide, grid, lmin, inv_step, d, slab)
    wc = torch.empty_like(guide)
    nw = torch.empty((h, w, 3), dtype=torch.float32, device=guide.device)
    lib = _build.library()
    with torch.cuda.device(guide.device):
        rc = lib.idf_slice_guided_grid(
            guide.data_ptr(), grid.data_ptr(), lmin.data_ptr(), inv_step.data_ptr(),
            wc.data_ptr(), nw.data_ptr(), h, w, hs, ws, grid.shape[0], d, *slab,
            _stream(guide),
        )
    _raise_on_error(rc, "slice_guided_grid")
    launches["slice_guided_grid_d1" if d == 1 else "slice_guided_grid"] += 1
    return wc, nw


def _fused_fits(d: int, n_taps: int, device: torch.device, n_images: int) -> bool:
    try:
        fused_tile(d, n_taps, max_shared_bytes(device), n_images)
    except ValueError:
        return False
    return True


def fused_guided_fits(d: int, n_taps: int, device: torch.device) -> bool:
    """Whether the fused guided kernel takes downsample d with n_taps blur
    taps on the CUDA device: some tile's window (fused_tile) fits a block's
    shared memory there."""
    return _fused_fits(d, n_taps, device, 2)


def fused_grid_fits(d: int, n_taps: int, device: torch.device) -> bool:
    """Whether the fused bilateral kernel takes downsample d with n_taps blur
    taps on the CUDA device: some tile's window (fused_tile, one staged
    pooled image) fits a block's shared memory there."""
    return _fused_fits(d, n_taps, device, 1)


def _fused_launch_args(d: int, n_taps: int, device: torch.device, n_images: int,
                       two_kernels: str) -> np.ndarray:
    """The fused kernel's tile as its launcher takes it; ValueError naming
    the two kernels to use where no tile fits."""
    try:
        return fused_tile(d, n_taps, max_shared_bytes(device), n_images).launch_args()
    except ValueError as e:
        kind = "guided" if n_images == 2 else "grid"
        raise ValueError(
            f"the fused {kind} kernel's window at d = {d} with {n_taps} blur taps exceeds a "
            f"block's shared memory on this device: use {two_kernels}"
        ) from e


def fused_grid(
    small: torch.Tensor,
    img: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    inv_step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
    d: int,
    alpha_val: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Bilateral grid build + slice per slice tile, the grid kept in shared
    memory (fast.py:_fused_grid_pipeline_planar): the inputs of build_grid
    and of slice_grid (img the slice's guide; alpha_val, one float32, is the
    output alpha under uniform alpha), the same (H, W, 4) float32 output.
    Each cell's sums keep the two kernels' order, so the output equals
    theirs. On the card the tile is fused_tile(d, ...); at the d of
    FUSED_GRID_RANGE_DOWNSAMPLES each tile builds only the levels its pixels
    touch."""
    _check_image(small, "small")
    _check_image(img, "img")
    _check_downsample(d, FUSED_GRID_DOWNSAMPLES)
    _check_range(lmin, step, inv_step)
    if levels < 2:
        raise ValueError(f"the grid needs at least 2 levels, got {levels}")
    taps = _check_taps(taps)
    h, w, _ = img.shape
    hs, ws = -(-h // d), -(-w // d)
    if tuple(small.shape) != (hs, ws, 4):
        raise ValueError(f"pooled image {tuple(small.shape)} != ({hs}, {ws}, 4) at d = {d}")
    if alpha_val is not None and alpha_val.numel() != 1:
        raise ValueError(f"alpha_val must be one value, got {tuple(alpha_val.shape)}")
    alpha = () if alpha_val is None else (alpha_val,)
    if not _on_cuda(small, img, lmin, step, inv_step, *alpha):
        return fused_grid_plain(
            small, img, lmin, step, inv_step, levels, taps, border, inv2sc, d, alpha_val
        )
    geom = _fused_launch_args(d, taps.size, img.device, 1, "build_grid and slice_grid")
    out = torch.empty_like(img)
    lib = _build.library()
    with torch.cuda.device(img.device):
        rc = lib.idf_fused_grid(
            small.data_ptr(), img.data_ptr(), lmin.data_ptr(), step.data_ptr(),
            inv_step.data_ptr(), None if alpha_val is None else alpha_val.data_ptr(),
            out.data_ptr(), h, w, hs, ws, levels, taps.ctypes.data, taps.size,
            inv2sc * LOG2E, d, int(border != BorderPolicy.CLAMP),
            int(d in FUSED_GRID_RANGE_DOWNSAMPLES), geom.ctypes.data, _stream(img),
        )
    _raise_on_error(rc, "fused_grid")
    launches["fused_grid"] += 1
    return out


def fused_guided(
    small_t: torch.Tensor,
    small_l: torch.Tensor,
    guide: torch.Tensor,
    lmin: torch.Tensor,
    step: torch.Tensor,
    inv_step: torch.Tensor,
    levels: int,
    taps: np.ndarray,
    border: str,
    inv2sc: float,
    d: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Guided build + slice per slice tile, the grid kept in shared memory
    (fast.py:_fused_guided_pipeline_planar): the inputs of build_guided_grid
    and of slice_guided_grid, the same partials out. Each cell's sums keep
    the two kernels' order, so the output equals theirs."""
    taps = _check_guided_inputs(small_t, small_l, lmin, step, levels, taps)
    _check_image(guide, "guide")
    _check_downsample(d)
    _check_range(inv_step)
    h, w, _ = guide.shape
    hs, ws = -(-h // d), -(-w // d)
    if tuple(small_t.shape) != (hs, ws, 4):
        raise ValueError(f"pooled images {tuple(small_t.shape)} != ({hs}, {ws}, 4) at d = {d}")
    if not _on_cuda(small_t, small_l, guide, lmin, step, inv_step):
        return fused_guided_plain(
            small_t, small_l, guide, lmin, step, inv_step, levels, taps, border, inv2sc, d
        )
    geom = _fused_launch_args(d, taps.size, guide.device, 2,
                              "the two guided kernels (build_guided_grid, slice_guided_grid)")
    wc = torch.empty_like(guide)
    nw = torch.empty((h, w, 3), dtype=torch.float32, device=guide.device)
    lib = _build.library()
    with torch.cuda.device(guide.device):
        rc = lib.idf_fused_guided(
            small_t.data_ptr(), small_l.data_ptr(), guide.data_ptr(), lmin.data_ptr(),
            step.data_ptr(), inv_step.data_ptr(), wc.data_ptr(), nw.data_ptr(), h, w, hs, ws,
            levels, taps.ctypes.data, taps.size, inv2sc * LOG2E, d,
            int(border != BorderPolicy.CLAMP), geom.ctypes.data, _stream(guide),
        )
    _raise_on_error(rc, "fused_guided")
    launches["fused_guided"] += 1
    return wc, nw


# ---------------------------------------------------------------------------
# Pipeline and public entry
# ---------------------------------------------------------------------------


def grid_range(small: torch.Tensor, levels: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The grid's intensity range from the pooled RGB (fast.py:412-414): lmin
    per channel and step = max(lmax - lmin, 1e-6) / (K - 1), both (3,) on
    small's device."""
    rgb = small[..., :3]
    lmin = rgb.amin((0, 1))
    return lmin, (rgb.amax((0, 1)) - lmin).clamp_min(1e-6) / (levels - 1)


def _pipeline(img, params, levels, d, pool_fn, grid_fn) -> torch.Tensor:
    small = pool_fn(img, d, params.border)
    lmin, step = grid_range(small, levels)
    return grid_fn(
        small, img, lmin, step, 1.0 / step, levels, _grid_taps(params.sigma_spatial, d),
        params.border, 0.5 / (params.sigma_color**2), d,
        img[0, 0, 3] if params.uniform_alpha else None,
    )


def _build_and_slice(small, img, lmin, step, inv_step, levels, taps, border, inv2sc, d,
                     alpha_val=None) -> torch.Tensor:
    """fused_grid's function through the build and the slice kernels."""
    grid = build_grid(small, lmin, step, levels, taps, border, inv2sc, alpha_val is not None, d=d)
    return slice_grid(img, grid, lmin, inv_step, d, alpha_val)


def default_fused(d: int) -> bool:
    """The reference's dispatch (fast.py:_default_fused): the build and the
    slice kernels at every d; the fused kernel only when asked for, and
    never at d = 1 (FUSED_GRID_DOWNSAMPLES)."""
    return False


def grid_pipeline(
    img: torch.Tensor,
    params: BilateralParams,
    levels: int,
    d: int,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Pool -> grid range -> build -> slice (fast.py:_grid_pipeline_planar
    with pad_free=False). The grid range stays on the device. Under uniform
    alpha the output alpha is img[0, 0, 3]. fused=True runs the build and
    the slice as the fused kernel (fused_grid; raises at d = 1 and on the
    card where its window does not fit), which gives the same output; None
    takes default_fused(d). At d = 1 this is the sharded turbo's pipeline
    (parallel/spatial.py:spatial_bilateral_fast) on one device."""
    if fused is None:
        fused = default_fused(d)
    return _pipeline(img, params, levels, d, pool, fused_grid if fused else _build_and_slice)


def grid_pipeline_plain(
    img: torch.Tensor, params: BilateralParams, levels: int, d: int
) -> torch.Tensor:
    """grid_pipeline through the plain versions, on any device."""
    return _pipeline(img, params, levels, d, pool_plain, fused_grid_plain)


def bilateral_fast(
    img: torch.Tensor,
    params: BilateralParams = BilateralParams(),
    levels: int = 6,
    downsample: int = 2,
) -> torch.Tensor:
    """Approximate bilateral filter, the per-channel bilateral grid
    (fast.py:bilateral_fast). img: (H, W, 4) float32; levels = K intensity
    levels; downsample = the grid's spatial reduction d. d in {2, 4, 8} runs
    the three kernels (their plain versions for a CPU tensor); d = 1 is the
    eager lattice, as the JAX package runs it with XLA on every backend on
    one device (on a mesh both packages run the kernels at d = 1:
    grid_pipeline(..., 1), parallel/spatial.py)."""
    _check_image(img, "img")
    d = max(1, downsample)
    if d == 1:
        return bilateral_fast_eager(img, params, levels, 1)
    return grid_pipeline(img, params, levels, d)


# ---------------------------------------------------------------------------
# The guided grid: turbo layers
# ---------------------------------------------------------------------------


def default_guided_fused(d: int) -> bool:
    """The reference's dispatch (fast.py:_default_guided_fused): the fused
    guided kernel at d = 2 and 4, the two guided kernels at d = 1 and 8."""
    return d in (2, 4)


def cross_bilateral_layers_fast(
    target: torch.Tensor,
    layer: torch.Tensor,
    params: LayersParams = LayersParams(),
    levels: int = 6,
    downsample: int = 2,
    fused: Optional[bool] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Turbo cross-bilateral partials for one layer (fast.py:
    cross_bilateral_layers_fast): (H, W, 4) target and layer -> (weightColor
    (H, W, 4), normWeight (H, W, 3)), the per-channel guided grid with range
    weights from the layer and payload from the target. Pool both, take the
    grid range from the pooled layer (it stays on the device), then the fused
    kernel or the guided build and slice. fused=None takes the fused kernel
    where default_guided_fused(d) does and, on the card, its window fits a
    block's shared memory (fused_guided_fits; on the H100 at d = 2 not from
    59 taps, sigma_s ~14.1, up), else the two kernels: the same partials
    either way.
    On a CPU tensor the plain versions run whichever is chosen. Accumulate the
    partials over all layers, then finish with normalize_layers_fast."""
    _check_image(target, "target")
    if layer.shape != target.shape:
        raise ValueError(f"layer {tuple(layer.shape)} != target {tuple(target.shape)}")
    d = max(1, downsample)
    taps = _grid_taps(params.sigma_spatial, d)
    if fused is None:
        fused = default_guided_fused(d) and (
            not _on_cuda(target, layer) or fused_guided_fits(d, taps.size, target.device)
        )
    small_t = pool(target, d, params.border)
    small_l = pool(layer, d, params.border)
    lmin, step = grid_range(small_l, levels)
    inv2sc = 0.5 / (params.sigma_color**2)
    if fused:
        return fused_guided(
            small_t, small_l, layer, lmin, step, 1.0 / step, levels, taps, params.border,
            inv2sc, d,
        )
    grid = build_guided_grid(small_t, small_l, lmin, step, levels, taps, params.border, inv2sc,
                             d=d)
    return slice_guided_grid(layer, grid, lmin, 1.0 / step, d)


def normalize_layers_fast(wc: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
    """The turbo layers' final divide (fast.py:normalize_layers_fast):
    out_c = wc_c / nw_c, alpha divided by green's norm, the magenta sentinel
    (1, 0, 1, 1) where green's norm is zero. Tensor ops, as the JAX package
    leaves it to XLA."""
    zero = nw[..., 1:2] == 0.0
    safe = torch.where(nw == 0.0, torch.ones_like(nw), nw)
    out = torch.cat([wc[..., :3] / safe, wc[..., 3:] / safe[..., 1:2]], -1)
    sentinel = torch.tensor([1.0, 0.0, 1.0, 1.0], dtype=torch.float32, device=wc.device)
    return torch.where(zero, sentinel, out)
