"""Spatial (row) sharding with halo exchange, and frame-level data parallelism.

Counterpart of image_denoising_filter_tpu/parallel/spatial.py on
`torch.distributed`. The image's H axis is split over the mesh's 'y' axis;
each rank holds one band of rows and needs `halo` rows of each neighbour's
band before it filters (the stencil analog of sequence parallelism). The
halo strips move between neighbours with `batch_isend_irecv` on the 'y'
group (JAX: `ppermute`); the outermost bands synthesise their missing halo
by the border policy (edge replication under CLAMP, zeros under ZERO). Each
rank then runs the single-device kernel on its halo-extended band and keeps
the centre, which equals filtering the whole image: the kernels' per-pixel
sums do not depend on where a pixel sits in the array.

Temporal NLM adds frame-level data parallelism: frames are split over the
'frame' axis, each rank accumulates the partials of its frames, and an
all-reduce SUM over 'frame' (JAX: `psum`) adds the (weightColor,
normWeight) accumulators.

Every function here is called by every rank of the mesh (they hold
collectives) and takes and returns the rank's LOCAL row band, where the JAX
functions take and return the global array under `shard_map`. `shard_rows`
cuts a rank's band out of a whole image and `gather_rows` puts the bands
back together.

The transport: NCCL moves device tensors directly. Gloo, which runs several
ranks on one card (NCCL refuses two ranks on one GPU), all-reduces and
all-gathers CUDA tensors itself, but its send and receive fail on them
(torch 2.11 on the H100: "writev ... Bad address"): there the halo strips
are staged through host memory (`_to_wire`), in both directions.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    NormalizeParams,
    TilingConfig,
)
from ..ops import eager, fast, stencils
from .mesh import FRAME_AXIS, SPATIAL_AXIS

# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------


def _host_staged(t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend() == "gloo"


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """What a send carries for t: t itself, or its host copy on gloo."""
    return t.contiguous().to("cpu") if _host_staged(t) else t.contiguous()


def _wire_buffer(like: torch.Tensor) -> torch.Tensor:
    device = "cpu" if _host_staged(like) else like.device
    return torch.empty(like.shape, dtype=like.dtype, device=device)


def _axis(mesh: DeviceMesh, axis: str) -> tuple[dist.ProcessGroup, int, int]:
    """(group, this rank's index along the axis, the axis size)."""
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def _all_reduce(t: torch.Tensor, op, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """All-reduce over one mesh axis (JAX: pmin/pmax/psum). Returns the
    result on t's device; an axis of one rank returns t."""
    group, _, n = _axis(mesh, axis)
    if n == 1:
        return t
    t = t.contiguous()
    dist.all_reduce(t, op, group=group)
    return t


def shard_rows(img: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's band of a whole image: rows [i * rows, (i + 1) * rows) of
    img's leading axis, i the rank's index along 'y' (JAX: the row block of
    P(SPATIAL_AXIS)). H must divide by the 'y' size."""
    _, idx, n = _axis(mesh, SPATIAL_AXIS)
    h = img.shape[0]
    if h % n:
        raise ValueError(f"{h} rows do not divide over {n} 'y' ranks; pad rows first")
    rows = h // n
    return img[idx * rows : (idx + 1) * rows]


def gather_rows(band: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole image from every rank's band, along the leading axis, on
    every rank of the 'y' group (an all-gather over 'y'); on band's device."""
    group, _, n = _axis(mesh, SPATIAL_AXIS)
    if n == 1:
        return band
    band = band.contiguous()
    parts = [torch.empty_like(band) for _ in range(n)]
    dist.all_gather(parts, band, group=group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _edge(band: torch.Tensor, halo: int, border: str, row_axis: int, top: bool) -> torch.Tensor:
    """The halo an outermost band synthesises: its first (top) or last row
    repeated under CLAMP, zeros under ZERO."""
    rows = band.shape[row_axis]
    if border == BorderPolicy.CLAMP:
        reps = [1] * band.dim()
        reps[row_axis] = halo
        return band.narrow(row_axis, 0 if top else rows - 1, 1).repeat(*reps)
    return torch.zeros_like(band.narrow(row_axis, 0, halo))


class _HaloExchange:
    """The halo strips of some bands in flight over 'y' (spatial.py:67-72 of
    the JAX package): band k's first `halo` rows go to the rank above and
    its last to the rank below, with tags 2k and 2k + 1. `wait(border)`
    returns each band's (top, bottom) halo, the outermost ranks' synthesised
    by the border policy."""

    def __init__(self, bands: Sequence[torch.Tensor], halo: int, mesh: DeviceMesh,
                 row_axis: int = 0) -> None:
        group, idx, n = _axis(mesh, SPATIAL_AXIS)
        for band in bands:
            if band.shape[row_axis] < halo:
                raise ValueError(
                    f"spatial band has {band.shape[row_axis]} rows but the stencil needs a "
                    f"{halo}-row halo; use fewer 'y' ranks or pad rows "
                    "(runtime.Session does this)"
                )
        self.bands, self.halo, self.row_axis = list(bands), halo, row_axis
        up = dist.get_global_rank(group, idx - 1) if idx > 0 else None
        down = dist.get_global_rank(group, idx + 1) if idx < n - 1 else None
        ops, self.above, self.below = [], [], []
        for k, band in enumerate(self.bands):
            rows = band.shape[row_axis]
            top = band.narrow(row_axis, 0, halo)
            bottom = band.narrow(row_axis, rows - halo, halo)
            above = below = None
            if up is not None:
                above = _wire_buffer(bottom)
                ops.append(dist.P2POp(dist.isend, _to_wire(top), up, group, 2 * k))
                ops.append(dist.P2POp(dist.irecv, above, up, group, 2 * k + 1))
            if down is not None:
                below = _wire_buffer(top)
                ops.append(dist.P2POp(dist.isend, _to_wire(bottom), down, group, 2 * k + 1))
                ops.append(dist.P2POp(dist.irecv, below, down, group, 2 * k))
            self.above.append(above)
            self.below.append(below)
        self._ops = ops  # the sent tensors stay alive until wait()
        self._reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait(self, border: str) -> list[tuple[torch.Tensor, torch.Tensor]]:
        for req in self._reqs:
            req.wait()
        self._ops = []
        halos = []
        for band, above, below in zip(self.bands, self.above, self.below):
            top = (_edge(band, self.halo, border, self.row_axis, True) if above is None
                   else above.to(band.device))
            bottom = (_edge(band, self.halo, border, self.row_axis, False) if below is None
                      else below.to(band.device))
            halos.append((top, bottom))
        return halos


def _extend(bands: Sequence[torch.Tensor], halo: int, border: str, mesh: DeviceMesh,
            row_axis: int = 0) -> list[torch.Tensor]:
    """Each band extended by `halo` rows on each side, in one exchange."""
    halos = _HaloExchange(bands, halo, mesh, row_axis).wait(border)
    return [torch.cat([top, band, bottom], row_axis)
            for band, (top, bottom) in zip(bands, halos)]


def _exchange_halo(local: torch.Tensor, halo: int, border: str, mesh: DeviceMesh,
                   row_axis: int = 0) -> torch.Tensor:
    """Extend a band with `halo` rows from each neighbour over 'y'
    (spatial.py:44-86 of the JAX package). local: this rank's rows, with the
    image's H axis at `row_axis` (0 for the channel-last (rows, W, C) layout,
    1 for planar (C, rows, W)). A band shorter than the halo raises."""
    return _extend([local], halo, border, mesh, row_axis)[0]


def _split_halo_compute(locals_: Sequence[torch.Tensor], halo: int, border: str,
                        mesh: DeviceMesh, fn: Callable) -> tuple[torch.Tensor, ...]:
    """Compute-communication overlap for a row-sharded stencil
    (spatial.py:93-155 of the JAX package): post the halo sends and receives,
    compute the band's interior (which needs local rows only) while they are
    in flight, wait, then compute the two edge strips of 3 * halo rows and
    stitch. locals_: (rows, W, ...) bands of equal height; fn maps a tuple of
    row-extended arrays to a tuple of outputs aligned with their rows.
    Returns the outputs' `rows` rows. Bands under 3 * halo rows, or one 'y'
    rank, take the blocking exchange."""
    rows = locals_[0].shape[0]
    _, _, n = _axis(mesh, SPATIAL_AXIS)
    if rows < 3 * halo or n == 1:
        outs = fn(tuple(_extend(locals_, halo, border, mesh)))
        return tuple(o[halo : halo + rows] for o in outs)
    pending = _HaloExchange(locals_, halo, mesh)
    # Interior: output rows [halo, rows - halo) need input rows [0, rows)
    # only; fn's own border handling reaches just its first and last halo
    # output rows, which are dropped.
    int_outs = fn(tuple(locals_))
    halos = pending.wait(border)
    # Top edge: output rows [0, halo) need input rows [-halo, 2 halo);
    # bottom edge: rows [rows - halo, rows) need [rows - 2 halo, rows + halo).
    top_outs = fn(tuple(torch.cat([a, x[: 2 * halo]]) for x, (a, _) in zip(locals_, halos)))
    bot_outs = fn(tuple(torch.cat([x[-2 * halo :], b]) for x, (_, b) in zip(locals_, halos)))
    return tuple(
        torch.cat([t[halo : 2 * halo], i[halo : rows - halo], b[halo : 2 * halo]])
        for t, i, b in zip(top_outs, int_outs, bot_outs)
    )


# ---------------------------------------------------------------------------
# The exact paths
# ---------------------------------------------------------------------------


def spatial_bilateral(
    local: torch.Tensor,
    params: BilateralParams = BilateralParams(),
    mesh: Optional[DeviceMesh] = None,
    tiling: Optional[TilingConfig] = None,
    linear: bool = False,
) -> torch.Tensor:
    """Bilateral filter of this rank's band (spatial.py:158-193): the kernel
    on the halo-extended band, the centre kept; the same output as the
    single-device kernel's rows. linear=True runs the linear layout
    (ops/eager.py) instead of the kernel."""
    halo = params.effective_radius  # what the kernel reads

    def fn(exts):
        (ext,) = exts
        if linear:
            return (eager.bilateral_eager(ext, params),)
        return (stencils.bilateral(ext, params, tiling),)

    (out,) = _split_halo_compute((local,), halo, params.border, mesh, fn)
    return out


def _check_hrw_lattice(params: NlmParams, rows: int, n_y: int) -> None:
    """Refuse a split that would shift the half-row pooling lattice
    (spatial.py:317-343): the half-row kernel pools row pairs of the array
    it is given, from its first row, so every band's halo-extended block must
    start on an even row of the image. Bands start at i * rows - halo: all
    are even iff rows and the halo (s + p) both are. The reference
    parameters (s=7, p=3: halo 10) pass for any even band height."""
    if not params.weights_halfres or n_y <= 1:
        return
    halo = params.search_radius + params.patch_radius
    if rows % 2 != 0 or halo % 2 != 0:
        raise ValueError(
            "weights_halfres sharding needs every shard to start on the "
            f"even-row pooling lattice: rows/shard={rows} and halo "
            f"(search_radius+patch_radius)={halo} must both be even, or the "
            "per-shard lattice silently shifts vs single-device. Use an "
            "even row partition or weights_halfres=False."
        )


def spatial_nlm_accumulate(
    target: torch.Tensor,
    neighbour: torch.Tensor,
    params: NlmParams = NlmParams(),
    mesh: Optional[DeviceMesh] = None,
    tiling: Optional[TilingConfig] = None,
    linear: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's NLM partials of this rank's band (spatial.py:346-374):
    (weightColor (rows, W, 4), normWeight (rows, W))."""
    halo = params.search_radius + params.patch_radius
    _check_hrw_lattice(params, target.shape[0], _axis(mesh, SPATIAL_AXIS)[2])

    def fn(exts):
        if linear:
            return eager.nlm_eager(exts[0], exts[1], params)
        return stencils.nlm_accumulate(exts[0], exts[1], params, tiling)

    return _split_halo_compute((target, neighbour), halo, params.border, mesh, fn)


def spatial_cross_bilateral_layers(
    target: torch.Tensor,
    layer: torch.Tensor,
    params: LayersParams = LayersParams(),
    mesh: Optional[DeviceMesh] = None,
    tiling: Optional[TilingConfig] = None,
    linear: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross-bilateral partials of this rank's band
    (spatial.py:377-405): (weightColor (rows, W, 4), normWeight (rows, W))."""
    halo = params.effective_radius

    def fn(exts):
        if linear:
            return eager.cross_bilateral_layers_eager(exts[0], exts[1], params)
        return stencils.cross_bilateral_layers(exts[0], exts[1], params, tiling)

    return _split_halo_compute((target, layer), halo, params.border, mesh, fn)


def temporal_nlm_local_partials(
    target: torch.Tensor,
    frames: torch.Tensor,
    params: NlmParams = NlmParams(),
    mesh: Optional[DeviceMesh] = None,
    tiling: Optional[TilingConfig] = None,
    valid: Optional[torch.Tensor] = None,
    linear: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The NLM partials of this rank's frames over its band, before the sum
    over 'frame' (spatial.py:436-479). target: (rows, W, 4); frames: (F, rows,
    W, 4), this rank's frames; valid ((F,) float 0/1) masks padding frames,
    norm seed included. The kernel form makes one frame-batched launch over
    the halo-extended frames; the linear form loops over the frames through
    ops/eager.py, each frame's halo exchanged inside the loop."""
    halo = params.search_radius + params.patch_radius
    rows = target.shape[0]
    _check_hrw_lattice(params, rows, _axis(mesh, SPATIAL_AXIS)[2])
    if valid is None:
        valid = torch.ones((frames.shape[0],), dtype=torch.float32, device=target.device)
    t_ext = _exchange_halo(target, halo, params.border, mesh)
    if linear:
        wc = torch.zeros((rows + 2 * halo,) + target.shape[1:], dtype=torch.float32,
                         device=target.device)
        nw = torch.zeros(wc.shape[:2], dtype=torch.float32, device=target.device)
        for frame, v in zip(frames, valid):
            f_ext = _exchange_halo(frame, halo, params.border, mesh)
            pwc, pnw = eager.nlm_eager(t_ext, f_ext, params)
            wc = wc + pwc * v
            nw = nw + pnw * v
    else:
        f_ext = torch.stack(_extend(list(frames), halo, params.border, mesh))
        wc, nw = stencils.nlm_accumulate_frames(t_ext, f_ext, params, tiling, valid)
    return wc[halo : halo + rows].contiguous(), nw[halo : halo + rows].contiguous()


def temporal_nlm_sharded_partials(
    target: torch.Tensor,
    frames: torch.Tensor,
    params: NlmParams = NlmParams(),
    mesh: Optional[DeviceMesh] = None,
    tiling: Optional[TilingConfig] = None,
    valid: Optional[torch.Tensor] = None,
    linear: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weight partials of multi-device temporal NLM over one frame batch
    (spatial.py:408-483): frames split over 'frame', rows over 'y', partials
    summed over 'frame'. Returns this band's (wc (rows, W, 4), nw (rows, W));
    sum them over batches and normalize to finish. Each frame adds its norm
    seed once, in the kernel of the rank that holds it, and the sum adds the
    seeds up: F seeds in all, as in the sequential loop."""
    wc, nw = temporal_nlm_local_partials(target, frames, params, mesh, tiling, valid, linear)
    return (_all_reduce(wc, dist.ReduceOp.SUM, mesh, FRAME_AXIS),
            _all_reduce(nw, dist.ReduceOp.SUM, mesh, FRAME_AXIS))


def temporal_nlm_sharded(
    target: torch.Tensor,
    frames: torch.Tensor,
    params: NlmParams = NlmParams(),
    norm_params: NormalizeParams = NormalizeParams(),
    mesh: Optional[DeviceMesh] = None,
    tiling: Optional[TilingConfig] = None,
    valid: Optional[torch.Tensor] = None,
    linear: bool = False,
) -> torch.Tensor:
    """Multi-device temporal NLM in one call (spatial.py:486-508): the
    partials of this rank's frames over its band, summed over 'frame', then
    normalised with the normalize kernel (pointwise, so its band is the
    whole image's rows; the linear layout divides with tensor ops). For the
    streamed form over long frame sequences see Session._run_sharded_temporal."""
    wc, nw = temporal_nlm_sharded_partials(target, frames, params, mesh, tiling, valid, linear)
    if linear:
        return eager.normalize_eager(wc, nw, norm_params)
    return stencils.normalize(wc, nw, norm_params)


# ---------------------------------------------------------------------------
# The turbo paths: the grids, sliced against a slab
# ---------------------------------------------------------------------------


def _grid_geometry(rows: int, d: int, sigma_spatial: float, what: str):
    if rows % d:
        raise ValueError(
            f"sharded turbo {what} needs band rows ({rows}) divisible by the downsample "
            f"{d}; pad rows first (runtime.Session does)"
        )
    taps = fast._grid_taps(sigma_spatial, d)
    return taps, (taps.size - 1) // 2 + 1  # halo: grid rows [-1, rows_s+1) need rg+1 more


def _grid_range(small: torch.Tensor, levels: int, mesh: DeviceMesh):
    """The grid range over the whole pooled image: this band's extrema
    reduced over 'y' (min of the mins and of the negated maxes, which is
    exact), then fast.grid_range's step formula. On a finite image pooling
    partitions the rows exactly, so the range equals the single-device one
    bit for bit. A band whose channel holds a NaN has a NaN extremum there,
    which the JAX package's pmin/pmax drop wherever it sits (XLA on the CPU
    takes the other bands' extremum; a channel NaN in every band gives
    +inf / -inf, the identities, and the least step). gloo's MIN keeps or
    drops a NaN by the rank that holds it, so each band sends the identity,
    +inf, in its place. One device (or one 'y' rank) keeps the NaN range,
    as fast.grid_range does."""
    rgb = small[..., :3]
    ext = torch.cat([rgb.amin((0, 1)), -rgb.amax((0, 1))])
    if _axis(mesh, SPATIAL_AXIS)[2] > 1:
        ext = torch.where(ext.isnan(), float("inf"), ext)
    ext = _all_reduce(ext, dist.ReduceOp.MIN, mesh, SPATIAL_AXIS)
    lmin, lmax = ext[:3], -ext[3:]
    return lmin, (lmax - lmin).clamp_min(1e-6) / (levels - 1)


def _slab(grid_ext: torch.Tensor, halo_s: int, rows_s: int) -> torch.Tensor:
    """Grid rows [-1, rows_s + 1) of the band, from the grid built on the
    pooled band extended by halo_s rows."""
    return grid_ext[:, halo_s - 1 : halo_s + rows_s + 1].contiguous()


def spatial_bilateral_fast(
    local: torch.Tensor,
    params: BilateralParams = BilateralParams(),
    mesh: Optional[DeviceMesh] = None,
    levels: int = 6,
    downsample: int = 2,
) -> torch.Tensor:
    """Turbo bilateral grid of this rank's band (spatial.py:196-314): pool
    the band (its rows divide by d), take the grid range over the whole
    image (a MIN all-reduce over 'y'), extend the pooled band by rg + 1
    pooled rows of each neighbour, so that the grid cells next to a seam blur
    over real cells as the single-device build does, build the grid on it,
    and slice the band against a slab of rows_s + 2 grid rows, one real row
    from each neighbour (fast.slice_grid's slab form, which clamps to the
    image's grid rows: the outermost bands read the edge rows as the
    single-device slice does). Build + slice, never the fused kernel: the
    seam needs the grid. The output equals the single-device pipeline's rows
    on the same (row-padded) image bit for bit (fast.grid_pipeline, which at
    d = 1 is not what fast.bilateral_fast runs: one device takes the eager
    lattice there). d in (1, 2, 4, 8)."""
    rows = local.shape[0]
    d = max(1, downsample)
    fast._check_downsample(d)
    taps, halo_s = _grid_geometry(rows, d, params.sigma_spatial, "bilateral")
    _, idx, n = _axis(mesh, SPATIAL_AXIS)
    rows_s = rows // d
    small = fast.pool(local, d, params.border)
    lmin, step = _grid_range(small, levels, mesh)
    small_ext = _exchange_halo(small, halo_s, params.border, mesh)
    grid = fast.build_grid(small_ext, lmin, step, levels, taps, params.border,
                           0.5 / (params.sigma_color**2), params.uniform_alpha, d=d)
    return fast.slice_grid(
        local, _slab(grid, halo_s, rows_s), lmin, 1.0 / step, d,
        local[0, 0, 3] if params.uniform_alpha else None,
        y_off=idx * rows, hs_all=n * rows_s, gy_off=idx * rows_s - 1,
    )


def spatial_cross_bilateral_layers_fast(
    target: torch.Tensor,
    layer: torch.Tensor,
    params: Optional[LayersParams] = None,
    mesh: Optional[DeviceMesh] = None,
    levels: int = 6,
    downsample: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Turbo layer-guided partials of this rank's band (spatial.py:511-613):
    the seam construction of spatial_bilateral_fast for the guided grid,
    weights from the layer and payload from the target, through the guided
    build and slice kernels. Returns (weightColor (rows, W, 4), normWeight
    (rows, W, 3)); accumulate over layers and finish with
    ops.fast.normalize_layers_fast. d in (1, 2, 4, 8)."""
    if params is None:
        params = LayersParams()
    rows = target.shape[0]
    d = max(1, downsample)
    fast._check_downsample(d)
    taps, halo_s = _grid_geometry(rows, d, params.sigma_spatial, "layers")
    _, idx, n = _axis(mesh, SPATIAL_AXIS)
    rows_s = rows // d
    small_t = fast.pool(target, d, params.border)
    small_l = fast.pool(layer, d, params.border)
    lmin, step = _grid_range(small_l, levels, mesh)
    small_t_ext, small_l_ext = _extend([small_t, small_l], halo_s, params.border, mesh)
    grid = fast.build_guided_grid(small_t_ext, small_l_ext, lmin, step, levels, taps,
                                  params.border, 0.5 / (params.sigma_color**2), d=d)
    return fast.slice_guided_grid(
        layer, _slab(grid, halo_s, rows_s), lmin, 1.0 / step, d,
        y_off=idx * rows, hs_all=n * rows_s, gy_off=idx * rows_s - 1,
    )
