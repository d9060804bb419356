"""Whole-image PyTorch versions of the device stencils: the linear-layout
config, and the turbo grid's lattice path.

Counterpart of image_denoising_filter_tpu/ops/xla.py, the analog of the
reference's *linear texel-buffer* variant (shaders/bialteral_linear.comp):
the same math as the hand-written kernels, written as whole-image tensor ops
that re-read the image for every tap. In the JAX package this is plain XLA,
not Pallas, so here it stays tensor ops on the device; it is the linear
config itself, not the kernels' plain versions (those live beside the
kernels in ops/stencils.py and ops/fast.py).

`bilateral_fast_eager` is the XLA lattice of
image_denoising_filter_tpu/ops/fast.py:bilateral_fast_planar (219-271): the
turbo bilateral grid without Pallas, which the JAX package runs at every
downsample off the TPU and at downsample 1 on it.

All functions take and return (H, W, 4) float32 tensors and run on whatever
device their inputs are on. Accumulators are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    NormalizeParams,
)


def _pad2d(img: torch.Tensor, r: int, border: str) -> torch.Tensor:
    """Pad the leading (H, W) axes by r: edge pixels under CLAMP, zeros
    otherwise (xla.py:_pad2d)."""
    if r == 0:
        return img
    return _pad_dim(_pad_dim(img, r, 0, border), r, 1, border)


def _pad_to(img: torch.Tensor, hp: int, wp: int, border: str) -> torch.Tensor:
    """Pad the leading (H, W) axes at the bottom and right up to (hp, wp):
    edge pixels under CLAMP, zeros otherwise (the jnp.pad of fast.py:404-406)."""
    h, w = img.shape[:2]
    if (hp, wp) == (h, w):
        return img
    if border == BorderPolicy.CLAMP:
        ys = torch.arange(hp, device=img.device).clamp_(max=h - 1)
        xs = torch.arange(wp, device=img.device).clamp_(max=w - 1)
        return img[ys][:, xs]
    return F.pad(img, (0, 0, 0, wp - w, 0, hp - h))


def _pad_dim(x: torch.Tensor, r: int, dim: int, border: str) -> torch.Tensor:
    """Pad axis `dim` by r on both sides: edge values under CLAMP, zeros
    otherwise."""
    n = x.shape[dim]
    if border == BorderPolicy.CLAMP:
        return x.index_select(dim, torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1))
    shape = list(x.shape)
    shape[dim] = r
    zeros = x.new_zeros(shape)
    return torch.cat([zeros, x, zeros], dim)


def _blur_valid(x: torch.Tensor, taps: np.ndarray, dim: int) -> torch.Tensor:
    """sum_i taps[i] * x[i : i + n] along `dim` (n = size - len(taps) + 1),
    accumulated in tap order, as fast.py:_sep_blur and the build kernel add."""
    n = x.shape[dim] - len(taps) + 1
    out = float(taps[0]) * x.narrow(dim, 0, n)
    for i in range(1, len(taps)):
        out = out + float(taps[i]) * x.narrow(dim, i, n)
    return out


def _mean_pool(x: torch.Tensor, d: int) -> torch.Tensor:
    """d x d mean of (H, W, C), H and W multiples of d: strided row sums,
    then strided column sums, then 1/d^2 (fast.py:_downsample), in float32."""
    rows = x[0::d]
    for i in range(1, d):
        rows = rows + x[i::d]
    out = rows[:, 0::d]
    for j in range(1, d):
        out = out + rows[:, j::d]
    return out * (1.0 / (d * d))


def _box_sum(e: torch.Tensor, k: int, out_h: int, out_w: int) -> torch.Tensor:
    """Valid k x k window sums of a 2D tensor: out[y, x] = sum of
    e[y:y+k, x:x+k], as shifted-slice adds (rows, then columns), so no
    convolution and no cumulative sum enters the arithmetic."""
    rows = e[0:out_h]
    for j in range(1, k):
        rows = rows + e[j : j + out_h]
    return _box_lanes(rows, k, out_w)


def _box_lanes(e: torch.Tensor, k: int, out_w: int) -> torch.Tensor:
    """Valid sums of k neighbouring columns: out[:, x] = sum of e[:, x:x+k],
    added left to right."""
    out = e[:, 0:out_w]
    for j in range(1, k):
        out = out + e[:, j : j + out_w]
    return out


def _bilateral_window(
    values: torch.Tensor, wsrc: torch.Tensor, params: BilateralParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Square-window accumulation shared by the plain and the layer-guided
    bilateral: weights from `wsrc`, values from `values`."""
    values = values.to(torch.float32)
    wsrc = wsrc.to(torch.float32)
    h, w, _ = values.shape
    r = params.effective_radius  # spatial-weight truncation (config.py)
    padded_v = _pad2d(values, r, params.border)
    padded_g = padded_v if wsrc is values else _pad2d(wsrc, r, params.border)
    inv2sc = float(np.float32(0.5 / (params.sigma_color**2)))
    center = wsrc[..., :3]
    nrgb = 2 if params.blue_bug else 3  # blue_bug: blue never contributes
    nch = 3 if params.uniform_alpha else 4
    wc = torch.zeros((h, w, nch), dtype=torch.float32, device=values.device)
    nw = torch.zeros((h, w), dtype=torch.float32, device=values.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            lsw = float(np.float32(-0.5 * (dy * dy + dx * dx) / params.sigma_spatial**2))
            tap_g = padded_g[dy + r : dy + r + h, dx + r : dx + r + w]
            tap_v = padded_v[dy + r : dy + r + h, dx + r : dx + r + w]
            d = center[..., :nrgb] - tap_g[..., :nrgb]
            wgt = torch.exp(lsw - (d * d).sum(-1) * inv2sc)
            wc += tap_v[..., :nch] * wgt[..., None]
            nw += wgt
    if params.uniform_alpha:
        wc = torch.cat([wc, values[..., 3:] * nw[..., None]], dim=-1)
    return wc, nw


def bilateral_eager(img: torch.Tensor, params: BilateralParams) -> torch.Tensor:
    """Bilateral filter (xla.py:bilateral_xla; shaders/bialteral_linear.comp)."""
    wc, nw = _bilateral_window(img, img, params)
    return wc / nw[..., None]


def cross_bilateral_layers_eager(
    target: torch.Tensor, layer: torch.Tensor, params: LayersParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer's cross-bilateral partials (xla.py:cross_bilateral_layers_xla;
    shaders/bialteral_layers.comp:27-66): weights from `layer`, colours from
    `target`. Returns (weightColor (H,W,4), normWeight (H,W))."""
    return _bilateral_window(target, layer, params)


def _sq_diff_bf16(t: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Per-pixel RGB squared difference of two bf16 (..., 3) tensors with a
    bf16 rounding after every operation, in the order d0*d0 + d1*d1 + d2*d2
    (stencils.py:560-563 with cdtype bfloat16), widened to float32."""
    d = t - n
    e = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    return (e + d[..., 2] * d[..., 2]).float()


# The half-row weight field's SSD scale: 3 x 2p half cells stand in for the
# 2p x 2p full box (stencils.py:NLM_HRW_KAPPA).
NLM_HRW_KAPPA = 2.0


def _pool_rows_bf16(x: torch.Tensor) -> torch.Tensor:
    """Half-row cells of rows (2i, 2i+1) as the turbo NLM's half-row kernel
    pools them (stencils.py:727-742): bf16(0.5 * (bf16(a) + bf16(b))), the
    sum in float32."""
    x = x.to(torch.bfloat16).float()
    return (0.5 * (x[0::2] + x[1::2])).to(torch.bfloat16)


def _weights_bf16(wh: torch.Tensor) -> torch.Tensor:
    """The half-row weight cells rounded to bf16 before the row upsample
    (stencils.py:786-788, wh.astype(vup.dtype)), widened to float32."""
    return wh.to(torch.bfloat16).float()


def _upsample_rows2(c: torch.Tensor, h: int) -> torch.Tensor:
    """x2 bilinear row upsample of half-row cells with half-pixel centres:
    c holds cells [-1, hc+1); w(2i) = 0.25 c(i-1) + 0.75 c(i), w(2i+1) =
    0.75 c(i) + 0.25 c(i+1), rows [0, h)."""
    even = 0.25 * c[:-2] + 0.75 * c[1:-1]
    odd = 0.75 * c[1:-1] + 0.25 * c[2:]
    return torch.stack([even, odd], 1).reshape(-1, *c.shape[1:])[:h]


def check_hrw_params(params: NlmParams) -> None:
    """The half-row weights take search stride 2 (even row offsets land on
    the half-row lattice) and patch radius 3 (its 6-row box is the 3-cell
    one), as both JAX lowerings require."""
    if params.search_stride != 2 or params.patch_radius != 3:
        raise ValueError("weights_halfres requires search_stride=2 and patch_radius=3")


def _nlm_hrw_weights(
    target: torch.Tensor, neighbour: torch.Tensor, params: NlmParams, bf16: bool
):
    """Per candidate (dy, dx), the half-row-resolution weight field at full
    resolution (xla.py:nlm_xla's halfres branch, 162-226; stencils.py:
    _nlm_hrw_kernel). Weight cells sit on the absolute half-row lattice,
    cell ih <-> rows (2ih, 2ih+1), rows past the image padded by the border
    policy. The squared difference of the pooled RGB is boxed over 3 half
    rows, then 2p lanes, scaled by kappa; the weight exp(-kappa ssd / h^2)
    is upsampled x2 along rows; non-self candidates get stride^2. With bf16
    the pooled planes, the squared difference and the weight cells round
    where the TPU kernel rounds them. Yields (dy, dx, weights (H, W))."""
    check_hrw_params(params)
    from .stencils import nlm_candidates

    h, w, _ = target.shape
    s, p = params.search_radius, params.patch_radius
    halo = s + p
    hc = (h + 1) // 2
    # rp rows above (even, so the lattice stays on absolute even rows) reach
    # the neighbour's cells from -2 + dy/2 >= -2 - s/2; below, up to row
    # 2 hc + rp covers cells up to hc + 2 + dy/2 < hc + rp/2.
    rp = 2 * ((s + 5) // 2)
    rows = torch.arange(-rp, 2 * hc + rp, device=target.device)

    def pooled(img):
        x = _pad_dim(img[..., :3], halo, 1, params.border)
        if params.border == BorderPolicy.CLAMP:
            x = x[rows.clamp(0, h - 1)]
        else:
            x = F.pad(x, (0, 0, 0, 0, rp, rp + 2 * hc - h))
        if bf16:
            return _pool_rows_bf16(x)
        return 0.5 * (x[0::2] + x[1::2])

    c0 = rp // 2  # cell ih is pooled row ih + c0
    ew = w + 2 * p - 1  # lanes x' in [-p, w + p - 1)
    t_he = pooled(target)[c0 - 2 : c0 + hc + 2, halo - p : halo - p + ew]
    n_half = pooled(neighbour)
    inv_h2 = float(np.float32(1.0 / (params.h**2)))
    for dy, dx in nlm_candidates(params):
        r0 = c0 - 2 + dy // 2
        n_he = n_half[r0 : r0 + hc + 4, dx + s : dx + s + ew]
        if bf16:
            e = _sq_diff_bf16(t_he, n_he)
        else:
            d = t_he - n_he
            e = (d * d).sum(-1)
        e3 = e[:-2] + e[1:-1] + e[2:]  # cells [-1, hc + 1)
        ssd = _box_lanes(e3, 2 * p, w)
        wh = torch.exp(-(NLM_HRW_KAPPA * ssd) * inv_h2)
        if bf16:
            wh = _weights_bf16(wh)
        wgt = _upsample_rows2(wh, h)
        if (dy, dx) != (0, 0):
            wgt = wgt * float(params.search_stride**2)  # importance compensation
        yield dy, dx, wgt


def nlm_eager(
    target: torch.Tensor,
    neighbour: torch.Tensor,
    params: NlmParams,
    compute_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's NLM partials (xla.py:nlm_xla; shaders/nonlocal.comp:30-65),
    exact or with the strided and disk candidate subsets, and with the
    weights at half row resolution (params.weights_halfres). normWeight is
    seeded with params.norm_seed. compute_dtype "bfloat16" computes the
    squared differences with bf16 taps, as the turbo NLM kernels do; the
    patch sums, weights and accumulators stay float32."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")
    bf16 = compute_dtype == "bfloat16"
    target = target.to(torch.float32)
    neighbour = neighbour.to(torch.float32)
    h, w, _ = target.shape
    s, p = params.search_radius, params.patch_radius
    halo = s + p
    pn = _pad2d(neighbour, halo, params.border)
    nch = 3 if params.uniform_alpha else 4
    wc = torch.zeros((h, w, nch), dtype=torch.float32, device=target.device)
    nw = torch.full((h, w), params.norm_seed, dtype=torch.float32, device=target.device)
    if params.weights_halfres:
        weights = _nlm_hrw_weights(target, neighbour, params, bf16)
    else:
        weights = _nlm_full_weights(target, pn, params, bf16)
    for dy, dx, wgt in weights:
        oy, ox = dy + s, dx + s
        tap = pn[oy + p : oy + p + h, ox + p : ox + p + w]
        wc += tap[..., :nch] * wgt[..., None]
        nw += wgt
    if params.uniform_alpha:
        # the seed is not alpha-weighted (shaders/nonlocal.comp:32, 61)
        wc = torch.cat([wc, neighbour[..., 3:] * (nw - params.norm_seed)[..., None]], dim=-1)
    return wc, nw


def _nlm_full_weights(target: torch.Tensor, pn: torch.Tensor, params: NlmParams, bf16: bool):
    """Per candidate (dy, dx), the full-resolution weight field: the 2p x 2p
    patch SSD of the RGB squared difference, exp(-ssd / h^2), stride^2 for
    non-self candidates. pn: the neighbour padded by s + p. Yields (dy, dx,
    weights (H, W))."""
    # Half-open search offsets [-s, s)^2 (shaders/nonlocal.comp:36-38), from
    # the table the NLM kernel takes: the stride subset keeps the zero offset,
    # the disk trim drops the corners. (ops/stencils.py imports this module.)
    from .stencils import nlm_candidates

    h, w, _ = target.shape
    s, p = params.search_radius, params.patch_radius
    # E must exist at rows y+j for y in [0,h), j in [-p, p): h+2p-1 rows from -p.
    eh, ew = h + 2 * p - 1, w + 2 * p - 1
    t_ext = _pad2d(target, p, params.border)[:eh, :ew, :3]
    inv_h2 = float(np.float32(1.0 / (params.h**2)))
    if bf16:
        t_taps, n_taps = t_ext.to(torch.bfloat16), pn[..., :3].to(torch.bfloat16)
    st = params.search_stride
    for dy, dx in nlm_candidates(params):
        # E in padded-neighbour coords starts at oy = dy+s: E index e is
        # absolute row e-p+dy, at padded row e-p+dy+halo = e+oy.
        oy, ox = dy + s, dx + s
        if bf16:
            e = _sq_diff_bf16(t_taps, n_taps[oy : oy + eh, ox : ox + ew])
        else:
            d = t_ext - pn[oy : oy + eh, ox : ox + ew, :3]
            e = (d * d).sum(-1)
        ssd = _box_sum(e, 2 * p, h, w)
        wgt = torch.exp(-ssd * inv_h2)
        if st > 1 and (dy, dx) != (0, 0):
            wgt = wgt * float(st * st)  # importance compensation, non-self
        yield dy, dx, wgt


def normalize_eager(
    weight_color: torch.Tensor,
    norm: torch.Tensor,
    params: NormalizeParams = NormalizeParams(),
) -> torch.Tensor:
    """Normalization pass (xla.py:normalize_xla; shaders/normalize.comp:30-44):
    wc / nw with the magenta sentinel where nw == 0."""
    sentinel = torch.tensor(
        [params.sentinel_r, params.sentinel_g, params.sentinel_b, params.sentinel_a],
        dtype=torch.float32,
        device=weight_color.device,
    )
    zero = norm == 0.0
    safe = torch.where(zero, torch.ones_like(norm), norm)
    return torch.where(zero[..., None], sentinel, weight_color / safe[..., None])


def bilateral_fast_eager(
    img: torch.Tensor,
    params: BilateralParams = BilateralParams(),
    levels: int = 6,
    downsample: int = 2,
) -> torch.Tensor:
    """Approximate bilateral filter, the per-channel bilateral grid as
    whole-image tensor ops (fast.py:bilateral_fast_planar's lattice,
    219-271): pad to multiples of d, float32 mean pool, range weights
    exp(-(p - level)^2 / (2 sigma_c^2)) from the pooled image, the separable
    Gaussian blur of the fields (columns, then rows; padded fields under
    ZERO carry no weight), normalize, then the tent sum over levels of the
    bilinearly upsampled grid. Alpha rides green. img: (H, W, 4)."""
    from .fast import _bilinear_up, _grid_taps, grid_range

    img = img.to(torch.float32)
    h, w, _ = img.shape
    inv2sc = 0.5 / (params.sigma_color**2)
    d = max(1, downsample)
    small = _pad_to(img, -(-h // d) * d, -(-w // d) * d, params.border)
    if d > 1:
        small = _mean_pool(small, d)
    rgb_s = small[..., :3]
    lmin, step = grid_range(small, levels)
    ks = torch.arange(levels, dtype=torch.float32, device=img.device)
    level_vals = lmin + step * ks[:, None]  # (K, 3)
    diff = rgb_s - level_vals[:, None, None]  # (K, hs, ws, 3)
    wk = torch.exp(-(diff * diff) * inv2sc)
    # Fields (K, hs, ws, 7): numerators r, g, b, a; denominators r, g, b.
    fields = torch.cat([wk * rgb_s, wk[..., 1:2] * small[..., 3:], wk], -1)
    taps = _grid_taps(params.sigma_spatial, d)
    r = (len(taps) - 1) // 2
    for dim in (2, 1):  # along W, then along H
        fields = _blur_valid(_pad_dim(fields, r, dim, params.border), taps, dim)
    den = fields[..., 4:].clamp_min(1e-20)
    grid = torch.cat([fields[..., :3] / den, fields[..., 3:4] / den[..., 1:2]], -1)
    t = ((img[..., :3] - lmin) / step).clamp(0.0, levels - 1.0)
    t = torch.cat([t, t[..., 1:2]], -1)
    out = torch.zeros((h, w, 4), dtype=torch.float32, device=img.device)
    for k in range(levels):
        tent = (1.0 - (t - k).abs()).clamp(0.0, 1.0)
        up = _bilinear_up(grid[k], d, h, w) if d > 1 else grid[k]
        out = out + tent * up
    return out
