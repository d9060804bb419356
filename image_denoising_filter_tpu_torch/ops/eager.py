"""Whole-image PyTorch versions of the device stencils: the linear-layout
config.

Counterpart of image_denoising_filter_tpu/ops/xla.py, the analog of the
reference's *linear texel-buffer* variant (shaders/bialteral_linear.comp):
the same math as the hand-written kernels, written as whole-image tensor ops
that re-read the image for every tap. In the JAX package this is plain XLA,
not Pallas, so here it stays tensor ops on the device; it is the linear
config itself, not the kernels' plain versions (those live beside the
kernels in ops/stencils.py).

All functions take and return (H, W, 4) float32 tensors and run on whatever
device their inputs are on. Accumulators are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from image_denoising_filter_tpu.config import (
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
    if border == BorderPolicy.CLAMP:
        h, w = img.shape[:2]
        ys = torch.arange(-r, h + r, device=img.device).clamp_(0, h - 1)
        xs = torch.arange(-r, w + r, device=img.device).clamp_(0, w - 1)
        return img[ys][:, xs]
    return F.pad(img, (0, 0, r, r, r, r))


def _box_sum(e: torch.Tensor, k: int, out_h: int, out_w: int) -> torch.Tensor:
    """Valid k x k window sums of a 2D tensor: out[y, x] = sum of
    e[y:y+k, x:x+k], as shifted-slice adds (rows, then columns), so no
    convolution and no cumulative sum enters the arithmetic."""
    rows = e[0:out_h]
    for j in range(1, k):
        rows = rows + e[j : j + out_h]
    out = rows[:, 0:out_w]
    for j in range(1, k):
        out = out + rows[:, j : j + out_w]
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


def nlm_eager(
    target: torch.Tensor, neighbour: torch.Tensor, params: NlmParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame's NLM partials (xla.py:nlm_xla; shaders/nonlocal.comp:30-65),
    exact or with the strided and disk candidate subsets. normWeight is
    seeded with params.norm_seed."""
    if params.weights_halfres:
        raise NotImplementedError(
            "weights_halfres is not ported yet (ROADMAP.md queue A item 8, turbo NLM)"
        )
    target = target.to(torch.float32)
    neighbour = neighbour.to(torch.float32)
    h, w, _ = target.shape
    s, p = params.search_radius, params.patch_radius
    halo = s + p
    # E must exist at rows y+j for y in [0,h), j in [-p, p): h+2p-1 rows from -p.
    eh, ew = h + 2 * p - 1, w + 2 * p - 1
    t_ext = _pad2d(target, p, params.border)[:eh, :ew, :3]
    pn = _pad2d(neighbour, halo, params.border)
    inv_h2 = float(np.float32(1.0 / (params.h**2)))

    # Half-open search offsets [-s, s)^2 (shaders/nonlocal.comp:36-38), from
    # the table the NLM kernel takes: the stride subset keeps the zero offset,
    # the disk trim drops the corners. (ops/stencils.py imports this module.)
    from .stencils import nlm_candidates

    st = params.search_stride
    nch = 3 if params.uniform_alpha else 4
    wc = torch.zeros((h, w, nch), dtype=torch.float32, device=target.device)
    nw = torch.full((h, w), params.norm_seed, dtype=torch.float32, device=target.device)
    for dy, dx in nlm_candidates(params):
        # E in padded-neighbour coords starts at oy = dy+s: E index e is
        # absolute row e-p+dy, at padded row e-p+dy+halo = e+oy.
        oy, ox = dy + s, dx + s
        d = t_ext - pn[oy : oy + eh, ox : ox + ew, :3]
        ssd = _box_sum((d * d).sum(-1), 2 * p, h, w)
        wgt = torch.exp(-ssd * inv_h2)
        if st > 1 and (dy, dx) != (0, 0):
            wgt = wgt * float(st * st)  # importance compensation, non-self
        tap = pn[oy + p : oy + p + h, ox + p : ox + p + w]
        wc += tap[..., :nch] * wgt[..., None]
        nw += wgt
    if params.uniform_alpha:
        # the seed is not alpha-weighted (shaders/nonlocal.comp:32, 61)
        wc = torch.cat([wc, neighbour[..., 3:] * (nw - params.norm_seed)[..., None]], dim=-1)
    return wc, nw


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
