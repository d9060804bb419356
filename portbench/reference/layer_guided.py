"""Plain layer-guided cross-bilateral, written from the filter's definition
(the port's `config.BilateralParams` and `config.LayersParams` docstrings,
after shaders/bialteral_layers.comp and src/main.cpp:1608-1624 of the
upstream reference).

For every G-buffer layer G and every tap (dy, dx) of the window
|dy|, |dx| <= radius whose spatial weight is at least truncate_eps, a pixel
(y, x) of the target T gets the weight

    w = exp(-(dy^2 + dx^2) / (2 ss^2)) * exp(-||G[y, x] - G[y+dy, x+dx]||^2 / (2 sc^2))

(the colour distance over RGB, or over R and G alone with blue_bug) and
accumulates wc += w * T[y+dy, x+dx] (all four channels) and nw += w, into
sums shared by all layers. The output is wc / nw, with the sentinel
(1, 0, 1, 1) where nw is 0. Out-of-image taps are clamped to the edge or
read zeros. Everything is float32.

Plain torch, on whatever device its inputs are: no kernel, no cache, and
nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

from .temporal_nlm import normalize, pad


def taps(radius: int, sigma_spatial: float, truncate_eps: float) -> list[tuple[int, int]]:
    """The window's taps whose spatial weight is at least truncate_eps
    (every tap at eps 0)."""
    r2 = math.inf if truncate_eps <= 0 else (
        2.0 * sigma_spatial * sigma_spatial * math.log(1.0 / truncate_eps))
    return [(dy, dx) for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
            if dy * dy + dx * dx <= r2]


def accumulate(target: torch.Tensor, layer: torch.Tensor, params: dict,
               wc: torch.Tensor, nw: torch.Tensor) -> None:
    """One layer's weights and taps added into wc (H, W, 4) and nw (H, W)."""
    h, w = target.shape[:2]
    tap_set = taps(params["radius"], params["sigma_spatial"], params["truncate_eps"])
    m = max(max(abs(dy), abs(dx)) for dy, dx in tap_set)
    nrgb = 2 if params["blue_bug"] else 3
    g_pad = pad(layer, m, params["border"])[..., :nrgb]
    t_pad = pad(target, m, params["border"])
    centre = layer[..., :nrgb]
    inv_ss = 1.0 / (2.0 * params["sigma_spatial"] ** 2)
    inv_sc = 1.0 / (2.0 * params["sigma_color"] ** 2)
    for dy, dx in tap_set:
        d = centre - g_pad[m + dy:m + dy + h, m + dx:m + dx + w]
        wgt = torch.exp(-(dy * dy + dx * dx) * inv_ss - (d * d).sum(-1) * inv_sc)
        wc.addcmul_(t_pad[m + dy:m + dy + h, m + dx:m + dx + w], wgt[..., None])
        nw += wgt


def layer_guided(target: torch.Tensor, layers: torch.Tensor, params: dict) -> torch.Tensor:
    """The denoised (H, W, 4) target over layers (L, H, W, 4). params: the
    configuration's radius, sigma_spatial, sigma_color, truncate_eps,
    blue_bug, border."""
    target = target.float()
    wc = torch.zeros(target.shape, dtype=torch.float32, device=target.device)
    nw = torch.zeros(target.shape[:2], dtype=torch.float32, device=target.device)
    for layer in layers:
        accumulate(target, layer.float(), params, wc, nw)
    return normalize(wc, nw)
