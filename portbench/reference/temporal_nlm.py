"""Plain temporal non-local means, written from the filter's definition
(the port's `config.NlmParams` docstring, after shaders/nonlocal.comp and
src/main.cpp:1574-1607, 1649-1652 of the upstream reference).

For every frame N_f of the window (the target first) and every search
offset (dy, dx) in the half-open square [-s, s)^2, a pixel (y, x) of the
target T gets the weight

    w = exp(-ssd / h^2),  ssd = sum over j, i in [-p, p) and c in RGB of
                                (T[y+j, x+i, c] - N_f[y+dy+j, x+dx+i, c])^2

and accumulates wc += w * N_f[y+dy, x+dx] (all four channels) and nw += w.
Each frame adds the norm seed to nw once. The output is wc / nw, with the
sentinel (1, 0, 1, 1) where nw is 0. Out-of-image coordinates are clamped
to the edge ("clamp") or read zeros ("zero"). Everything is float32.

Plain torch, on whatever device its inputs are: no kernel, no cache, and
nothing of the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SENTINEL = (1.0, 0.0, 1.0, 1.0)


def pad(img: torch.Tensor, m: int, border: str) -> torch.Tensor:
    """(H, W, C) padded by m on each side of H and W."""
    if m == 0:
        return img
    h, w = img.shape[:2]
    if border == "clamp":
        rows = torch.arange(-m, h + m, device=img.device).clamp(0, h - 1)
        cols = torch.arange(-m, w + m, device=img.device).clamp(0, w - 1)
        return img[rows][:, cols]
    if border == "zero":
        return F.pad(img, (0, 0, m, m, m, m))
    raise ValueError(f"unknown border {border!r}")


def box_sum(e: torch.Tensor, k: int, out_h: int, out_w: int) -> torch.Tensor:
    """out[y, x] = sum of e[y:y+k, x:x+k]."""
    rows = e[0:out_h].clone()
    for j in range(1, k):
        rows += e[j:j + out_h]
    out = rows[:, 0:out_w].clone()
    for i in range(1, k):
        out += rows[:, i:i + out_w]
    return out


def normalize(wc: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
    sentinel = torch.tensor(SENTINEL, dtype=wc.dtype, device=wc.device)
    zero = nw == 0
    out = wc / torch.where(zero, torch.ones_like(nw), nw)[..., None]
    return torch.where(zero[..., None], sentinel, out)


def accumulate(target: torch.Tensor, frame: torch.Tensor, search_radius: int,
               patch_radius: int, h: float, norm_seed: float, border: str,
               wc: torch.Tensor, nw: torch.Tensor) -> None:
    """One frame's weights and taps added into wc (H, W, 4) and nw (H, W)."""
    ht, wt = target.shape[:2]
    s, p = search_radius, patch_radius
    k = 2 * p
    t_pad = pad(target, p, border)[:, :, :3]       # T[y + j] at row y + j + p
    n_pad = pad(frame, s + p, border)             # N[y] at row y + s + p
    eh, ew = ht + k - 1, wt + k - 1               # rows y + j, j in [-p, p)
    t_ext = t_pad[:eh, :ew]
    inv_h2 = 1.0 / (h * h)
    nw += norm_seed
    for dy in range(-s, s):
        for dx in range(-s, s):
            # N[y + dy + j] at row (y + j + p) + dy + s of n_pad
            n_ext = n_pad[dy + s:dy + s + eh, dx + s:dx + s + ew, :3]
            d = t_ext - n_ext
            ssd = box_sum((d * d).sum(-1), k, ht, wt)
            wgt = torch.exp(-ssd * inv_h2)
            tap = n_pad[dy + s + p:dy + s + p + ht, dx + s + p:dx + s + p + wt]
            wc.addcmul_(tap, wgt[..., None])
            nw += wgt


def temporal_nlm(target: torch.Tensor, frames: torch.Tensor, params: dict) -> torch.Tensor:
    """The denoised (H, W, 4) target over frames (F, H, W, 4). params: the
    configuration's search_radius, patch_radius, h, norm_seed, border."""
    target = target.float()
    wc = torch.zeros(target.shape, dtype=torch.float32, device=target.device)
    nw = torch.zeros(target.shape[:2], dtype=torch.float32, device=target.device)
    for frame in frames:
        accumulate(target, frame.float(), params["search_radius"], params["patch_radius"],
                   params["h"], params["norm_seed"], params["border"], wc, nw)
    return normalize(wc, nw)
