"""The temporal NLM family on HDR shots: float32 frames as a path tracer
writes them to EXR, through Session.run with the multiframe NLM config
(`gpu-denoise --all-frames` on a `.exr` target). The scenes and the pan are
the temporal NLM family's; the HDR model is `tools/make_dataset.py --hdr`'s
and `chip_smoke.py` phase 10's: an emissive ceiling patch, noise left
unclipped, fireflies. The parameters, window, program entry, plain
reference and step's work are the temporal NLM family's."""

from __future__ import annotations

import numpy as np
import torch

from portbench import content
from portbench.families import temporal_nlm as base

params = base.params
tiling = base.tiling
window_item = base.window_item
reference = base.reference
session = base.session
step_work = base.step_work


def hdr_shot(cfg: dict, scene: int, gen: torch.Generator, device) -> torch.Tensor:
    """A shot of cfg["shot_frames"] (H, W, 4) float32 HDR frames: the scene
    `content.synthetic_render_device(..., scene)` (RGB in [0, 1]) with an
    emissive ceiling patch of cfg["emissive"] added where v < 0.08 and |u -
    0.5| < 0.2 of the scene (so it pans with the scene), seen through a
    window that pans cfg["pan"] pixels a frame down and to the right; then
    Gaussian noise of cfg["noise"] on RGB, not clipped; then in every frame
    cfg["firefly_share"] of the pixels (at least one), drawn from gen, with
    RGB times cfg["firefly_gain"]; alpha 1."""
    h, w, n, pan = cfg["height"], cfg["width"], cfg["shot_frames"], cfg["pan"]
    margin = pan * (n - 1)
    view = content.synthetic_render_device(h + margin, w + margin, scene, device=device)
    v = torch.arange(h + margin, dtype=torch.float32, device=device)[:, None] / (h + margin)
    u = torch.arange(w + margin, dtype=torch.float32, device=device)[None, :] / (w + margin)
    patch = (v < 0.08) & ((u - 0.5).abs() < 0.2)
    view[..., :3] += cfg["emissive"] * patch[..., None].to(torch.float32)
    clean = torch.stack([view[k * pan:k * pan + h, k * pan:k * pan + w] for k in range(n)])
    rgb = clean[..., :3] + cfg["noise"] * torch.randn(clean[..., :3].shape, generator=gen,
                                                      device=device)
    fireflies = max(1, round(cfg["firefly_share"] * h * w))
    flat = rgb.view(n, h * w, 3)
    for k in range(n):
        idx = torch.randperm(h * w, generator=gen, device=device)[:fireflies]
        flat[k, idx] *= cfg["firefly_gain"]
    return torch.cat([rgb, clean[..., 3:]], dim=-1)


def host_shots(cfg: dict, n_shots: int, seed: int, device) -> np.ndarray:
    """(n_shots, shot_frames, H, W, 4) float32 HDR frames on the host, as
    the EXR files hold them: shot s shows scene s, whatever the seed, so
    every seed brings the same work; the noise and the fireflies are drawn
    from the seed."""
    return np.stack([hdr_shot(cfg, s, content.generator(seed, s, device), device).cpu().numpy()
                     for s in range(n_shots)])
