"""The benchmark's inputs, made on the device: fixed scenes, and noise
drawn from the seed.

`_scene` and `synthetic_render_device` are frozen copies of
`image_denoising_filter_tpu_torch/utils/content.py` (a render-like scene:
shaded background, twelve flat surfaces with hard anti-aliased edges, fine
texture). `render_frame_device` is `tools/make_dataset.py:render_frame`
(the moving sphere in a coloured box, with its albedo, normal and depth
layers) written with torch operations, so that a 4K frame and its layers
are made where they are denoised. Noise comes from a torch.Generator on the
device, drawn for a whole shot in one call.
"""

from __future__ import annotations

import numpy as np
import torch


def _scene(seed: int) -> list[tuple]:
    """The scene's parameters, drawn from default_rng(seed): per surface
    (albedo, gdir, gmag, geometry), the geometry ("rect", y0, x0, dy, dx) or
    ("disk", cy, cx, r)."""
    rng = np.random.default_rng(seed)
    surfs = []
    for _ in range(12):
        albedo = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        gdir = rng.uniform(-1, 1, 2).astype(np.float32)
        gmag = rng.uniform(0.05, 0.25)
        if rng.uniform() < 0.5:
            y0, x0 = rng.uniform(0, 0.8, 2)
            dy, dx = rng.uniform(0.1, 0.45, 2)
            geom = ("rect", float(y0), float(x0), float(dy), float(dx))
        else:
            cy, cx = rng.uniform(0.1, 0.9, 2)
            geom = ("disk", float(cy), float(cx), float(rng.uniform(0.05, 0.25)))
        surfs.append((albedo, gdir, gmag, geom))
    return surfs


def synthetic_render_device(h: int, w: int, seed: int, *, device) -> torch.Tensor:
    """A render-like (h, w, 4) float32 scene in [0, 1] on `device`, alpha 1,
    without noise."""
    dev = torch.device(device)
    f32 = torch.float32

    def div(x, d):
        return x / torch.tensor(d, dtype=x.dtype, device=dev)

    yy = torch.arange(h, dtype=f32, device=dev)[:, None]
    xx = torch.arange(w, dtype=f32, device=dev)[None, :]
    yn, xn = div(yy, max(h - 1, 1)), div(xx, max(w - 1, 1))
    yn64, xn64 = yn.double(), xn.double()

    base = torch.stack(
        [
            (0.35 + 0.25 * yn).expand(h, w),
            (0.30 + 0.20 * yn).expand(h, w),
            (0.28 + 0.15 * yn).expand(h, w),
        ],
        dim=-1,
    )
    aspect = w / max(h, 1)
    for albedo, gdir, gmag, geom in _scene(seed):
        shade = gmag * (float(gdir[0]) * yn + float(gdir[1]) * xn)
        if geom[0] == "rect":
            _, y0, x0, dy, dx = geom
            mask = (yn64 >= y0) & (yn64 < y0 + dy) & (xn64 >= x0) & (xn64 < x0 + dx)
        else:
            _, cy, cx, r = geom
            mask = ((yn64 - cy) ** 2 + div(xn64 - cx, max(aspect, 1e-3)) ** 2) < r * r
        surf = (torch.from_numpy(albedo).to(dev) + shade[..., None]).clamp(0.0, 1.0)
        base = torch.where(mask[..., None], surf, base)

    tex = 0.02 * torch.sin(div(xx, 3.1)) * torch.cos(div(yy, 4.7))
    rgb = (base + tex[..., None]).clamp(0.0, 1.0)

    for axis in (0, 1):
        n = rgb.shape[axis]
        p = torch.cat([rgb.narrow(axis, 0, 1), rgb, rgb.narrow(axis, n - 1, 1)], axis)
        acc = torch.zeros_like(rgb)
        for t, k in enumerate((0.25, 0.5, 0.25)):
            acc += k * p.narrow(axis, t, n)
        rgb = acc
    alpha = torch.ones((h, w, 1), dtype=f32, device=dev)
    return torch.cat([rgb, alpha], dim=-1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one use of the seed (`stream` tells the
    uses apart)."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + stream) % 2**63)
    return g


def noisy_shot(h: int, w: int, frames: int, scene: int, noise: float, pan: int,
               gen: torch.Generator, device) -> torch.Tensor:
    """A shot of `frames` noisy (h, w, 4) frames in [0, 1]: the scene
    `synthetic_render_device(..., scene)` seen through a window that pans
    `pan` pixels a frame down and to the right, with Gaussian noise of
    standard deviation `noise` on RGB drawn from gen in one call, clipped
    to [0, 1]; alpha 1. (frames, h, w, 4)."""
    margin = pan * (frames - 1)
    view = synthetic_render_device(h + margin, w + margin, scene, device=device)
    clean = torch.stack([view[k * pan:k * pan + h, k * pan:k * pan + w] for k in range(frames)])
    rgb = clean[..., :3] + noise * torch.randn(clean[..., :3].shape, generator=gen,
                                               device=device)
    return torch.cat([rgb.clamp(0.0, 1.0), clean[..., 3:]], dim=-1)


def render_frame_device(t: float, h: int, w: int, device) -> tuple[torch.Tensor, dict]:
    """The clean frame at time t and its noise-free G-buffer layers
    {albedo, normal, depth}, each (h, w, 4) float32 with alpha 1."""
    dev = torch.device(device)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    u, v = xx / w, yy / h

    wall = 0.7 - 0.3 * v
    left, right = u < 0.15, u > 0.85

    def sides(a, b, c):
        return torch.where(left, a, torch.where(right, b, c))

    albedo = torch.stack([sides(0.9, 0.2, wall), sides(0.1, 0.8, wall), sides(0.1, 0.2, wall)], -1)

    cx, cy, r0 = 0.35 + 0.3 * t, 0.55, 0.18
    d = torch.sqrt((u - cx) ** 2 + (v - cy) ** 2)
    sphere = d < r0
    albedo = torch.where(sphere[..., None],
                         torch.tensor([0.85, 0.75, 0.3], dtype=torch.float32, device=dev), albedo)

    nz = torch.sqrt(torch.clamp(r0 * r0 - (u - cx) ** 2 - (v - cy) ** 2, min=0.0)) / r0
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    normal = torch.stack(
        [
            torch.where(sphere, (u - cx) / r0, sides(1.0, -1.0, zero)),
            torch.where(sphere, (v - cy) / r0, zero),
            torch.where(sphere, nz, torch.where(~left & ~right, one, zero)),
        ],
        -1,
    ) * 0.5 + 0.5

    depth = torch.where(sphere, 0.5 - 0.2 * nz, 0.2 + 0.8 * v)
    depth3 = depth[..., None].expand(h, w, 3)

    light = 1.2 - 0.8 * d
    clean = torch.clamp(albedo * torch.clamp(light, min=0.1)[..., None], 0.0, 1.0)

    alpha = torch.ones((h, w, 1), dtype=torch.float32, device=dev)

    def rgba(x):
        return torch.cat([x, alpha], -1)

    return rgba(clean), {"albedo": rgba(albedo), "normal": rgba(normal), "depth": rgba(depth3)}
