"""Synthetic render-like benchmark content: `synthetic_render` on the host
(a copy of image_denoising_filter_tpu/utils/content.py's) and its twin
evaluated with torch ops on a device, `synthetic_render_device`.

The reference's workload is denoising Monte-Carlo renders (CornellBox /
Bathroom01 / WasteWhite animation frames, Animations/README.md:1): piecewise-
smooth surfaces, hard geometric edges, soft shading gradients -- locally
low-dynamic-range content. This generator produces a deterministic scene with
those statistics so benchmarks and quality gates can run on the content class
the framework targets without shipping binary assets. Full-range iid noise
remains the published worst case (see bench.py): it is NOT what a denoiser
denoises, and grid methods are content-dependent by design.
"""

from __future__ import annotations

import numpy as np


def synthetic_render(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A deterministic render-like RGBA float32 scene in [0, 1].

    Composition: a vertically-shaded background (soft gradient), a set of
    overlapping rectangles and disks with flat-ish albedos and per-surface
    shading gradients (hard edges between them), plus low-amplitude texture.
    Alpha is 1 (opaque LDR render). Noise is NOT added here -- callers add
    the noise they want to denoise.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yn, xn = yy / max(h - 1, 1), xx / max(w - 1, 1)

    # Background: cornell-style wall gradient, slightly colored.
    base = np.stack(
        [
            0.35 + 0.25 * yn,
            0.30 + 0.20 * yn,
            0.28 + 0.15 * yn,
        ],
        axis=-1,
    )

    # Opaque geometric surfaces: rectangles and disks with flat albedo +
    # a per-surface shading gradient (what a lit diffuse surface looks like).
    for _ in range(12):
        albedo = rng.uniform(0.1, 0.9, 3).astype(np.float32)
        gdir = rng.uniform(-1, 1, 2).astype(np.float32)
        gmag = rng.uniform(0.05, 0.25)
        shade = gmag * (gdir[0] * yn + gdir[1] * xn)
        if rng.uniform() < 0.5:
            y0, x0 = rng.uniform(0, 0.8, 2)
            dy, dx = rng.uniform(0.1, 0.45, 2)
            mask = (yn >= y0) & (yn < y0 + dy) & (xn >= x0) & (xn < x0 + dx)
        else:
            cy, cx = rng.uniform(0.1, 0.9, 2)
            r = rng.uniform(0.05, 0.25)
            aspect = w / max(h, 1)
            mask = ((yn - cy) ** 2 + ((xn - cx) / max(aspect, 1e-3) * 1.0) ** 2) < r * r
        surf = np.clip(albedo[None, None] + shade[..., None], 0.0, 1.0)
        base = np.where(mask[..., None], surf, base)

    # Low-amplitude texture (fine detail a denoiser must not flatten).
    tex = 0.02 * np.sin(xx / 3.1) * np.cos(yy / 4.7)
    rgb = np.clip(base + tex[..., None], 0.0, 1.0).astype(np.float32)

    # Anti-aliasing: real renders rasterize with pixel filtering (multi-sample
    # AA / reconstruction filters), so geometric edges span 1-2 px. A small
    # separable blur models that; infinitely hard edges would make this
    # harsher than any real frame.
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for axis in (0, 1):
        pad = [(1, 1) if a == axis else (0, 0) for a in range(3)]
        p = np.pad(rgb, pad, mode="edge")
        sl = [slice(None)] * 3
        acc = np.zeros_like(rgb)
        for t in range(3):
            sl[axis] = slice(t, t + rgb.shape[axis])
            acc += k[t] * p[tuple(sl)]
        rgb = acc
    rgb = rgb.astype(np.float32)
    alpha = np.ones((h, w, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1)




def _scene(seed: int) -> list[tuple]:
    """The scene's parameters, drawn from default_rng(seed) in the order
    `synthetic_render` draws them: per surface (albedo, gdir, gmag, geometry),
    the geometry ("rect", y0, x0, dy, dx) or ("disk", cy, cx, r)."""
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


def synthetic_render_device(h: int, w: int, seed: int = 0, *, device):
    """`synthetic_render` evaluated with torch ops on `device`: the same
    parameter draws (`_scene`) and the same float32 fields, so the frame is
    made where it is denoised and never crosses from the host. Returns an
    (h, w, 4) float32 tensor on `device` that matches the host version to
    float32 rounding (tests/test_torch_content.py: 2e-6).

    Two operations follow numpy rather than torch's defaults, because a
    one-ulp difference there moves a surface edge by a pixel: divisions by a
    constant divide by a device tensor (the CUDA kernels multiply by the
    reciprocal of a host scalar, numpy divides), and the surface masks
    compare in float64, as numpy compares float32 coordinates with the float64
    draws."""
    import torch

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
