"""Pure NumPy reference oracles for every device kernel.

A copy of image_denoising_filter_tpu/ops/reference.py, kept function for
function equal to it (tests/test_torch_reference.py), so that the port
imports nothing of the JAX package: `Session.run_cpu` falls back to
`cpu_bilateral_reference` where the native library is not built, and the
parity reading (`psnr` of the bilateral kernel at the CPU parameters against
that oracle) needs no JAX.

These are the correctness ground truth the device kernels are tested against --
they play the role the CPU path (src/main.cpp:1732-1921) plays in the reference,
but cover *all five* kernels, not just the bilateral.

Semantics are transcribed from the reference GLSL (cited per function). Border
policy: the reference GPU kernels read out of bounds (UB -- the bounds check is
commented out, shaders/bialteral.comp:33-41); we define clamp-to-edge as the
framework-wide policy (matching the reference's sampler config, texture.cpp:44-46)
with zero-fill as an option.

Images are float32 arrays of shape (H, W, 4), RGBA, typically in [0, 1] for LDR.
"""

from __future__ import annotations

import numpy as np

from ..config import (
    BilateralParams,
    BorderPolicy,
    CpuBilateralParams,
    LayersParams,
    NlmParams,
    NormalizeParams,
)


def _pad(img: np.ndarray, r: int, border: str) -> np.ndarray:
    """Pad H and W by r on each side according to the border policy."""
    if r == 0:
        return img
    if border == BorderPolicy.CLAMP:
        return np.pad(img, ((r, r), (r, r), (0, 0)), mode="edge")
    return np.pad(img, ((r, r), (r, r), (0, 0)), mode="constant")


def _spatial_weight(i: int, j: int, sigma_spatial: float) -> np.float32:
    # exp(-0.5 * (sqrt(i^2+j^2) / sigma)^2) == exp(-0.5 * (i^2+j^2) / sigma^2)
    # (shaders/bialteral.comp:53-54; sqrt-then-square fused away).
    return np.float32(np.exp(-0.5 * (i * i + j * j) / (sigma_spatial**2)))


def _color_ssd(center: np.ndarray, tap: np.ndarray, blue_bug: bool) -> np.ndarray:
    """Squared RGB distance between center and tap colors, per pixel.

    shaders/bialteral.comp:60-63. With blue_bug, the blue difference is
    `texColor.b - texColor.b` == 0 (src/main.cpp:1850).
    """
    d = center[..., :3] - tap[..., :3]
    if blue_bug:
        d = d.copy()
        d[..., 2] = 0.0
    return np.sum(d * d, axis=-1)


def bilateral_reference(img: np.ndarray, params: BilateralParams) -> np.ndarray:
    """Bilateral filter oracle (shaders/bialteral.comp:29-81).

    All four channels are accumulated with the RGB-derived weight
    (bialteral.comp:68: `weightColor += curColor * resultWeight` on vec4).
    """
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    r = params.radius
    padded = _pad(img, r, params.border)
    inv2sc = np.float32(0.5 / (params.sigma_color**2))

    weight_color = np.zeros((h, w, 4), np.float32)
    norm = np.zeros((h, w), np.float32)
    for i in range(-r, r + 1):  # i is the x offset in the shader's loop naming
        for j in range(-r, r + 1):
            tap = padded[r + j : r + j + h, r + i : r + i + w]
            ssd = _color_ssd(img, tap, params.blue_bug)
            wgt = _spatial_weight(i, j, params.sigma_spatial) * np.exp(-ssd * inv2sc)
            weight_color += tap * wgt[..., None]
            norm += wgt
    return weight_color / norm[..., None]


def cpu_bilateral_reference(img: np.ndarray, params: CpuBilateralParams | None = None) -> np.ndarray:
    """The CPU reference path (src/main.cpp:1732-1921) -- the PSNR parity target.

    Differences from the GPU bilateral, faithfully reproduced:
      * window radius 10, sigma_spatial 10.0 (src/main.cpp:1819, 1833-1835);
      * blue-channel bug: blue never contributes to the color distance
        (src/main.cpp:1850);
      * only RGB accumulated; output alpha forced to 1.0 (src/main.cpp:1855-1864);
      * a radius-wide border is skipped, left as zeros (loop bounds
        src/main.cpp:1823-1828 run y, x in [radius, dim - radius] inclusive).

    Border deviation (documented): the reference's flat indexing makes the very
    last interior row/column read one-past-the-end (undefined behavior in C++);
    we use clamp-to-edge for those few taps instead.
    """
    if params is None:
        params = CpuBilateralParams()
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    r = params.radius
    padded = _pad(img, r, BorderPolicy.CLAMP)
    inv2sc = np.float32(0.5 / (params.sigma_color**2))

    weight_color = np.zeros((h, w, 3), np.float32)
    norm = np.zeros((h, w), np.float32)
    for i in range(-r, r + 1):
        for j in range(-r, r + 1):
            tap = padded[r + i : r + i + h, r + j : r + j + w]
            ssd = _color_ssd(img, tap, params.blue_bug)
            wgt = _spatial_weight(i, j, params.sigma_spatial) * np.exp(-ssd * inv2sc)
            weight_color += tap[..., :3] * wgt[..., None]
            norm += wgt

    out = np.zeros((h, w, 4), np.float32)
    out[..., :3] = weight_color / norm[..., None]
    out[..., 3] = 1.0
    if params.skip_border:
        # Interior is [r, dim - r] inclusive (src/main.cpp:1823-1828); everything
        # else stays zero-initialized (outputPixels default, src/main.cpp:1816).
        mask = np.zeros((h, w), bool)
        mask[r : h - r + 1, r : w - r + 1] = True
        out[~mask] = 0.0
    return out


def cross_bilateral_layers_reference(
    target: np.ndarray, layer: np.ndarray, params: LayersParams
) -> tuple[np.ndarray, np.ndarray]:
    """One layer's accumulation pass (shaders/bialteral_layers.comp:27-66).

    Weights come from the *layer* image (center AND tap colors both read from
    layerTex, bialteral_layers.comp:29, 46-51); the accumulated colors are the
    *target* image's taps (bialteral_layers.comp:55). Returns the
    (weightColor, normWeight) partials for this layer; the caller accumulates
    across layers and normalizes (shaders/normalize.comp).
    """
    target = np.asarray(target, np.float32)
    layer = np.asarray(layer, np.float32)
    h, w, _ = target.shape
    r = params.radius
    padded_t = _pad(target, r, params.border)
    padded_l = _pad(layer, r, params.border)
    inv2sc = np.float32(0.5 / (params.sigma_color**2))

    weight_color = np.zeros((h, w, 4), np.float32)
    norm = np.zeros((h, w), np.float32)
    for i in range(-r, r + 1):
        for j in range(-r, r + 1):
            tap_l = padded_l[r + j : r + j + h, r + i : r + i + w]
            tap_t = padded_t[r + j : r + j + h, r + i : r + i + w]
            ssd = _color_ssd(layer, tap_l, params.blue_bug)
            wgt = _spatial_weight(i, j, params.sigma_spatial) * np.exp(-ssd * inv2sc)
            weight_color += tap_t * wgt[..., None]
            norm += wgt
    return weight_color, norm


def nlm_reference(
    target: np.ndarray, neighbour: np.ndarray, params: NlmParams
) -> tuple[np.ndarray, np.ndarray]:
    """One frame's NLM accumulation pass (shaders/nonlocal.comp:30-65).

    For each pixel p and each search offset (dx, dy) in
    [-search_radius, search_radius) x [-search_radius, search_radius):
      ssd   = sum over patch offsets (i, j) in [-patch_radius, patch_radius)^2 of
              ||rgb(target[p + (i,j)]) - rgb(neighbour[p + (dx,dy) + (i,j)])||^2
      wgt   = exp(-ssd / h^2)
      weightColor += neighbour[p + (dx,dy)] * wgt ;  normWeight += wgt
    normWeight is seeded with `norm_seed` per frame (shaders/nonlocal.comp:32).
    Returns this frame's (weightColor, normWeight) partials.
    """
    target = np.asarray(target, np.float32)
    neighbour = np.asarray(neighbour, np.float32)
    h, w, _ = target.shape
    s, p = params.search_radius, params.patch_radius
    halo = s + p
    pt = _pad(target, p, params.border)
    pn = _pad(neighbour, halo, params.border)
    inv_h2 = np.float32(1.0 / (params.h**2))

    weight_color = np.zeros((h, w, 4), np.float32)
    norm = np.full((h, w), params.norm_seed, np.float32)
    st = params.search_stride  # 1 = exact parity; >1 = approximate subset
    # Strided subsets are phase-aligned to include the d=0 self-match, and
    # non-self weights carry an importance-sampling compensation of stride^2
    # (each evaluated candidate stands in for stride^2 neighbors) so the
    # smoothing strength matches the full search (see tests/test_fast.py).
    for dy in range(s % st - s, s, st):  # half-open: [-s, s) (nonlocal.comp:36)
        for dx in range(s % st - s, s, st):
            if params.search_disk and dy * dy + dx * dx > s * s:
                continue  # disk trim (config.NlmParams.search_disk)
            ssd = np.zeros((h, w), np.float32)
            for j in range(-p, p):  # half-open: [-p, p) (shaders/nonlocal.comp:42)
                for i in range(-p, p):
                    t = pt[p + j : p + j + h, p + i : p + i + w, :3]
                    n = pn[halo + dy + j : halo + dy + j + h,
                           halo + dx + i : halo + dx + i + w, :3]
                    d = t - n
                    ssd += np.sum(d * d, axis=-1)
            wgt = np.exp(-ssd * inv_h2)
            if st > 1 and not (dy == 0 and dx == 0):
                wgt = wgt * np.float32(st * st)
            tap = pn[halo + dy : halo + dy + h, halo + dx : halo + dx + w]
            weight_color += tap * wgt[..., None]
            norm += wgt
    return weight_color, norm


def normalize_reference(
    weight_color: np.ndarray, norm: np.ndarray, params: NormalizeParams | None = None
) -> np.ndarray:
    """Normalization pass (shaders/normalize.comp:30-44): out = wc / nw with a
    magenta sentinel where nw == 0."""
    if params is None:
        params = NormalizeParams()
    norm = np.asarray(norm, np.float32)
    sentinel = np.array(
        [params.sentinel_r, params.sentinel_g, params.sentinel_b, params.sentinel_a],
        np.float32,
    )
    zero = norm == 0.0
    safe = np.where(zero, np.float32(1.0), norm)
    out = weight_color / safe[..., None]
    return np.where(zero[..., None], sentinel, out).astype(np.float32)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Mean structural similarity (Wang et al. 2004): 11x11 Gaussian window
    (sigma 1.5), C1=(0.01 L)^2, C2=(0.03 L)^2, averaged over channels."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    x = np.arange(-5, 6, dtype=np.float64)
    g = np.exp(-(x * x) / (2 * 1.5 * 1.5))
    g /= g.sum()

    def blur(im):  # separable 11x11 over symmetric-padded edges
        pad = np.pad(im, ((5, 5), (5, 5), (0, 0)), mode="symmetric")
        t = sum(g[i] * pad[i : i + im.shape[0]] for i in range(11))
        return sum(g[j] * t[:, j : j + im.shape[1]] for j in range(11))

    mu_a = blur(a)
    mu_b = blur(b)
    saa = blur(a * a) - mu_a * mu_a
    sbb = blur(b * b) - mu_b * mu_b
    sab = blur(a * b) - mu_a * mu_b
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (saa + sbb + c2)
    return float(np.mean(num / den))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB (the BASELINE.json parity metric)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(peak * peak / mse))
