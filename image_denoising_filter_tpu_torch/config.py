"""Configuration dataclasses of the PyTorch / CUDA denoising port.

A copy of image_denoising_filter_tpu/config.py, kept field for field equal
to it (tests/test_torch_config.py), so that the port imports nothing of the
JAX package.

The reference (Reefufui/image_denoising_filter) hardcodes every parameter:
compile-time kernel constants (shaders/bialteral.comp:4-5, shaders/nonlocal.comp:4-6),
push-constant values at the call sites (src/main.cpp:806-807, 870-871, 875-876,
908-909), and CPU-path locals (src/main.cpp:1819, 1833-1835). Here they are all
promoted to real config objects with the reference values as defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


class BorderPolicy:
    """How stencil taps that fall outside the image are handled.

    The reference GPU kernels have *undefined behavior* at borders: the bounds
    check is commented out (shaders/bialteral.comp:33-41) and `texelFetch` with
    out-of-bounds coordinates is UB in Vulkan (the sampler's clamp-to-edge mode,
    texture.cpp:44-46, does not apply to texelFetch). We define an explicit,
    tested policy instead. CLAMP matches the reference's *sampler configuration*
    and is the default.
    """

    CLAMP = "clamp"  # clamp-to-edge (VK_SAMPLER_ADDRESS_MODE_CLAMP_TO_EDGE analog)
    ZERO = "zero"    # out-of-bounds taps read (0, 0, 0, 0)


@dataclasses.dataclass(frozen=True)
class BilateralParams:
    """Parameters of the bilateral filter.

    Reference defaults: window radius `TEXEL_WINDOW 20` (shaders/bialteral.comp:5),
    sigma_spatial=2.0 and sigma_color=0.2 pushed at src/main.cpp:806-807.

    The weight of tap (i, j) relative to center pixel c with tap color t:
        w = exp(-0.5 * (i^2 + j^2) / sigma_spatial^2)
          * exp(-0.5 * ||rgb(c) - rgb(t)||^2 / sigma_color^2)
    (shaders/bialteral.comp:51-66 -- the shader takes sqrt then squares again,
    which is algebraically the identity; we fuse the two exps into one, which is
    also algebraically exact). Output = sum(w * rgba(t)) / sum(w), all four
    channels weighted (shaders/bialteral.comp:68-72).
    """

    radius: int = 20
    sigma_spatial: float = 2.0
    sigma_color: float = 0.2
    border: str = BorderPolicy.CLAMP
    # Reproduce the CPU path's blue-channel bug (src/main.cpp:1850: the color
    # distance compares texColor.b with itself, so blue never contributes).
    blue_bug: bool = False
    # Exact fast path for images whose alpha channel is one constant value
    # (typical LDR alpha=1): sum(w * a) == a * sum(w), so the kernel skips the
    # per-tap alpha accumulation and reconstructs it from the norm. Enable
    # only when alpha is genuinely uniform across ALL inputs (Session
    # auto-detects); output is bit-equivalent up to fp reassociation.
    uniform_alpha: bool = False
    # Drop taps whose *spatial* weight alone is below this (their total weight
    # is <= spatial x 1, so the dropped tail can shift the normalized output
    # by at most ~window^2 * eps ~= 2e-5 relative -- far below the parity
    # tolerance, though above float32 eps). With the reference's
    # sigma_spatial=2.0 this shrinks the 41x41 window to 27x27
    # (effective_radius 13). 0.0 disables truncation (full window).
    truncate_eps: float = 1e-8

    @property
    def window(self) -> int:
        return 2 * self.radius + 1

    @property
    def effective_radius(self) -> int:
        """Radius after spatial-weight truncation (== radius when
        truncate_eps is 0 or sigma_spatial is large). floor, not ceil: a row
        at |dy| = floor(R)+1 has dy^2 > R^2, i.e. every tap in it is already
        below truncate_eps."""
        if self.truncate_eps <= 0.0:
            return self.radius
        import math

        r_eff = math.floor(self.sigma_spatial * math.sqrt(-2.0 * math.log(self.truncate_eps)))
        return min(self.radius, max(1, r_eff))


@dataclasses.dataclass(frozen=True)
class CpuBilateralParams(BilateralParams):
    """The CPU reference path's (different!) parameter set.

    src/main.cpp:1819 (windowSize=10), 1833-1835 (sigma_spatial=10, sigma_color=0.2),
    1850 (blue-channel bug). The CPU path also skips a `windowSize`-wide border,
    leaving those pixels zero (loop bounds src/main.cpp:1823-1828), and forces
    output alpha to 1.0 in the interior (src/main.cpp:1864).
    """

    radius: int = 10
    sigma_spatial: float = 10.0
    sigma_color: float = 0.2
    blue_bug: bool = True
    skip_border: bool = True
    force_alpha_one: bool = True


@dataclasses.dataclass(frozen=True)
class NlmParams:
    """Non-local means parameters.

    Reference: search radius `WINDOW 7`, patch radius `PATCH_WINDOW 3`
    (shaders/nonlocal.comp:4-6) with *half-open* loop ranges: search offsets in
    [-7, 7) x [-7, 7) (14x14 = 196 candidates, shaders/nonlocal.comp:36-38) and
    patch offsets in [-3, 3) x [-3, 3) (6x6 = 36 taps, shaders/nonlocal.comp:42-44).
    Filtering parameter h = 0.5 pushed at src/main.cpp:870-871;
    weight = exp(-patch_ssd / h^2) (shaders/nonlocal.comp:55). Each dispatch
    (i.e. each frame) seeds the normalization weight with 0.001
    (shaders/nonlocal.comp:32) and both accumulators += into a persistent buffer
    across frames (shaders/nonlocal.comp:61-62).
    """

    search_radius: int = 7  # offsets in [-search_radius, search_radius)
    patch_radius: int = 3   # patch taps in [-patch_radius, patch_radius)
    h: float = 0.5
    norm_seed: float = 0.001  # added to normWeight once per frame
    border: str = BorderPolicy.CLAMP
    # Exact fast path when every input's alpha is one constant (see
    # BilateralParams.uniform_alpha); reconstructs wc_alpha = a * (nw - seed).
    uniform_alpha: bool = False
    # APPROXIMATION knob (the NLM analog of the turbo bilateral): evaluate
    # only every search_stride-th candidate offset along each search axis,
    # phase-aligned so the zero offset (the SSD-0 self-match, which anchors
    # the weight normalization) is always in the subset: offsets
    # d in range(search_radius % stride - search_radius, search_radius, stride).
    # 1 = exact reference parity (all 196 candidates); 2 = 49 candidates,
    # ~3.5x faster, quality measured in tests/test_fast.py and docs.
    search_stride: int = 1
    # Second APPROXIMATION knob, composable with search_stride: drop
    # candidates outside the disk dy^2 + dx^2 <= search_radius^2 (the grid's
    # corners: SSD there is largest and the exp weight smallest per
    # candidate evaluated). stride=2 + disk keeps 37 of 196 candidates and
    # measures ~0.7 dB CLOSER to the exact kernel than the 36-candidate
    # radius-6 trim at the same cost, with axis coverage kept at radius 7
    # (round-4 CPU quality screen, tools/quality_ladders_r3.py). The
    # stride^2 importance compensation is unchanged (dropped corners are
    # simply unrepresented, exactly like the radius trim).
    search_disk: bool = False
    # Third APPROXIMATION knob, composable with the other two: compute the
    # per-candidate WEIGHT field at half ROW resolution (2x1-mean-pooled
    # images, kappa=2-scaled 3-row x 2p-lane SSD box, bilinear row
    # upsample with half-pixel centers) while the value taps stay at full
    # resolution. The weight field is a box-filtered (smooth) quantity, so
    # the interpolation sits far inside the turbo budget: measured 41.5 dB
    # vs the exact kernel with stride 2 + disk on both bench gate contents
    # (tools/nlm_hrw_screen_r4.py) -- and the denoising PSNR is marginally
    # ABOVE full-res weights (the weight smoothing regularizes). Cuts the
    # dominant per-candidate VPU work (diff/SSD-box/exp) in half; in the
    # Pallas kernel the row upsample is one small banded bf16 MXU dot per
    # candidate (the slice kernels' pattern), off the VPU critical path.
    # Requires search_stride == 2 (row offsets must be even to land on the
    # half-row lattice) and patch_radius == 3 (the reference value; the
    # 3-row half-window is its 6-row box).
    weights_halfres: bool = False

    @property
    def halo(self) -> int:
        # A tap at search offset s-1 with patch offset p-1 reaches
        # search_radius + patch_radius - 2 forward; -s, -p reach that far back.
        return self.search_radius + self.patch_radius


@dataclasses.dataclass(frozen=True)
class LayersParams(BilateralParams):
    """Layer-guided cross-bilateral (shaders/bialteral_layers.comp).

    Same window/sigmas as the bilateral (pushed at src/main.cpp:875-876), but the
    weights are computed from the G-buffer *layer* image (both the center color
    and the tap color come from layerTex, bialteral_layers.comp:29, 46-51) while
    the accumulated color taps come from the target image
    (bialteral_layers.comp:55). Accumulates (weightColor, normWeight) across one
    dispatch per layer; normalized by the separate normalize pass.
    """


@dataclasses.dataclass(frozen=True)
class NormalizeParams:
    """Normalization pass (shaders/normalize.comp).

    out = weightColor / normWeight, with a magenta debug sentinel (1, 0, 1, 1)
    where normWeight == 0 (shaders/normalize.comp:36-43).
    """

    sentinel_r: float = 1.0
    sentinel_g: float = 0.0
    sentinel_b: float = 1.0
    sentinel_a: float = 1.0


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One denoising run configuration -- the five booleans of RunOnGPU
    (src/main.cpp:1307) plus input path.

    Invariants asserted by the reference (src/main.cpp:1315-1316):
    multiframe => nlm, overlap => multiframe.
    """

    nlm: bool = False            # NLM vs bilateral family
    linear: bool = False         # linear texel-buffer layout vs tiled texture
    multiframe: bool = False     # temporal NLM over neighbor frames
    overlap: bool = False        # copy/compute overlap (double-buffered prefetch)
    use_layers: bool = False     # layer-guided cross-bilateral
    max_frames: int = 10         # framesToUse when multiframe (src/main.cpp:1341)

    def __post_init__(self) -> None:
        assert self.nlm or not self.multiframe, "multiframe requires nlm"
        assert self.multiframe or not self.overlap, "overlap requires multiframe"
        assert not (self.nlm and self.use_layers), "layers path is bilateral-family"

    def output_name(self, hdr: bool) -> str:
        """Flag-encoded output filename, matching src/main.cpp:1677-1682."""
        name = "output"
        name += "-linear" if self.linear else "-nonlinear"
        name += "-nlm" if self.nlm else "-bialteral"  # sic -- reference spelling
        name += "-multiframe" if self.multiframe else ""
        name += "-overlap" if self.overlap else ""
        name += "-layers" if self.use_layers else ""
        name += ".exr" if hdr else ".png"
        return name


#: The fixed battery main() runs, in order (src/main.cpp:1953-1973).
GPU_BATTERY = (
    RunConfig(nlm=False, linear=False),                        # tiled bilateral
    RunConfig(nlm=False, linear=False, use_layers=True),       # bilateral + layers
    RunConfig(nlm=False, linear=True),                         # linear-buffer bilateral
    RunConfig(nlm=True, linear=False),                         # NLM single frame
    RunConfig(nlm=True, linear=False, multiframe=True),        # NLM multiframe
    RunConfig(nlm=True, linear=False, multiframe=True, overlap=True),  # + overlap
)


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Kernel tiling knobs. None = auto-select per image/kernel. The CUDA
    kernels choose their own tiles and read compute_dtype only."""

    tile_h: Optional[int] = None
    tile_w: Optional[int] = None
    # Compute dtype inside kernels. float32 is the parity default; bfloat16 is
    # an opt-in speed mode (costs ~0.5-1 dB of PSNR headroom).
    compute_dtype: str = "float32"
