"""The work a step needs, and the least time the card could take for it.

Frozen copy of `chip_smoke.py:kernel_work` (the entries the benchmark's
configurations use) and `chip_smoke.py:bound`, with the data-sheet peaks of
one NVIDIA H100 SXM (3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor
cores). The benchmark counts the work of a whole step from these, so that a
kernel that is fused, split or renamed leaves the count unchanged: each
input of the step read once, its output written once, and the least
arithmetic the filter needs.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12


def kernel_work(name: str, pixels: int, frames: int = 1, cands: int = 0,
                disk: int = 0) -> tuple[int, int]:
    """(bytes, float32 operations) of one call of a kernel's function, as
    `chip_smoke.py:kernel_work` counts them: a multiply-add counts 2, an
    exp2 or a divide 1. An NLM candidate is 24 operations a pixel and frame
    with box sums (squared difference 8, two running sums 4, exponent and
    exp2 3, weighted colour 8, weight 1); a guided bilateral tap 20 (colour
    distance 8, exponent 2, exp2 1, weighted colour 8, weight 1); the
    normalize 5 a pixel (four divides and the sentinel's test)."""
    fcp = frames * cands * pixels
    return {
        "nlm": (20 * pixels + 16 * (frames + 1) * pixels, 24 * fcp),
        "bilateral_guided": (52 * pixels, pixels * 20 * disk),
        "normalize": (36 * pixels, 5 * pixels),
    }[name]


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time in ms the card could take for that work, and what
    bounds it: the larger of the bytes over the memory rate and the
    operations over the float32 rate."""
    mem_ms = nbytes / PEAK_BYTES_S * 1e3
    op_ms = flops / PEAK_FLOPS_S * 1e3
    return max(mem_ms, op_ms), "bytes" if mem_ms >= op_ms else "operations"


def nlm_candidates(search_radius: int) -> int:
    """Search offsets of the exact NLM: the half-open square [-s, s)^2."""
    return (2 * search_radius) ** 2


def disk_taps(radius: int, sigma_spatial: float, truncate_eps: float) -> int:
    """Taps (dy, dx) of the bilateral window, |dy|, |dx| <= radius, whose
    spatial weight exp(-(dy^2 + dx^2) / (2 ss^2)) is at least truncate_eps:
    dy^2 + dx^2 <= 2 ss^2 ln(1 / eps). The whole window at eps 0."""
    if truncate_eps <= 0.0:
        return (2 * radius + 1) ** 2
    r2 = 2.0 * sigma_spatial * sigma_spatial * math.log(1.0 / truncate_eps)
    return sum(1 for dy in range(-radius, radius + 1) for dx in range(-radius, radius + 1)
               if dy * dy + dx * dx <= r2)
