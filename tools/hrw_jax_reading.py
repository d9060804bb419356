#!/usr/bin/env python3
"""The JAX package's own reading of the half-row NLM on chip_smoke.py's 1080p
target frame: PSNR over RGB of the single-frame NLM with a stride-2 search
and half-row weights (`--turbo 2 --weights-halfres`) against the exact NLM,
both through the JAX package's XLA oracle (ops/xla.py:nlm_xla, float32) and
its normalize, each saved as 8-bit values with --clamp, as chip_smoke.py's
phase 7 reads the port's output files against phase 4's.

    JAX_PLATFORMS=cpu python tools/hrw_jax_reading.py

The Pallas kernel in interpret mode is too slow at 1080p on the CPU; the
oracle computes the same weights in float32 (tests/test_kernels.py holds the
two to rtol 1e-5). Also prints the stride-2 NLM without half-row weights,
and the PyTorch port's half-row NLM (its plain versions on the CPU, float32
and bf16 taps) read against the same exact output.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402  (the smoke's animation and PSNR)


def main() -> int:
    import numpy as np
    import torch

    from image_denoising_filter_tpu.config import NlmParams, NormalizeParams
    from image_denoising_filter_tpu.ops import xla
    from image_denoising_filter_tpu.utils import imageio
    from image_denoising_filter_tpu_torch import config as tcfg
    from image_denoising_filter_tpu_torch.ops import stencils

    root = smoke.scratch_dir()
    try:
        anim = smoke.write_animation(imageio, smoke.load_render_frame(), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    target = anim["frames"][smoke.TARGET_FRAME]

    def saved(params):
        t0 = time.perf_counter()
        wc, nw = xla.nlm_xla(target, target, params)
        out = np.asarray(xla.normalize_xla(wc, nw, NormalizeParams()))
        print(f"  {params}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        return imageio.to_float(imageio.quantize(out, clamp=True))

    exact = saved(NlmParams())
    print(f"frame {smoke.W}x{smoke.H}, target {smoke.TARGET_FRAME}; "
          f"noisy vs clean {smoke.psnr(target, anim['clean']):.4f} dB")
    for name, params in (
        ("stride 2", NlmParams(search_stride=2)),
        ("stride 2, half-row weights", NlmParams(search_stride=2, weights_halfres=True)),
    ):
        out = saved(params)
        print(f"{name}: vs exact {smoke.psnr(out[..., :3], exact[..., :3]):.4f} dB (RGB), "
              f"vs clean {smoke.psnr(out, anim['clean']):.4f} dB")
    img = torch.from_numpy(target)
    hrw = tcfg.NlmParams(search_stride=2, weights_halfres=True)
    for name, tiling in (("float32", None), ("bf16", tcfg.TilingConfig(compute_dtype="bfloat16"))):
        wc, nw = stencils.nlm_accumulate(img, img, hrw, tiling)
        out = imageio.to_float(imageio.quantize(stencils.normalize(wc, nw).numpy(), clamp=True))
        print(f"port, half-row weights, {name} taps (plain versions, CPU): vs exact "
              f"{smoke.psnr(out[..., :3], exact[..., :3]):.4f} dB (RGB), "
              f"vs clean {smoke.psnr(out, anim['clean']):.4f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
