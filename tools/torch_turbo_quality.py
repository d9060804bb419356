#!/usr/bin/env python3
"""PSNR of the PyTorch port's --turbo outputs against its exact outputs and
against the clean render, on chip_smoke.py's 1080p animation.

    python tools/torch_turbo_quality.py [--device cpu|cuda] [--threads N]

Writes the smoke's animation, runs `gpu-denoise` for the exact configs and
then chip_smoke.turbo_battery, the smoke's own turbo runs and readings, and
prints each output's PSNR against the clean render and against the exact
output of its config, over RGBA as the smoke's bilateral gate reads it and
over RGB as the JAX package's tests do. With --device cpu the kernels' plain
versions run, so the readings are what the smoke's gates should see on the
card. Imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402  (the smoke's animation, runs and PSNR)

EXACT = ("bilateral", "layers") + smoke.NLM_CONFIGS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--threads", type=int, default=4, help="torch CPU threads")
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(args.threads)
    from image_denoising_filter_tpu_torch import cli
    from image_denoising_filter_tpu_torch import config as cfg
    from image_denoising_filter_tpu_torch.utils import imageio

    root = smoke.scratch_dir()
    try:
        anim = smoke.write_animation(imageio, smoke.load_render_frame(), root)
        noisy = anim["frames"][smoke.TARGET_FRAME]
        print(f"device {args.device}; noisy target vs clean "
              f"{smoke.psnr(noisy, anim['clean']):.2f} dB")

        def run(argv):
            t0 = time.perf_counter()
            result = smoke.run_cli(cli, argv)
            print(f"{' '.join(argv[4:-2])}: {time.perf_counter() - t0:.1f} s")
            return result

        exact_dir = os.path.join(root, "exact")
        rc, _, err = run([anim["target"], "--device", args.device, "--clamp", "--configs",
                          ",".join(EXACT), "--output-dir", exact_dir])
        smoke.check(rc == 0, f"gpu-denoise exact configs failed ({rc}): {err.strip()}")
        names = smoke.output_names(cli, cfg)
        exact = {k: imageio.load(os.path.join(exact_dir, names[k]))[0] for k in EXACT}
        for key in EXACT:
            print(f"  exact {key:10s} vs clean {smoke.psnr(exact[key], anim['clean']):.2f} dB")
        for *_, readings in smoke.turbo_battery(cli, cfg, imageio, anim, root, exact,
                                                args.device, run):
            for key, (_, db_clean, db_exact, db_rgb) in readings.items():
                print(f"  turbo {key:10s} vs clean {db_clean:.2f} dB, "
                      f"vs exact {db_exact:.2f} dB (RGB {db_rgb:.2f})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
