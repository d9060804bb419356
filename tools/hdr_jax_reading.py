#!/usr/bin/env python3
"""The JAX package's own readings of the approximate configs on
chip_smoke.py's HDR target (phase 10): each bf16-tap and turbo output
against the exact output of its config (the grid configs against the exact
tiled bilateral), in dB over RGB with the exact output's largest RGB value
as the peak, as chip_smoke.py reads the port's.

    JAX_PLATFORMS=cpu python tools/hdr_jax_reading.py

The JAX side runs on the CPU as its tests run it: `tpu-denoise` (its CLI)
with the same flags as the smoke's `gpu-denoise` runs, and its Session with
bf16 taps for the bilateral and layers configs, the Pallas kernels in
interpret mode (a few seconds each at 1080p). On the CPU the JAX package's
turbo bilateral and linear configs take its XLA lattice in float32
(fast.py:211-214); its chip runs the Pallas pipeline (bf16 grid), which the
port's grid kernels port. The tool reads both and prints the Pallas
pipeline's as the reading for those configs, with how far the grid's output
strays from the target where the fireflies stretch its range (its alpha,
1 in the target, and its mean RGB).

Then the port's readings through its plain versions on the CPU
(`gpu-denoise --device cpu`, `Session(tiling=bf16, device="cpu")`), which
the card's kernels meet at the kernel contracts: minutes at 1080p. Prints
one line a reading and, last, the dict chip_smoke.py carries as
JAX_HDR_READINGS_DB.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402  (the smoke's HDR animation and readings)

SIX = ("bilateral", "layers", "linear", "nlm", "multiframe", "overlap")


def _outputs(imageio, out_dir: str, names: dict, keys) -> dict:
    return {k: imageio.load(os.path.join(out_dir, names[k]))[0] for k in keys}


def _readings(exact: dict, outputs: dict) -> dict:
    """{reading name: dB} of each approximate output against its exact one."""
    out = {}
    for name, img in outputs.items():
        key = name.rsplit(" ", 1)[1]
        ref = exact["bilateral" if key == "linear" else key]
        out[name] = smoke.psnr_peak(img, ref, float(ref[..., :3].max()))
    return out


def _range_note(target, out) -> str:
    """How far a grid output strays where fireflies stretch the grid's
    range: the share of pixels whose alpha (1 in the target) leaves 1 by
    more than 0.01, and the mean RGB of target and output."""
    stray = float((abs(out[..., 3] - 1.0) > 0.01).mean())
    return (f"alpha off 1 by > 0.01 on {stray:.4%} of pixels, mean RGB "
            f"{float(target[..., :3].mean()):.4f} -> {float(out[..., :3].mean()):.4f}")


def _run_package(label: str, cli_main, bf16_session, battery, imageio, target: str, root: str,
                 names: dict) -> tuple[dict, dict]:
    """The exact battery, the bf16-tap bilateral and layers configs and the
    turbo runs of one package: cli_main(argv) is its CLI, bf16_session(dir)
    its Session with bf16 taps. Returns (exact outputs, {reading name:
    approximate output})."""
    t0 = time.perf_counter()
    exact_dir = os.path.join(root, f"{label}_exact")
    assert cli_main([target, "--configs", ",".join(SIX), "--output-dir", exact_dir]) == 0
    exact = _outputs(imageio, exact_dir, names, SIX)
    print(f"  {label}: exact battery {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    bf16_dir = os.path.join(root, f"{label}_bf16")
    os.makedirs(bf16_dir)
    session = bf16_session(bf16_dir)
    approx = {f"bf16 {key}": session.run(battery[i]).image
              for i, key in ((0, "bilateral"), (1, "layers"))}
    for name, flags, keys in smoke.HDR_TURBO_RUNS:
        t0 = time.perf_counter()
        out_dir = os.path.join(root, f"{label}_{name.replace(' ', '_')}")
        assert cli_main([target, *flags, "--configs", ",".join(keys), "--output-dir", out_dir]) == 0
        for key, img in _outputs(imageio, out_dir, names, keys).items():
            approx[f"{name} {key}"] = img
        print(f"  {label}: {name} {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return exact, approx


def main() -> int:
    import jax.numpy as jnp
    import numpy as np
    import torch

    from image_denoising_filter_tpu import cli as jcli
    from image_denoising_filter_tpu.config import BilateralParams, GPU_BATTERY
    from image_denoising_filter_tpu.config import TilingConfig as JTiling
    from image_denoising_filter_tpu.ops import fast as jfast
    from image_denoising_filter_tpu.runtime import Session as JSession
    from image_denoising_filter_tpu.utils import imageio as jimageio
    from image_denoising_filter_tpu_torch import cli as pcli
    from image_denoising_filter_tpu_torch.config import GPU_BATTERY as PBATTERY
    from image_denoising_filter_tpu_torch.config import TilingConfig as PTiling
    from image_denoising_filter_tpu_torch.runtime import Session as PSession
    from image_denoising_filter_tpu_torch.utils import imageio as pimageio

    torch.set_num_threads(4)
    names = {k: c.output_name(True) for k, c in zip(SIX, GPU_BATTERY)}
    root = smoke.scratch_dir()
    try:
        anim = smoke.write_hdr_animation(jimageio, smoke.load_render_frame(), root)
        target = anim["target"]
        exact, approx = _run_package(
            "jax", jcli.main,
            lambda out: JSession(target, output_dir=out, warmup=False,
                                 tiling=JTiling(compute_dtype="bfloat16")),
            GPU_BATTERY, jimageio, target, root, names)
        jax_db = _readings(exact, approx)
        # The Pallas pipeline of the bilateral grid, which tpu-denoise runs on
        # its chip (on the CPU it takes the XLA lattice read above).
        planar = jnp.transpose(jnp.asarray(anim["frames"][smoke.TARGET_FRAME]), (2, 0, 1))
        lattice, notes = {}, {}
        for name, flags, keys in smoke.HDR_TURBO_RUNS:
            d = int(flags[1])
            if "bilateral" not in keys or d == 1:
                continue
            bp = BilateralParams(sigma_spatial=float(flags[-1]) if "--sigma-spatial" in flags
                                 else 2.0)
            out = jfast._grid_pipeline_planar(planar, bp, smoke.turbo_levels(d), d)
            out = np.transpose(np.asarray(out), (1, 2, 0))
            for key in ("bilateral", "linear"):
                lattice[f"{name} {key}"] = jax_db[f"{name} {key}"]
                jax_db[f"{name} {key}"] = _readings(exact, {f"{name} {key}": out})[f"{name} {key}"]
            notes[name] = _range_note(anim["frames"][smoke.TARGET_FRAME], out)

        pexact, papprox = _run_package(
            "port", lambda argv: pcli.main([*argv, "--device", "cpu"]),
            lambda out: PSession(target, device="cpu", output_dir=out, warmup=False,
                                 tiling=PTiling(compute_dtype="bfloat16")),
            PBATTERY, pimageio, target, root, names)
        port_db = _readings(pexact, papprox)
        for name in notes:
            print(f"{name} bilateral grid on the target: the JAX Pallas pipeline's "
                  f"{notes[name]}; the port's (plain versions) "
                  f"{_range_note(anim['frames'][smoke.TARGET_FRAME], papprox[name + ' bilateral'])}")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    peak = float(exact["bilateral"][..., :3].max())
    print(f"frame {smoke.W}x{smoke.H}, target {smoke.TARGET_FRAME}, {anim['fireflies']} "
          f"fireflies; peak (the exact tiled bilateral's largest RGB) {peak:.4f}")
    for name in jax_db:
        extra = f" (its CPU XLA lattice {lattice[name]:.4f})" if name in lattice else ""
        print(f"{name}: JAX {jax_db[name]:.4f} dB{extra}; port, plain versions on the CPU "
              f"{port_db[name]:.4f} dB")
    print(json.dumps({k: round(v, 4) for k, v in jax_db.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
