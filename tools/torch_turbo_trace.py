#!/usr/bin/env python3
"""Where the exec time of `gpu-denoise --turbo D`'s grid configs goes on the card.

    python3 tools/torch_turbo_trace.py [--turbo 1] [--runs 3] [--out FILE]

On chip_smoke.py's 1080p animation (seed 0; the target's albedo, normal and
depth layers) it:
  1. runs `gpu-denoise --turbo D --configs bilateral,linear,layers --device
     cuda --clamp` --runs times in this process and prints each config's exec
     ns as PRINT_TIME reports it (host clock around the fenced call);
  2. times the function each config's exec region calls, outside the CLI:
     the host clock around one call and a synchronize (median of 5), and the
     device time of the call (chip_smoke.median_ms, median of 5);
  3. for the layers config, the device time of each stage of one layer
     (the two pools, the grid range, the guided build, the guided slice) and
     of the final divide;
  4. torch.profiler's device time of one call of each function, per kernel
     (key_averages), the ten largest.
Then the nvidia-smi line and one JSON line with the numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """This checkout's chip_smoke.py, loaded by file path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_ms(torch, fn, reps: int = 5) -> float:
    """Median host time of fn() and a synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(torch, fn, top: int = 10) -> list:
    """(kernel, device ms, calls) of one fn() call, the `top` largest."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as run_profiler

    fn()
    torch.cuda.synchronize()
    with run_profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.key.split("(")[0] not in ("cudaLaunchKernel", "cudaDeviceSynchronize"):
            rows.append((ev.key[:70], dev_us / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])[:top]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turbo", type=int, default=1)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_turbo_trace: no CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke()
    sys.path.insert(0, REPO)
    from image_denoising_filter_tpu_torch import cli
    from image_denoising_filter_tpu_torch import config as cfg
    from image_denoising_filter_tpu_torch.ops import _build, fast
    from image_denoising_filter_tpu_torch.utils import imageio

    _build.build()
    d = args.turbo
    levels = smoke.turbo_levels(d)
    root = smoke.scratch_dir()
    result = {"turbo": d, "levels": levels, "cli_exec_ms": {}, "host_ms": {}, "device_ms": {},
              "layer_stages_ms": {}, "profile": {}}
    try:
        anim = smoke.write_animation(imageio, smoke.load_render_frame(), root)
        # 1. The CLI's own exec readings.
        for run in range(args.runs):
            rc, text, err = smoke.run_cli(cli, [
                anim["target"], "--device", "cuda", "--clamp", "--turbo", str(d), "--configs",
                ",".join(cli.GRID_CONFIGS), "--output-dir", os.path.join(root, f"out{run}")])
            if rc != 0:
                raise RuntimeError(f"gpu-denoise failed ({rc}): {err.strip()}")
            execs = [int(ex) / 1e6 for _, ex in
                     re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", text)]
            # gpu-denoise runs (and reports) the configs in its own order
            for key, ms in zip([k for k in cli.CONFIG_KEYS if k in cli.GRID_CONFIGS], execs):
                result["cli_exec_ms"].setdefault(key, []).append(ms)
        print(f"gpu-denoise --turbo {d} exec ms, {args.runs} runs: {result['cli_exec_ms']}")

        # 2. The exec regions' functions, outside the CLI.
        layer_dir = os.path.join(os.path.dirname(anim["target"]), "RenderElements")
        dev = torch.device("cuda")
        target = torch.from_numpy(anim["frames"][smoke.TARGET_FRAME]).to(dev)
        layers = [torch.from_numpy(imageio.load(os.path.join(layer_dir, name))[0]).to(dev)
                  for name in sorted(os.listdir(layer_dir))]
        bp, lp = cfg.BilateralParams(), cfg.LayersParams()

        def bilateral():
            return fast.bilateral_fast(target, bp, levels, d)

        def layers_config():
            h, w, _ = target.shape
            wc = torch.zeros((h, w, 4), dtype=torch.float32, device=dev)
            nw = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
            for layer in layers:
                pwc, pnw = fast.cross_bilateral_layers_fast(target, layer, lp, levels, d)
                wc += pwc
                nw += pnw
            return fast.normalize_layers_fast(wc, nw)

        for name, fn in (("bilateral", bilateral), ("layers", layers_config)):
            result["host_ms"][name] = host_ms(torch, fn)
            result["device_ms"][name] = smoke.median_ms(torch, fn, 5)
            result["profile"][name] = profile(torch, fn)
            print(f"{name}: host {result['host_ms'][name]:.4f} ms, device "
                  f"{result['device_ms'][name]:.4f} ms; profiler, device ms by kernel:")
            for key, ms, calls in result["profile"][name]:
                print(f"    {ms:9.4f} ms  x{calls:<4d} {key}")

        # 3. One layer's stages, and the final divide.
        taps = fast._grid_taps(lp.sigma_spatial, d)
        small_t = fast.pool(target, d, lp.border)
        small_l = fast.pool(layers[0], d, lp.border)
        lmin, step = fast.grid_range(small_l, levels)
        inv2sc = 0.5 / lp.sigma_color**2
        grid = fast.build_guided_grid(small_t, small_l, lmin, step, levels, taps, lp.border,
                                      inv2sc, d=d)
        wc, nw = fast.slice_guided_grid(layers[0], grid, lmin, 1.0 / step, d)
        stages = {
            "pool x2": lambda: (fast.pool(target, d, lp.border),
                                fast.pool(layers[0], d, lp.border)),
            "grid_range": lambda: fast.grid_range(small_l, levels),
            "build_guided_grid": lambda: fast.build_guided_grid(
                small_t, small_l, lmin, step, levels, taps, lp.border, inv2sc, d=d),
            "slice_guided_grid": lambda: fast.slice_guided_grid(layers[0], grid, lmin,
                                                                1.0 / step, d),
            "normalize_layers_fast": lambda: fast.normalize_layers_fast(wc, nw),
        }
        for name, fn in stages.items():
            result["layer_stages_ms"][name] = smoke.median_ms(torch, fn, 5)
        print("layers, one layer's stages, device ms:",
              {k: round(v, 4) for k, v in result["layer_stages_ms"].items()})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    smi = smoke.nvidia_smi_line()
    result["card"] = smi
    print(smi)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if np.isfinite(list(result["host_ms"].values())).all() else 1


if __name__ == "__main__":
    sys.exit(main())
