#!/usr/bin/env python3
"""Time the redesigned kernels of two checkouts of the port on one card, the
same way and in turns, and compare their outputs bit for bit.

    git archive <commit> | tar -x -C build/ab_base    # the other checkout
    python3 tools/torch_kernel_ab.py --baseline build/ab_base

Each side runs in a process of its own from its own root: its package, its
kernels built from its own sources into its own build/. The order is
baseline, this checkout, this checkout, baseline. Every process times with
this checkout's chip_smoke.py:median_ms (device time only: a spin kernel
holds the stream while the host enqueues the call), at 1920x1080 on random
frames (seed 0) with the reference parameters:

  nlm        F=1, the target as its own frame (s=7, p=3, 196 candidates)
  nlm F=6    six frames
  nlm_bf16   F=1, bf16 taps, stride 2 (49 candidates)
  nlm p=5    F=1, patch radius 5
  normalize  wc / nw with a sentinel where nw == 0
  divide     the broadcast divide wc / nw[..., None] (no sentinel)
  nlm_hrw, nlm_hrw_bf16
             the half-row NLM, F=1, stride 2 (49 candidates), float32 and
             bf16 taps, on a smooth frame (seed 0) where the weights carry
  build_guided 4K d=2 K=5
             the guided grid build of a 3840x2160 target and layer pooled at
             d=2 (9 blur taps at sigma_s 2), 5 levels
  build_guided 1080p d=1 K=6
             the same at the main path's --turbo 1 shape: 1920x1080 at d=1
             (17 blur taps), 6 levels
  build_guided 1080p d=1 K=6 HDR
             the same on an HDR render at 1920x1080 (t=0.5, seed 0) with
             chip_smoke.py's fireflies, and its albedo layer, as phase 10
             builds its target
  build_grid 4K d=2 K=5, d=4 K=5, d=8 s6 K=6
             the bilateral grid build of chip_smoke.py's noisy 3840x2160
             frame pooled at d (9, 5 and, at sigma_s 6, 7 blur taps)
  build_grid 1080p d=1 K=6, d=1 s6 K=6
             the bilateral grid build of chip_smoke.py's 1920x1080 render
             at d=1 (the sharded --turbo 1's form), 17 and, at sigma_s 6, 49
             blur taps
  fused_grid 4K d=2 K=5, d=4 K=5, d=8 s6 K=6
             the fused bilateral build + slice of that frame at the same
             settings, as grid_pipeline(fused=True) runs it
  two_kernel_grid 4K d=2 K=5, d=4 K=5, d=8 s6 K=6
             the same output through build_grid + slice_grid
  fused_guided 4K d=2 K=5, d=4 K=5
             the fused guided build + slice of that frame (target) and its
             albedo layer, as chip_smoke.py's phase 6 runs it
  two_kernel 4K d=2 K=5, d=4 K=5
             the same partials through build_guided_grid + slice_guided_grid
  slice_grid 1080p d=1 K=6, 4K d=2 K=5
             the bilateral grid's slice alone, on a grid that
             build_grid_plain makes (the same bytes on both sides, whatever
             their build kernels): chip_smoke.py's render at 1920x1080
             (t=0.5, seed 0) at d=1 (the sharded --turbo 1's form, 17 taps),
             and its noisy 3840x2160 frame at d=2 (9 taps)
  slice_guided 1080p d=1 K=6, 4K d=2 K=5
             the guided slice alone, likewise on a build_guided_grid_plain
             grid, each frame the target and its albedo the layer (d=1: the
             --turbo 1 layers' form)
  bilateral, bilateral_guided (and each with " ua")
             the exact bilateral with its normalize fused and the layers
             config's guided partials (the second random frame as the
             layer), reference parameters (radius 20, disk radius 12), with
             alpha accumulated and with uniform alpha (the main path's: the
             frames' alpha is 1)
  bilateral_bf16, bilateral_guided_bf16 (and each with " ua")
             the same with bf16 taps, on trees that have them

Each process also hashes the output of every case but the divide (SHA-256
of its bytes); the summary says for each whether the two sides' outputs are
equal bit for bit.

The pool kernel has no case: no redesign has touched it. One would need
only the frame (pool(noisy, d, clamp) at 4K d=2, 4, 8 and on the 1080p
render at d=1, the d=1 pool being a bf16 round trip) and, to time the
kernel and not the cache, a frame larger than L2 at each d.

This checkout's processes also read the SM clock with nvidia-smi while the
nlm kernel runs back to back (with --only, the first case it times), and
turn the nlm time into cycles a tile and candidate on each SM, and a 512
outputs (a 16x32 tile) and candidate, which compares tiles of two shapes.
Prints one JSON line a run, the median of each side's two runs and the
nvidia-smi line; --out PATH also writes them to PATH as JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 1080, 1920


def load_smoke():
    """This checkout's chip_smoke.py, loaded by file path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sm_clock_mhz(torch, fn, seconds: float = 2.0) -> float:
    """Median SM clock nvidia-smi reads every 100 ms while fn() runs back to
    back for `seconds`."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True,
    )
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate(timeout=30)[0]
    readings = [float(x) for x in out.split() if x.strip()]
    # drop the first and last reading, taken around the loop's edges
    return statistics.median(readings[1:-1] if len(readings) > 2 else readings)


def worker(root: str, only: tuple = ("",)) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from image_denoising_filter_tpu_torch import config as cfg
    from image_denoising_filter_tpu_torch.ops import _build, fast, stencils

    package = os.path.dirname(os.path.dirname(os.path.abspath(stencils.__file__)))
    assert os.path.samefile(os.path.dirname(package), root), stencils.__file__
    smoke = load_smoke()
    _build.build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 1, (6, H, W, 4)).astype(np.float32)).to(dev)
    frames[..., 3] = 1.0
    target = frames[0]
    wc = torch.from_numpy(rng.uniform(0, 5, (H, W, 4)).astype(np.float32)).to(dev)
    nw = torch.from_numpy(rng.uniform(0.5, 1.5, (H, W)).astype(np.float32)).to(dev)
    nw[::97, ::89] = 0.0
    nw_b = nw[..., None]
    bf16 = cfg.TilingConfig(compute_dtype="bfloat16")
    ref, turbo, p5 = cfg.NlmParams(), cfg.NlmParams(search_stride=2), cfg.NlmParams(patch_radius=5)
    hrw = cfg.NlmParams(search_stride=2, weights_halfres=True)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([0.5 + 0.4 * np.sin(xx / 23.0), 0.5 + 0.4 * np.cos(yy / 17.0),
                       np.where(xx > W / 2, 0.8, 0.2), np.ones((H, W))], -1)
    smooth[..., :3] += rng.normal(0, 0.05, (H, W, 3))
    smooth = torch.from_numpy(np.clip(smooth, 0, 1).astype(np.float32)).to(dev)
    # The builds take the downsample on trees whose wrappers have it (the
    # d = 1 body's dispatch)
    takes_d = "d" in inspect.signature(fast.build_grid).parameters

    def downsample(d):
        return {"d": d} if takes_d else {}

    guided = {}
    for key, h, w, d, levels in (("4K d=2 K=5", 2160, 3840, 2, 5), ("1080p d=1 K=6", H, W, 1, 6)):
        imgs = torch.from_numpy(rng.uniform(0, 1, (2, h, w, 4)).astype(np.float32)).to(dev)
        small_t = fast.pool_plain(imgs[0], d, cfg.BorderPolicy.CLAMP)
        small_l = fast.pool_plain(imgs[1], d, cfg.BorderPolicy.CLAMP)
        guided[key] = ((small_t, small_l, *fast.grid_range(small_l, levels), levels,
                        fast._grid_taps(2.0, d), cfg.BorderPolicy.CLAMP, 12.5), d)
    noisy, layers = smoke.load_render_frame()(0.5, 2160, 3840, np.random.default_rng(smoke.SEED),
                                              noise=smoke.NOISE)
    noisy = torch.from_numpy(noisy).to(dev)
    albedo = torch.from_numpy(np.ascontiguousarray(np.clip(layers["albedo"], 0, 1))).to(dev)
    clamp = cfg.BorderPolicy.CLAMP
    grid_cases, fused_grid_cases, fused_cases = {}, {}, {}
    for key, d, levels, sigma_s in (("4K d=2 K=5", 2, 5, 2.0), ("4K d=4 K=5", 4, 5, 2.0),
                                    ("4K d=8 s6 K=6", 8, 6, 6.0)):
        small = fast.pool_plain(noisy, d, clamp)
        grid_cases[key] = ((small, *fast.grid_range(small, levels), levels,
                            fast._grid_taps(sigma_s, d), clamp, 12.5), d)
        lmin, step = grid_cases[key][0][1:3]
        fused_grid_cases[key] = (small, noisy, lmin, step, 1.0 / step, *grid_cases[key][0][3:],
                                 d)
        if d in (2, 4):
            small_l = fast.pool_plain(albedo, d, clamp)
            lmin, step = fast.grid_range(small_l, levels)
            fused_cases[key] = (small, small_l, albedo, lmin, step, 1.0 / step, levels,
                                fast._grid_taps(sigma_s, d), clamp, 12.5, d)

    # The slices alone, on plain-built grids: (guide, grid, lmin, inv_step, d)
    slice_cases, slice_guided_cases = {}, {}
    frame_1080, layers_1080 = smoke.load_render_frame()(0.5, H, W,
                                                        np.random.default_rng(smoke.SEED),
                                                        noise=smoke.NOISE)
    frame_1080 = torch.from_numpy(frame_1080).to(dev)
    albedo_1080 = torch.from_numpy(
        np.ascontiguousarray(np.clip(layers_1080["albedo"], 0, 1))).to(dev)
    small = fast.pool_plain(frame_1080, 1, clamp)
    for key, sigma_s in (("1080p d=1 K=6", 2.0), ("1080p d=1 s6 K=6", 6.0)):
        grid_cases[key] = ((small, *fast.grid_range(small, 6), 6, fast._grid_taps(sigma_s, 1),
                            clamp, 12.5), 1)
    hdr_1080, hdr_layers = smoke.load_render_frame()(0.5, H, W, np.random.default_rng(smoke.SEED),
                                                     noise=smoke.NOISE, hdr=True)
    fire = np.random.default_rng(smoke.SEED + 1).choice(
        H * W, round(smoke.HDR_FIREFLY_SHARE * H * W), replace=False)
    hdr_1080.reshape(-1, 4)[fire, :3] *= np.float32(smoke.HDR_FIREFLY_GAIN)
    small_t = fast.pool_plain(torch.from_numpy(hdr_1080).to(dev), 1, clamp)
    small_l = fast.pool_plain(torch.from_numpy(
        np.ascontiguousarray(np.clip(hdr_layers["albedo"], 0, 1))).to(dev), 1, clamp)
    guided["1080p d=1 K=6 HDR"] = ((small_t, small_l, *fast.grid_range(small_l, 6), 6,
                                    fast._grid_taps(2.0, 1), clamp, 12.5), 1)
    for key, img, layer, d, levels in (("1080p d=1 K=6", frame_1080, albedo_1080, 1, 6),
                                       ("4K d=2 K=5", noisy, albedo, 2, 5)):
        taps = fast._grid_taps(2.0, d)
        small = fast.pool_plain(img, d, clamp)
        lmin, step = fast.grid_range(small, levels)
        grid = fast.build_grid_plain(small, lmin, step, levels, taps, clamp, 12.5)
        slice_cases[key] = (img, grid, lmin, 1.0 / step, d)
        small_l = fast.pool_plain(layer, d, clamp)
        lmin, step = fast.grid_range(small_l, levels)
        grid = fast.build_guided_grid_plain(small, small_l, lmin, step, levels, taps, clamp, 12.5)
        slice_guided_cases[key] = (layer, grid, lmin, 1.0 / step, d)

    def two_kernel_grid(small, img, lmin, step, inv_step, levels, taps, border, inv2sc, d):
        grid = fast.build_grid(small, lmin, step, levels, taps, border, inv2sc, **downsample(d))
        return fast.slice_grid(img, grid, lmin, inv_step, d)

    def two_kernels(small_t, small_l, guide, lmin, step, inv_step, levels, taps, border,
                    inv2sc, d):
        grid = fast.build_guided_grid(small_t, small_l, lmin, step, levels, taps, border, inv2sc,
                                      **downsample(d))
        return fast.slice_guided_grid(guide, grid, lmin, inv_step, d)

    cases = {
        "nlm": (lambda: stencils.nlm_accumulate(target, target, ref), 10),
        "nlm F=6": (lambda: stencils.nlm_accumulate_frames(target, frames, ref), 5),
        "nlm_bf16": (lambda: stencils.nlm_accumulate(target, target, turbo, bf16), 10),
        "nlm p=5": (lambda: stencils.nlm_accumulate(target, target, p5), 5),
        "normalize": (lambda: stencils.normalize(wc, nw), 50),
        "divide": (lambda: wc / nw_b, 50),
        "nlm_hrw": (lambda: stencils.nlm_accumulate(smooth, smooth, hrw), 10),
        "nlm_hrw_bf16": (lambda: stencils.nlm_accumulate(smooth, smooth, hrw, bf16), 10),
        **{f"build_guided {key}": (lambda a=args, d=d: fast.build_guided_grid(*a, **downsample(d)),
                                   10)
           for key, (args, d) in guided.items()},
        **{f"build_grid {key}": (lambda a=args, d=d: fast.build_grid(*a, **downsample(d)), 10)
           for key, (args, d) in grid_cases.items()},
        **{f"fused_grid {key}": (lambda a=args: fast.fused_grid(*a), 10)
           for key, args in fused_grid_cases.items()},
        **{f"two_kernel_grid {key}": (lambda a=args: two_kernel_grid(*a), 10)
           for key, args in fused_grid_cases.items()},
        **{f"fused_guided {key}": (lambda a=args: fast.fused_guided(*a), 10)
           for key, args in fused_cases.items()},
        **{f"two_kernel {key}": (lambda a=args: two_kernels(*a), 10)
           for key, args in fused_cases.items()},
        **{f"slice_grid {key}": (lambda a=args: fast.slice_grid(*a), 10)
           for key, args in slice_cases.items()},
        **{f"slice_guided {key}": (lambda a=args: fast.slice_guided_grid(*a), 10)
           for key, args in slice_guided_cases.items()},
    }
    layer = frames[1]
    for name, bp, lp in (("", cfg.BilateralParams(), cfg.LayersParams()),
                         (" ua", cfg.BilateralParams(uniform_alpha=True),
                          cfg.LayersParams(uniform_alpha=True))):
        forms = [("", None)] + ([("_bf16", bf16)] if hasattr(stencils, "bilateral_tile") else [])
        for suffix, tiling in forms:
            cases[f"bilateral{suffix}{name}"] = (
                lambda p=bp, t=tiling: stencils.bilateral(target, p, t), 10)
            cases[f"bilateral_guided{suffix}{name}"] = (
                lambda p=lp, t=tiling: stencils.cross_bilateral_layers(target, layer, p, t), 10)
    out = {"root": root, "digests": {}}
    for name, (fn, reps) in cases.items():
        if not name.startswith(only):
            continue
        result = fn()  # first call: module load, shared-memory opt-in
        torch.cuda.synchronize()
        if name != "divide":
            digest = hashlib.sha256()
            for t in result if isinstance(result, tuple) else (result,):
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            out["digests"][name] = digest.hexdigest()
        out[name] = smoke.median_ms(torch, fn, reps)
    timed = [name for name in cases if name.startswith(only)]
    if hasattr(stencils, "nlm_tile") and only != ("",) and timed:
        # the SM clock while the first case timed runs
        out["sm_clock_mhz"] = sm_clock_mhz(torch, cases[timed[0]][0])
    if hasattr(stencils, "nlm_tile") and only == ("",):
        mhz = sm_clock_mhz(torch, cases["nlm"][0])
        tile = stencils.nlm_tile(ref, False, stencils.max_shared_bytes(dev))
        tiles = -(-H // tile.th) * -(-W // tile.tw)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out["sm_clock_mhz"] = mhz
        out["nlm cycles a tile-candidate a SM"] = (
            out["nlm"] * 1e-3 * mhz * 1e6 * sms / (tiles * len(stencils.nlm_candidates(ref))))
        # per 512 outputs (a 16x32 tile), whatever the side's tile
        out["nlm cycles a 512-output candidate a SM"] = (
            out["nlm"] * 1e-3 * mhz * 1e6 * sms * 512 / (H * W * len(stencils.nlm_candidates(ref))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="root of the other checkout")
    ap.add_argument("--out", help="write the runs and medians to this JSON file")
    ap.add_argument("--only", default="",
                    help="time only the cases whose name starts with one of these "
                         "comma-separated prefixes")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.worker), tuple(args.only.split(",")))))
        return 0
    if not args.baseline:
        ap.error("--baseline is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    base = os.path.abspath(args.baseline)
    runs = []
    for side, root in (("baseline", base), ("this", REPO), ("this", REPO), ("baseline", base)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               "--only", args.only], capture_output=True, text=True, timeout=1200)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"{side} run failed with code {proc.returncode}")
        run = {"side": side, **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(run))
        runs.append(run)
    keys = list(dict.fromkeys(k for r in runs for k in r if k not in ("side", "root", "digests")))
    summary = {
        side: {k: statistics.median(r[k] for r in runs if r["side"] == side and k in r)
               for k in keys if any(r["side"] == side and k in r for r in runs)}
        for side in ("baseline", "this")
    }
    for k in keys:
        print(f"{k:34s} baseline {summary['baseline'].get(k, float('nan')):.4f}  "
              f"this {summary['this'].get(k, float('nan')):.4f}")
    # Each side's runs agree with themselves; the two sides bit for bit?
    digests = {side: [r["digests"] for r in runs if r["side"] == side]
               for side in ("baseline", "this")}
    bitwise = {}
    for name in digests["this"][0]:
        seen = {side: {d.get(name) for d in ds} for side, ds in digests.items()}
        if seen["baseline"] == {None}:
            print(f"{name:34s} outputs on this side only")
            continue
        bitwise[name] = seen["baseline"] == seen["this"] and len(seen["this"]) == 1
        print(f"{name:34s} outputs {'equal' if bitwise[name] else 'DIFFER'} bit for bit")
    summary["bit_for_bit"] = bitwise
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
