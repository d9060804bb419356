#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (image_denoising_filter_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, one line or block each:
  1. device  -- the card, as nvidia-smi gives its name and power limit;
  2. build   -- the kernels compiled from ops/csrc with nvcc, one process
                per source, all at once;
  3. kernels -- each exact-battery CUDA kernel against its plain PyTorch
                version on the card at 1920x1080, with max errors and
                median times;
  4. battery -- a 1080p animation (5 frames + albedo/normal/depth layers)
                through `gpu-denoise` (cli.main) on the card, the launch
                counts of that run, and the checks on its outputs;
  5. turbo kernels -- the bilateral grid's pool, build and slice kernels
                and the whole grid pipeline against their plain versions at
                3840x2160, for (D, K) = (2, 5), (4, 5), (8, 6), and on the
                1080p target at each setting of phase 6, with median times
                at 4K (2, 5) and the pipeline's Mpix/s at each D;
  6. turbo battery -- `gpu-denoise --turbo D --configs bilateral,linear` on
                the 1080p target for D = 1 (the eager lattice), 2, 4 and 8
                (sigma_s 6), the launch counts of each run, and the PSNR of
                its output against the clean render and against phase 4's
                exact bilateral.
Then one JSON line with every kernel's launches, error and times, the
nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero without printing a result; so does a
machine without a CUDA device, or a directory that holds this file alone.
The script imports no JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
H, W = 1080, 1920
N_FRAMES = 5
TARGET_FRAME = 3
NOISE = 0.08
SEED = 0
KERNEL_SOURCE = "image_denoising_filter_tpu_torch/ops/csrc/stencils.cu"
FAST_SOURCE = "image_denoising_filter_tpu_torch/ops/csrc/fast.cu"
JAX_STENCILS = "image_denoising_filter_tpu/ops/stencils.py"
JAX_FAST = "image_denoising_filter_tpu/ops/fast.py"
# Tolerances: the repo's exact-kernel contract (rtol 1e-4 / atol 1e-5); NLM at
# the full reference parameters sums 196 candidates x 36 taps in another
# order than the plain version, hence rtol 2e-4 / atol 1e-4
# (tests/test_kernels.py); normalize is one IEEE division, held to 1 ulp.
TOL_BILATERAL = dict(rtol=1e-4, atol=1e-5)
TOL_NLM = dict(rtol=2e-4, atol=1e-4)
# Turbo grid: pool reproduces the plain version's bf16 casts and exact sums
# (rtol 1e-6); the slice computes the plain version's formula on the same
# grid (rtol 1e-5 / atol 1e-6); the build is held to the stored-grid bf16
# contract (at most 2 bf16 ulps, at most 1% of cells off), and so the whole
# pipeline to 2 bf16 ulps at values up to 1 (2 * 2^-8), with at most 1% of
# pixels beyond 1e-5.
TOL_POOL = dict(rtol=1e-6, atol=0.0)
TOL_SLICE = dict(rtol=1e-5, atol=1e-6)
H4K, W4K = 2160, 3840
TURBO_CELLS = ((2, 5), (4, 5), (8, 6))  # (D, K): run_turbo's K at each D
# The turbo battery: D and --sigma-spatial (D=8 is gated in the JAX package
# only from sigma_s ~5-6 up, hence sigma_s 6 there). D=1 is the eager
# lattice and launches no kernel. Phase 5 also holds the kernels to their
# plain versions at each of these settings on the same 1080p target.
TURBO_RUNS = ((1, 2.0), (2, 2.0), (4, 2.0), (8, 6.0))
# PSNR of the D=2 turbo output against the exact tiled bilateral: the repo's
# 40 dB gate (bench.py:51, tests/test_fast.py:28).
TURBO_GATE_DB = 40.0


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def turbo_levels(d: int) -> int:
    """K as Session.run_turbo resolves levels=None."""
    return 5 if d in (2, 4) else 6


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def load_render_frame():
    """tools/make_dataset.render_frame, loaded by file path (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "make_dataset", os.path.join(REPO, "tools", "make_dataset.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_frame


def median_ms(torch, fn, reps: int) -> float:
    """Median CUDA-event time of fn() after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(torch, got, want) -> tuple[float, float]:
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp_min(1e-30)).max())


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return math.inf if mse == 0.0 else 10.0 * math.log10(1.0 / mse)


def scratch_dir() -> str:
    """A fresh directory whose path holds no '.': dataset.frame_id reads the
    four characters before the first dot of the whole path."""
    for base in (tempfile.gettempdir(), os.path.join(REPO, "build")):
        if "." not in base:
            os.makedirs(base, exist_ok=True)
            path = tempfile.mkdtemp(prefix="idf_smoke_", dir=base)
            if "." not in path:
                return path
            shutil.rmtree(path)
    raise SmokeError("no scratch directory without a '.' in its path")


def phase_kernels(torch, stencils, cfg, frames_np, layer_np):
    """Each kernel against its plain version on the card, at the main path's
    shapes. Returns {kernel: {max_abs_err, ms, plain_ms}}."""
    dev = torch.device("cuda")
    target = torch.from_numpy(frames_np[TARGET_FRAME]).to(dev)
    layer = torch.from_numpy(layer_np).to(dev)
    frames6 = torch.from_numpy(np.stack([frames_np[TARGET_FRAME], *frames_np])).to(dev)
    valid6 = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0], device=dev)
    results = {}

    def record(kernel, case, got, want, tol=None, ulps=None):
        if isinstance(got, tuple):
            pairs = list(zip(got, want))
        else:
            pairs = [(got, want)]
        worst_abs = worst_rel = 0.0
        for g, w in pairs:
            torch.cuda.synchronize()
            check(bool(torch.isfinite(g).all()), f"{kernel} {case}: non-finite output")
            a, r = errors(torch, g, w)
            worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
            if tol is not None:
                ok = bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all())
                check(ok, f"{kernel} {case}: max abs {a:.3g} rel {r:.3g} beyond {tol}")
            if ulps is not None:
                d = int((g.view(torch.int32) - w.view(torch.int32)).abs().max())
                check(d <= ulps, f"{kernel} {case}: {d} ulp apart")
        entry = results.setdefault(kernel, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], worst_abs)
        print(f"  {kernel:17s} {case:28s} max abs {worst_abs:.3g}  max rel {worst_rel:.3g}")

    bp = cfg.BilateralParams()
    for case, p in [
        ("defaults", bp),
        ("blue_bug", cfg.BilateralParams(blue_bug=True)),
        ("zero border", cfg.BilateralParams(border=cfg.BorderPolicy.ZERO)),
        ("uniform_alpha", cfg.BilateralParams(uniform_alpha=True)),
    ]:
        record("bilateral", case, stencils.bilateral(target, p),
               stencils.bilateral_plain(target, None, p, True)[0], TOL_BILATERAL)
    lp = cfg.LayersParams()
    for case, p in [("guided partials", lp),
                    ("uniform_alpha", cfg.LayersParams(uniform_alpha=True))]:
        record("bilateral_guided", case, stencils.cross_bilateral_layers(target, layer, p),
               stencils.bilateral_plain(target, layer, p, False), TOL_BILATERAL)
    np_ = cfg.NlmParams()
    record("nlm", "F=1", stencils.nlm_accumulate(target, target, np_),
           stencils.nlm_plain(target, target[None], np_), TOL_NLM)
    wc6, nw6 = stencils.nlm_accumulate_frames(target, frames6, np_, None, valid6)
    record("nlm", "F=6, valid mask", (wc6, nw6),
           stencils.nlm_plain(target, frames6, np_, valid6), TOL_NLM)
    ua = cfg.NlmParams(uniform_alpha=True)
    record("nlm", "uniform_alpha, F=6", stencils.nlm_accumulate_frames(target, frames6, ua),
           stencils.nlm_plain(target, frames6, ua), TOL_NLM)
    nw0 = nw6.clone()
    nw0[::97, ::89] = 0.0
    record("normalize", "with nw == 0 pixels", stencils.normalize(wc6, nw0),
           stencils.normalize_plain(wc6, nw0, cfg.NormalizeParams()), ulps=1)

    timings = {
        "bilateral": (lambda: stencils.bilateral(target, bp),
                      lambda: stencils.bilateral_plain(target, None, bp, True)),
        "bilateral_guided": (lambda: stencils.cross_bilateral_layers(target, layer, lp),
                             lambda: stencils.bilateral_plain(target, layer, lp, False)),
        "nlm": (lambda: stencils.nlm_accumulate(target, target, np_),
                lambda: stencils.nlm_plain(target, target[None], np_)),
        "normalize": (lambda: stencils.normalize(wc6, nw0),
                      lambda: stencils.normalize_plain(wc6, nw0, cfg.NormalizeParams())),
    }
    for kernel, (kfn, pfn) in timings.items():
        results[kernel]["ms"] = median_ms(torch, kfn, 10)
        results[kernel]["plain_ms"] = median_ms(torch, pfn, 3)
        print(f"  {kernel:17s} 1080p median {results[kernel]['ms']:.4f} ms "
              f"(plain {results[kernel]['plain_ms']:.4f} ms)")
    f6 = median_ms(torch, lambda: stencils.nlm_accumulate_frames(target, frames6, np_), 5)
    f6p = median_ms(torch, lambda: stencils.nlm_plain(target, frames6, np_), 2)
    print(f"  nlm F=6 (batched temporal) 1080p median {f6:.4f} ms (plain {f6p:.4f} ms)")
    return results


def run_cli(cli, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def write_animation(imageio, render_frame, root: str) -> dict:
    """A 1080p LDR animation: N_FRAMES noisy frames, and the albedo, normal
    and depth layers of the target frame; plus the target's clean render.
    Returns the paths and the frames as the port will load them."""
    anim = os.path.join(root, "anim")
    layers_dir = os.path.join(anim, "RenderElements")
    os.makedirs(layers_dir)
    rng = np.random.default_rng(SEED)
    frames, layer, clean = [], None, None
    for i in range(N_FRAMES):
        t = i / (N_FRAMES - 1)
        noisy, layers = render_frame(t, H, W, rng, noise=NOISE)
        path = os.path.join(anim, f"Animation01_LDR_{i:04d}.png")
        imageio.save(path, noisy)
        frames.append(imageio.load(path)[0])
        if i == TARGET_FRAME:
            clean = render_frame(t, H, W, np.random.default_rng(SEED), noise=0.0)[0]
            for name, img in layers.items():
                lpath = os.path.join(layers_dir, f"{name}_{i:04d}.png")
                imageio.save(lpath, np.clip(img, 0, 1))
                if name == "albedo":
                    layer = imageio.load(lpath)[0]
    return {
        "target": os.path.join(anim, f"Animation01_LDR_{TARGET_FRAME:04d}.png"),
        "frames": frames,
        "layer": layer,
        "clean": clean,
    }


def phase_battery(cfg, stencils, cli, imageio, Session, anim, root):
    """Drive gpu-denoise on the card, check the run's launches and outputs.
    Returns the launch counts of the six-config run."""
    target, clean = anim["target"], anim["clean"]
    out_main = os.path.join(root, "out")
    out_linear = os.path.join(root, "out_linear")
    out_batch = os.path.join(root, "out_batch")

    stencils.reset_launches()
    rc, text, err = run_cli(cli, [target, "--device", "cuda", "--clamp", "--output-dir", out_main])
    counts = dict(stencils.launches)
    check(rc == 0, f"gpu-denoise failed ({rc}): {err.strip()}")
    print(f"  gpu-denoise, six configs: kernel launches {counts}")
    check(counts["bilateral"] > 0, "tiled bilateral launched no kernel")
    check(counts["bilateral_guided"] >= 3, "layers config launched fewer than 3 layer passes")
    check(counts["nlm"] > 0 and counts["normalize"] > 0, "NLM configs launched no kernel")

    rc, _, err = run_cli(cli, [target, "--device", "cuda", "--clamp", "--configs", "linear",
                               "--output-dir", out_linear])
    check(rc == 0, f"gpu-denoise linear failed ({rc}): {err.strip()}")
    check(dict(stencils.launches) == counts, "the linear config launched a kernel")
    rc, _, err = run_cli(cli, [target, "--device", "cuda", "--clamp", "--configs", "multiframe",
                               "--batch-frames", "--output-dir", out_batch])
    check(rc == 0, f"gpu-denoise --batch-frames failed ({rc}): {err.strip()}")
    check(stencils.launches["nlm"] > counts["nlm"], "--batch-frames launched no NLM kernel")

    reports = re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", text)
    check(len(reports) == 6, f"expected 6 timing reports, got {len(reports)}")
    noisy_psnr = psnr(anim["frames"][TARGET_FRAME], clean)
    print(f"  noisy target PSNR vs clean render: {noisy_psnr:.2f} dB")
    keys = ("bilateral", "layers", "linear", "nlm", "multiframe", "overlap")
    config_psnr = {}
    for key, run_cfg, (tr, ex) in zip(keys, cfg.GPU_BATTERY, reports):
        out, _ = imageio.load(os.path.join(out_main, run_cfg.output_name(False)))
        check(out.shape == (H, W, 4), f"{key}: output shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"{key}: non-finite output")
        config_psnr[key] = psnr(out, clean)
        print(f"  {key:10s} transfer {int(tr):>11d} ns  exec {int(ex):>11d} ns  "
              f"PSNR {config_psnr[key]:.2f} dB")
    check(config_psnr["bilateral"] > noisy_psnr, "tiled bilateral did not beat the noisy PSNR")
    check(config_psnr["nlm"] > noisy_psnr, "single-frame NLM did not beat the noisy PSNR")

    # The saved multiframe outputs of the streamed and the --batch-frames run.
    multiframe_name = cfg.GPU_BATTERY[4].output_name(False)
    streamed = imageio.load(os.path.join(out_main, multiframe_name))[0]
    batched = imageio.load(os.path.join(out_batch, multiframe_name))[0]
    err_bs = float(np.abs(batched - streamed).max())
    # Tiled vs linear bilateral as floats, through the Session the CLI drives
    # (after the launch counts above were read).
    session = Session(target, device="cuda", output_dir=out_linear, warmup=False)
    tiled = session.run(cfg.GPU_BATTERY[0]).image
    linear = session.run(cfg.GPU_BATTERY[2]).image
    err_tl = float(np.abs(tiled - linear).max())
    check(np.allclose(tiled, linear, **TOL_BILATERAL),
          f"tiled vs linear bilateral: max abs {err_tl:.3g}")
    check(np.allclose(batched, streamed, rtol=1e-5, atol=1e-6),
          f"batched vs streamed multiframe: max abs {err_bs:.3g}")
    print(f"  tiled vs linear bilateral max abs {err_tl:.3g}; "
          f"batched vs streamed multiframe max abs {err_bs:.3g}")
    return counts, os.path.join(out_main, cfg.GPU_BATTERY[0].output_name(False))


def check_bf16_close(torch, got, want, what: str) -> None:
    """The stored-grid bf16 contract (tests/test_sharding.py): at most 2 bf16
    ulps apart, at most 1% of cells differing."""

    def key(x):
        b = x.contiguous().view(torch.int16).int()
        return torch.where(b < 0, -(b & 0x7FFF), b)

    ulps = int((key(got) - key(want)).abs().max())
    flipped = float((got != want).float().mean())
    check(ulps <= 2 and flipped <= 0.01,
          f"{what}: {ulps} bf16 ulps apart, {flipped:.3%} of cells differ")


def phase_turbo_kernels(torch, fast, cfg, frame_4k, frame_1080):
    """The grid kernels and the pipeline against their plain versions: at 4K
    for each (D, K) of TURBO_CELLS, and on the 1080p target at each setting
    of the turbo battery. Returns {kernel: {max_abs_err, ms, plain_ms}} and
    prints the pipeline's Mpix/s at each D at 4K."""
    img4k = torch.from_numpy(frame_4k).to("cuda")
    img1080 = torch.from_numpy(frame_1080).to("cuda")
    results = {k: {"max_abs_err": 0.0} for k in ("pool", "build_grid", "slice_grid")}

    def note(kernel, case, got, want):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"{kernel} {case}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
        print(f"  {kernel:10s} {case:36s} max abs {err:.3g}")

    def close(got, want, tol, what):
        ok = bool(((got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()).all())
        check(ok, f"{what}: max abs {float((got - want).abs().max()):.3g} beyond {tol}")

    cells = []  # (label, image, D, K, params)
    for d, levels in TURBO_CELLS:
        cells.append(("4K", img4k, d, levels, cfg.BilateralParams()))
        if d == 2:  # the other border and uniform alpha, once
            cells.append(("4K", img4k, d, levels, cfg.BilateralParams(
                border=cfg.BorderPolicy.ZERO, uniform_alpha=True)))
    for d, sigma_s in TURBO_RUNS:
        if d > 1:
            cells.append(("1080p", img1080, d, turbo_levels(d),
                          cfg.BilateralParams(sigma_spatial=sigma_s)))

    timed = {}
    for label, img, d, levels, bp in cells:
        border, ua = bp.border, bp.uniform_alpha
        case = (f"{label} D={d} K={levels} {border} sigma_s {bp.sigma_spatial:g}"
                f"{' ua' if ua else ''}")
        small = fast.pool_plain(img, d, border)
        got = fast.pool(img, d, border)
        note("pool", case, got, small)
        close(got, small, TOL_POOL, f"pool {case}")
        lmin, step = fast.grid_range(small, levels)
        build_args = (small, lmin, step, levels, fast._grid_taps(bp.sigma_spatial, d),
                      border, 0.5 / bp.sigma_color**2, ua)
        grid = fast.build_grid_plain(*build_args)
        got = fast.build_grid(*build_args)
        note("build_grid", case, got, grid)
        check_bf16_close(torch, got, grid, f"build_grid {case}")
        slice_args = (img, grid, lmin, 1.0 / step, d, img[0, 0, 3] if ua else None)
        want = fast.slice_grid_plain(*slice_args)
        got = fast.slice_grid(*slice_args)
        note("slice_grid", case, got, want)
        close(got, want, TOL_SLICE, f"slice_grid {case}")
        got = fast.bilateral_fast(img, bp, levels, d)
        want = fast.grid_pipeline_plain(img, bp, levels, d)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        loose = float(((got - want).abs() > 1e-5).float().mean())
        check(err <= 2 * 2.0**-8 and loose <= 0.01,
              f"pipeline {case}: max abs {err:.3g}, {loose:.3%} of pixels beyond 1e-5")
        print(f"  {'pipeline':10s} {case:36s} max abs {err:.3g} "
              f"({loose:.4%} of pixels beyond 1e-5)")
        if label == "4K" and d == 2 and not ua:
            timed = {
                "pool": (lambda a=(img, d, border): fast.pool(*a),
                         lambda a=(img, d, border): fast.pool_plain(*a)),
                "build_grid": (lambda a=build_args: fast.build_grid(*a),
                               lambda a=build_args: fast.build_grid_plain(*a)),
                "slice_grid": (lambda a=slice_args: fast.slice_grid(*a),
                               lambda a=slice_args: fast.slice_grid_plain(*a)),
            }

    mpix = H4K * W4K / 1e6
    bp = cfg.BilateralParams()
    for d, levels in TURBO_CELLS:
        ms = median_ms(torch, lambda: fast.bilateral_fast(img4k, bp, levels, d), 10)
        plain_ms = median_ms(torch, lambda: fast.grid_pipeline_plain(img4k, bp, levels, d), 3)
        print(f"  pipeline D={d} K={levels} 4K median {ms:.4f} ms = {mpix / ms * 1e3:.1f} Mpix/s "
              f"(plain {plain_ms:.4f} ms = {mpix / plain_ms * 1e3:.1f} Mpix/s)")
    for kernel, (kfn, pfn) in timed.items():
        results[kernel]["ms"] = median_ms(torch, kfn, 10)
        results[kernel]["plain_ms"] = median_ms(torch, pfn, 3)
        print(f"  {kernel:10s} 4K D=2 K=5 median {results[kernel]['ms']:.4f} ms "
              f"(plain {results[kernel]['plain_ms']:.4f} ms)")
    return results


def phase_turbo_battery(cfg, stencils, cli, imageio, anim, root, exact_path):
    """gpu-denoise --turbo D on the card, each run's launch counts read just
    after it; checks the outputs. Returns the summed launch counts."""
    target, clean = anim["target"], anim["clean"]
    exact, _ = imageio.load(exact_path)
    noisy_psnr = psnr(anim["frames"][TARGET_FRAME], clean)
    names = [cfg.GPU_BATTERY[i].output_name(False) for i in (0, 2)]  # bilateral, linear
    totals = {"pool": 0, "build_grid": 0, "slice_grid": 0}
    for d, sigma_s in TURBO_RUNS:
        out_dir = os.path.join(root, f"turbo{d}")
        extra = f"--sigma-spatial {sigma_s:g}"
        stencils.reset_launches()
        rc, text, err = run_cli(cli, [target, "--device", "cuda", "--clamp", "--turbo", str(d),
                                      "--configs", "bilateral,linear", "--output-dir", out_dir,
                                      *extra.split()])
        counts = dict(stencils.launches)
        check(rc == 0, f"gpu-denoise --turbo {d} failed ({rc}): {err.strip()}")
        if d == 1:
            check(not any(counts.values()), f"--turbo 1 launched a kernel: {counts}")
        for kernel in totals if d > 1 else ():
            check(counts[kernel] > 0, f"--turbo {d} launched no {kernel} kernel")
            totals[kernel] += counts[kernel]
        check(all(counts[k] == 0 for k in counts if k not in totals),
              f"--turbo {d} launched an exact kernel: {counts}")
        reports = re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", text)
        check(len(reports) == 2, f"--turbo {d}: expected 2 timing reports, got {len(reports)}")
        bil, lin = (imageio.load(os.path.join(out_dir, n))[0] for n in names)
        check(bil.shape == (H, W, 4) and bool(np.isfinite(bil).all()),
              f"--turbo {d}: output shape {bil.shape} or non-finite values")
        check(np.array_equal(bil, lin), f"--turbo {d}: bilateral and linear outputs differ")
        db_clean, db_exact = psnr(bil, clean), psnr(bil, exact)
        check(db_clean > noisy_psnr, f"--turbo {d}: {db_clean:.2f} dB vs clean, noisy "
                                     f"{noisy_psnr:.2f} dB")
        if d == 2:
            check(db_exact >= TURBO_GATE_DB,
                  f"--turbo 2: {db_exact:.2f} dB vs exact < {TURBO_GATE_DB} dB")
        for (tr, ex), cfg_name in zip(reports, ("bilateral", "linear")):
            print(f"  --turbo {d} {extra:18s} {cfg_name:9s} transfer {int(tr):>10d} ns  "
                  f"exec {int(ex):>10d} ns")
        print(f"  --turbo {d} launches {dict((k, counts[k]) for k in totals)}; PSNR vs clean "
              f"{db_clean:.2f} dB, vs exact (sigma_s 2) {db_exact:.2f} dB")
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from image_denoising_filter_tpu_torch import cli
    from image_denoising_filter_tpu_torch import config as cfg
    from image_denoising_filter_tpu_torch.utils import imageio
    from image_denoising_filter_tpu_torch.ops import _build, fast, stencils
    from image_denoising_filter_tpu_torch.runtime import Session

    check("jax" not in sys.modules, "the port imported jax")
    render_frame = load_render_frame()
    smi = nvidia_smi_line()
    print(f"[1/6] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[2/6] build: {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    root = scratch_dir()
    try:
        anim = write_animation(imageio, render_frame, root)
        print(f"[3/6] kernels vs plain versions at {W}x{H}")
        kernels = phase_kernels(torch, stencils, cfg, anim["frames"], anim["layer"])
        print(f"[4/6] battery through gpu-denoise --device cuda ({N_FRAMES} frames + 3 layers)")
        counts, exact_path = phase_battery(cfg, stencils, cli, imageio, Session, anim, root)
        print(f"[5/6] turbo grid kernels vs plain versions at {W4K}x{H4K} and {W}x{H}")
        frame_4k = render_frame(0.5, H4K, W4K, np.random.default_rng(SEED), noise=NOISE)[0]
        kernels.update(phase_turbo_kernels(torch, fast, cfg, frame_4k,
                                           anim["frames"][TARGET_FRAME]))
        del frame_4k
        print("[6/6] turbo battery through gpu-denoise --turbo D --device cuda")
        counts.update(phase_turbo_battery(cfg, stencils, cli, imageio, anim, root, exact_path))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check("jax" not in sys.modules, "the port imported jax")

    replaces = {
        "bilateral": (KERNEL_SOURCE, f"{JAX_STENCILS}:178"),
        "bilateral_guided": (KERNEL_SOURCE, f"{JAX_STENCILS}:178"),
        "nlm": (KERNEL_SOURCE, f"{JAX_STENCILS}:467"),
        "normalize": (KERNEL_SOURCE, f"{JAX_STENCILS}:1039"),
        "pool": (FAST_SOURCE, f"{JAX_FAST}:83"),
        "build_grid": (FAST_SOURCE, f"{JAX_FAST}:1018"),
        "slice_grid": (FAST_SOURCE, f"{JAX_FAST}:502"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": where,
         "launches": counts[name], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name, (source, where) in replaces.items()
    ]}
    for k in line["kernels"]:
        check(k["launches"] > 0, f"{k['name']} was not launched by the main path")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # report and fail: no result line on any error
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
