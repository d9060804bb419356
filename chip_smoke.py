#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (image_denoising_filter_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, one line or block each:
  1. device  -- the card, as nvidia-smi gives its name and power limit;
  2. build   -- the kernels compiled from ops/csrc with nvcc;
  3. kernels -- each CUDA kernel against its plain PyTorch version on the
                card at 1920x1080, with max errors and median times;
  4. battery -- a 1080p animation (5 frames + albedo/normal/depth layers)
                through `gpu-denoise` (cli.main) on the card, the launch
                counts of that run, and the checks on its outputs.
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
JAX_STENCILS = "image_denoising_filter_tpu/ops/stencils.py"
# Tolerances: the repo's exact-kernel contract (rtol 1e-4 / atol 1e-5); NLM at
# the full reference parameters sums 196 candidates x 36 taps in another
# order than the plain version, hence rtol 2e-4 / atol 1e-4
# (tests/test_kernels.py); normalize is one IEEE division, held to 1 ulp.
TOL_BILATERAL = dict(rtol=1e-4, atol=1e-5)
TOL_NLM = dict(rtol=2e-4, atol=1e-4)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


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
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from image_denoising_filter_tpu_torch import cli
    from image_denoising_filter_tpu_torch import config as cfg
    from image_denoising_filter_tpu_torch.utils import imageio
    from image_denoising_filter_tpu_torch.ops import _build, stencils
    from image_denoising_filter_tpu_torch.runtime import Session

    check("jax" not in sys.modules, "the port imported jax")
    render_frame = load_render_frame()
    smi = nvidia_smi_line()
    print(f"[1/4] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    build_s = time.perf_counter() - t0
    print(f"[2/4] build: {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    root = scratch_dir()
    try:
        anim = write_animation(imageio, render_frame, root)
        print(f"[3/4] kernels vs plain versions at {W}x{H}")
        kernels = phase_kernels(torch, stencils, cfg, anim["frames"], anim["layer"])
        print(f"[4/4] battery through gpu-denoise --device cuda ({N_FRAMES} frames + 3 layers)")
        counts = phase_battery(cfg, stencils, cli, imageio, Session, anim, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check("jax" not in sys.modules, "the port imported jax")

    replaces = {
        "bilateral": f"{JAX_STENCILS}:178",
        "bilateral_guided": f"{JAX_STENCILS}:178",
        "nlm": f"{JAX_STENCILS}:467",
        "normalize": f"{JAX_STENCILS}:1039",
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces[name],
         "launches": counts[name], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name in ("bilateral", "bilateral_guided", "nlm", "normalize")
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
