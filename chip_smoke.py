#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (image_denoising_filter_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, one line or block each:
  1. device  -- the card, as nvidia-smi gives its name and power limit;
  2. build   -- the kernels compiled from ops/csrc with nvcc, one process
                per source, all at once, and beside them the native host
                library (native/idf_native.cpp with g++ and OpenMP,
                utils/native.ensure());
  3. kernels -- each exact-battery CUDA kernel, the bilateral kernel's
                two forms with bf16 taps, the NLM kernel with the turbo
                NLM's bf16 taps and stride-2 search, and the half-row NLM
                kernel (--weights-halfres) with float32 and bf16 taps,
                against its plain PyTorch version on the card at 1920x1080,
                with max errors and median times; the redesigned kernels'
                registers, spill bytes, tile, shared bytes and blocks a SM
                beside their times before the redesign;
  4. battery -- a 1080p animation (5 frames + albedo/normal/depth layers)
                through `gpu-denoise` (cli.main) on the card, the launch
                counts of that run, and the checks on its outputs; then
                the NLM configs at --search-radius 0 (no candidate: the
                seeds alone) on the card against --device cpu; then the
                tiled bilateral and layers configs with bf16 taps through
                Session(tiling=...), each gated against its exact output;
  5. turbo kernels -- the bilateral grid's pool, build and slice kernels
                and the whole grid pipeline against their plain versions, and
                the fused build+slice kernel against the build and slice
                kernels bit for bit, at 3840x2160 for (D, K) = (2, 5), (4, 5),
                (8, 6), on that frame with its RGB scaled into [0, 4] (HDR) at
                (2, 5), and on the 1080p target at each setting of phase 7;
                the fused path, grid_pipeline(fused=True), driven at each 4K
                (D, K) with its launch counts; median times at 4K (2, 5),
                the build's and the fused kernel's registers, tile and shared
                bytes, both pipelines' Mpix/s at each D, and the fused
                kernel's time against the build's and the slice's at each D;
  6. guided kernels -- the layer-guided grid's build, slice and fused
                build+slice against their plain versions (the fused kernel
                against the two kernels, bit for bit) at 3840x2160 for the
                same (D, K) and on the 1080p albedo layer at each setting of
                phase 7, with median times at 4K (2, 5), and the guided
                build's also at the main path's --turbo 1 shape (1080p, D=1,
                K=6, 17 taps); the guided build's and the fused kernel's
                registers, tile and shared bytes; the fused kernel's time
                against the two kernels' at 4K (2, 5) and (4, 5);
  7. turbo battery -- `gpu-denoise --turbo D` on the 1080p target: every
                config at D = 2, the NLM configs again with
                --weights-halfres, the grid configs (bilateral, linear,
                layers) at D = 1, 4 and 8 (sigma_s 6), the launch counts of
                each run, and the PSNR of each output against the clean
                render and against phase 4's exact output of its config;
  8. CPU configs, parity, profile, content -- the render generator on the
                card at 3840x2160 against the host's; the parity reading,
                the bilateral kernel at the CPU path's parameters against the
                CPU bilateral oracle over interior RGB (at least 59 dB), on
                bench.py's 96x128 uniform frame and on a 270x480 crop of the
                card's render with the battery's noise; `gpu-denoise --configs
                cpu1,cpu8` on that crop (the native OpenMP oracle, no kernel
                launch, output-cpu.png within 1 LSB of the NumPy oracle's
                on the crop); the six device
                configs through `gpu-denoise --profile`, the trace's kernel
                events against the run's launch counts, and each config's
                host ms, device busy ms and busy share;
  9. sharded -- gpu-denoise --mesh on four ranks that share the card over
                gloo: the six configs on 1x4 (every file phase 4's byte for
                byte) and on 2x2 (the spatial configs phase 4's, the
                multiframe ones within 1 LSB: the SUM over 'frame' regroups
                the frames' partials); --turbo 2 --weights-halfres on 1x4
                (phase 7's files); --turbo 4 on 1x4 (bilateral_fast on the
                same row-padded frame); the slab slice kernels with offsets
                at 4K D=2 against the whole slice and their plain versions;
                the HDR 4K frame through the sharded turbo grid against the
                single-device pipeline; parallel.dryrun on four ranks. Each
                run's rank-0 transfer and exec times and its launch counts
                summed over the ranks; four ranks on one card show the
                overhead of the transport, not scaling.
 10. HDR    -- a 1080p EXR animation (render_frame(hdr=True): noise below 0,
                the emissive ceiling above 4; fireflies in the target; LDR PNG
                layers) written and read back, the EXR codec that ran (the
                native one) timed a frame, and held to the Python codec;
                every kernel in every form against
                its plain version on HDR frames (1080p, and a 4K HDR render
                for the grids at each (D, K)), the staged bilateral's walks,
                HDR times beside the LDR ones; then gpu-denoise on the HDR
                target: the exact battery against the plain versions on the
                card, the bilateral and layers configs with bf16 taps,
                --turbo 2 (the NLM configs again with --weights-halfres),
                --turbo 8 --sigma-spatial 6 and --turbo 1 layers, each output
                a float32 EXR read against the exact output and gated at the
                JAX package's reading (JAX_HDR_READINGS_DB); --all-frames over
                the animation, each output byte for byte a single-target run;
 11. host runtime -- the native library's build route, compiler, libgomp,
                idf_num_threads() and os.cpu_count(); the default run,
                `gpu-denoise <1080p target> --device cuda --clamp` with no
                --configs (the six device configs, then cpu1 and cpu8): the
                six files phase 4's byte for byte, output-cpu.png's border,
                alpha and parity reading against the bilateral kernel at the
                CPU parameters, cpu1 and cpu8 seconds and the OpenMP
                filter's own on 1 and 8 threads; the overlap config on
                the native frame loader (PNG and EXR targets), its output
                phase 4's (phase 10's) and its exec ns beside theirs, and the
                frame streaming's host time on the native loader against the
                Python codec on the loop's thread; --all-frames over the LDR
                animation against single-target runs; the six exact configs
                on the EXR target through --mesh 1x4 over gloo, each output
                phase 10's array for array.
Then one JSON line with every kernel's launches, error, times and bound, the
nvidia-smi line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and exits non-zero without printing a result; so does a
machine without a CUDA device, or a directory that holds this file alone.
The script imports no JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
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
# The bilateral with bf16 taps against its config's exact output: the JAX
# package's own bf16 headroom (tests/test_kernels.py: rtol 0.1 / atol 0.03).
TOL_BF16_CONFIG = dict(rtol=0.1, atol=0.03)
# The redesigned kernels' medians before their redesign, at the same shapes
# and timed as median_ms times (tools/torch_kernel_ab.py, the two runs of
# each kernel before its redesign, on an NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 6).
BEFORE_REDESIGN_MS = {"bilateral": 1.1941, "bilateral_guided": 1.4404,
                      "nlm": 16.0932, "nlm_bf16": 5.2365, "nlm F=6": 96.5862,
                      "nlm_hrw": 2.2086, "nlm_hrw_bf16": 3.3669,
                      "build_guided_grid 4K D=2 K=5": 1.7550,
                      "build_guided_grid 1080p D=1": 7.1050,
                      "build_grid 4K D=2 K=5": 1.5590, "fused_guided 4K D=2 K=5": 0.8898,
                      "fused_grid 4K D=2 K=5": 0.6683}
H4K, W4K = 2160, 3840
# The HDR case of phase 5: the 4K frame's RGB clipped to [0, 1] and scaled
# by HDR_SCALE. Its pipeline check is the LDR contract (2 bf16 ulps at values
# up to 1, at most 1% of pixels beyond 1e-5) scaled by the range, as
# tests/test_torch_fast.py reads HDR against the JAX package.
HDR_SCALE = 4.0
TURBO_CELLS = ((2, 5), (4, 5), (8, 6))  # (D, K): run_turbo's K at each D
# The turbo battery: D and --sigma-spatial (D=8 is gated in the JAX package
# only from sigma_s ~5-6 up, hence sigma_s 6 there). At D=1 the bilateral
# grid is the eager lattice, which launches no kernel, and the guided grid
# runs its two kernels. Phases 5 and 6 also hold the kernels to their plain
# versions at each of these settings on the same 1080p target.
TURBO_RUNS = ((1, 2.0), (2, 2.0), (4, 2.0), (8, 6.0))
# PSNR of the D=2 turbo output against the exact tiled bilateral: the repo's
# 40 dB gate (bench.py:51, tests/test_fast.py:28).
TURBO_GATE_DB = 40.0
# The JAX package's gates of its own turbo tests, over RGB as they read
# them: the bf16 stride-2 NLM at least 40 dB against the exact NLM
# (tests/test_fast.py:119), the turbo layers at D=2 at least 35 dB against
# the exact layers (tests/test_fast.py:254). TURBO_GATE_DB reads RGBA, as it
# has since it was set (alpha is 1 in both, which adds 1.25 dB; over RGB
# this frame reads 38.8 dB, ROADMAP.md queue C).
TURBO_NLM_GATE_DB = 40.0
TURBO_LAYERS_GATE_DB = 35.0
# The half-row NLM (--turbo 2 --weights-halfres) against the exact NLM over
# RGB: the JAX package's own reading on this frame is 29.0547 dB
# (tools/hrw_jax_reading.py, its float32 XLA oracle), below the 40 dB NLM
# gate: pooling two rows halves the noise in each weight cell's squared
# difference, so the weights, and the smoothing, grow on this noisy frame.
# The gate is that reading less 0.05 dB (ROADMAP.md queue C).
JAX_HRW_READING_DB = 29.0547
TURBO_HRW_GATE_DB = min(TURBO_NLM_GATE_DB, JAX_HRW_READING_DB - 0.05)
# Card rates for the bound of each kernel: device memory 3.35 TB/s and
# float32 outside the tensor cores 67 TFLOP/s (H100 SXM datasheet); bfloat16
# outside the tensor cores 133.8 TFLOP/s (NVIDIA H100 Tensor Core GPU
# Architecture whitepaper, H100 SXM5), the rate of the turbo NLM's bf16
# squared differences, elementwise operations that the tensor cores' bf16
# matrix rate does not serve.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = 67e12
PEAK_BF16_FLOPS_S = 133.8e12
# The NLM configs, which run at D = 2 of the turbo battery only: once as
# --turbo 2, once with the half-row weights.
NLM_CONFIGS = ("nlm", "multiframe", "overlap")
NLM_RUNS = ((), ("--weights-halfres",))
# Phase 8. The parity gate against the CPU bilateral (BASELINE.md:15); the
# frame of the CPU configs and of the second parity reading, a crop of the
# card's 4K render; the device generator against the host's
# (tests/test_content.py's bound); in a --profile trace, the kernels counted
# against the launch counts that each name sums, and the event categories
# whose intervals make a config's device busy time.
PARITY_GATE_DB = 59.0
CPU_CROP = (270, 480)
CONTENT_TOL = 2e-6
PROFILE_KERNELS = {"bilateral_staged_kernel": ("bilateral", "bilateral_guided"),
                   "nlm_kernel": ("nlm",), "normalize_kernel": ("normalize",)}
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
# Phase 10, HDR. The animation: render_frame(hdr=True) frames with RGB
# unclipped (the noise below 0, the emissive ceiling at 4 and above), and in
# the target frame a seeded HDR_FIREFLY_SHARE of the pixels with RGB times
# HDR_FIREFLY_GAIN, as fireflies; the layers LDR PNG, as
# tools/make_dataset.py writes them.
HDR_FIREFLY_SHARE = 0.0005
HDR_FIREFLY_GAIN = 50.0
# gpu-denoise's runs of phase 10 after the exact battery, each (name, flags,
# configs): the turbo modes as phase 7 runs them, on the HDR target.
HDR_TURBO_RUNS = (
    ("turbo 2", ("--turbo", "2"), ("bilateral", "layers", "linear", "nlm", "multiframe",
                                   "overlap")),
    ("turbo 2 half-row", ("--turbo", "2", "--weights-halfres"), NLM_CONFIGS),
    ("turbo 8", ("--turbo", "8", "--sigma-spatial", "6"), ("bilateral", "layers", "linear")),
    ("turbo 1", ("--turbo", "1"), ("layers",)),
)
# The JAX package's readings of each approximate output against the exact
# output of its config (the grid configs against the exact tiled
# bilateral) on phase 10's target: dB over RGB, the exact output's largest
# RGB value the peak (tools/hdr_jax_reading.py: tpu-denoise and the JAX
# Session on the CPU, its Pallas kernels in interpret mode; the bilateral
# grid through its Pallas pipeline, which tpu-denoise runs on its chip). Each
# port reading is gated at the JAX package's less HDR_GATE_MARGIN_DB.
JAX_HDR_READINGS_DB = {
    "bf16 bilateral": 103.4119, "bf16 layers": 92.1951,
    "turbo 2 bilateral": 45.0386, "turbo 2 layers": 50.9923, "turbo 2 linear": 45.0386,
    "turbo 2 nlm": 92.5413, "turbo 2 multiframe": 94.7206, "turbo 2 overlap": 94.1288,
    "turbo 2 half-row nlm": 75.7141, "turbo 2 half-row multiframe": 78.4433,
    "turbo 2 half-row overlap": 77.5545,
    "turbo 8 bilateral": 46.7575, "turbo 8 layers": 39.4342, "turbo 8 linear": 46.7575,
    "turbo 1 layers": 72.5516,
}
HDR_GATE_MARGIN_DB = 0.05
# Phase 11. The native library's build routes (utils/native.py), and the
# least speed-up of the OpenMP CPU bilateral on 8 threads over 1 (the cpu8
# and cpu1 configs' filter) at 1080p on a host of at least CPU8_MIN_CORES
# cores.
NATIVE_ROUTES = {"a": "native/Makefile's command",
                 "b": "-fopenmp -c, then libgomp linked by path",
                 "c": "the port's omp.h, -fopenmp -c, then libgomp linked by path"}
CPU8_MIN_SPEEDUP = 3.0
CPU8_MIN_CORES = 8


# The port's modules this script drives; none may load jax or the JAX
# package image_denoising_filter_tpu (tests/test_torch_imports.py).
PORT_MODULES = (
    "image_denoising_filter_tpu_torch.cli",
    "image_denoising_filter_tpu_torch.config",
    "image_denoising_filter_tpu_torch.ops._build",
    "image_denoising_filter_tpu_torch.ops.fast",
    "image_denoising_filter_tpu_torch.ops.reference",
    "image_denoising_filter_tpu_torch.ops.stencils",
    "image_denoising_filter_tpu_torch.parallel.dryrun",
    "image_denoising_filter_tpu_torch.parallel.launch",
    "image_denoising_filter_tpu_torch.runtime",
    "image_denoising_filter_tpu_torch.utils.content",
    "image_denoising_filter_tpu_torch.utils.imageio",
    "image_denoising_filter_tpu_torch.utils.native",
)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def check_no_jax() -> None:
    bad = sorted(m for m in sys.modules if m in ("jax", "image_denoising_filter_tpu")
                 or m.startswith(("jax.", "image_denoising_filter_tpu.")))
    check(not bad, f"the port imported {bad}")


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


@functools.lru_cache(maxsize=1)
def sleep_cycles_per_ms(torch) -> float:
    """The card's clock cycles a millisecond of torch.cuda._sleep, measured
    once."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def median_ms(torch, fn, reps: int) -> float:
    """Median device time of fn()'s launches, between two CUDA events, after
    one warm-up call. Before each timed call a spin kernel
    (torch.cuda._sleep) holds the stream for twice the warm-up call's wall
    time and a millisecond more, so the events and fn's launches are all
    queued before the first event runs: the host's time to enqueue them
    (Python wrappers, allocations) does not enter the reading."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_ms = 1.0 + 2e3 * (time.perf_counter() - t0)
    cycles = int(hold_ms * sleep_cycles_per_ms(torch))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def errors(torch, got, want) -> tuple[float, float]:
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp_min(1e-30)).max())


def disk_taps(stencils, p) -> int:
    """Taps of the exact bilateral's truncation disk (its `_circle_runs`)."""
    runs = stencils._circle_runs(p.effective_radius, p.sigma_spatial, p.truncate_eps)
    return sum(n_rows * (2 * hw + 1) for _, n_rows, hw in runs)


def kernel_work(name: str, pixels: int, cells: int = 0, levels: int = 0, taps: int = 0,
                frames: int = 1, cands: int = 0, disk: int = 0,
                aliased: bool = False) -> tuple[int, ...]:
    """(bytes, float32 operations[, bfloat16 operations]) of one call of a
    kernel's function: each input read once and each output written once, and
    the least arithmetic the function needs (a multiply-add counts 2, an exp2
    or a divide 1). pixels: full-resolution pixels; cells: pooled cells of
    one level; levels: K; taps: blur taps along one axis; frames and cands:
    the NLM's frames and search candidates; disk: the bilateral's disk taps;
    aliased: the NLM's target is its one frame (F = 1), read once.

    Per unit: a bilateral tap 20 (colour distance 8, in bfloat16 with bf16
    taps; exponent 2, exp2 1, weighted colour 8, weight 1), its normalize 4;
    an NLM candidate 24 per
    pixel and frame with box sums (squared difference 8, in bfloat16 with
    bf16 taps; two running sums 4, exponent and exp2 3, weighted colour 8,
    weight 1); with the weights at half the rows the 15 operations before
    the weighted colour halve and the row upsample adds 3 (39/2, of which
    the squared difference's 4 are bfloat16 with bf16 taps); a grid cell and
    level 16 (range weights 3 x 4, payload 4) plus 28 per blur tap (7
    fields, two passes, one multiply-add each), the normalized grid 4 more
    for its divides; a slice 132 a pixel for the bilateral grid (the t of 3
    channels 12, then 4 channels x 2 levels x (tent 4, bilinear 9, add 2))
    and 222 for the guided grid (7 planes). The fused kernels read the
    pooled images and the guide and write the slice's output: their grid
    never goes to device memory."""
    grid = levels * cells
    blur = 28 * taps
    fcp = frames * cands * pixels
    nlm_bytes = 20 * pixels + 16 * (frames + (0 if aliased else 1)) * pixels
    build = grid * (20 + blur)
    return {
        "nlm_hrw": (nlm_bytes, 39 * fcp // 2),
        "nlm_hrw_bf16": (nlm_bytes, 31 * fcp // 2, 4 * fcp),
        "fused_grid": (16 * cells + 32 * pixels, build + 132 * pixels),
        "bilateral": (32 * pixels, pixels * (20 * disk + 4)),
        "bilateral_guided": (52 * pixels, pixels * 20 * disk),
        "bilateral_bf16": (32 * pixels, pixels * (12 * disk + 4), pixels * 8 * disk),
        "bilateral_guided_bf16": (52 * pixels, pixels * 12 * disk, pixels * 8 * disk),
        "nlm": (nlm_bytes, 24 * fcp),
        "nlm_bf16": (nlm_bytes, 16 * fcp, 8 * fcp),
        "normalize": (36 * pixels, 5 * pixels),
        "pool": (16 * pixels + 16 * cells, 8 * pixels),
        "build_grid": (16 * cells + 8 * grid, build),
        "slice_grid": (32 * pixels + 8 * grid, 132 * pixels),
        "build_guided_grid": (32 * cells + 14 * grid, grid * (16 + blur)),
        "slice_guided_grid": (44 * pixels + 14 * grid, 222 * pixels),
        "fused_guided": (32 * cells + 44 * pixels, grid * (16 + blur) + 222 * pixels),
    }[name]


def bound(nbytes: int, flops: int, bf16_flops: int = 0) -> dict:
    """The least time the card could take for that work: the larger of the
    bytes over the memory rate and the operations, each type over its rate."""
    mem_ms = nbytes / PEAK_BYTES_S * 1e3
    op_ms = (flops / PEAK_FLOPS_S + bf16_flops / PEAK_BF16_FLOPS_S) * 1e3
    return {"bound_ms": max(mem_ms, op_ms),
            "bound_by": "bytes" if mem_ms >= op_ms else "operations"}


def grid_sample_slice(torch, grid, guide, lmin, inv_step, d: int, groups):
    """One torch.nn.functional.grid_sample call that slices a (K, hs, ws, c)
    grid as the slice kernels do: the planes of each RGB channel's group
    (groups[c]) sampled trilinearly at (x, y, t_c), edge-replicated. The
    library yardstick of the slice kernels; the port never calls it. Returns
    the call and a function that maps its output to the kernel's planes."""
    levels, hs, ws, _ = grid.shape
    h, w, _ = guide.shape
    dev = grid.device
    vol = torch.zeros((3, max(map(len, groups)), levels, hs, ws), device=dev)
    for n, planes in enumerate(groups):
        for c, p in enumerate(planes):
            vol[n, c] = grid[..., p].float()
    t = ((guide[..., :3] - lmin) * inv_step).clamp(0.0, levels - 1.0)
    coords = torch.empty((3, 1, h, w, 3), device=dev)
    coords[..., 0] = (2 * torch.arange(w, device=dev) + 1) / (d * ws) - 1
    coords[..., 1] = ((2 * torch.arange(h, device=dev) + 1) / (d * hs) - 1)[:, None]
    coords[..., 2] = ((2 * t + 1) / levels - 1).permute(2, 0, 1)[:, None]

    def call():
        return torch.nn.functional.grid_sample(vol, coords, mode="bilinear",
                                               padding_mode="border", align_corners=False)

    def planes(out):
        return {p: out[n, c, 0] for n, group in enumerate(groups) for c, p in enumerate(group)}

    return call, planes


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


def scaled(tol: dict, scale: float) -> dict:
    """A tolerance whose absolute part grows with the content's range."""
    return dict(rtol=tol["rtol"], atol=tol["atol"] * scale)


def phase_kernels(torch, stencils, cfg, frames_np, layer_np, scale: float = 1.0,
                  where: str = "1080p"):
    """Each kernel against its plain version on the card, at the main path's
    shapes, with the absolute tolerances times `scale` (max |RGB| of HDR
    content, 1 for LDR). Returns {kernel: {max_abs_err, ms, plain_ms}}; the
    LDR call (scale 1) also times the frame-batched NLM and prints the
    redesigned kernels' launch shapes."""
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
        tol = None if tol is None else scaled(tol, scale)
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
    # bf16 taps (Session(tiling=...)): kernel and plain version round each
    # operation of the colour distance and each value tap alike.
    bf16 = cfg.TilingConfig(compute_dtype="bfloat16")
    for case, p in [
        ("defaults", bp),
        ("blue_bug", cfg.BilateralParams(blue_bug=True)),
        ("zero border", cfg.BilateralParams(border=cfg.BorderPolicy.ZERO)),
        ("uniform_alpha", cfg.BilateralParams(uniform_alpha=True)),
    ]:
        record("bilateral_bf16", case, stencils.bilateral(target, p, bf16),
               stencils.bilateral_plain(target, None, p, True, "bfloat16")[0], TOL_BILATERAL)
    for case, p in [("guided partials", lp),
                    ("uniform_alpha", cfg.LayersParams(uniform_alpha=True)),
                    ("zero border, blue_bug", cfg.LayersParams(border=cfg.BorderPolicy.ZERO,
                                                               blue_bug=True))]:
        record("bilateral_guided_bf16", case,
               stencils.cross_bilateral_layers(target, layer, p, bf16),
               stencils.bilateral_plain(target, layer, p, False, "bfloat16"), TOL_BILATERAL)
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
    # The turbo NLM: bf16 taps, stride-2 search (49 candidates; 37 with the
    # disk). Kernel and plain version round each tap operation alike.
    turbo_nlm = cfg.NlmParams(search_stride=2)
    for case, p in [("stride 2", turbo_nlm),
                    ("stride 2, disk", cfg.NlmParams(search_stride=2, search_disk=True))]:
        record("nlm_bf16", f"{case}, F=1", stencils.nlm_accumulate(target, target, p, bf16),
               stencils.nlm_plain(target, target[None], p, None, "bfloat16"), TOL_NLM)
        record("nlm_bf16", f"{case}, F=6, valid mask",
               stencils.nlm_accumulate_frames(target, frames6, p, bf16, valid6),
               stencils.nlm_plain(target, frames6, p, valid6, "bfloat16"), TOL_NLM)
    # The half-row NLM (--weights-halfres): float32 and bf16 taps.
    hrw = cfg.NlmParams(search_stride=2, weights_halfres=True)
    for kernel, tiling, dtype in (("nlm_hrw", None, "float32"),
                                  ("nlm_hrw_bf16", bf16, "bfloat16")):
        for case, p in [("stride 2", hrw),
                        ("stride 2, disk", cfg.NlmParams(search_stride=2, search_disk=True,
                                                         weights_halfres=True))]:
            record(kernel, f"{case}, F=1", stencils.nlm_accumulate(target, target, p, tiling),
                   stencils.nlm_plain(target, target[None], p, None, dtype), TOL_NLM)
            record(kernel, f"{case}, F=6, valid mask",
                   stencils.nlm_accumulate_frames(target, frames6, p, tiling, valid6),
                   stencils.nlm_plain(target, frames6, p, valid6, dtype), TOL_NLM)

    timings = {
        "bilateral": (lambda: stencils.bilateral(target, bp),
                      lambda: stencils.bilateral_plain(target, None, bp, True)),
        "bilateral_guided": (lambda: stencils.cross_bilateral_layers(target, layer, lp),
                             lambda: stencils.bilateral_plain(target, layer, lp, False)),
        "bilateral_bf16": (lambda: stencils.bilateral(target, bp, bf16),
                           lambda: stencils.bilateral_plain(target, None, bp, True, "bfloat16")),
        "bilateral_guided_bf16": (
            lambda: stencils.cross_bilateral_layers(target, layer, lp, bf16),
            lambda: stencils.bilateral_plain(target, layer, lp, False, "bfloat16")),
        "nlm": (lambda: stencils.nlm_accumulate(target, target, np_),
                lambda: stencils.nlm_plain(target, target[None], np_)),
        "nlm_bf16": (lambda: stencils.nlm_accumulate(target, target, turbo_nlm, bf16),
                     lambda: stencils.nlm_plain(target, target[None], turbo_nlm, None,
                                                "bfloat16")),
        "nlm_hrw": (lambda: stencils.nlm_accumulate(target, target, hrw),
                    lambda: stencils.nlm_plain(target, target[None], hrw)),
        "nlm_hrw_bf16": (lambda: stencils.nlm_accumulate(target, target, hrw, bf16),
                         lambda: stencils.nlm_plain(target, target[None], hrw, None,
                                                    "bfloat16")),
        "normalize": (lambda: stencils.normalize(wc6, nw0),
                      lambda: stencils.normalize_plain(wc6, nw0, cfg.NormalizeParams())),
    }
    pixels = H * W
    shapes = {
        "bilateral": dict(pixels=pixels, disk=disk_taps(stencils, bp)),
        "bilateral_guided": dict(pixels=pixels, disk=disk_taps(stencils, lp)),
        "bilateral_bf16": dict(pixels=pixels, disk=disk_taps(stencils, bp)),
        "bilateral_guided_bf16": dict(pixels=pixels, disk=disk_taps(stencils, lp)),
        # timed at F = 1 with the target as its own neighbour frame
        "nlm": dict(pixels=pixels, cands=len(stencils.nlm_candidates(np_)), aliased=True),
        "nlm_bf16": dict(pixels=pixels, cands=len(stencils.nlm_candidates(turbo_nlm)),
                         aliased=True),
        "nlm_hrw": dict(pixels=pixels, cands=len(stencils.nlm_candidates(hrw)), aliased=True),
        "nlm_hrw_bf16": dict(pixels=pixels, cands=len(stencils.nlm_candidates(hrw)),
                             aliased=True),
        "normalize": dict(pixels=pixels),
    }
    nw0_b = nw0[..., None]
    library = {"normalize": lambda: wc6 / nw0_b}  # the divide without the sentinel
    time_kernels(torch, results, timings, shapes, library, where)
    if scale != 1.0:
        return results
    f6 = median_ms(torch, lambda: stencils.nlm_accumulate_frames(target, frames6, np_), 5)
    f6p = median_ms(torch, lambda: stencils.nlm_plain(target, frames6, np_), 2)
    print(f"  nlm F=6 (batched temporal) 1080p median {f6:.4f} ms (plain {f6p:.4f} ms; "
          f"before the redesign {BEFORE_REDESIGN_MS['nlm F=6']} ms)")
    f6b = median_ms(torch, lambda: stencils.nlm_accumulate_frames(target, frames6, turbo_nlm,
                                                                  bf16), 5)
    print(f"  nlm_bf16 F=6 (batched temporal) 1080p median {f6b:.4f} ms")
    # The kernels redesigned for this card: launch shape as compiled, and the
    # time beside the one before the redesign (the bilateral's bf16 forms
    # have none: they are new).
    for kernel, p in (("bilateral", bp), ("bilateral_guided", lp), ("bilateral_bf16", bp),
                      ("bilateral_guided_bf16", lp), ("nlm", np_), ("nlm_bf16", turbo_nlm),
                      ("nlm_hrw", hrw), ("nlm_hrw_bf16", hrw)):
        print_redesigned(kernel, stencils.kernel_info(kernel, dev, p), results[kernel]["ms"])
    return results


def print_redesigned(kernel: str, info: dict, ms: float) -> None:
    before = BEFORE_REDESIGN_MS.get(kernel)
    print(f"  {kernel:21s} {json.dumps(info)}: median {ms:.4f} ms, before the redesign "
          f"{'none (a new form)' if before is None else f'{before} ms'}")


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


def write_hdr_animation(imageio, render_frame, root: str) -> dict:
    """Phase 10's 1080p EXR animation (HDR_* above) and its layers, saved
    with `imageio` (either package's). Returns the target's path, the
    frames as written (float32 EXR is lossless), the target's albedo layer
    as loaded and the number of fireflies."""
    anim = os.path.join(root, "hdr")
    layers_dir = os.path.join(anim, "RenderElements")
    os.makedirs(layers_dir)
    rng = np.random.default_rng(SEED)
    frames, layer, n_fire = [], None, 0
    for i in range(N_FRAMES):
        noisy, layers = render_frame(i / (N_FRAMES - 1), H, W, rng, noise=NOISE, hdr=True)
        if i == TARGET_FRAME:
            n_fire = round(HDR_FIREFLY_SHARE * H * W)
            fire = np.random.default_rng(SEED + 1).choice(H * W, n_fire, replace=False)
            noisy.reshape(-1, 4)[fire, :3] *= np.float32(HDR_FIREFLY_GAIN)
        imageio.save(os.path.join(anim, f"Animation01_HDR_{i:04d}.exr"), noisy)
        frames.append(noisy)
        for name, img in layers.items():
            lpath = os.path.join(layers_dir, f"{name}_{i:04d}.png")
            imageio.save(lpath, np.clip(img, 0, 1))
            if name == "albedo" and i == TARGET_FRAME:
                layer = imageio.load(lpath)[0]
    return {"target": os.path.join(anim, f"Animation01_HDR_{TARGET_FRAME:04d}.exr"),
            "frames": frames, "layer": layer, "fireflies": n_fire}


def psnr_peak(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    """PSNR over RGB with `peak` as the signal's peak: HDR content has no
    fixed white."""
    mse = float(np.mean((a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)) ** 2))
    return math.inf if mse == 0.0 else 10.0 * math.log10(peak * peak / mse)


def exr_channels(path: str) -> dict:
    """{channel: pixel type} of an OpenEXR file's header (0 UINT, 1 HALF, 2
    FLOAT)."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
    pos = 8  # magic and version
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = data.index(b"\0", end + 1) + 1  # past the type name
        size = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if name == "channels":
            body, q, chans = data[pos : pos + size], 0, {}
            while body[q] != 0:
                e = body.index(b"\0", q)
                chans[body[q:e].decode()] = int.from_bytes(body[e + 1 : e + 5], "little")
                q = e + 17  # type, pLinear, 3 reserved bytes, x and y sampling
            return chans
        pos += size
    raise SmokeError(f"{path}: no channels attribute")


def phase_battery(cfg, stencils, cli, imageio, Session, anim, root):
    """Drive gpu-denoise on the card, check the run's launches and outputs;
    then the half-row NLM with float32 taps through Session.run, as a
    library caller runs it. Returns the launch counts of the six-config run
    and of the Session run, summed, the exact outputs' directory and the
    six configs' exec ns."""
    target, clean = anim["target"], anim["clean"]
    out_main = os.path.join(root, "out")
    out_linear = os.path.join(root, "out_linear")
    out_batch = os.path.join(root, "out_batch")

    stencils.reset_launches()
    rc, text, err = run_cli(cli, [target, "--device", "cuda", "--clamp", "--configs",
                                  ",".join(cli.CONFIG_KEYS), "--output-dir", out_main])
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
    exec_ns = {key: int(ex) for key, (_, ex) in zip(keys, reports)}
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

    # The half-row NLM with float32 taps: gpu-denoise runs it with bf16 taps
    # only (--turbo), a library caller through Session with its NlmParams.
    hrw = Session(target, device="cuda", output_dir=out_linear, warmup=False,
                  nlm_params=cfg.NlmParams(search_stride=2, weights_halfres=True))
    stencils.reset_launches()
    out = hrw.run(cfg.GPU_BATTERY[3]).image
    hrw_counts = {k: n for k, n in stencils.launches.items() if n}
    check(hrw_counts == {"nlm_hrw": 1, "normalize": 1},
          f"Session.run, half-row NLM: launches {hrw_counts}")
    check(out.shape == (H, W, 4) and bool(np.isfinite(out).all()),
          "Session.run, half-row NLM: output shape or non-finite values")
    hrw_psnr = psnr(out, clean)
    check(hrw_psnr > noisy_psnr, f"half-row NLM {hrw_psnr:.2f} dB vs clean, "
                                 f"noisy {noisy_psnr:.2f} dB")
    print(f"  Session.run nlm, half-row weights, float32 taps: launches {hrw_counts}, "
          f"PSNR vs clean {hrw_psnr:.2f} dB")
    for k, n in hrw_counts.items():
        counts[k] += n

    # Search radius 0: no candidate, each frame's seed alone; the card's
    # outputs are --device cpu's.
    saved = {}
    for device in ("cuda", "cpu"):
        out_dir = os.path.join(root, f"out_s0_{device}")
        stencils.reset_launches()
        rc, _, err = run_cli(cli, [target, "--device", device, "--clamp", "--search-radius", "0",
                                   "--configs", "nlm,multiframe", "--output-dir", out_dir])
        check(rc == 0, f"gpu-denoise --search-radius 0 --device {device} failed ({rc}): "
                       f"{err.strip()}")
        saved[device] = [imageio.load(os.path.join(out_dir, cfg.GPU_BATTERY[i].output_name(False)))[0]
                         for i in (3, 4)]
        if device == "cuda":
            s0_counts = {k: n for k, n in stencils.launches.items() if n}
    check(s0_counts.get("nlm", 0) > 0, f"--search-radius 0 launched no NLM kernel: {s0_counts}")
    check(all(np.array_equal(g, c) for g, c in zip(saved["cuda"], saved["cpu"])),
          "--search-radius 0: the card's outputs differ from --device cpu's")
    print(f"  gpu-denoise --search-radius 0 --configs nlm,multiframe: launches {s0_counts}, "
          "outputs equal to --device cpu's")
    for k, n in s0_counts.items():
        counts[k] += n

    # The tiled bilateral and layers configs with bf16 taps, as a library
    # caller runs them (gpu-denoise has no flag for it, as tpu-denoise has
    # none): each within the bf16 headroom of its exact output.
    out_bf16 = os.path.join(root, "out_bf16")
    os.makedirs(out_bf16)
    exact = Session(target, device="cuda", output_dir=out_bf16, warmup=False)
    tiled = Session(target, device="cuda", output_dir=out_bf16,
                    tiling=cfg.TilingConfig(compute_dtype="bfloat16"))
    for key, run_cfg, kernel in (("bilateral", cfg.GPU_BATTERY[0], "bilateral_bf16"),
                                 ("layers", cfg.GPU_BATTERY[1], "bilateral_guided_bf16")):
        want = exact.run(run_cfg).image
        stencils.reset_launches()
        res = tiled.run(run_cfg)
        got = res.image
        bf16_counts = {k: n for k, n in stencils.launches.items() if n}
        check(bf16_counts.get(kernel, 0) > 0 and not bf16_counts.get(kernel[:-5]),
              f"Session(tiling=bf16) {key}: launches {bf16_counts}")
        check(got.shape == (H, W, 4) and bool(np.isfinite(got).all()),
              f"Session(tiling=bf16) {key}: output shape or non-finite values")
        err = float(np.abs(got - want).max())
        check(np.allclose(got, want, **TOL_BF16_CONFIG),
              f"Session(tiling=bf16) {key}: max abs {err:.3g} from exact, beyond {TOL_BF16_CONFIG}")
        check(not np.array_equal(got, want), f"Session(tiling=bf16) {key}: equals exact")
        print(f"  Session(tiling=bf16) {key}: launches {bf16_counts}, exec "
              f"{res.report.exec_ns} ns, PSNR vs clean {psnr(got, clean):.2f} dB, vs exact "
              f"{psnr(got, want):.2f} dB (RGB {psnr(got[..., :3], want[..., :3]):.2f}), "
              f"max abs {err:.3g}")
        for k, n in bf16_counts.items():
            counts[k] += n
    return counts, out_main, exec_ns


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


def phase_turbo_kernels(torch, fast, stencils, cfg, frame_4k, frame_1080, hdr: bool = False):
    """The grid kernels and the pipeline against their plain versions, and
    the fused kernel against the build and slice kernels bit for bit: at 4K
    for each (D, K) of TURBO_CELLS, and on the 1080p target at each setting
    of the turbo battery. Drives the fused path, grid_pipeline(fused=True),
    at each 4K cell, its launch counts read just after each call. Returns
    ({kernel: {max_abs_err, ms, plain_ms, ...}}, the fused path's summed
    launch counts) and prints both pipelines' Mpix/s at each D at 4K. With
    hdr the frames are HDR content (phase 10): the same cells, the
    tolerances scaled by each frame's max |RGB|, the kernels timed at 4K D=2
    K=5; no fused path and no pipeline rates."""
    img4k = torch.from_numpy(frame_4k).to("cuda")
    img1080 = torch.from_numpy(frame_1080).to("cuda")
    results = {k: {"max_abs_err": 0.0}
               for k in ("pool", "build_grid", "slice_grid", "fused_grid")}
    path_counts = dict.fromkeys(stencils.launches, 0)
    tag = " HDR" if hdr else ""

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
        cells.append(("4K" + tag, img4k, d, levels, cfg.BilateralParams()))
        if d == 2:  # the other border and uniform alpha, once
            cells.append(("4K" + tag, img4k, d, levels, cfg.BilateralParams(
                border=cfg.BorderPolicy.ZERO, uniform_alpha=True)))
        if d == 2 and not hdr:  # RGB clipped to [0, 1] and scaled, once
            hdr4k = img4k.clone()
            hdr4k[..., :3] = hdr4k[..., :3].clamp(0.0, 1.0) * HDR_SCALE
            cells.append(("4K x4", hdr4k, d, levels, cfg.BilateralParams()))
    for d, sigma_s in TURBO_RUNS:
        if d > 1:
            cells.append(("1080p" + tag, img1080, d, turbo_levels(d),
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
        close(got, want, scaled(TOL_SLICE, max(1.0, float(img[..., :3].abs().max()))),
              f"slice_grid {case}")
        fused_args = (small, img, lmin, step, 1.0 / step, *build_args[3:7], d, slice_args[5])
        got = fast.fused_grid(*fused_args)
        two = fast.slice_grid(img, fast.build_grid(*build_args), *slice_args[2:])
        torch.cuda.synchronize()
        check(torch.equal(got, two), f"fused_grid {case}: differs from the build and slice kernels")
        # against its plain version, the composition of the two plain
        # versions (`want`): the build's bf16 flips through the slice
        note("fused_grid", case, got, want)
        if label == "4K":  # the fused path, as a caller drives it
            stencils.reset_launches()
            fused_out = fast.grid_pipeline(img, bp, levels, d, fused=True)
            counts = {k: n for k, n in stencils.launches.items() if n}
            check(counts == {"pool": 1, "fused_grid": 1},
                  f"grid_pipeline(fused=True) {case}: launches {counts}")
            for k, n in counts.items():
                path_counts[k] += n
            check(torch.equal(fused_out, fast.bilateral_fast(img, bp, levels, d)),
                  f"grid_pipeline(fused=True) {case}: differs from bilateral_fast")
        got = fast.bilateral_fast(img, bp, levels, d)
        want = fast.grid_pipeline_plain(img, bp, levels, d)
        torch.cuda.synchronize()
        scale = max(1.0, float(img[..., :3].abs().max()))
        err = float((got - want).abs().max())
        loose = float(((got - want).abs() > 1e-5 * scale).float().mean())
        check(err <= 2 * 2.0**-8 * scale and loose <= 0.01,
              f"pipeline {case}: max abs {err:.3g}, {loose:.3%} of pixels beyond "
              f"{1e-5 * scale:g}")
        print(f"  {'pipeline':10s} {case:36s} max abs {err:.3g} "
              f"({loose:.4%} of pixels beyond {1e-5 * scale:g})")
        if label == "4K" + tag and d == 2 and not ua:
            timed = {
                "pool": (lambda a=(img, d, border): fast.pool(*a),
                         lambda a=(img, d, border): fast.pool_plain(*a)),
                "build_grid": (lambda a=build_args: fast.build_grid(*a),
                               lambda a=build_args: fast.build_grid_plain(*a)),
                "slice_grid": (lambda a=slice_args: fast.slice_grid(*a),
                               lambda a=slice_args: fast.slice_grid_plain(*a)),
                "fused_grid": (lambda a=fused_args: fast.fused_grid(*a),
                               lambda a=fused_args: fast.fused_grid_plain(*a)),
            }
            shape = dict(pixels=img.shape[0] * img.shape[1], cells=small.shape[0] * small.shape[1],
                         levels=levels, taps=len(build_args[4]))
            # The library yardsticks: one avg_pool2d over the image as NCHW;
            # one trilinear grid_sample (alpha under green's t).
            nchw = img.permute(2, 0, 1)[None].contiguous()
            sample, planes = grid_sample_slice(torch, grid, img, lmin, 1.0 / step, d,
                                               [(0,), (1, 3), (2,)])
            kernel_out = fast.slice_grid(*slice_args)
            lib_err = max(float((v - kernel_out[..., p]).abs().max())
                          for p, v in planes(sample()).items())
            print(f"  grid_sample yardstick vs slice_grid {case}: max abs {lib_err:.3g}")
            library = {"pool": lambda a=(nchw, d): torch.nn.functional.avg_pool2d(*a),
                       "slice_grid": sample}

    where = f"4K{tag} D=2 K=5"
    if hdr:
        time_kernels(torch, results, timed, dict.fromkeys(timed, shape), library, where)
        return results, path_counts
    mpix = H4K * W4K / 1e6
    bp = cfg.BilateralParams()
    clamp = cfg.BorderPolicy.CLAMP
    for d, levels in TURBO_CELLS:
        ms = median_ms(torch, lambda: fast.bilateral_fast(img4k, bp, levels, d), 10)
        fused_ms = median_ms(torch, lambda: fast.grid_pipeline(img4k, bp, levels, d, fused=True),
                             10)
        plain_ms = median_ms(torch, lambda: fast.grid_pipeline_plain(img4k, bp, levels, d), 3)
        print(f"  pipeline D={d} K={levels} 4K median {ms:.4f} ms = {mpix / ms * 1e3:.1f} Mpix/s, "
              f"fused {fused_ms:.4f} ms = {mpix / fused_ms * 1e3:.1f} Mpix/s "
              f"(plain {plain_ms:.4f} ms = {mpix / plain_ms * 1e3:.1f} Mpix/s)")
        # The fused kernel against the two kernels it fuses, on one pooled
        # image and grid range, and as compiled at this D.
        small = fast.pool(img4k, d, clamp)
        lmin, step = fast.grid_range(small, levels)
        taps = fast._grid_taps(bp.sigma_spatial, d)
        build_args = (small, lmin, step, levels, taps, clamp, 0.5 / bp.sigma_color**2)
        fused_args = (small, img4k, lmin, step, 1.0 / step, *build_args[3:], d)
        fused_ms = median_ms(torch, lambda a=fused_args: fast.fused_grid(*a), 10)
        build_ms = median_ms(torch, lambda a=build_args: fast.build_grid(*a), 10)
        grid = fast.build_grid(*build_args)
        slice_ms = median_ms(torch, lambda: fast.slice_grid(img4k, grid, lmin, 1.0 / step, d), 10)
        print(f"  fused_grid 4K D={d} K={levels} median {fused_ms:.4f} ms against build_grid + "
              f"slice_grid {build_ms:.4f} + {slice_ms:.4f} = {build_ms + slice_ms:.4f} ms; "
              f"{json.dumps(fast.fused_grid_info(img4k.device, d, taps.size, clamp))}")
    time_kernels(torch, results, timed, dict.fromkeys(timed, shape), library, where)
    print_redesigned("build_grid 4K D=2 K=5",
                     fast.build_grid_info(img4k.device, shape["taps"], clamp),
                     results["build_grid"]["ms"])
    print_redesigned("fused_grid 4K D=2 K=5",
                     fast.fused_grid_info(img4k.device, 2, shape["taps"], clamp),
                     results["fused_grid"]["ms"])
    return results, path_counts


def time_kernels(torch, results, timed, shapes, library, where: str) -> None:
    """Median times of each kernel, its plain version and its library call,
    and its bound at shapes[kernel] (kernel_work's arguments), into
    results."""
    for kernel, (kfn, pfn) in timed.items():
        res = results[kernel]
        res["ms"] = median_ms(torch, kfn, 10)
        res["plain_ms"] = median_ms(torch, pfn, 3)
        res.update(bound(*kernel_work(kernel, **shapes[kernel])))
        res["library_ms"] = median_ms(torch, library[kernel], 10) if kernel in library else None
        lib = "none" if res["library_ms"] is None else f"{res['library_ms']:.4f} ms"
        print(f"  {kernel:17s} {where} median {res['ms']:.4f} ms (plain {res['plain_ms']:.4f} ms, "
              f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}, library {lib})")


def phase_guided_kernels(torch, fast, cfg, images, hdr: bool = False):
    """The guided grid's kernels against their plain versions: the build at
    the stored-grid bf16 contract, the slice at TOL_SLICE on the plain grid,
    and the fused kernel bit for bit against the two kernels, at 4K for each
    (D, K) of TURBO_CELLS (ZERO border once) and on the 1080p albedo layer at
    each setting of the turbo battery. images: {"4K" | "1080p": (target,
    layer)} on the card. Returns {kernel: {max_abs_err, ms, ...}}. With hdr
    the targets are HDR content (phase 10), the slice's absolute tolerance
    times the target's max |RGB|; the kernels are timed at 4K D=2 K=5 only."""
    kernels = ("build_guided_grid", "slice_guided_grid", "fused_guided")
    results = {k: {"max_abs_err": 0.0} for k in kernels}
    clamp, zero = cfg.BorderPolicy.CLAMP, cfg.BorderPolicy.ZERO
    inv2sc = 0.5 / cfg.LayersParams().sigma_color**2
    tag = " HDR" if hdr else ""

    def note(kernel, case, got, want):
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            check(bool(torch.isfinite(g.float()).all()), f"{kernel} {case}: non-finite output")
            err = max(err, float((g.float() - w.float()).abs().max()))
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
        print(f"  {kernel:17s} {case:34s} max abs {err:.3g}")

    cells = []  # (label, D, K, sigma_s, border)
    for d, levels in TURBO_CELLS:
        cells.append(("4K", d, levels, 2.0, clamp))
        if d == 2:
            cells.append(("4K", d, levels, 2.0, zero))
    for d, sigma_s in TURBO_RUNS:
        cells.append(("1080p", d, turbo_levels(d), sigma_s, clamp))

    timed, fused_vs_two = {}, {}
    for label, d, levels, sigma_s, border in cells:
        target, layer = images[label]
        label += tag
        tol = scaled(TOL_SLICE, max(1.0, float(target[..., :3].abs().max())))
        case = f"{label} D={d} K={levels} {border} sigma_s {sigma_s:g}"
        small_t = fast.pool_plain(target, d, border)
        small_l = fast.pool_plain(layer, d, border)
        lmin, step = fast.grid_range(small_l, levels)
        taps = fast._grid_taps(sigma_s, d)
        build_args = (small_t, small_l, lmin, step, levels, taps, border, inv2sc)
        grid = fast.build_guided_grid_plain(*build_args)
        got = fast.build_guided_grid(*build_args)
        note("build_guided_grid", case, (got,), (grid,))
        check_bf16_close(torch, got, grid, f"build_guided_grid {case}")
        slice_args = (layer, grid, lmin, 1.0 / step, d)
        want = fast.slice_guided_grid_plain(*slice_args)
        got = fast.slice_guided_grid(*slice_args)
        note("slice_guided_grid", case, got, want)
        for g, w in zip(got, want):
            ok = bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all())
            check(ok, f"slice_guided_grid {case}: max abs {float((g - w).abs().max()):.3g}")
        fused_args = (small_t, small_l, layer, lmin, step, 1.0 / step, levels, taps, border,
                      inv2sc, d)
        if fast.fused_guided_fits(d, taps.size, layer.device):
            got = fast.fused_guided(*fused_args)
            two = fast.slice_guided_grid(layer, fast.build_guided_grid(*build_args), lmin,
                                         1.0 / step, d)
            torch.cuda.synchronize()
            check(all(torch.equal(g, t) for g, t in zip(got, two)),
                  f"fused_guided {case}: differs from the two guided kernels")
            # against its plain version, the composition of the two plain
            # versions (`want`): the build's bf16 flips through the slice
            note("fused_guided", case, got, want)
        if label == "1080p" and d == 1:
            main_build = build_args  # the main path's --turbo 1 build
        if label == "4K" and d in (2, 4) and border == clamp:
            fused_vs_two[d] = (fused_args, build_args, slice_args[2:])
        if label == "4K" + tag and d == 2 and border == clamp:
            timed = {
                "build_guided_grid": (lambda a=build_args: fast.build_guided_grid(*a),
                                      lambda a=build_args: fast.build_guided_grid_plain(*a)),
                "slice_guided_grid": (lambda a=slice_args: fast.slice_guided_grid(*a),
                                      lambda a=slice_args: fast.slice_guided_grid_plain(*a)),
                "fused_guided": (lambda a=fused_args: fast.fused_guided(*a),
                                 lambda a=fused_args: fast.fused_guided_plain(*a)),
            }
            shape = dict(pixels=layer.shape[0] * layer.shape[1],
                         cells=small_t.shape[0] * small_t.shape[1], levels=levels,
                         taps=taps.size)
            # The slice's library yardstick: one trilinear grid_sample over
            # the planes of each channel (alpha's numerator under green's t).
            sample, planes = grid_sample_slice(torch, grid, layer, lmin, 1.0 / step, d,
                                               [(0, 4), (1, 3, 5), (2, 6)])
            kernel_out = torch.cat(fast.slice_guided_grid(*slice_args), -1)
            lib_err = max(float((v - kernel_out[..., p]).abs().max())
                          for p, v in planes(sample()).items())
            print(f"  grid_sample yardstick vs slice_guided_grid {case}: max abs {lib_err:.3g}")
            library = {"slice_guided_grid": sample}
    time_kernels(torch, results, timed, dict.fromkeys(timed, shape), library, f"4K{tag} D=2 K=5")
    if hdr:
        return results
    # The guided build at the main path's --turbo 1 shape, and as compiled.
    small_t, _, _, _, levels, taps, border, _ = main_build
    d1 = {"ms": median_ms(torch, lambda: fast.build_guided_grid(*main_build), 10),
          "plain_ms": median_ms(torch, lambda: fast.build_guided_grid_plain(*main_build), 3),
          **bound(*kernel_work("build_guided_grid", 0, cells=small_t.shape[0] * small_t.shape[1],
                               levels=levels, taps=taps.size))}
    print(f"  build_guided_grid 1080p D=1 K={levels} ({taps.size} taps) median {d1['ms']:.4f} ms "
          f"(plain {d1['plain_ms']:.4f} ms, bound {d1['bound_ms']:.4f} ms by {d1['bound_by']})")
    for where, n_taps, ms in (("4K D=2 K=5", shape["taps"], results["build_guided_grid"]["ms"]),
                              ("1080p D=1", taps.size, d1["ms"])):
        print_redesigned(f"build_guided_grid {where}",
                         fast.build_grid_info(small_t.device, n_taps, border, guided=True), ms)
    print_redesigned("fused_guided 4K D=2 K=5",
                     fast.fused_guided_info(small_t.device, 2, shape["taps"], clamp),
                     results["fused_guided"]["ms"])
    # The fused kernel against the two kernels it fuses, which the reference's
    # dispatch runs at d = 1 and 8 (the layers' default_guided_fused).
    for d, (fused_args, build_args, slice_rest) in sorted(fused_vs_two.items()):
        layer = fused_args[2]
        fused_ms = median_ms(torch, lambda a=fused_args: fast.fused_guided(*a), 10)
        build_ms = median_ms(torch, lambda a=build_args: fast.build_guided_grid(*a), 10)
        grid = fast.build_guided_grid(*build_args)
        slice_ms = median_ms(torch, lambda: fast.slice_guided_grid(layer, grid, *slice_rest), 10)
        print(f"  fused_guided 4K D={d} K={build_args[4]} median {fused_ms:.4f} ms against "
              f"build_guided_grid + slice_guided_grid {build_ms:.4f} + {slice_ms:.4f} = "
              f"{build_ms + slice_ms:.4f} ms")
    return results


# Kernels each turbo run may launch, and must: the grid configs through the
# bilateral grid (pool, build, slice; D=1 is the eager lattice) and the
# guided grid (fused at D = 2 and 4, the guided build and slice at D = 1 and
# 8, beside the pool); the NLM configs through the bf16 NLM, or with
# --weights-halfres the bf16 half-row NLM, and normalize.
def turbo_kernels(d: int, nlm: bool, flags: tuple = ()) -> set:
    if nlm:
        return {"nlm_hrw_bf16" if "--weights-halfres" in flags else "nlm_bf16", "normalize"}
    guided = {"fused_guided"} if d in (2, 4) else {"build_guided_grid", "slice_guided_grid"}
    return {"pool"} | guided | ({"build_grid", "slice_grid"} if d > 1 else set())


def output_names(cli, cfg) -> dict:
    """{config key: the file name gpu-denoise saves its output under}."""
    return {k: c.output_name(False) for k, c in zip(cli.CONFIG_KEYS, cfg.GPU_BATTERY)}


def turbo_battery(cli, cfg, imageio, anim, root, exact, device, run):
    """gpu-denoise --turbo D on anim's target, as phase 7 and
    tools/torch_turbo_quality.py make it: for each (D, sigma_s) of
    TURBO_RUNS one run of the grid configs, and at D = 2 one of NLM_CONFIGS
    for each flags of NLM_RUNS. exact: {config: its exact output}; run(argv)
    calls cli.main once and returns (rc, stdout, stderr). Yields each run as
    (D, sigma_s, keys, flags, stdout, {key: (output, dB vs clean, dB vs
    exact, RGB dB vs exact)}), the grid configs read against the exact tiled
    bilateral."""
    names = output_names(cli, cfg)
    for d, sigma_s in TURBO_RUNS:
        runs = [(cli.GRID_CONFIGS, ())]
        if d == 2:
            runs += [(NLM_CONFIGS, flags) for flags in NLM_RUNS]
        for keys, flags in runs:
            out_dir = os.path.join(root, f"turbo{d}_{keys[0]}{'_hrw' if flags else ''}")
            rc, text, err = run([anim["target"], "--device", device, "--clamp", "--turbo", str(d),
                                 *flags, "--sigma-spatial", f"{sigma_s:g}", "--configs",
                                 ",".join(keys), "--output-dir", out_dir])
            what = " ".join(("--turbo", str(d), *flags, "--configs", ",".join(keys)))
            check(rc == 0, f"{what} failed ({rc}): {err.strip()}")
            readings = {}
            for key in keys:
                out = imageio.load(os.path.join(out_dir, names[key]))[0]
                ref = exact["bilateral" if key == "linear" else key]
                readings[key] = (out, psnr(out, anim["clean"]), psnr(out, ref),
                                 psnr(out[..., :3], ref[..., :3]))
            yield d, sigma_s, keys, flags, text, readings


def phase_turbo_battery(cfg, stencils, cli, imageio, anim, root, exact_dir):
    """gpu-denoise --turbo D on the card (turbo_battery), each run's launch
    counts read just after it; checks every output against the clean render
    and phase 4's exact output of its config, with the gates at D = 2.
    Returns the summed launch counts."""
    names = output_names(cli, cfg)
    exact = {k: imageio.load(os.path.join(exact_dir, names[k]))[0]
             for k in ("bilateral", "layers") + NLM_CONFIGS}
    noisy_psnr = psnr(anim["frames"][TARGET_FRAME], anim["clean"])
    # config: (gate in dB against exact, channels it reads)
    gates = {"bilateral": (TURBO_GATE_DB, 4), "layers": (TURBO_LAYERS_GATE_DB, 3),
             "nlm": (TURBO_NLM_GATE_DB, 3)}
    hrw_gates = {"nlm": (TURBO_HRW_GATE_DB, 3)}
    totals = dict.fromkeys(stencils.launches, 0)
    counts = {}

    def run(argv):
        stencils.reset_launches()
        result = run_cli(cli, argv)
        counts.update(stencils.launches)
        return result

    for d, sigma_s, keys, flags, text, readings in turbo_battery(cli, cfg, imageio, anim, root,
                                                                 exact, "cuda", run):
        what = " ".join(("--turbo", str(d), *flags, "--configs", ",".join(keys)))
        expected = turbo_kernels(d, keys[0] == "nlm", flags)
        run_gates = hrw_gates if flags else gates
        check(all(counts[k] > 0 for k in expected), f"{what}: launches {counts}")
        check(all(counts[k] == 0 for k in counts if k not in expected),
              f"{what} launched a kernel of another path: {counts}")
        for k, n in counts.items():
            totals[k] += n
        reports = re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", text)
        check(len(reports) == len(keys), f"{what}: {len(reports)} timing reports")
        print(f"  {what} (sigma_s {sigma_s:g}) launches "
              f"{ {k: counts[k] for k in sorted(expected)} }")
        # gpu-denoise runs (and reports) the selected configs in its own order
        for key, (tr, ex) in zip([k for k in cli.CONFIG_KEYS if k in keys], reports):
            out, db_clean, db_exact, db_rgb = readings[key]
            check(out.shape == (H, W, 4) and bool(np.isfinite(out).all()),
                  f"{what} {key}: output shape {out.shape} or non-finite values")
            check(db_clean > noisy_psnr, f"{what} {key}: {db_clean:.2f} dB vs clean, "
                                         f"noisy {noisy_psnr:.2f} dB")
            if d == 2 and key in run_gates:
                gate, channels = run_gates[key]
                got = db_exact if channels == 4 else db_rgb
                check(got >= gate, f"{what} {key}: {got:.2f} dB vs exact over "
                                   f"{channels} channels < {gate} dB")
            print(f"    {key:10s} transfer {int(tr):>10d} ns  exec {int(ex):>10d} ns  "
                  f"PSNR vs clean {db_clean:.2f} dB, vs exact {db_exact:.2f} dB "
                  f"(RGB {db_rgb:.2f} dB)")
        if "linear" in keys:
            check(np.array_equal(readings["bilateral"][0], readings["linear"][0]),
                  f"{what}: bilateral and linear outputs differ")
    return totals


def busy_ms(intervals) -> float:
    """The length of the union of (start, end) intervals in microseconds, in
    milliseconds."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def read_trace(path: str, keys) -> tuple[dict, list]:
    """A Chrome trace of torch.profiler: ({key: (start, end) of its one
    span}, [device events: kernels, copies and fills]), times in
    microseconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in keys:
            check(e["name"] not in spans, f"trace: two spans named {e['name']}")
            spans[e["name"]] = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    return spans, [e for e in events if e.get("cat") in DEVICE_EVENTS]


def phase_cpu_parity_profile(torch, cfg, stencils, cli, imageio, content, reference, native,
                             kernels, anim, root, exact_dir):
    """Phase 8: the card's render against the host's; the parity reading on
    two frames (the bilateral kernel also against its plain version, into
    kernels); the CPU configs through gpu-denoise on the crop; the six device
    configs through gpu-denoise --profile, their outputs equal to phase 4's
    files. Returns the launch counts of the profiled run."""
    h, w = CPU_CROP
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render = content.synthetic_render_device(H4K, W4K, seed=1, device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    gen_ms = median_ms(torch, lambda: content.synthetic_render_device(H4K, W4K, seed=1,
                                                                       device="cuda"), 3)
    t0 = time.perf_counter()
    host = content.synthetic_render(H4K, W4K, seed=1)
    host_s = time.perf_counter() - t0
    got = render.cpu().numpy()
    err = float(np.abs(got - host).max())
    check(got.shape == host.shape and err < CONTENT_TOL,
          f"synthetic_render_device 4K: max abs {err:.3g} from the host's, bound {CONTENT_TOL}")
    check(bool((got[..., 3] == 1.0).all()) and 0.0 <= got.min() and got.max() <= 1.0,
          "synthetic_render_device 4K: alpha not 1 or values outside [0, 1]")
    print(f"  synthetic_render_device {W4K}x{H4K} seed 1: max abs {err:.3g} from the host's; "
          f"first call {first_s:.3f} s, then median {gen_ms:.4f} ms of device time "
          f"(host numpy {host_s:.3f} s)")

    # The parity reading, as bench.py:1104-1119 takes it.
    cp = cfg.CpuBilateralParams()
    kp = cfg.BilateralParams(radius=cp.radius, sigma_spatial=cp.sigma_spatial,
                             sigma_color=cp.sigma_color, blue_bug=cp.blue_bug)
    r = cp.radius
    interior = (slice(r, -r), slice(r, -r), slice(0, 3))
    check(native.available(), "phase 8: no native library loaded")
    oracle = "native"
    rng = np.random.default_rng(SEED)
    uniform = rng.uniform(0, 1, (96, 128, 4)).astype(np.float32)
    y0, x0 = (H4K - h) // 2, (W4K - w) // 2
    crop = got[y0 : y0 + h, x0 : x0 + w].copy()
    crop[..., :3] = np.clip(crop[..., :3] + rng.normal(0, NOISE, (h, w, 3)).astype(np.float32),
                            0.0, 1.0)
    frames = {"uniform 96x128": uniform, f"render crop {w}x{h} + noise": crop}
    stencils.reset_launches()
    outs = {name: stencils.bilateral(torch.from_numpy(img).to("cuda"), kp)
            for name, img in frames.items()}
    parity_counts = {k: n for k, n in stencils.launches.items() if n}
    check(parity_counts == {"bilateral": 2}, f"parity readings: launches {parity_counts}")
    for name, img in frames.items():
        plain = stencils.bilateral_plain(torch.from_numpy(img).to("cuda"), None, kp, True)[0]
        torch.cuda.synchronize()
        diff = (outs[name] - plain).abs()
        abs_err = float(diff.max())
        check(bool((diff <= TOL_BILATERAL["atol"] + TOL_BILATERAL["rtol"] * plain.abs()).all()),
              f"bilateral at the CPU parameters, {name}: max abs {abs_err:.3g} from plain")
        kernels["bilateral"]["max_abs_err"] = max(kernels["bilateral"]["max_abs_err"], abs_err)
        t0 = time.perf_counter()
        want = native.cpu_bilateral(img, cp, 8)
        oracle_s = time.perf_counter() - t0
        db = reference.psnr(outs[name].cpu().numpy()[interior], want[interior])
        check(db >= PARITY_GATE_DB, f"parity {name}: {db:.2f} dB < {PARITY_GATE_DB} dB")
        print(f"  parity vs the CPU bilateral ({oracle} oracle, {oracle_s:.2f} s), {name}: "
              f"{db:.2f} dB over interior RGB (gate {PARITY_GATE_DB:g}); max abs {abs_err:.3g} "
              "from plain")
    target = torch.from_numpy(anim["frames"][TARGET_FRAME]).to("cuda")
    ms = median_ms(torch, lambda: stencils.bilateral(target, kp), 10)
    cpu_bound = bound(*kernel_work("bilateral", H * W, disk=disk_taps(stencils, kp)))
    print(f"  parity readings: launches {parity_counts}; bilateral_staged_kernel at the CPU "
          f"parameters {json.dumps(stencils.kernel_info('bilateral', target.device, kp))}, "
          f"{W}x{H} median {ms:.4f} ms (bound {cpu_bound['bound_ms']:.4f} ms by "
          f"{cpu_bound['bound_by']}; at the reference parameters {kernels['bilateral']['ms']:.4f} ms)")

    # The CPU configs on the crop, as a user runs them.
    small = os.path.join(root, "cpu", "frame_0000.png")
    os.makedirs(os.path.dirname(small))
    imageio.save(small, crop)
    out_cpu = os.path.join(root, "out_cpu")
    stencils.reset_launches()
    rc, text, err = run_cli(cli, [small, "--device", "cuda", "--configs", "cpu1,cpu8",
                                  "--output-dir", out_cpu])
    cpu_counts = {k: n for k, n in stencils.launches.items() if n}
    check(rc == 0, f"gpu-denoise --configs cpu1,cpu8 failed ({rc}): {err.strip()}")
    check(not cpu_counts, f"the CPU configs launched kernels: {cpu_counts}")
    secs = re.findall(r"Time taken: (\S+) sec", text)
    check(len(secs) == 2, f"the CPU configs printed {len(secs)} 'Time taken:' lines")
    out, _ = imageio.load(os.path.join(out_cpu, "output-cpu.png"))
    inside = np.zeros((h, w), bool)
    inside[r : h - r + 1, r : w - r + 1] = True
    check(out.shape == (h, w, 4) and bool((out[~inside] == 0.0).all())
          and bool((out[inside][:, 3] == 1.0).all()),
          "output-cpu.png: shape, a border not zero or alpha not 1 inside")
    t0 = time.perf_counter()
    numpy_out = reference.cpu_bilateral_reference(imageio.load(small)[0], cp)
    numpy_s = time.perf_counter() - t0
    lsb = 255.0 * float(np.abs(out - imageio.to_float(imageio.quantize(numpy_out))).max())
    check(lsb <= 1.0 + 1e-3, f"output-cpu.png: {lsb:.1f} LSB from the NumPy oracle's")
    print(f"  gpu-denoise --configs cpu1,cpu8 on {w}x{h} ({oracle} oracle): cpu1 {secs[0]} s, "
          f"cpu8 {secs[1]} s; no launch; output-cpu.png zero in its {r}-pixel border, within "
          f"{lsb:.0f} LSB of the NumPy oracle's ({numpy_s:.2f} s on one thread)")

    # The six device configs under the profiler.
    prof_dir = os.path.join(root, "prof")
    out_prof = os.path.join(root, "out_prof")
    stencils.reset_launches()
    t0 = time.perf_counter()
    rc, text, err = run_cli(cli, [anim["target"], "--device", "cuda", "--clamp", "--configs",
                                  ",".join(cli.CONFIG_KEYS), "--profile", prof_dir,
                                  "--output-dir", out_prof])
    prof_s = time.perf_counter() - t0
    counts = dict(stencils.launches)
    check(rc == 0, f"gpu-denoise --profile failed ({rc}): {err.strip()}")
    check(f"profile trace written to {prof_dir}" in text, "gpu-denoise --profile: no trace line")
    trace = os.path.join(prof_dir, cli.TRACE_NAME)
    t0 = time.perf_counter()
    spans, device = read_trace(trace, cli.CONFIG_KEYS)
    parse_s = time.perf_counter() - t0
    check(sorted(spans) == sorted(cli.CONFIG_KEYS), f"trace spans {sorted(spans)}")
    for name, keys in PROFILE_KERNELS.items():
        events = sum(e["cat"] == "kernel" and name in e["name"] for e in device)
        launched = sum(counts[k] for k in keys)
        check(launched > 0 and events == launched,
              f"trace: {events} {name} events for {launched} launches of {keys}")
        print(f"  trace: {events} {name} events = launches of {'+'.join(keys)}")
    print(f"  gpu-denoise --profile, six configs: {prof_s:.2f} s, trace "
          f"{os.path.getsize(trace) / 1e6:.2f} MB, {len(device)} device events, parsed in "
          f"{parse_s:.2f} s; launches { {k: n for k, n in counts.items() if n} }")
    for key in cli.CONFIG_KEYS:
        start, end = spans[key]
        busy = busy_ms((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                       for e in device if start <= float(e["ts"]) < end)
        host_ms = (end - start) / 1e3
        print(f"    {key:10s} span {host_ms:.3f} ms on the host, device busy {busy:.3f} ms "
              f"({busy / host_ms:.2%})")
    names = sorted(os.listdir(exact_dir))
    check(sorted(os.listdir(out_prof)) == names, f"--profile wrote {sorted(os.listdir(out_prof))}")
    for name in names:
        with open(os.path.join(exact_dir, name), "rb") as a, \
                open(os.path.join(out_prof, name), "rb") as b:
            check(a.read() == b.read(), f"--profile: {name} differs from phase 4's")
    print(f"  --profile outputs equal phase 4's {len(names)} files byte for byte")
    return counts


def sum_counts(stencils, rank_counts) -> dict:
    """Launch counts summed over the ranks' dicts."""
    total = dict.fromkeys(stencils.launches, 0)
    for counts in rank_counts:
        for k, n in counts.items():
            total[k] += n
    return total


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_sharded(torch, cfg, stencils, fast, cli, imageio, launch, dryrun, anim, root,
                  exact_dir, smi):
    """Phase 9: gpu-denoise --mesh on four ranks that share the card over
    gloo. The exact battery on 1x4 and 2x2 against phase 4's files, the
    sharded turbo against phase 7's files or the single-device pipeline on
    the same padded frame; the slab slice kernels against their plain
    versions with offsets; the HDR frame of phase 5 through the sharded turbo
    grid; the dry run. Each run's launch counts are summed over its ranks,
    read just after it. Returns the launch counts of all of them, summed."""
    names = output_names(cli, cfg)
    target = anim["target"]
    totals = dict.fromkeys(stencils.launches, 0)
    gloo = ("--dist-backend", "gloo")

    def run(what, argv):
        t0 = time.perf_counter()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc, rank_counts = cli.run(argv)
        check(rc == 0, f"{what} failed ({rc}): {err.getvalue().strip()[-2000:]}")
        counts = sum_counts(stencils, rank_counts)
        check(len(rank_counts) == 4, f"{what}: {len(rank_counts)} ranks")
        for k, n in counts.items():
            totals[k] += n
        reports = re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", out.getvalue())
        print(f"  {what}: {time.perf_counter() - t0:.1f} s, launches summed over 4 ranks "
              f"{ {k: n for k, n in counts.items() if n} }")
        return counts, reports

    def print_reports(keys, reports):
        check(len(reports) == len(keys), f"{len(reports)} timing reports for {len(keys)} configs")
        for key, (tr, ex) in zip(keys, reports):
            print(f"    {key:10s} rank 0 transfer {int(tr):>11d} ns  exec {int(ex):>11d} ns "
                  f"({smi}; 4 ranks on one card: overhead, not scaling)")

    keys = cli.CONFIG_KEYS
    # 1-2. the exact battery on 1x4 and on 2x2
    for mesh in ("1x4", "2x2"):
        out_dir = os.path.join(root, f"mesh{mesh}")
        counts, reports = run(f"gpu-denoise --mesh {mesh} (six configs)",
                              [target, "--device", "cuda", "--clamp", "--configs", ",".join(keys),
                               "--mesh", mesh, *gloo, "--output-dir", out_dir])
        print_reports(keys, reports)
        for key in keys:
            got, want = os.path.join(out_dir, names[key]), os.path.join(exact_dir, names[key])
            if mesh == "1x4" or key not in ("multiframe", "overlap"):
                check(same_bytes(got, want), f"--mesh {mesh} {key}: differs from phase 4's file")
            else:  # the SUM over 'frame' regroups the frames' partials
                lsb = float(np.abs(imageio.load(got)[0] - imageio.load(want)[0]).max()) * 255
                check(lsb <= 1.0 + 1e-3, f"--mesh {mesh} {key}: {lsb:.1f} LSB from phase 4's")
                print(f"    {key}: within {lsb:.0f} LSB of phase 4's file")
        # The split path: three launches a band and call (the warm-up and the
        # timed call) of the bilateral (#1), of each layer's guided bilateral,
        # and of the single-frame NLM (#2) beside the multiframe NLM's
        # frame-batched launches; normalize (#4) once a band and call.
        calls = 2 * 4
        check(counts["bilateral"] == 3 * calls and counts["bilateral_guided"] == 3 * 3 * calls,
              f"--mesh {mesh}: bilateral launches {counts['bilateral']}, guided "
              f"{counts['bilateral_guided']}, expected {3 * calls} and {9 * calls}")
        check(counts["nlm"] > 3 * calls and counts["normalize"] >= 2 * calls,
              f"--mesh {mesh}: nlm {counts['nlm']}, normalize {counts['normalize']}")
        print(f"    every file {'equal to' if mesh == '1x4' else 'within the bounds of'} phase 4's; "
              "the split path launched 3 kernels a band and call")

    # 3. --turbo 2 (and the half-row NLM) on 1x4: 270 rows a band, no padding
    out_dir = os.path.join(root, "mesh_turbo2")
    tkeys = ("bilateral", "layers", "linear", "nlm")
    counts, reports = run("gpu-denoise --turbo 2 --weights-halfres --mesh 1x4",
                          [target, "--device", "cuda", "--clamp", "--turbo", "2",
                           "--weights-halfres", "--configs", ",".join(tkeys), "--mesh", "1x4",
                           *gloo, "--output-dir", out_dir])
    print_reports(tkeys, reports)
    for key in tkeys:
        phase7 = os.path.join(root, "turbo2_nlm_hrw" if key == "nlm" else "turbo2_bilateral")
        check(same_bytes(os.path.join(out_dir, names[key]), os.path.join(phase7, names[key])),
              f"--turbo 2 --mesh 1x4 {key}: differs from phase 7's file")
    for kernel in ("pool", "build_grid", "slice_grid", "build_guided_grid", "slice_guided_grid",
                   "nlm_hrw_bf16", "normalize"):
        check(counts[kernel] > 0, f"--turbo 2 --mesh 1x4 launched no {kernel}")
    check(counts["fused_guided"] == 0 and counts["fused_grid"] == 0,
          "the sharded turbo launched a fused kernel")
    print("    bilateral, linear, layers and the half-row NLM equal phase 7's files")

    # 4. --turbo 4 on 1x4: bands of ceil_4(max(ceil(H/4), 4 (ceil(13/4) + 1)))
    # rows, 272 at 1080p (Session._turbo_pad_rows), edge padded
    out_dir = os.path.join(root, "mesh_turbo4")
    counts, reports = run("gpu-denoise --turbo 4 --mesh 1x4",
                          [target, "--device", "cuda", "--clamp", "--turbo", "4", "--configs",
                           "bilateral", "--mesh", "1x4", *gloo, "--output-dir", out_dir])
    print_reports(("bilateral",), reports)
    loaded = imageio.load(target)[0]
    rg = -(-cfg.BilateralParams().effective_radius // 4)
    band_rows = -(-max(-(-H // 4), 4 * (rg + 1)) // 4) * 4
    padded = np.pad(loaded, ((0, 4 * band_rows - H), (0, 0), (0, 0)), mode="edge")
    want = fast.bilateral_fast(torch.from_numpy(padded).to("cuda"), cfg.BilateralParams(),
                               turbo_levels(4), 4)[:H].cpu().numpy()
    got = imageio.load(os.path.join(out_dir, names["bilateral"]))[0]
    check(np.array_equal(got, imageio.to_float(imageio.quantize(want, clamp=True))),
          "--turbo 4 --mesh 1x4: differs from bilateral_fast on the padded frame")
    print(f"    equal to bilateral_fast on the same edge-padded {4 * band_rows}-row frame")

    # 6. the slab slice kernels with offsets at 4K D=2, and the HDR frame
    noisy_4k = anim["noisy_4k"]
    img = torch.from_numpy(noisy_4k).to("cuda")
    d, levels, bp = 2, turbo_levels(2), cfg.BilateralParams()
    small = fast.pool(img, d)
    lmin, step = fast.grid_range(small, levels)
    taps = fast._grid_taps(bp.sigma_spatial, d)
    grid = fast.build_grid(small, lmin, step, levels, taps, bp.border, 0.5 / bp.sigma_color**2)
    ggrid = fast.build_guided_grid(small, small, lmin, step, levels, taps, bp.border,
                                   0.5 / bp.sigma_color**2)
    whole = fast.slice_grid(img, grid, lmin, 1.0 / step, d)
    gwhole = fast.slice_guided_grid(img, ggrid, lmin, 1.0 / step, d)
    rows, hs = H4K // 4, H4K // d
    for i in (0, 1, 3):
        band = img[i * rows : (i + 1) * rows].contiguous()
        lo = max(i * rows // d - 1, 0)
        off = (i * rows, hs, lo)
        slab = grid[:, lo : min((i + 1) * rows // d + 1, hs)].contiguous()
        got = fast.slice_grid(band, slab, lmin, 1.0 / step, d, None, *off)
        want = fast.slice_grid_plain(band, slab, lmin, 1.0 / step, d, None, off)
        torch.cuda.synchronize()
        check(torch.equal(got, whole[i * rows : (i + 1) * rows]),
              f"slice_grid slab band {i}: differs from the whole slice's rows")
        ok = bool(((got - want).abs() <= TOL_SLICE["atol"] + TOL_SLICE["rtol"] * want.abs()).all())
        check(ok, f"slice_grid slab band {i}: beyond {TOL_SLICE} of its plain version")
        gslab = ggrid[:, lo : min((i + 1) * rows // d + 1, hs)].contiguous()
        got = fast.slice_guided_grid(band, gslab, lmin, 1.0 / step, d, *off)
        want = fast.slice_guided_grid_plain(band, gslab, lmin, 1.0 / step, d, off)
        for g, w_, part in zip(got, want, gwhole):
            check(torch.equal(g, part[i * rows : (i + 1) * rows]),
                  f"slice_guided_grid slab band {i}: differs from the whole slice's rows")
            ok = bool(((g - w_).abs() <= TOL_SLICE["atol"] + TOL_SLICE["rtol"] * w_.abs()).all())
            check(ok, f"slice_guided_grid slab band {i}: beyond {TOL_SLICE} of its plain version")
        if i == 1:
            slab_ms = median_ms(torch, lambda: fast.slice_grid(band, slab, lmin, 1.0 / step, d,
                                                               None, *off), 10)
    print(f"  slab slices at 4K D=2, bands 0, 1 and 3 of 4 (offsets y_off, hs_all, gy_off): "
          f"the whole slice's rows bit for bit, within {TOL_SLICE} of the plain versions; "
          f"slice_grid on band 1 median {slab_ms:.4f} ms ({smi})")
    del whole, gwhole, grid, ggrid
    hdr = noisy_4k.copy()
    hdr[..., :3] = np.clip(hdr[..., :3], 0.0, 1.0) * HDR_SCALE
    cases = [{"name": "hdr", "kind": "bilateral_fast", "inputs": {"img": hdr},
              "kw": {"params": bp, "levels": levels, "downsample": d}}]
    out_dir = os.path.join(root, "hdr_sharded")
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    rank_counts = launch.run_ranks(4, dryrun.run_cases, cases, out_dir, (1, 4), "cuda",
                                   backend="gloo", device_type="cuda", timeout_s=600)
    ranks_s = time.perf_counter() - t0
    counts = sum_counts(stencils, rank_counts)
    for k, n in counts.items():
        totals[k] += n
    (got,) = dryrun.load_outputs(out_dir, "hdr")
    want = fast.bilateral_fast(torch.from_numpy(hdr).to("cuda"), bp, levels, d).cpu().numpy()
    check(got.shape == (H4K, W4K, 4) and np.isfinite(got).all(), "HDR sharded turbo: output")
    check(np.array_equal(got, want), f"HDR sharded turbo 4K D=2 at 1x4: max abs "
                                     f"{np.abs(got - want).max():.3g} from the single-device")
    print(f"  HDR 4K (RGB in [0, {HDR_SCALE:g}]) through spatial_bilateral_fast at 1x4: equal to "
          f"the single-device pipeline bit for bit ({time.perf_counter() - t0:.1f} s, the "
          f"ranks {ranks_s:.1f} s; launches {sum(counts.values())})")

    # 7. the dry run on four ranks of the card
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        counts = dryrun.dryrun(4, "cuda", "gloo")
    for k, n in counts.items():
        totals[k] += n
    for line in out.getvalue().splitlines():
        print("  " + line)
    print(f"  parallel.dryrun --ranks 4 --device cuda: {time.perf_counter() - t0:.1f} s")
    return totals


def native_codec_check(native, imageio, paths) -> str:
    """Each EXR of `paths` decoded by the native codec against the Python
    one, the native encode of it decoded again, and the frames through the
    native frame loader (the overlap loop's decode path) against
    imageio.load. Fails on any difference, or where load and save do not
    run the native codec. Returns the line to print."""
    from image_denoising_filter_tpu_torch.utils import exr

    check(native.available() and imageio.codec() == "native",
          "the native codec is not the one load and save run")
    dec, enc = [], []
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        got = native.exr_decode(data)
        dec.append(time.perf_counter() - t0)
        want = exr.decode(data)
        t0 = time.perf_counter()
        blob = native.exr_encode(got)
        enc.append(time.perf_counter() - t0)
        check(np.array_equal(got, want), f"{path}: the native decode differs from the Python one")
        check(np.array_equal(exr.decode(blob), want), f"{path}: the native encode decodes otherwise")
    loader = native.FrameLoader(paths)
    try:
        for path, got in zip(paths, loader):
            check(np.array_equal(got, imageio.load(path)[0]),
                  f"{path}: the frame loader's array differs from imageio.load's")
    finally:
        loader.close()
    return (f"native codec: every frame decodes to the Python codec's arrays, its encodes "
            f"decode back, the frame loader agrees; decode {1e3 * statistics.median(dec):.1f} ms, "
            f"encode {1e3 * statistics.median(enc):.1f} ms per 1080p frame (median of "
            f"{len(paths)})")


def mapped_libgomp() -> list:
    """The libgomp files this process has mapped (one OpenMP runtime is
    shared by everything that needs libgomp.so.1)."""
    with open("/proc/self/maps") as f:
        return sorted({line.split()[-1] for line in f if "libgomp" in line})


def stream_ms(torch, FramePrefetcher, paths, loader, native_paths: bool) -> tuple[float, str]:
    """Host ms to stream `paths` to the card through FramePrefetcher as the
    overlap loop does (depth 2), the construction included: decoding on
    the native loader's threads, or `loader` on this thread. Returns the ms
    and the loader that ran."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = FramePrefetcher(paths, loader, "cuda", depth=2, native_paths=native_paths)
    for _ in frames:
        pass
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), frames.loader


def phase_host_runtime(torch, cfg, stencils, cli, imageio, dataset, native, reference, Session,
                       anim, hdr, root, exact_dir, exec4, hdr_dir, hdr_exec, smi):
    """Phase 11: the native host library on the card's machine. Its build
    (route, compiler, libgomp, threads); the default gpu-denoise run (all
    eight configs) against phase 4's files and the parity gate; the overlap
    config on the native frame loader against phase 4's and phase 10's
    files, with the streaming's host time on both loaders; --all-frames
    over the LDR animation; the exact configs on the EXR target through
    --mesh 1x4. Returns the launch counts of the runs, summed."""
    from image_denoising_filter_tpu_torch.runtime import FramePrefetcher
    from image_denoising_filter_tpu_torch.utils import exr, png

    totals = dict.fromkeys(stencils.launches, 0)

    def add(counts):
        for k, n in counts.items():
            totals[k] += n

    # 1. the build
    info = native.ensure()
    cores = os.cpu_count() or 1
    check(info.route in NATIVE_ROUTES, f"the native library came from {info.route}, "
                                       "not the port's build")
    check(info.openmp, f"{info.path}: no OpenMP")
    check(info.threads >= min(CPU8_MIN_CORES, cores),
          f"idf_num_threads() {info.threads} on {cores} cores")
    print(f"  native library: route {info.route} ({NATIVE_ROUTES[info.route]}), "
          f"{info.build_s:.2f} s of g++ ({info.compiler}) -> {os.path.relpath(info.path, REPO)}")
    refused = [line.strip() for line in info.log.splitlines()
               if "libgomp.spec" in line or "omp.h" in line]
    if refused:
        print(f"    route a refused: {refused[0]}")
    print(f"    libgomp linked {info.libgomp}; mapped {', '.join(mapped_libgomp())}; "
          f"idf_num_threads() {info.threads}, os.cpu_count() {cores}")

    # 2. the default run: the six device configs, then cpu1 and cpu8
    names = output_names(cli, cfg)
    target = anim["target"]
    out_default = os.path.join(root, "out_default")
    stencils.reset_launches()
    t0 = time.perf_counter()
    rc, text, err = run_cli(cli, [target, "--device", "cuda", "--clamp", "--output-dir",
                                  out_default])
    run_s = time.perf_counter() - t0
    counts = dict(stencils.launches)
    check(rc == 0, f"gpu-denoise <target> (default configs) failed ({rc}): {err.strip()}")
    check(all(counts[k] > 0 for k in ("bilateral", "bilateral_guided", "nlm", "normalize")),
          f"the default run: launches {counts}")
    add(counts)
    banners = [text.find(b) for b in ("multiframe NLM with copy/compute overlap",
                                      "bilateral filter on cpu (1 thread)",
                                      "bilateral filter on cpu (8 threads)")]
    check(-1 < banners[0] < banners[1] < banners[2], "the default run: configs missing or "
                                                     "out of order")
    reports = re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", text)
    secs = [float(x) for x in re.findall(r"Time taken: (\S+) sec", text)]
    check(len(reports) == 6 and len(secs) == 2,
          f"the default run: {len(reports)} timing reports, {len(secs)} 'Time taken:' lines")
    check(sorted(os.listdir(out_default)) == sorted([*names.values(), "output-cpu.png"]),
          f"the default run wrote {sorted(os.listdir(out_default))}")
    for key in cli.CONFIG_KEYS:
        check(same_bytes(os.path.join(out_default, names[key]), os.path.join(exact_dir, names[key])),
              f"the default run: {key} differs from phase 4's file")
    print(f"  gpu-denoise <{W}x{H} target> --device cuda --clamp (no --configs): {run_s:.1f} s, "
          f"launches { {k: n for k, n in counts.items() if n} }; the six device files equal "
          "phase 4's byte for byte")
    for key, (tr, ex) in zip(cli.CONFIG_KEYS, reports):
        print(f"    {key:10s} transfer {int(tr):>11d} ns  exec {int(ex):>11d} ns "
              f"(phase 4: exec {exec4[key]} ns)")
    cp = cfg.CpuBilateralParams()
    kp = cfg.BilateralParams(radius=cp.radius, sigma_spatial=cp.sigma_spatial,
                             sigma_color=cp.sigma_color, blue_bug=cp.blue_bug)
    r = cp.radius
    out = imageio.load(os.path.join(out_default, "output-cpu.png"))[0]
    inside = np.zeros((H, W), bool)
    inside[r : H - r + 1, r : W - r + 1] = True
    check(out.shape == (H, W, 4) and bool((out[~inside] == 0.0).all())
          and bool((out[inside][:, 3] == 1.0).all()),
          "the default run's output-cpu.png: shape, a border not zero or alpha not 1 inside")
    frame = imageio.load(target)[0]
    kernel = stencils.bilateral(torch.from_numpy(frame).to("cuda"), kp).cpu().numpy()
    interior = (slice(r, -r), slice(r, -r), slice(0, 3))
    db_file = reference.psnr(out[interior],
                             imageio.to_float(imageio.quantize(kernel, clamp=True))[interior])
    db_float = reference.psnr(kernel[interior], native.cpu_bilateral(frame, cp, 8)[interior])
    check(min(db_file, db_float) >= PARITY_GATE_DB,
          f"the default run's parity: file {db_file:.2f} dB, float {db_float:.2f} dB "
          f"< {PARITY_GATE_DB} dB")
    filter_s = {}
    for n in (1, 8):
        t0 = time.perf_counter()
        native.cpu_bilateral(frame, cp, n)
        filter_s[n] = time.perf_counter() - t0
    speedup = filter_s[1] / filter_s[8]
    if cores >= CPU8_MIN_CORES:
        check(speedup >= CPU8_MIN_SPEEDUP, f"the CPU bilateral on 8 threads {filter_s[8]:.3f} s "
                                           f"is {speedup:.2f}x 1 thread's {filter_s[1]:.3f} s, "
                                           f"below {CPU8_MIN_SPEEDUP}x")
    print(f"    cpu1 {secs[0]:.3f} s, cpu8 {secs[1]:.3f} s ({secs[0] / secs[1]:.2f}x; load, filter "
          f"and save at {W}x{H}); the filter alone {filter_s[1]:.3f} s on 1 thread, "
          f"{filter_s[8]:.3f} s on 8 ({speedup:.2f}x; {cores} host cores; {smi})")
    print(f"    output-cpu.png zero in its {r}-pixel border, "
          f"alpha 1 inside; parity against the bilateral kernel at the CPU parameters over "
          f"interior RGB: {db_file:.2f} dB file to file (the kernel's output written as the run "
          f"writes it), {db_float:.2f} dB as floats (gate {PARITY_GATE_DB:g})")

    # 3. the overlap config on the native frame loader, PNG and EXR
    overlap = cfg.GPU_BATTERY[5]
    for label, tgt, ref_dir, ref_exec, is_hdr, codec in (
            ("PNG", target, exact_dir, exec4["overlap"], False,
             lambda p: imageio.to_float(png.read(p))),
            ("EXR", hdr["target"], hdr_dir, hdr_exec["overlap"], True, exr.read)):
        out_dir = os.path.join(root, f"overlap_{label}")
        os.makedirs(out_dir)
        stencils.reset_launches()
        res = Session(tgt, device="cuda", output_dir=out_dir, clamp_output=not is_hdr).run(overlap)
        counts = {k: n for k, n in stencils.launches.items() if n}
        add(counts)
        check(res.frame_loader == "native", f"overlap {label}: the {res.frame_loader} loader ran")
        want = os.path.join(ref_dir, overlap.output_name(is_hdr))
        if is_hdr:
            check(np.array_equal(check_hdr_output(res.output_path, "overlap EXR"),
                                 imageio.load(want)[0]), "overlap EXR: differs from phase 10's")
        else:
            check(same_bytes(res.output_path, want), "overlap PNG: differs from phase 4's file")
        ds = dataset.discover(tgt, multiframe=True, max_frames=overlap.max_frames)
        frames = ds.frames[:-1]  # the frames the overlap loop streams
        py_ms, py_loader = stream_ms(torch, FramePrefetcher, frames, codec, False)
        nat_ms, nat_loader = stream_ms(torch, FramePrefetcher, frames, codec, True)
        check((py_loader, nat_loader) == ("python", "native"), "stream_ms: loaders")
        print(f"  overlap on the {label} animation: frame loader {res.frame_loader}, launches "
              f"{counts}, exec {res.report.exec_ns} ns, transfer {res.report.transfer_ns} ns "
              f"(phase {10 if is_hdr else 4}'s gpu-denoise run: exec {ref_exec} ns); output equals "
              f"phase {10 if is_hdr else 4}'s; streaming {len(frames)} frames: {nat_ms:.1f} ms on "
              f"the native loader, {py_ms:.1f} ms with the Python codec on the loop's thread")

    # 4. --all-frames over the LDR animation against single-target runs
    keys = ("bilateral", "nlm")
    out_all = os.path.join(root, "ldr_all")
    argv = ["--device", "cuda", "--clamp", "--configs", ",".join(keys)]
    t0 = time.perf_counter()
    stencils.reset_launches()
    rc, _, err = run_cli(cli, [target, "--all-frames", *argv, "--output-dir", out_all])
    check(rc == 0, f"gpu-denoise --all-frames failed ({rc}): {err.strip()}")
    add(stencils.launches)
    adir = os.path.dirname(target)
    paths = sorted(os.path.join(adir, f) for f in os.listdir(adir) if f.endswith(".png"))
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    check(sorted(os.listdir(out_all)) == stems, f"--all-frames wrote {sorted(os.listdir(out_all))}")
    for path, stem in zip(paths, stems):
        single = exact_dir
        if path != target:
            single = os.path.join(root, f"ldr_single_{stem}")
            stencils.reset_launches()
            rc, _, err = run_cli(cli, [path, *argv, "--output-dir", single])
            check(rc == 0, f"gpu-denoise {stem}.png failed ({rc}): {err.strip()}")
            add(stencils.launches)
        for key in keys:
            got = imageio.load(os.path.join(out_all, stem, names[key]))[0]
            check(np.array_equal(got, imageio.load(os.path.join(single, names[key]))[0]),
                  f"--all-frames {stem} {key}: differs from the single-target run")
    print(f"  --all-frames over {len(paths)} LDR frames ({imageio.codec()} codec): every output "
          f"decodes to its single-target run's arrays ({time.perf_counter() - t0:.1f} s)")

    # 5. the exact configs on the EXR target through --mesh 1x4 over gloo
    six = cli.CONFIG_KEYS
    hnames = {k: c.output_name(True) for k, c in zip(six, cfg.GPU_BATTERY)}
    out_mesh = os.path.join(root, "hdr_mesh1x4")
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc, rank_counts = cli.run([hdr["target"], "--device", "cuda", "--configs", ",".join(six),
                                   "--mesh", "1x4", "--dist-backend", "gloo",
                                   "--output-dir", out_mesh])
    check(rc == 0, f"gpu-denoise <HDR target> --mesh 1x4 failed ({rc}): "
                   f"{err.getvalue().strip()[-2000:]}")
    check(len(rank_counts) == 4, f"--mesh 1x4: {len(rank_counts)} ranks")
    counts = sum_counts(stencils, rank_counts)
    add(counts)
    reports = re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", out.getvalue())
    check(len(reports) == len(six), f"--mesh 1x4 on HDR: {len(reports)} timing reports")
    for key in six:
        got = check_hdr_output(os.path.join(out_mesh, hnames[key]), f"--mesh 1x4 HDR {key}")
        check(np.array_equal(got, imageio.load(os.path.join(hdr_dir, hnames[key]))[0]),
              f"--mesh 1x4 HDR {key}: differs from phase 10's single-device output")
    print(f"  gpu-denoise <HDR target> --mesh 1x4 --dist-backend gloo (six configs): "
          f"{time.perf_counter() - t0:.1f} s, launches summed over 4 ranks "
          f"{ {k: n for k, n in counts.items() if n} }; every EXR equals phase 10's array for "
          "array")
    for key, (tr, ex) in zip(six, reports):
        print(f"    {key:10s} rank 0 transfer {int(tr):>11d} ns  exec {int(ex):>11d} ns "
              f"(phase 10 single device: exec {hdr_exec[key]} ns; {smi})")
    return totals


def check_hdr_output(path: str, what: str) -> np.ndarray:
    """A phase-10 output: a float32 EXR (A, B, G, R, each FLOAT: no 8-bit
    cast, alpha kept) of the frame's shape, finite. Returns it as loaded;
    the caller holds its values, alpha included, to what was computed."""
    from image_denoising_filter_tpu_torch.utils import imageio

    chans = exr_channels(path)
    check(chans == {c: 2 for c in "ABGR"}, f"{what}: EXR channels {chans}, not float32 RGBA")
    out, hdr = imageio.load(path)
    check(hdr and out.shape == (H, W, 4) and bool(np.isfinite(out).all()),
          f"{what}: shape {out.shape} or non-finite values")
    return out


def hdr_gate(name: str, got: np.ndarray, exact: np.ndarray) -> str:
    """Read `got` against `exact` (psnr_peak, the exact output's largest RGB
    value the peak) and gate the reading at the JAX package's less
    HDR_GATE_MARGIN_DB. Returns the reading as printed."""
    peak = float(exact[..., :3].max())
    db = psnr_peak(got, exact, peak)
    check(name in JAX_HDR_READINGS_DB, f"no JAX reading for {name}")
    gate = JAX_HDR_READINGS_DB[name] - HDR_GATE_MARGIN_DB
    check(db >= gate, f"{name}: {db:.4f} dB vs exact < {gate:.4f} dB (the JAX package's "
                      f"{JAX_HDR_READINGS_DB[name]} less {HDR_GATE_MARGIN_DB})")
    return (f"{db:.4f} dB vs exact over RGB (peak {peak:.4f}; JAX {JAX_HDR_READINGS_DB[name]}, "
            f"gate {gate:.4f})")


def exact_plain(torch, cfg, stencils, imageio, dataset, target: str) -> dict:
    """The exact battery's outputs through the plain versions on the card, on
    the frames as gpu-denoise loads them, with the parameters its Session
    takes (uniform alpha where the target's alpha is one constant, per frame
    in the streamed multiframe loop, never in the overlap loop)."""
    dev = "cuda"

    def load(path):
        return torch.from_numpy(imageio.load(path)[0]).to(dev)

    t = load(target)
    ua = bool(t[..., 3].min() == t[..., 3].max())
    bp = cfg.BilateralParams(uniform_alpha=ua)
    lp = cfg.LayersParams(uniform_alpha=ua)
    norm = cfg.NormalizeParams()
    out = {"bilateral": stencils.bilateral_plain(t, None, bp, True)[0]}
    out["linear"] = out["bilateral"]
    wc = torch.zeros_like(t)
    nw = torch.zeros(t.shape[:2], device=dev)
    for path in dataset.discover(target, use_layers=True).layers:
        pwc, pnw = stencils.bilateral_plain(t, load(path), lp, False)
        wc, nw = wc + pwc, nw + pnw
    out["layers"] = stencils.normalize_plain(wc, nw, norm)
    out["nlm"] = stencils.normalize_plain(
        *stencils.nlm_plain(t, t[None], cfg.NlmParams(uniform_alpha=ua)), norm)
    frames = [load(p) for p in dataset.discover(target, multiframe=True, max_frames=None).frames]
    wc = torch.zeros_like(t)
    nw = torch.zeros(t.shape[:2], device=dev)
    for f in frames:
        fua = bool(f[..., 3].min() == f[..., 3].max())
        pwc, pnw = stencils.nlm_plain(t, f[None], cfg.NlmParams(uniform_alpha=fua))
        wc, nw = wc + pwc, nw + pnw
    out["multiframe"] = stencils.normalize_plain(wc, nw, norm)
    # the overlap loop: at most max_frames frames, the last one never filtered
    overlap = frames[: cfg.GPU_BATTERY[5].max_frames][:-1]
    out["overlap"] = stencils.normalize_plain(
        *stencils.nlm_plain(t, torch.stack(overlap), cfg.NlmParams()), norm)
    torch.cuda.synchronize()
    return {k: v.cpu().numpy() for k, v in out.items()}


def phase_hdr(torch, cfg, stencils, fast, cli, imageio, dataset, native, Session, render_frame,
              root, ldr_frames, ldr_kernels, smi):
    """Phase 10: HDR. The EXR animation (HDR_*) written and read back, the
    EXR codec timed; every kernel, in every form, against its plain version
    on its HDR frame (1080p and 4K, the grid kernels at each (D, K)), with
    the staged bilateral's walks; then gpu-denoise on the card: the exact
    battery against the plain versions on the same frames, the bilateral
    and layers configs with bf16 taps (Session(tiling=...)), the turbo runs
    of HDR_TURBO_RUNS, each gated at the JAX package's reading, and
    --all-frames over the animation against single-target runs, byte for
    byte; the native codec against the Python one. Returns (the HDR kernel
    results, the summed launch counts of the runs, the animation and the
    exact battery's directory and exec ns)."""
    dev = torch.device("cuda")
    totals = dict.fromkeys(stencils.launches, 0)
    names = {k: c.output_name(True) for k, c in zip(cli.CONFIG_KEYS, cfg.GPU_BATTERY)}
    t0 = time.perf_counter()
    anim = write_hdr_animation(imageio, render_frame, root)
    target = anim["target"]
    paths = sorted(os.path.join(os.path.dirname(target), f)
                   for f in os.listdir(os.path.dirname(target)) if f.endswith(".exr"))
    dec = []
    for path, want in zip(paths, anim["frames"]):
        t1 = time.perf_counter()
        got = imageio.load(path)[0]
        dec.append(time.perf_counter() - t1)
        check(np.array_equal(got, want), f"{path}: read back differs from the frame written")
    frames = anim["frames"]
    enc = []
    for i in range(2):
        t1 = time.perf_counter()
        imageio.save(os.path.join(root, f"encode_{i}.exr"), frames[TARGET_FRAME])
        enc.append(time.perf_counter() - t1)
    rgb = frames[TARGET_FRAME][..., :3]
    scale = float(np.abs(rgb).max())
    print(f"  {N_FRAMES} EXR frames + PNG layers written in {time.perf_counter() - t0:.1f} s; "
          f"target RGB in [{float(rgb.min()):.4f}, {scale:.4f}], {anim['fireflies']} "
          f"fireflies; every frame reads back bit for bit")
    check(imageio.codec() == "native", f"phase 10: the {imageio.codec()} codec ran")
    print(f"  EXR codec that ran: {imageio.codec()}; decode {1e3 * statistics.median(dec):.1f} "
          f"ms (median of {len(dec)}), float32 ZIP encode {1e3 * statistics.median(enc):.1f} "
          f"ms (median of {len(enc)}) per 1080p frame ({smi})")

    # Kernels against their plain versions on the HDR frames.
    t0 = time.perf_counter()
    results = phase_kernels(torch, stencils, cfg, frames, anim["layer"], scale, "1080p HDR")
    bp = cfg.BilateralParams()
    for form, bf16 in (("bilateral", False), ("bilateral_bf16", True)):
        tile = stencils.bilateral_tile(bp, False, bf16, stencils.max_shared_bytes(dev))
        walks = {}
        for label, img in (("LDR", ldr_frames[TARGET_FRAME]), ("HDR", frames[TARGET_FRAME])):
            walks[label] = stencils.bilateral_walks(torch.from_numpy(img).to(dev), bp, bf16,
                                                    tile)
        print(f"  {form} walks (tile {tile.th}x{tile.tw}, {walks['LDR']['blocks']} blocks, "
              f"{walks['LDR']['rows']} tap rows): exp2f on {walks['LDR']['rows_exp2f']} rows "
              f"of {walks['LDR']['blocks_exp2f']} blocks on the LDR target, "
              f"{walks['HDR']['rows_exp2f']} rows of {walks['HDR']['blocks_exp2f']} blocks on "
              f"the HDR one; median {ldr_kernels[form]['ms']:.4f} ms LDR, "
              f"{results[form]['ms']:.4f} ms HDR")
    lp = cfg.LayersParams()
    layer_walks = stencils.bilateral_walks(
        torch.from_numpy(anim["layer"]).to(dev), lp, False,
        stencils.bilateral_tile(lp, True, False, stencils.max_shared_bytes(dev)))
    print(f"  bilateral_guided walks on the albedo guide (LDR): exp2f on "
          f"{layer_walks['rows_exp2f']} of {layer_walks['rows']} tap rows")
    noisy_4k, layers_4k = render_frame(0.5, H4K, W4K, np.random.default_rng(SEED), noise=NOISE,
                                       hdr=True)
    print(f"  4K HDR frame: RGB in [{float(noisy_4k[..., :3].min()):.4f}, "
          f"{float(noisy_4k[..., :3].max()):.4f}]")
    grid_results, _ = phase_turbo_kernels(torch, fast, stencils, cfg, noisy_4k,
                                          frames[TARGET_FRAME], hdr=True)
    results.update(grid_results)
    images = {"4K": (noisy_4k, np.clip(layers_4k["albedo"], 0, 1)),
              "1080p": (frames[TARGET_FRAME], anim["layer"])}
    images = {k: tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in v)
              for k, v in images.items()}
    del layers_4k
    results.update(phase_guided_kernels(torch, fast, cfg, images, hdr=True))
    del images
    for kernel, res in results.items():
        print(f"  {kernel:21s} median {ldr_kernels[kernel]['ms']:.4f} ms LDR, "
              f"{res['ms']:.4f} ms HDR ({smi})")
    print(f"  kernels on HDR content: {time.perf_counter() - t0:.1f} s")

    def run(what, argv, expected):
        stencils.reset_launches()
        rc, text, err = run_cli(cli, [*argv, "--device", "cuda"])
        counts = dict(stencils.launches)
        check(rc == 0, f"{what} failed ({rc}): {err.strip()}")
        check(all(counts[k] > 0 for k in expected) and
              all(n == 0 for k, n in counts.items() if k not in expected),
              f"{what}: launches {counts}, expected {sorted(expected)}")
        for k, n in counts.items():
            totals[k] += n
        print(f"  {what}: launches { {k: n for k, n in counts.items() if n} }")
        return re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", text)

    def report(keys, reports):
        check(len(reports) == len(keys), f"{len(reports)} timing reports for {keys}")
        return dict(zip([k for k in cli.CONFIG_KEYS if k in keys], reports))

    # The exact battery, against the plain versions on the same frames.
    t0 = time.perf_counter()
    six = cli.CONFIG_KEYS
    out_exact = os.path.join(root, "hdr_exact")
    reports = report(six, run("gpu-denoise <HDR target> (six configs)",
                              [target, "--configs", ",".join(six), "--output-dir", out_exact],
                              {"bilateral", "bilateral_guided", "nlm", "normalize"}))
    exact_exec_ns = {key: int(ex) for key, (_, ex) in reports.items()}
    plain = exact_plain(torch, cfg, stencils, imageio, dataset, target)
    exact = {}
    for key in six:
        exact[key] = check_hdr_output(os.path.join(out_exact, names[key]), f"exact {key}")
        tol = scaled(TOL_NLM if key in NLM_CONFIGS else TOL_BILATERAL, scale)
        err = float(np.abs(exact[key] - plain[key]).max())
        check(bool(np.all(np.abs(exact[key] - plain[key])
                          <= tol["atol"] + tol["rtol"] * np.abs(plain[key]))),
              f"exact {key}: max abs {err:.3g} from the plain versions, beyond {tol}")
        tr, ex = reports[key]
        print(f"    {key:10s} transfer {int(tr):>11d} ns  exec {int(ex):>11d} ns  max abs "
              f"{err:.3g} from the plain versions (tolerance {tol})")
    del plain
    peak = float(exact["bilateral"][..., :3].max())
    print(f"  exact battery: {time.perf_counter() - t0:.1f} s; float32 EXR, alpha kept")

    # bf16 taps, as a library caller runs them.
    out_bf16 = os.path.join(root, "hdr_bf16")
    os.makedirs(out_bf16)
    tiled = Session(target, device="cuda", output_dir=out_bf16,
                    tiling=cfg.TilingConfig(compute_dtype="bfloat16"))
    for key, run_cfg, kernel in (("bilateral", cfg.GPU_BATTERY[0], "bilateral_bf16"),
                                 ("layers", cfg.GPU_BATTERY[1], "bilateral_guided_bf16")):
        stencils.reset_launches()
        res = tiled.run(run_cfg)
        counts = {k: n for k, n in stencils.launches.items() if n}
        check(counts.get(kernel, 0) > 0 and not counts.get(kernel[:-5]),
              f"Session(tiling=bf16) {key}: launches {counts}")
        for k, n in counts.items():
            totals[k] += n
        got = check_hdr_output(res.output_path, f"bf16 {key}")
        check(np.array_equal(got, res.image), f"bf16 {key}: the file differs from the result")
        reading = hdr_gate(f"bf16 {key}", got, exact[key])
        print(f"    Session(tiling=bf16) {key}: launches {counts}, exec "
              f"{res.report.exec_ns} ns, transfer {res.report.transfer_ns} ns, {reading}")

    # The turbo modes.
    target_dev = torch.from_numpy(frames[TARGET_FRAME]).to(dev)
    for name, flags, keys in HDR_TURBO_RUNS:
        d = int(flags[1])
        expected = set()
        for nlm in (False, True):
            if any((k in NLM_CONFIGS) == nlm for k in keys):
                expected |= turbo_kernels(d, nlm, flags)
        out_dir = os.path.join(root, f"hdr_{name.replace(' ', '_')}")
        reports = report(keys, run(f"gpu-denoise <HDR target> {' '.join(flags)} --configs "
                                   f"{','.join(keys)}",
                                   [target, *flags, "--configs", ",".join(keys),
                                    "--output-dir", out_dir], expected))
        for key in keys:
            got = check_hdr_output(os.path.join(out_dir, names[key]), f"{name} {key}")
            if key in ("bilateral", "linear"):  # the grid pipeline phase 10 checked
                bp = cfg.BilateralParams(sigma_spatial=float(flags[-1]) if
                                         "--sigma-spatial" in flags else 2.0)
                want = fast.bilateral_fast(target_dev, bp, turbo_levels(d), d)
                check(np.array_equal(got, want.cpu().numpy()),
                      f"{name} {key}: differs from bilateral_fast on the loaded target")
            reading = hdr_gate(f"{name} {key}", got,
                               exact["bilateral" if key == "linear" else key])
            tr, ex = reports[key]
            print(f"    {key:10s} transfer {int(tr):>11d} ns  exec {int(ex):>11d} ns  "
                  f"{reading}")
    del exact

    # --all-frames, the serving loop, against single-target runs.
    t0 = time.perf_counter()
    keys = ("bilateral", "nlm")
    out_all = os.path.join(root, "hdr_all")
    run("gpu-denoise <HDR animation> --all-frames --configs bilateral,nlm",
        [target, "--all-frames", "--configs", ",".join(keys), "--output-dir", out_all],
        {"bilateral", "nlm", "normalize"})
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    check(sorted(os.listdir(out_all)) == stems,
          f"--all-frames wrote {sorted(os.listdir(out_all))}")
    for path, stem in zip(paths, stems):
        single = out_exact
        if path != target:
            single = os.path.join(root, f"hdr_single_{stem}")
            run(f"gpu-denoise {stem}.exr --configs bilateral,nlm",
                [path, "--configs", ",".join(keys), "--output-dir", single],
                {"bilateral", "nlm", "normalize"})
        got_names = sorted(os.listdir(os.path.join(out_all, stem)))
        check(got_names == sorted(names[k] for k in keys), f"--all-frames {stem}: {got_names}")
        for key in keys:
            got = os.path.join(out_all, stem, names[key])
            check_hdr_output(got, f"--all-frames {stem} {key}")
            check(same_bytes(got, os.path.join(single, names[key])),
                  f"--all-frames {stem} {key}: differs from the single-target run")
    print(f"  --all-frames over {len(paths)} frames: every output equals its single-target "
          f"run byte for byte ({time.perf_counter() - t0:.1f} s)")
    print("  " + native_codec_check(native, imageio, paths))
    return results, totals, anim, out_exact, exact_exec_ns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from image_denoising_filter_tpu_torch import cli
    from image_denoising_filter_tpu_torch import config as cfg
    from image_denoising_filter_tpu_torch.utils import content, dataset, imageio, native
    from image_denoising_filter_tpu_torch.ops import _build, fast, reference, stencils
    from image_denoising_filter_tpu_torch.parallel import dryrun, launch
    from image_denoising_filter_tpu_torch.runtime import Session

    check_no_jax()
    render_frame = load_render_frame()
    smi = nvidia_smi_line()
    print(f"[1/11] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.ensure)  # g++ beside nvcc
        lib_path, log = _build.build()
        build_s = time.perf_counter() - t0
        native_info = native_build.result()
    print(f"[2/11] build: {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}; native host "
          f"library: route {native_info.route}, {native_info.build_s:.2f} s of g++ beside it")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    root = scratch_dir()
    try:
        anim = write_animation(imageio, render_frame, root)
        print(f"[3/11] kernels vs plain versions at {W}x{H}")
        kernels = phase_kernels(torch, stencils, cfg, anim["frames"], anim["layer"])
        print(f"[4/11] battery through gpu-denoise --device cuda ({N_FRAMES} frames + 3 layers)")
        counts, exact_dir, exec4 = phase_battery(cfg, stencils, cli, imageio, Session, anim, root)
        print(f"[5/11] turbo grid kernels vs plain versions at {W4K}x{H4K} and {W}x{H}")
        noisy_4k, layers_4k = render_frame(0.5, H4K, W4K, np.random.default_rng(SEED),
                                           noise=NOISE)
        turbo_kernels_results, fused_counts = phase_turbo_kernels(
            torch, fast, stencils, cfg, noisy_4k, anim["frames"][TARGET_FRAME])
        kernels.update(turbo_kernels_results)
        print(f"[6/11] guided grid kernels vs plain versions at {W4K}x{H4K} and {W}x{H}")
        images = {
            "4K": (noisy_4k, np.clip(layers_4k["albedo"], 0, 1)),
            "1080p": (anim["frames"][TARGET_FRAME], anim["layer"]),
        }
        images = {k: tuple(torch.from_numpy(np.ascontiguousarray(x)).to("cuda") for x in v)
                  for k, v in images.items()}
        anim["noisy_4k"] = noisy_4k
        del layers_4k
        kernels.update(phase_guided_kernels(torch, fast, cfg, images))
        del images
        print("[7/11] turbo battery through gpu-denoise --turbo D --device cuda")
        totals = phase_turbo_battery(cfg, stencils, cli, imageio, anim, root, exact_dir)
        print("[8/11] CPU configs, parity, profile, content")
        t0 = time.perf_counter()
        profiled = phase_cpu_parity_profile(torch, cfg, stencils, cli, imageio, content,
                                            reference, native, kernels, anim, root, exact_dir)
        print(f"  phase 8: {time.perf_counter() - t0:.1f} s")
        for k, n in profiled.items():
            totals[k] += n
        print("[9/11] sharded: gpu-denoise --mesh on 4 ranks sharing the card over gloo")
        t0 = time.perf_counter()
        sharded = phase_sharded(torch, cfg, stencils, fast, cli, imageio, launch, dryrun, anim,
                                root, exact_dir, smi)
        print(f"  phase 9: {time.perf_counter() - t0:.1f} s")
        for k, n in sharded.items():
            totals[k] += n
        print("[10/11] HDR: an EXR animation through the kernels and gpu-denoise --device cuda")
        t0 = time.perf_counter()
        _, hdr_counts, hdr, hdr_dir, hdr_exec = phase_hdr(
            torch, cfg, stencils, fast, cli, imageio, dataset, native, Session, render_frame, root,
            anim["frames"], kernels, smi)
        print(f"  phase 10: {time.perf_counter() - t0:.1f} s")
        for k, n in hdr_counts.items():
            totals[k] += n
        print("[11/11] host runtime: the native library, the default run, the native frame "
              "loader, --all-frames, --mesh 1x4 on HDR")
        t0 = time.perf_counter()
        host_counts = phase_host_runtime(torch, cfg, stencils, cli, imageio, dataset, native,
                                         reference, Session, anim, hdr, root, exact_dir, exec4,
                                         hdr_dir, hdr_exec, smi)
        print(f"  phase 11: {time.perf_counter() - t0:.1f} s")
        for k, n in host_counts.items():
            totals[k] += n
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check_no_jax()

    replaces = {
        "bilateral": (KERNEL_SOURCE, f"{JAX_STENCILS}:178"),
        "bilateral_guided": (KERNEL_SOURCE, f"{JAX_STENCILS}:178"),
        "bilateral_bf16": (KERNEL_SOURCE, f"{JAX_STENCILS}:178"),
        "bilateral_guided_bf16": (KERNEL_SOURCE, f"{JAX_STENCILS}:178"),
        "nlm": (KERNEL_SOURCE, f"{JAX_STENCILS}:467"),
        "nlm_bf16": (KERNEL_SOURCE, f"{JAX_STENCILS}:467"),
        "nlm_hrw": (KERNEL_SOURCE, f"{JAX_STENCILS}:645"),
        "nlm_hrw_bf16": (KERNEL_SOURCE, f"{JAX_STENCILS}:645"),
        "normalize": (KERNEL_SOURCE, f"{JAX_STENCILS}:1039"),
        "pool": (FAST_SOURCE, f"{JAX_FAST}:83"),
        "build_grid": (FAST_SOURCE, f"{JAX_FAST}:1018"),
        "slice_grid": (FAST_SOURCE, f"{JAX_FAST}:502"),
        "fused_grid": (FAST_SOURCE, f"{JAX_FAST}:730"),
        "build_guided_grid": (FAST_SOURCE, f"{JAX_FAST}:1269"),
        "slice_guided_grid": (FAST_SOURCE, f"{JAX_FAST}:1372"),
        "fused_guided": (FAST_SOURCE, f"{JAX_FAST}:1516"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": where,
         "launches": counts[name] + fused_counts[name] + totals[name],
         **{k: kernels[name][k] for k in keys}}
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
