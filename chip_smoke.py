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
                (2, 5), and on the 1080p target at each setting of phase 7
                and at D=1 sigma_s 6; at D=1 (the sharded --turbo 1's form:
                17 and 49 taps, timed at 17) the slice bit for bit its plain
                version, and the target also cut into the four bands of a
                1x4 mesh, each pooled, and sliced in the slab form, bit for
                bit its plain version; the fused path,
                grid_pipeline(fused=True), driven at each 4K (D, K) with its
                launch counts; median times at 4K (2, 5),
                the build's and the fused kernel's registers, tile and shared
                bytes, both pipelines' Mpix/s at each D, and the fused
                kernel's time against the build's and the slice's at each D;
  6. guided kernels -- the layer-guided grid's build, slice and fused
                build+slice against their plain versions (the fused kernel
                against the two kernels, bit for bit) at 3840x2160 for the
                same (D, K) and on the 1080p albedo layer at each setting of
                phase 7, with median times at 4K (2, 5), and the guided
                build's and slice's also at the main path's --turbo 1 shape
                (1080p, D=1, K=6, 17 taps), where the slice is held to its
                plain version bit for bit, whole and on the four slab bands
                of a 1x4 mesh; the guided build's and the fused kernel's
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
                host ms, device busy ms and busy share; the device's idle ms
                under each of the program's idf.* spans (utils/timing.py),
                and most of its busy ms under them (one clock, to about a
                millisecond);
  9. sharded -- gpu-denoise --mesh on four ranks that share the card over
                gloo: the six configs on 1x4 (every file phase 4's byte for
                byte) and on 2x2 (the spatial configs phase 4's, the
                multiframe ones within 1 LSB: the SUM over 'frame' regroups
                the frames' partials); --turbo 2 --weights-halfres on 1x4
                (phase 7's files); --turbo 4 on 1x4 (bilateral_fast on the
                same row-padded frame); --turbo 1 on 1x4 (bilateral, linear,
                layers: the bilateral grid's kernels at D=1 band by band,
                byte for byte the single-device two-kernel pipeline on the
                same row-padded frame, layers phase 7's file, the dB against
                the exact bilateral gated at the JAX package's reading); the
                slab slice kernels with offsets
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
                JAX package's reading (JAX_HDR_READINGS_DB); --turbo 1 --mesh
                1x4 as phase 9 runs it, on the EXR target; --all-frames over
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
 12. non-finite -- every kernel form on the kernels line against its plain
                version on frames with +inf, -inf and NaN (NaNs in bands 0
                and 2 of a 1x4 mesh; at 1080p and, for the grids, 4K): the
                same NaN, +inf and -inf positions, every value finite in both
                at the kernel's tolerance, each grid on its frame's own range,
                the sharded range of a 1x4 mesh and a finite frame's, the d = 1
                slab bands, the fused kernels bit for bit the two kernels, the
                d = 1 slice's own-cell read where it parts from its plain
                version (ROADMAP.md queue C); then phase 10's EXR animation
                with NaN in the target's bands 0 and 2, in a neighbour frame,
                and +inf in the albedo layer, through gpu-denoise: the exact
                battery, --turbo 1, 2, 2 --weights-halfres, and --turbo 1 and
                2 on --mesh 1x4, each output held to the JAX package's reading
                (JAX_NONFINITE_READINGS: counts and positions, or inside the
                boxes its tiles spread over; dB against exact).
Then the SHA-256 of the .png and .exr files the phases wrote, a line for
each directory (two runs' files compare byte for byte by these lines), one
JSON line with every kernel's launches, error, times and bound, the
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
import hashlib
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
                      # the d = 1 builds: this smoke on the commit before
                      # their redesign (PERF.md section 6)
                      "build_guided_grid 1080p D=1 17 taps": 0.8504,
                      "build_grid 1080p D=1 17 taps": 0.7392,
                      "build_grid 1080p D=1 49 taps": 5.6959,
                      "build_grid 4K D=2 K=5": 1.5590, "fused_guided 4K D=2 K=5": 0.8898,
                      "fused_grid 4K D=2 K=5": 0.6683, "slice_grid 1080p D=1 K=6": 0.0647}
H4K, W4K = 2160, 3840
# The HDR case of phase 5: the 4K frame's RGB clipped to [0, 1] and scaled
# by HDR_SCALE. Its pipeline check is the LDR contract (2 bf16 ulps at values
# up to 1, at most 1% of pixels beyond 1e-5) scaled by the range, as
# tests/test_torch_fast.py reads HDR against the JAX package.
HDR_SCALE = 4.0
TURBO_CELLS = ((2, 5), (4, 5), (8, 6))  # (D, K): run_turbo's K at each D
# The turbo battery: D and --sigma-spatial (D=8 is gated in the JAX package
# only from sigma_s ~5-6 up, hence sigma_s 6 there). At D=1 the bilateral
# grid is the eager lattice on one device, which launches no kernel (on a
# mesh, phase 9, its kernels at D=1), and the guided grid runs its two
# kernels. Phases 5 and 6 also hold the kernels to their plain
# versions at each of these settings on the same 1080p target.
TURBO_RUNS = ((1, 2.0), (2, 2.0), (4, 2.0), (8, 6.0))
# The grid kernels at D=1, as --turbo 1 runs them (the bilateral grid's build
# and slice on a mesh, the guided build and slice for the layers on one device
# and on a mesh): their own entries of the kernels line, timed and counted
# apart from the D > 1 forms. The wrappers count each launch at D = 1 under
# these names (ops/stencils.py:launches).
D1_FORMS = {"build_grid": "build_grid_d1", "slice_grid": "slice_grid_d1",
            "build_guided_grid": "build_guided_grid_d1",
            "slice_guided_grid": "slice_guided_grid_d1"}
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
# The sharded --turbo 1 (the bilateral grid's kernels at D=1 band by band,
# phases 9 and 10): the JAX package's reading of its bilateral output
# against its exact tiled bilateral on each 1080p target, read as the smoke
# reads the port's (tools/turbo1_mesh_jax_reading.py: tpu-denoise --turbo 1
# --mesh 1x4 on four virtual CPU devices, its Pallas kernels in interpret
# mode): the PNG target over RGB of the 8-bit files, the EXR target with
# psnr_peak. The port's reading is gated at it less the margin.
JAX_TURBO1_MESH_READINGS_DB = {"1080p": 47.0676, "1080p HDR": 44.5734}
TURBO1_MESH_GATE_MARGIN_DB = 0.05
# Phase 12, non-finite frames. normalize on partials with non-finite values,
# held to 1 ulp as phase 3 holds it.
TOL_NORMALIZE = dict(rtol=2.4e-7, atol=0.0)
# The half-row NLM with bf16 taps against its plain version where the
# neighbour frame is not the target: the kernel sums a cell's squared
# differences in another order, and where that moves a bf16 weight across a
# rounding boundary its partials move by that weight's last bit (2^-8 of
# it): on the 1080p target and the frame before it 13 of 10.4 million values
# leave TOL_NLM, by at most 7.2e-4 of their value, finite frames and
# non-finite ones alike (measured on one H100; phase 3's F = 1 pairs the
# target with itself, where none does; ROADMAP.md queue C). Such
# values, at most HRW_BF16_FLIPS[0] of them, are held within
# HRW_BF16_FLIPS[1] of their value.
HRW_BF16_FLIPS = (1e-5, 2.0**-9)
# The animation: phase 10's, with NaN in bands 0 and 2 of a 1x4 mesh in the
# target (green and blue), NaN in a neighbour frame, and +inf in the target's
# albedo layer (an EXR there, as a depth or emission layer's background):
# (row, column, channel, value) at 1080p.
NONFINITE_ANIMATION = {
    "frames": {TARGET_FRAME: ((150, 600, 1, float("nan")), (800, 1500, 2, float("nan"))),
               2: ((400, 1000, 0, float("nan")),)},
    "albedo": ((700, 300, 0, float("inf")),),
}
GRID_CONFIGS = ("bilateral", "layers", "linear")
# gpu-denoise's runs of phase 12, each (name, flags, configs); the JAX
# package's runs drop --dist-backend.
NONFINITE_RUNS = (
    ("exact", (), ("bilateral", "layers", "linear", "nlm", "multiframe", "overlap")),
    ("turbo 1", ("--turbo", "1"), GRID_CONFIGS),
    ("turbo 2", ("--turbo", "2"), ("bilateral", "layers", "linear", "nlm", "multiframe",
                                   "overlap")),
    ("turbo 2 half-row", ("--turbo", "2", "--weights-halfres"), NLM_CONFIGS),
    ("mesh turbo 1", ("--turbo", "1", "--mesh", "1x4", "--dist-backend", "gloo"), GRID_CONFIGS),
    ("mesh turbo 2", ("--turbo", "2", "--mesh", "1x4", "--dist-backend", "gloo"), GRID_CONFIGS),
)
# The JAX package's readings of phase 12's outputs (nonfinite_reading;
# tools/nonfinite_jax_reading.py: tpu-denoise on the CPU, its Pallas kernels
# in interpret mode, the mesh on four virtual CPU devices; the single-device
# turbo bilateral grid through its Pallas pipeline, which tpu-denoise runs on
# its chip). An entry with "boxes" is one where the JAX package's banded
# matmuls (pool, build, slice) spread a non-finite value over their tile:
# the boxes bound its non-finite values, channel by channel, and box whole a
# channel whose grid range takes the animation's +inf (the port's range keeps
# it: the channel is NaN, as on one device; the JAX package's sharded range
# drops it, its pool's matmul having made it NaN).
JAX_NONFINITE_READINGS = {
    'exact bilateral': {'counts': [[998, 0, 0], [998, 0, 0], [998, 0, 0], [998, 0, 0]],
        'digest': 'f822a38b60e55744', 'db': None},
    'exact layers': {'counts': [[1, 0, 0], [500, 0, 0], [500, 0, 0], [1, 0, 0]], 'digest':
        '180d759512b5b812', 'db': None},
    'exact linear': {'counts': [[1250, 0, 0], [1250, 0, 0], [1250, 0, 0], [1250, 0, 0]],
        'digest': '05bc91209c5684ce', 'db': None},
    'exact nlm': {'counts': [[722, 0, 0], [722, 0, 0], [722, 0, 0], [722, 0, 0]], 'digest':
        'cf6ed24d6a61d212', 'db': None},
    'exact multiframe': {'counts': [[1083, 0, 0], [1083, 0, 0], [1083, 0, 0], [1083, 0, 0]],
        'digest': 'c10e37ed80e99c50', 'db': None},
    'exact overlap': {'counts': [[1083, 0, 0], [1083, 0, 0], [1083, 0, 0], [1083, 0, 0]],
        'digest': 'c10e37ed80e99c50', 'db': None},
    'turbo 1 bilateral': {'counts': [[0, 0, 0], [2073600, 0, 0], [2073600, 0, 0], [2073600, 0,
        0]], 'digest': 'b6fbf33d617621cc', 'db': 44.6068},
    'turbo 1 layers': {'counts': [[2073600, 0, 0], [983040, 0, 0], [1090560, 0, 0], [0, 0, 0]],
        'digest': 'e9ff491782baffb3', 'db': 73.43, 'boxes': [[0, 0, 1080, 0, 1920], [1, 0, 512,
        0, 1920], [2, 512, 1080, 0, 1920], [0, 0, 1080, 0, 1920]]},
    'turbo 1 linear': {'counts': [[0, 0, 0], [2073600, 0, 0], [2073600, 0, 0], [2073600, 0,
        0]], 'digest': 'b6fbf33d617621cc', 'db': 44.6068},
    'turbo 2 bilateral': {'counts': [[0, 0, 0], [2073600, 0, 0], [2073600, 0, 0], [2073600, 0,
        0]], 'digest': 'b6fbf33d617621cc', 'db': 44.7135},
    'turbo 2 layers': {'counts': [[2073600, 0, 0], [983040, 0, 0], [1090560, 0, 0], [0, 0, 0]],
        'digest': 'e9ff491782baffb3', 'db': 51.0951, 'boxes': [[0, 0, 1080, 0, 1920], [1, 0,
        512, 0, 1920], [2, 512, 1080, 0, 1920], [0, 0, 1080, 0, 1920]]},
    'turbo 2 linear': {'counts': [[0, 0, 0], [2073600, 0, 0], [2073600, 0, 0], [2073600, 0,
        0]], 'digest': 'b6fbf33d617621cc', 'db': 44.7135},
    'turbo 2 nlm': {'counts': [[648, 0, 0], [648, 0, 0], [648, 0, 0], [648, 0, 0]], 'digest':
        'de42723837991708', 'db': 92.5414},
    'turbo 2 multiframe': {'counts': [[972, 0, 0], [972, 0, 0], [972, 0, 0], [972, 0, 0]],
        'digest': 'b4442d69d26024e9', 'db': 94.7206},
    'turbo 2 overlap': {'counts': [[972, 0, 0], [972, 0, 0], [972, 0, 0], [972, 0, 0]],
        'digest': 'b4442d69d26024e9', 'db': 94.1287},
    'turbo 2 half-row nlm': {'counts': [[4608, 0, 0], [4608, 0, 0], [4608, 0, 0], [4608, 0,
        0]], 'digest': 'f760bf5498c1f882', 'db': 75.7131, 'boxes': [[0, 128, 256, 592, 610],
        [0, 768, 896, 1492, 1510], [1, 128, 256, 592, 610], [1, 768, 896, 1492, 1510], [2, 128,
        256, 592, 610], [2, 768, 896, 1492, 1510], [3, 128, 256, 592, 610], [3, 768, 896, 1492,
        1510]]},
    'turbo 2 half-row multiframe': {'counts': [[6912, 0, 0], [6912, 0, 0], [6912, 0, 0], [6912,
        0, 0]], 'digest': '85037d87005acdda', 'db': 78.442, 'boxes': [[0, 128, 256, 592, 610],
        [0, 384, 512, 992, 1010], [0, 768, 896, 1492, 1510], [1, 128, 256, 592, 610], [1, 384,
        512, 992, 1010], [1, 768, 896, 1492, 1510], [2, 128, 256, 592, 610], [2, 384, 512, 992,
        1010], [2, 768, 896, 1492, 1510], [3, 128, 256, 592, 610], [3, 384, 512, 992, 1010],
        [3, 768, 896, 1492, 1510]]},
    'turbo 2 half-row overlap': {'counts': [[6912, 0, 0], [6912, 0, 0], [6912, 0, 0], [6912, 0,
        0]], 'digest': '85037d87005acdda', 'db': 77.5528, 'boxes': [[0, 128, 256, 592, 610],
        [0, 384, 512, 992, 1010], [0, 768, 896, 1492, 1510], [1, 128, 256, 592, 610], [1, 384,
        512, 992, 1010], [1, 768, 896, 1492, 1510], [2, 128, 256, 592, 610], [2, 384, 512, 992,
        1010], [2, 768, 896, 1492, 1510], [3, 128, 256, 592, 610], [3, 384, 512, 992, 1010],
        [3, 768, 896, 1492, 1510]]},
    'mesh turbo 1 bilateral': {'counts': [[0, 0, 0], [518400, 0, 0], [1009920, 0, 0], [518400,
        0, 0]], 'digest': 'a6ae7cb3b6b8d9a7', 'db': 44.8797, 'boxes': [[1, 0, 270, 0, 1920],
        [2, 540, 1066, 0, 1920], [3, 0, 270, 0, 1920]]},
    'mesh turbo 1 layers': {'counts': [[1036800, 0, 0], [518400, 0, 0], [1009920, 0, 0], [0, 0,
        0]], 'digest': '215eecea7414ae2e', 'db': 72.2644, 'boxes': [[0, 270, 810, 0, 1920], [1,
        0, 270, 0, 1920], [2, 540, 1066, 0, 1920], [0, 0, 1080, 0, 1920]]},
    'mesh turbo 1 linear': {'counts': [[0, 0, 0], [518400, 0, 0], [1009920, 0, 0], [518400, 0,
        0]], 'digest': 'a6ae7cb3b6b8d9a7', 'db': 44.8797, 'boxes': [[1, 0, 270, 0, 1920], [2,
        540, 1066, 0, 1920], [3, 0, 270, 0, 1920]]},
    'mesh turbo 2 bilateral': {'counts': [[0, 0, 0], [518400, 0, 0], [1009920, 0, 0], [518400,
        0, 0]], 'digest': 'a6ae7cb3b6b8d9a7', 'db': 45.2373, 'boxes': [[1, 0, 270, 0, 1920],
        [2, 540, 1066, 0, 1920], [3, 0, 270, 0, 1920]]},
    'mesh turbo 2 layers': {'counts': [[1036800, 0, 0], [518400, 0, 0], [1009920, 0, 0], [0, 0,
        0]], 'digest': '215eecea7414ae2e', 'db': 51.6923, 'boxes': [[0, 270, 810, 0, 1920], [1,
        0, 270, 0, 1920], [2, 540, 1066, 0, 1920], [0, 0, 1080, 0, 1920]]},
    'mesh turbo 2 linear': {'counts': [[0, 0, 0], [518400, 0, 0], [1009920, 0, 0], [518400, 0,
        0]], 'digest': 'a6ae7cb3b6b8d9a7', 'db': 45.2373, 'boxes': [[1, 0, 270, 0, 1920], [2,
        540, 1066, 0, 1920], [3, 0, 270, 0, 1920]]},
}
NONFINITE_DB_MARGIN = 0.05
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
    never goes to device memory. At D = 1 (the "_d1" names, cells =
    pixels) the build does the same work, and the slice reads each pixel's
    own cell (wy = wx = 0) at 2 of the K levels of each of its 4 planes,
    16 B a pixel, and does 60 operations a pixel (the t of 3 channels 12,
    then 4 channels x 2 levels x (tent 4, add 2)); the guided slice reads
    the layer (16 B), writes wc and nw (16 + 12 B) and reads each pixel's
    own cell at 2 of the K levels of each of its 7 planes (28 B): 72 B a
    pixel, and 96 operations (the t 12, then 7 planes x 2 levels x (tent 4,
    add 2))."""
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
        "build_grid_d1": (16 * cells + 8 * grid, build),
        "slice_grid_d1": (48 * pixels, 60 * pixels),
        "build_guided_grid": (32 * cells + 14 * grid, grid * (16 + blur)),
        "build_guided_grid_d1": (32 * cells + 14 * grid, grid * (16 + blur)),
        "slice_guided_grid": (44 * pixels + 14 * grid, 222 * pixels),
        "slice_guided_grid_d1": (72 * pixels, 96 * pixels),
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


def own_cell_reads(torch, guide, lmin, inv_step, levels: int, cell_bytes: int) -> str:
    """What a d = 1 slice's grid reads on this guide: the levels whose tent
    is nonzero for some RGB channel of a pixel (floor(t), and floor(t) + 1
    where t is not whole), their mean count a pixel, and the 32-byte sectors
    of the (K, H, W, planes) grid those cells fill (cell_bytes each), in MB
    and bytes a pixel: the grid traffic the data needs at the memory's
    granularity, where kernel_work counts 2 bytes a plane and level."""
    h, w, _ = guide.shape
    t = ((guide[..., :3] - lmin) * inv_step).clamp(0.0, levels - 1.0)
    lo = t.floor()
    up = t > lo
    per_sector = 32 // cell_bytes
    touched, sectors = 0, 0
    for k in range(levels):
        need = ((lo == k) | (up & (lo + 1 == k))).any(-1)
        touched += int(need.sum())
        pad = (-w) % per_sector
        need = torch.nn.functional.pad(need, (0, pad)).view(h, -1, per_sector).any(-1)
        sectors += int(need.sum())
    return (f"{touched / (h * w):.3f} levels a pixel, {32 * sectors / 1e6:.1f} MB of 32-byte "
            f"grid sectors ({32 * sectors / (h * w):.2f} B a pixel)")


def output_digests(root: str) -> list[str]:
    """One line a directory under root (files at its top under "."), and
    one for all of them: how many .png and .exr files it holds and the
    SHA-256 of their relative paths and bytes in sorted order, so that two
    runs' files compare byte for byte by their lines."""
    groups = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for name in sorted(filenames):
            if name.endswith((".png", ".exr")):
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                groups.setdefault(rel.split(os.sep)[0] if os.sep in rel else ".", []).append(rel)
    total, lines = hashlib.sha256(), []
    for group, rels in sorted(groups.items()):
        digest = hashlib.sha256()
        for rel in rels:
            with open(os.path.join(root, rel), "rb") as f:
                data = hashlib.sha256(f.read()).digest()
            for h in (digest, total):
                h.update(rel.encode() + data)
        lines.append(f"{group}: {len(rels)} files, sha256 {digest.hexdigest()[:16]}")
    return lines + [f"all output files: sha256 {total.hexdigest()}"]


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


def write_hdr_animation(imageio, render_frame, root: str, name: str = "hdr") -> dict:
    """Phase 10's 1080p EXR animation (HDR_* above) and its layers, saved
    with `imageio` (either package's) into root/name. Returns the target's
    path, the frames as written (float32 EXR is lossless), the target's
    albedo layer as loaded and the number of fireflies."""
    anim = os.path.join(root, name)
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


def pipeline_check(torch, case: str, got, want, img) -> None:
    """A grid pipeline against its plain version: within 2 bf16 ulps of the
    frame's max |RGB|, at most 1% of pixels beyond 1e-5 of it (the build's
    bf16 flips through the slice)."""
    torch.cuda.synchronize()
    scale = max(1.0, float(img[..., :3].abs().max()))
    err = float((got - want).abs().max())
    loose = float(((got - want).abs() > 1e-5 * scale).float().mean())
    check(err <= 2 * 2.0**-8 * scale and loose <= 0.01,
          f"pipeline {case}: max abs {err:.3g}, {loose:.3%} of pixels beyond {1e-5 * scale:g}")
    print(f"  {'pipeline':10s} {case:36s} max abs {err:.3g} "
          f"({loose:.4%} of pixels beyond {1e-5 * scale:g})")


# The non-finite frame of phases 5, 6 and 12: one +inf, one -inf and two
# NaN values, each (row, column, channel) of the 1080p target (or layer),
# scaled to another frame's size by nonfinite_frame. The NaNs fall in band 0
# and band 2 of a 1x4 mesh (bands of 270 rows at 1080p, 540 at 4K), the
# +inf in band 0 and the -inf in band 1.
NONFINITE_VALUES = ((100, 200, 0, float("inf")), (150, 600, 1, float("nan")),
                    (500, 900, 1, float("-inf")), (800, 1500, 2, float("nan")))


def scaled_position(y: int, x: int, h: int, w: int) -> tuple[int, int]:
    """A (row, column) of a 1920x1080 frame at the same place of an h x w
    one (band by band: bands of a 1x4 mesh keep their values)."""
    return y * h // 1080, x * w // 1920


def nonfinite_frame(img, shift: int = 0):
    """A copy of img with NONFINITE_VALUES written in, each position scaled
    to img's rows and columns, the columns moved by shift * 97 (another
    frame's or a layer's values beside the target's)."""
    out = img.clone()
    h, w = img.shape[:2]
    for y, x, c, v in NONFINITE_VALUES:
        yy, xx = scaled_position(y, x, h, w)
        out[yy, (xx + shift * 97) % w, c] = v
    return out


def same_nonfinite(torch, what: str, got, want, tol=None, bf16_ulps=None, flips=None) -> str:
    """A kernel's output (or tuple of outputs) against its plain version's,
    or another kernel's, on a non-finite frame: the same positions of NaN,
    +inf and -inf, and every value finite in both bit for bit (NaN payloads
    may differ); or within tol (rtol, atol) where it is given, but for at
    most flips[0] of them within flips[1] of their value where flips is
    given (HRW_BF16_FLIPS); or within bf16_ulps bfloat16 ulps with at most 1%
    of them off (the stored-grid contract of check_bf16_close). Fails
    otherwise; returns the counts as printed."""
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    kinds = {"NaN": torch.isnan, "+inf": torch.isposinf, "-inf": torch.isneginf}
    counts = {k: [0, 0, 0] for k in kinds}
    n_finite, worst, off, flipped = 0, 0.0, 0, 0
    for g_raw, w_raw in pairs:
        g, w = g_raw.float(), w_raw.float()
        for k, f in kinds.items():
            counts[k][0] += int(f(g).sum())
            counts[k][1] += int(f(w).sum())
            counts[k][2] += int((f(g) != f(w)).sum())
        finite = torch.isfinite(g) & torch.isfinite(w)
        n_finite += int(finite.sum())
        a, b = g[finite], w[finite]
        if a.numel():
            worst = max(worst, float((a - b).abs().max()))
        if tol is not None:
            beyond = (a - b).abs() > tol["atol"] + tol["rtol"] * b.abs()
            if flips is not None:
                flipped += int(beyond.sum())
                beyond &= (a - b).abs() > flips[1] * b.abs()
            off += int(beyond.sum())
        elif bf16_ulps is not None:
            def key(x):
                k = x.to(torch.bfloat16).view(torch.int16).int()
                return torch.where(k < 0, -(k & 0x7FFF), k)

            ulps = (key(a) - key(b)).abs()
            off += int((ulps > bf16_ulps).sum()) + (int((ulps > 0).sum()) > 0.01 * a.numel())
        else:
            bits = torch.int16 if g_raw.dtype == torch.bfloat16 else torch.int32
            off += int((g_raw.view(bits)[finite] != w_raw.view(bits)[finite]).sum())
    rule = (f"within {tol}" if tol is not None else f"within {bf16_ulps} bf16 ulps"
            if bf16_ulps is not None else "bit for bit")
    if flips is not None:
        off += flipped > flips[0] * n_finite
        rule += f" but {flipped} (at most {flips[0]:g} of them) within {flips[1]:.3g} relative"
    check(all(c[2] == 0 for c in counts.values()) and off == 0,
          f"{what}: non-finite positions (kernel, plain, differing) {counts}, {off} finite "
          f"values not {rule} (max abs {worst:.3g})")
    return (f"{what}: " + ", ".join(f"{k} at {c[0]} values" for k, c in counts.items())
            + f" in both, {n_finite} finite values {rule} (max abs {worst:.3g})")


def band_ext(torch, fast, small, i: int, rows: int, halo: int, border: str):
    """Band i of rows pooled rows of a 1x4 mesh, extended by halo rows on
    each side as parallel/spatial.py extends it (its neighbours' rows, the
    edge row (CLAMP) or zero rows (ZERO) beyond the image)."""
    idx = torch.arange(i * rows - halo, (i + 1) * rows + halo, device=small.device)
    ext = small[idx.clamp(0, small.shape[0] - 1)]
    if border != fast.BorderPolicy.CLAMP:
        ext[(idx < 0) | (idx >= small.shape[0])] = 0.0
    return ext.contiguous()


def mesh_bands(torch, fast, note, close, case: str, slice_args, border, whole, build_args,
               whole_grid) -> float:
    """The D = 1 grid kernels on the four bands of a 1x4 mesh, as
    spatial_bilateral_fast gives them: each band pooled against its plain
    version at TOL_POOL, its pooled rows and halo_s = r + 1 of each
    neighbour (band_ext) built against its plain version and its rows
    against the whole grid's, and sliced in the slab form (its rows of the
    grid and one of each neighbour, the offsets y_off, hs_all, gy_off)
    against its plain version and against the whole slice's rows, bit for
    bit. Returns band 1's slab slice median ms."""
    img, grid, lmin, inv_step, d, alpha = slice_args
    small, rest = build_args[0], build_args[1:]
    halo = len(build_args[4]) // 2 + 1
    h = img.shape[0]
    rows = h // 4
    pooled, pooled_plain, sliced, sliced_plain, built = [], [], [], [], []
    for i in range(4):
        band = img[i * rows : (i + 1) * rows].contiguous()
        pooled.append(fast.pool(band, d, border))
        pooled_plain.append(fast.pool_plain(band, d, border))
        ext = band_ext(torch, fast, small, i, rows, halo, border)
        got = fast.build_grid(ext, *rest, d=d)
        check(torch.equal(got, fast.build_grid_plain(ext, *rest)),
              f"build_grid {case} band {i}: not bit for bit the plain version")
        check(torch.equal(got[:, halo : halo + rows], whole_grid[:, i * rows : (i + 1) * rows]),
              f"build_grid {case} band {i}: differs from the whole grid's rows")
        built.append(got[:, halo : halo + rows])
        lo = max(i * rows - 1, 0)
        off = (i * rows, h, lo)
        slab = grid[:, lo : min((i + 1) * rows + 1, h)].contiguous()
        sliced.append(fast.slice_grid(band, slab, lmin, inv_step, d, alpha, *off))
        sliced_plain.append(fast.slice_grid_plain(band, slab, lmin, inv_step, d, alpha, off))
        check(torch.equal(sliced[-1], whole[i * rows : (i + 1) * rows]),
              f"slice_grid {case} slab band {i}: differs from the whole slice's rows")
        if i == 1:
            slab_ms = median_ms(torch, lambda: fast.slice_grid(band, slab, lmin, inv_step, d,
                                                               alpha, *off), 10)
    got, want = torch.cat(pooled), torch.cat(pooled_plain)
    note("pool", f"{case} 1x4 bands", got, want)
    close(got, want, TOL_POOL, f"pool {case} 1x4 bands")
    note("build_grid_d1", f"{case} 1x4 bands", torch.cat(built, 1), whole_grid)
    got, want = torch.cat(sliced), torch.cat(sliced_plain)
    note("slice_grid_d1", f"{case} 1x4 slabs", got, want)
    check(torch.equal(got, want), f"slice_grid {case} 1x4 slabs: not bit for bit the plain version")
    return slab_ms


def guided_bands(torch, fast, note, case: str, slice_args, whole, build_args) -> None:
    """The guided grid's kernels at D = 1 on the four bands of a 1x4 mesh,
    as spatial_cross_bilateral_layers_fast gives them: each band's pooled
    target and layer with halo_s = r + 1 rows of each neighbour (band_ext)
    built against its plain version and its rows against the whole grid's;
    each band sliced in the slab form (its rows of the grid and one of each
    neighbour, the offsets y_off, hs_all, gy_off) against its plain version
    and against the whole slice's rows, bit for bit."""
    layer, grid, lmin, inv_step, d = slice_args
    small_t, small_l, rest = build_args[0], build_args[1], build_args[2:]
    border = build_args[6]
    halo = len(build_args[5]) // 2 + 1
    h = layer.shape[0]
    rows = h // 4
    sliced, sliced_plain, built = [], [], []
    for i in range(4):
        ext = (band_ext(torch, fast, small_t, i, rows, halo, border),
               band_ext(torch, fast, small_l, i, rows, halo, border))
        got = fast.build_guided_grid(*ext, *rest, d=d)
        check(torch.equal(got, fast.build_guided_grid_plain(*ext, *rest)),
              f"build_guided_grid {case} band {i}: not bit for bit the plain version")
        check(torch.equal(got[:, halo : halo + rows], grid[:, i * rows : (i + 1) * rows]),
              f"build_guided_grid {case} band {i}: differs from the whole grid's rows")
        built.append(got[:, halo : halo + rows])
        band = layer[i * rows : (i + 1) * rows].contiguous()
        lo = max(i * rows - 1, 0)
        off = (i * rows, h, lo)
        slab = grid[:, lo : min((i + 1) * rows + 1, h)].contiguous()
        sliced.append(fast.slice_guided_grid(band, slab, lmin, inv_step, d, *off))
        sliced_plain.append(fast.slice_guided_grid_plain(band, slab, lmin, inv_step, d, off))
        for g, part in zip(sliced[-1], whole):
            check(torch.equal(g, part[i * rows : (i + 1) * rows]),
                  f"slice_guided_grid {case} slab band {i}: differs from the whole slice's rows")
    got = tuple(torch.cat(parts) for parts in zip(*sliced))
    want = tuple(torch.cat(parts) for parts in zip(*sliced_plain))
    note("slice_guided_grid_d1", f"{case} 1x4 slabs", got, want)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"slice_guided_grid {case} 1x4 slabs: not bit for bit the plain version")
    note("build_guided_grid_d1", f"{case} 1x4 bands", (torch.cat(built, 1),), (grid,))


def phase_turbo_kernels(torch, fast, stencils, cfg, frame_4k, frame_1080, hdr: bool = False):
    """The grid kernels and the pipeline against their plain versions, and
    the fused kernel against the build and slice kernels bit for bit: at 4K
    for each (D, K) of TURBO_CELLS, and on the 1080p target at each setting
    of the turbo battery. Drives the fused path, grid_pipeline(fused=True),
    at each 4K cell, its launch counts read just after each call. Returns
    ({kernel: {max_abs_err, ms, plain_ms, ...}}, the fused path's summed
    launch counts) and prints both pipelines' Mpix/s at each D at 4K. At
    D = 1 (the 1080p target at sigma_s 2 and 6: 17 and 49 taps) the build
    and slice are recorded under their "_d1" names and timed there, and in
    place of the fused kernel, which D = 1 never runs, the target is cut
    into the four bands of a 1x4 mesh as the sharded --turbo 1 cuts it: each
    band pooled against its plain version, and sliced in the slab form, the
    whole slice's rows bit for bit. With hdr the frames are HDR content
    (phase 10): the same cells, the tolerances scaled by each frame's max
    |RGB|, the kernels timed at 4K D=2 K=5 and 1080p D=1 K=6; no fused path
    and no pipeline rates."""
    img4k = torch.from_numpy(frame_4k).to("cuda")
    img1080 = torch.from_numpy(frame_1080).to("cuda")
    results = {k: {"max_abs_err": 0.0}
               for k in ("pool", "build_grid", "slice_grid", "fused_grid", "build_grid_d1",
                         "slice_grid_d1")}
    path_counts = dict.fromkeys(stencils.launches, 0)
    tag = " HDR" if hdr else ""

    def note(kernel, case, got, want):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"{kernel} {case}: non-finite output")
        err = float((got.float() - want.float()).abs().max())
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)
        print(f"  {kernel:13s} {case:36s} max abs {err:.3g}")

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
        cells.append(("1080p" + tag, img1080, d, turbo_levels(d),
                      cfg.BilateralParams(sigma_spatial=sigma_s)))
    # D=1 again at sigma_s 6: the 49-tap build (--turbo 1 --sigma-spatial 6)
    cells.append(("1080p" + tag, img1080, 1, turbo_levels(1),
                  cfg.BilateralParams(sigma_spatial=6.0)))

    timed, shapes, library = {}, {}, {}
    timed_d1, shapes_d1, library_d1 = {}, {}, {}
    for label, img, d, levels, bp in cells:
        border, ua = bp.border, bp.uniform_alpha
        case = (f"{label} D={d} K={levels} {border} sigma_s {bp.sigma_spatial:g}"
                f"{' ua' if ua else ''}")
        build_name, slice_name = (D1_FORMS[k] if d == 1 else k for k in ("build_grid",
                                                                          "slice_grid"))
        small = fast.pool_plain(img, d, border)
        got = fast.pool(img, d, border)
        note("pool", case, got, small)
        close(got, small, TOL_POOL, f"pool {case}")
        lmin, step = fast.grid_range(small, levels)
        build_args = (small, lmin, step, levels, fast._grid_taps(bp.sigma_spatial, d),
                      border, 0.5 / bp.sigma_color**2, ua)
        grid = fast.build_grid_plain(*build_args)
        got = fast.build_grid(*build_args, d=d)
        note(build_name, case, got, grid)
        check_bf16_close(torch, got, grid, f"build_grid {case}")
        if d == 1:  # the d = 1 body keeps the plain version's order: bit for bit
            check(torch.equal(got, grid), f"build_grid {case}: not bit for bit the plain version")
        slice_args = (img, grid, lmin, 1.0 / step, d, img[0, 0, 3] if ua else None)
        want = fast.slice_grid_plain(*slice_args)
        got = fast.slice_grid(*slice_args)
        note(slice_name, case, got, want)
        if d == 1:  # the own cell at the touched levels, in level order: bit for bit
            check(torch.equal(got, want), f"slice_grid {case}: not bit for bit the plain version")
            slab_ms = mesh_bands(torch, fast, note, close, case, slice_args, border, got,
                                 build_args, grid)
            n_taps = len(build_args[4])
            build_ms = median_ms(torch, lambda a=build_args: fast.build_grid(*a, d=1), 10)
            info = fast.build_d1_info(img.device, n_taps, border)
            print(f"  build_grid {case}: {n_taps} taps, bit for bit the plain version (whole "
                  f"and 1x4 bands), median {build_ms:.4f} ms; slab band 1 median "
                  f"{slab_ms:.4f} ms")
            if not hdr:
                print_redesigned(f"build_grid 1080p D=1 {n_taps} taps", info, build_ms)
            else:
                print(f"  build_grid_d1 {json.dumps(info)}")
            if bp.sigma_spatial == 2.0 and not hdr:
                # The non-finite frame, pooled, built on the finite frame's
                # grid range and on its own (a channel whose range is not
                # finite: every level NaN, queue C of ROADMAP.md)
                small_nf = fast.pool(nonfinite_frame(img), 1, border)
                for rng in ((lmin, step), fast.grid_range(small_nf, levels)):
                    args = (small_nf, *rng, *build_args[3:])
                    print("  " + same_nonfinite(
                        torch, f"build_grid_d1 non-finite frame, range "
                               f"{'finite' if bool(torch.isfinite(rng[1]).all()) else 'not finite'}",
                        fast.build_grid(*args, d=1), fast.build_grid_plain(*args)))
            if bp.sigma_spatial == 2.0:
                timed_d1 = {
                    build_name: (lambda a=build_args: fast.build_grid(*a, d=1),
                                 lambda a=build_args: fast.build_grid_plain(*a)),
                    slice_name: (lambda a=slice_args: fast.slice_grid(*a),
                                 lambda a=slice_args: fast.slice_grid_plain(*a)),
                }
                pixels = img.shape[0] * img.shape[1]
                shapes_d1 = dict.fromkeys(timed_d1, dict(pixels=pixels, cells=pixels,
                                                         levels=levels, taps=n_taps))
                sample, planes = grid_sample_slice(torch, grid, img, lmin, 1.0 / step, d,
                                                   [(0,), (1, 3), (2,)])
                lib_err = max(float((v - got[..., p]).abs().max())
                              for p, v in planes(sample()).items())
                print(f"  grid_sample yardstick vs slice_grid {case}: max abs {lib_err:.3g}")
                library_d1 = {slice_name: sample}
                print(f"  slice_grid {case} reads "
                      f"{own_cell_reads(torch, img, lmin, 1.0 / step, levels, 8)}")
        else:
            close(got, want, scaled(TOL_SLICE, max(1.0, float(img[..., :3].abs().max()))),
                  f"slice_grid {case}")
            fused_args = (small, img, lmin, step, 1.0 / step, *build_args[3:7], d, slice_args[5])
            got = fast.fused_grid(*fused_args)
            two = fast.slice_grid(img, fast.build_grid(*build_args, d=d), *slice_args[2:])
            torch.cuda.synchronize()
            check(torch.equal(got, two),
                  f"fused_grid {case}: differs from the build and slice kernels")
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
        got = fast.grid_pipeline(img, bp, levels, d)
        want = fast.grid_pipeline_plain(img, bp, levels, d)
        pipeline_check(torch, case, got, want, img)
        if label == "4K" + tag and d == 2 and not ua:
            timed = {
                "pool": (lambda a=(img, d, border): fast.pool(*a),
                         lambda a=(img, d, border): fast.pool_plain(*a)),
                "build_grid": (lambda a=build_args: fast.build_grid(*a, d=2),
                               lambda a=build_args: fast.build_grid_plain(*a)),
                "slice_grid": (lambda a=slice_args: fast.slice_grid(*a),
                               lambda a=slice_args: fast.slice_grid_plain(*a)),
                "fused_grid": (lambda a=fused_args: fast.fused_grid(*a),
                               lambda a=fused_args: fast.fused_grid_plain(*a)),
            }
            shape = dict(pixels=img.shape[0] * img.shape[1], cells=small.shape[0] * small.shape[1],
                         levels=levels, taps=len(build_args[4]))
            shapes = dict.fromkeys(timed, shape)
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

    time_kernels(torch, results, timed_d1, shapes_d1, library_d1,
                 f"1080p{tag} D=1 K={turbo_levels(1)}")
    if not hdr:
        key = f"slice_grid 1080p D=1 K={turbo_levels(1)}"
        print(f"  {key}: median {results['slice_grid_d1']['ms']:.4f} ms, before the redesign "
              f"{BEFORE_REDESIGN_MS[key]} ms")
    where = f"4K{tag} D=2 K=5"
    if hdr:
        time_kernels(torch, results, timed, shapes, library, where)
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
        build_ms = median_ms(torch, lambda a=build_args: fast.build_grid(*a, d=d), 10)
        grid = fast.build_grid(*build_args, d=d)
        slice_ms = median_ms(torch, lambda: fast.slice_grid(img4k, grid, lmin, 1.0 / step, d), 10)
        print(f"  fused_grid 4K D={d} K={levels} median {fused_ms:.4f} ms against build_grid + "
              f"slice_grid {build_ms:.4f} + {slice_ms:.4f} = {build_ms + slice_ms:.4f} ms; "
              f"{json.dumps(fast.fused_grid_info(img4k.device, d, taps.size, clamp))}")
    time_kernels(torch, results, timed, shapes, library, where)
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
    each setting of the turbo battery. At D = 1 (the --turbo 1 layers'
    form, recorded under slice_guided_grid_d1) the slice is held to its plain
    version bit for bit, on the whole layer and in the slab form on the four
    bands of a 1x4 mesh, each band the whole slice's rows. images: {"4K" |
    "1080p": (target, layer)} on the card. Returns {kernel: {max_abs_err,
    ms, ...}}. With hdr the targets are HDR content (phase 10), the slice's
    absolute tolerance times the target's max |RGB|; the kernels are timed
    at 4K D=2 K=5 and the D = 1 slice at 1080p D=1 K=6 only."""
    kernels = ("build_guided_grid", "slice_guided_grid", "build_guided_grid_d1",
               "slice_guided_grid_d1", "fused_guided")
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

    def yardstick(case, grid, layer, lmin, step, d, sliced):
        """The slice's library yardstick: one trilinear grid_sample over the
        planes of each channel (alpha's numerator under green's t), its
        distance from the kernel's output printed."""
        sample, planes = grid_sample_slice(torch, grid, layer, lmin, 1.0 / step, d,
                                           [(0, 4), (1, 3, 5), (2, 6)])
        kernel_out = torch.cat(sliced, -1)
        lib_err = max(float((v - kernel_out[..., p]).abs().max())
                      for p, v in planes(sample()).items())
        print(f"  grid_sample yardstick vs slice_guided_grid {case}: max abs {lib_err:.3g}")
        return sample

    cells = []  # (label, D, K, sigma_s, border)
    for d, levels in TURBO_CELLS:
        cells.append(("4K", d, levels, 2.0, clamp))
        if d == 2:
            cells.append(("4K", d, levels, 2.0, zero))
    for d, sigma_s in TURBO_RUNS:
        cells.append(("1080p", d, turbo_levels(d), sigma_s, clamp))

    timed, fused_vs_two, timed_d1 = {}, {}, {}
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
        got = fast.build_guided_grid(*build_args, d=d)
        build_name = "build_guided_grid_d1" if d == 1 else "build_guided_grid"
        note(build_name, case, (got,), (grid,))
        check_bf16_close(torch, got, grid, f"build_guided_grid {case}")
        if d == 1:  # the d = 1 body keeps the plain version's order: bit for bit
            check(torch.equal(got, grid),
                  f"build_guided_grid {case}: not bit for bit the plain version")
        slice_args = (layer, grid, lmin, 1.0 / step, d)
        want = fast.slice_guided_grid_plain(*slice_args)
        sliced = fast.slice_guided_grid(*slice_args)
        slice_name = "slice_guided_grid_d1" if d == 1 else "slice_guided_grid"
        note(slice_name, case, sliced, want)
        for g, w in zip(sliced, want):
            if d == 1:
                check(torch.equal(g, w), f"slice_guided_grid {case}: max abs "
                                         f"{float((g - w).abs().max()):.3g}, not bit for bit")
            else:
                ok = bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all())
                check(ok, f"slice_guided_grid {case}: max abs {float((g - w).abs().max()):.3g}")
        if d == 1:
            guided_bands(torch, fast, note, case, slice_args, sliced, build_args)
        fused_args = (small_t, small_l, layer, lmin, step, 1.0 / step, levels, taps, border,
                      inv2sc, d)
        if fast.fused_guided_fits(d, taps.size, layer.device):
            got = fast.fused_guided(*fused_args)
            two = fast.slice_guided_grid(layer, fast.build_guided_grid(*build_args, d=d), lmin,
                                         1.0 / step, d)
            torch.cuda.synchronize()
            check(all(torch.equal(g, t) for g, t in zip(got, two)),
                  f"fused_guided {case}: differs from the two guided kernels")
            # against its plain version, the composition of the two plain
            # versions (`want`): the build's bf16 flips through the slice
            note("fused_guided", case, got, want)
        if label == "1080p" + tag and d == 1:
            main_build = build_args  # the main path's --turbo 1 build
            timed_d1 = {build_name: (lambda a=build_args: fast.build_guided_grid(*a, d=1),
                                     lambda a=build_args: fast.build_guided_grid_plain(*a)),
                        slice_name: (lambda a=slice_args: fast.slice_guided_grid(*a),
                                     lambda a=slice_args: fast.slice_guided_grid_plain(*a))}
            if not hdr:
                # the non-finite target and layer, pooled, on the finite
                # frames' grid range and on the layer's own
                small_nf = tuple(fast.pool(nonfinite_frame(x), 1, border)
                                 for x in (target, layer))
                for rng in ((lmin, step), fast.grid_range(small_nf[1], levels)):
                    args = (*small_nf, *rng, *build_args[4:])
                    print("  " + same_nonfinite(
                        torch, f"build_guided_grid_d1 non-finite frames, range "
                               f"{'finite' if bool(torch.isfinite(rng[1]).all()) else 'not finite'}",
                        fast.build_guided_grid(*args, d=1), fast.build_guided_grid_plain(*args)))
            pixels = layer.shape[0] * layer.shape[1]
            shape_d1 = dict(pixels=pixels, cells=pixels, levels=levels, taps=taps.size)
            sample_d1 = yardstick(case, grid, layer, lmin, step, d, sliced)
            print(f"  slice_guided_grid {case} reads "
                  f"{own_cell_reads(torch, layer, lmin, 1.0 / step, levels, 16)}")
        if label == "4K" and d in (2, 4) and border == clamp:
            fused_vs_two[d] = (fused_args, build_args, slice_args[2:])
        if label == "4K" + tag and d == 2 and border == clamp:
            timed = {
                "build_guided_grid": (lambda a=build_args: fast.build_guided_grid(*a, d=2),
                                      lambda a=build_args: fast.build_guided_grid_plain(*a)),
                "slice_guided_grid": (lambda a=slice_args: fast.slice_guided_grid(*a),
                                      lambda a=slice_args: fast.slice_guided_grid_plain(*a)),
                "fused_guided": (lambda a=fused_args: fast.fused_guided(*a),
                                 lambda a=fused_args: fast.fused_guided_plain(*a)),
            }
            shape = dict(pixels=layer.shape[0] * layer.shape[1],
                         cells=small_t.shape[0] * small_t.shape[1], levels=levels,
                         taps=taps.size)
            library = {"slice_guided_grid": yardstick(case, grid, layer, lmin, step, d, sliced)}
    time_kernels(torch, results, timed, dict.fromkeys(timed, shape), library, f"4K{tag} D=2 K=5")
    time_kernels(torch, results, timed_d1, dict.fromkeys(timed_d1, shape_d1),
                 {k: sample_d1 for k in timed_d1 if k.startswith("slice")},
                 f"1080p{tag} D=1 K={shape_d1['levels']}")
    small_t, _, _, _, levels, taps, border, _ = main_build
    info = fast.build_d1_info(small_t.device, taps.size, border, guided=True)
    if hdr:
        print(f"  build_guided_grid_d1 {json.dumps(info)}")
        return results
    # The guided builds as compiled, the d = 1 body at the main path's
    # --turbo 1 shape.
    print_redesigned("build_guided_grid 4K D=2 K=5",
                     fast.build_grid_info(small_t.device, shape["taps"], border, guided=True),
                     results["build_guided_grid"]["ms"])
    print_redesigned(f"build_guided_grid 1080p D=1 {taps.size} taps", info,
                     results["build_guided_grid_d1"]["ms"])
    print_redesigned("fused_guided 4K D=2 K=5",
                     fast.fused_guided_info(small_t.device, 2, shape["taps"], clamp),
                     results["fused_guided"]["ms"])
    # The fused kernel against the two kernels it fuses, which the reference's
    # dispatch runs at d = 1 and 8 (the layers' default_guided_fused).
    for d, (fused_args, build_args, slice_rest) in sorted(fused_vs_two.items()):
        layer = fused_args[2]
        fused_ms = median_ms(torch, lambda a=fused_args: fast.fused_guided(*a), 10)
        build_ms = median_ms(torch, lambda a=build_args: fast.build_guided_grid(*a, d=d), 10)
        grid = fast.build_guided_grid(*build_args, d=d)
        slice_ms = median_ms(torch, lambda: fast.slice_guided_grid(layer, grid, *slice_rest), 10)
        print(f"  fused_guided 4K D={d} K={build_args[4]} median {fused_ms:.4f} ms against "
              f"build_guided_grid + slice_guided_grid {build_ms:.4f} + {slice_ms:.4f} = "
              f"{build_ms + slice_ms:.4f} ms")
    return results


# Kernels each turbo run may launch, and must: the grid configs through the
# bilateral grid (pool, build, slice; D=1 is the eager lattice on one
# device) and the guided grid (fused at D = 2 and 4, the guided build and
# slice at D = 1 and 8, under their D = 1 names there, beside the pool);
# the NLM configs through the bf16 NLM, or with --weights-halfres the bf16
# half-row NLM, and normalize.
def turbo_kernels(d: int, nlm: bool, flags: tuple = ()) -> set:
    if nlm:
        return {"nlm_hrw_bf16" if "--weights-halfres" in flags else "nlm_bf16", "normalize"}
    guided = {"fused_guided"} if d in (2, 4) else {
        D1_FORMS[k] if d == 1 else k for k in ("build_guided_grid", "slice_guided_grid")}
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
        counts.clear()
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


def program_spans(path: str, prefix: str = "idf.") -> list:
    """The program's own spans in a Chrome trace of torch.profiler (the
    spans of utils/timing.py, every one of a name kept): [(name, start,
    end)] in microseconds, by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events
                  if e.get("cat") == "user_annotation" and e.get("name", "").startswith(prefix))


def idle_under_spans(spans, device, start: float, end: float) -> tuple[dict, float, float]:
    """({name: (ms of its spans, ms of them in which the device ran no
    kernel, copy or fill)} over the spans that start in [start, end), the
    device's busy ms in [start, end), and the part of it under those
    spans). A span holds the spans nested in it."""
    def clipped(a, b):
        out = []
        for e in device:
            s0, s1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            if s1 > a and s0 < b:
                out.append((max(s0, a), min(s1, b)))
        return out

    inside = [(n, a, b) for n, a, b in spans if start <= a < end]
    out = {}
    for name, a, b in inside:
        span_ms, idle_ms = out.get(name, (0.0, 0.0))
        out[name] = (span_ms + (b - a) / 1e3, idle_ms + (b - a) / 1e3 - busy_ms(clipped(a, b)))
    under = busy_ms(piece for _, a, b in inside for piece in clipped(a, b))
    return out, busy_ms(clipped(start, end)), under


def phase_cpu_parity_profile(torch, cfg, stencils, cli, imageio, content, reference, native,
                             kernels, anim, root, exact_dir):
    """Phase 8: the card's render against the host's; the parity reading on
    two frames (the bilateral kernel also against its plain version, into
    kernels); the CPU configs through gpu-denoise on the crop; the six device
    configs through gpu-denoise --profile, their outputs equal to phase 4's
    files, and per config the device's idle ms under each of the program's
    idf.* spans. Returns the launch counts of the profiled run."""
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
    ours = program_spans(trace)
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
        # The program's spans and the device's events share one clock: the
        # device's work falls under the Session's phases. The profiler maps
        # the device's timestamps onto the host's clock to within about a
        # millisecond (on the H100, 88% of the multiframe config's busy ms
        # has read under the spans, its uploads shifted into the alpha
        # checks before them), so the check is that most of it does.
        idle, busy_all, under = idle_under_spans(ours, device, start, end)
        check(busy_all > 0 and under >= 0.5 * busy_all,
              f"{key}: {under:.3f} of the device's {busy_all:.3f} busy ms under idf.* spans")
        print(f"      device busy {under:.3f} of {busy_all:.3f} ms under idf.* spans; idle ms "
              "under each (of its ms): " + ", ".join(
                  f"{n.removeprefix('idf.')} {i:.3f} ({t:.3f})" for n, (t, i) in idle.items()))
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


def turbo1_mesh_gate(label: str, got: np.ndarray, exact: np.ndarray, hdr: bool) -> str:
    """The sharded --turbo 1 bilateral output read against the exact tiled
    bilateral's (RGB of the 8-bit files, or psnr_peak on EXR) and gated at
    the JAX package's reading less TURBO1_MESH_GATE_MARGIN_DB. Returns the
    reading as printed."""
    db = (psnr_peak(got, exact, float(exact[..., :3].max())) if hdr
          else psnr(got[..., :3], exact[..., :3]))
    jax_db = JAX_TURBO1_MESH_READINGS_DB[label]
    gate = jax_db - TURBO1_MESH_GATE_MARGIN_DB
    check(db >= gate, f"--turbo 1 --mesh 1x4 {label} bilateral: {db:.4f} dB vs exact < "
                      f"{gate:.4f} dB (the JAX package's {jax_db} less "
                      f"{TURBO1_MESH_GATE_MARGIN_DB})")
    return f"{db:.4f} dB vs exact over RGB (JAX {jax_db}, gate {gate:.4f})"


def check_mesh_turbo(torch, fast, cfg, imageio, turbo_pad_rows, target: str, got: str, root: str,
                     d: int, pipeline, hdr: bool, what: str) -> int:
    """The bilateral file (got) of gpu-denoise <target> --turbo d --mesh 1x4
    against pipeline(padded, bp, K, d) on one device: the frame row-padded as
    the sharded Session pads it (turbo_pad_rows over 4 bands), the output
    cropped to the frame and saved as gpu-denoise saves it, byte for byte on
    PNG (--clamp), array for array on EXR. Returns the padded frame's rows."""
    bp = cfg.BilateralParams()
    padded = turbo_pad_rows(imageio.load(target)[0], 4, bp.effective_radius, d, bp.border)
    want = pipeline(torch.from_numpy(padded).to("cuda"), bp, turbo_levels(d),
                    d)[:H].cpu().numpy()
    if hdr:
        same = np.array_equal(imageio.load(got)[0], want)
    else:
        want_path = os.path.join(root, f"pipeline_d{d}_{os.path.basename(got)}")
        imageio.save(want_path, want, clamp=True)
        same = same_bytes(got, want_path)
    check(same, f"{what}: differs from {pipeline.__name__}(..., {d}) on the padded frame")
    return padded.shape[0]


def turbo1_mesh(torch, cfg, stencils, fast, cli, imageio, turbo_pad_rows, target: str, root: str,
                label: str, layers_file: str, exact_file: str, lattice_file: str | None,
                hdr: bool, smi: str) -> dict:
    """gpu-denoise <target> --turbo 1 --mesh 1x4 over gloo with the
    bilateral, linear and layers configs: the bilateral grid's kernels at
    D = 1 on each rank's band. The bilateral file is the single-device
    two-kernel pipeline grid_pipeline(padded, bp, 6, 1) on the row-padded
    frame (check_mesh_turbo), the linear file its bytes; the layers file is
    the single-device --turbo 1 run's (layers_file); pool, build_grid and
    slice_grid launch on the ranks beside the guided kernels, no other
    kernel, each under its D = 1 name; the bilateral file's reading against
    exact_file is gated (turbo1_mesh_gate), the one-device lattice's
    (lattice_file, where given) printed beside it. Returns the launch counts
    summed over the ranks."""
    names = {k: c.output_name(hdr) for k, c in zip(cli.CONFIG_KEYS, cfg.GPU_BATTERY)}
    keys = ("bilateral", "layers", "linear")  # gpu-denoise's order
    out_dir = os.path.join(root, f"mesh_turbo1_{'hdr' if hdr else 'ldr'}")
    what = f"gpu-denoise <{label} target> --turbo 1 --mesh 1x4"
    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc, rank_counts = cli.run([target, "--device", "cuda", *(() if hdr else ("--clamp",)),
                                   "--turbo", "1", "--configs", ",".join(keys), "--mesh", "1x4",
                                   "--dist-backend", "gloo", "--output-dir", out_dir])
    check(rc == 0, f"{what} failed ({rc}): {err.getvalue().strip()[-2000:]}")
    check(len(rank_counts) == 4, f"{what}: {len(rank_counts)} ranks")
    counts = sum_counts(stencils, rank_counts)
    expected = {"pool", *D1_FORMS.values()}
    check(all(counts[k] > 0 for k in expected)
          and all(n == 0 for k, n in counts.items() if k not in expected),
          f"{what}: launches {counts}, expected {sorted(expected)}")
    print(f"  {what}: {time.perf_counter() - t0:.1f} s, launches summed over 4 ranks "
          f"{ {k: n for k, n in counts.items() if n} }")
    reports = re.findall(r"transfer time: (\d+)ns; execution time: (\d+)ns", out.getvalue())
    check(len(reports) == len(keys), f"{what}: {len(reports)} timing reports")
    for key, (tr, ex) in zip(keys, reports):
        print(f"    {key:10s} rank 0 transfer {int(tr):>11d} ns  exec {int(ex):>11d} ns "
              f"({smi}; 4 ranks on one card: overhead, not scaling)")
    got = {key: os.path.join(out_dir, names[key]) for key in keys}
    rows = check_mesh_turbo(torch, fast, cfg, imageio, turbo_pad_rows, target, got["bilateral"],
                            root, 1, fast.grid_pipeline, hdr, f"{what} bilateral")
    check(same_bytes(got["bilateral"], got["linear"]), f"{what}: bilateral and linear differ")
    if hdr:
        same = np.array_equal(imageio.load(got["layers"])[0], imageio.load(layers_file)[0])
    else:
        same = same_bytes(got["layers"], layers_file)
    check(same, f"{what} layers: differs from the single-device --turbo 1 file")
    exact = imageio.load(exact_file)[0]
    reading = turbo1_mesh_gate(label, imageio.load(got["bilateral"])[0], exact, hdr)
    if lattice_file is not None:
        lattice = imageio.load(lattice_file)[0]
        reading += f"; the one-device lattice {psnr(lattice[..., :3], exact[..., :3]):.4f} dB"
    print(f"    bilateral and linear: grid_pipeline(..., 1) on the edge-padded {rows}-row frame "
          f"{'array for array' if hdr else 'byte for byte'}; layers the single-device "
          f"--turbo 1 file's; {reading}")
    return counts


def phase_sharded(torch, cfg, stencils, fast, cli, imageio, launch, dryrun, turbo_pad_rows, anim,
                  root, exact_dir, smi):
    """Phase 9: gpu-denoise --mesh on four ranks that share the card over
    gloo. The exact battery on 1x4 and 2x2 against phase 4's files, the
    sharded turbo against phase 7's files or the single-device pipeline on
    the same padded frame (check_mesh_turbo; --turbo 1 in turbo1_mesh); the
    slab slice kernels against their plain versions with offsets; the HDR
    frame of phase 5 through the sharded turbo grid; the dry run. Each run's
    launch counts are summed over its ranks, read just after it. Returns the
    launch counts of all of them, summed."""
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
    rows = check_mesh_turbo(torch, fast, cfg, imageio, turbo_pad_rows, target,
                            os.path.join(out_dir, names["bilateral"]), root, 4,
                            fast.bilateral_fast, False, "--turbo 4 --mesh 1x4")
    print(f"    equal to bilateral_fast on the same edge-padded {rows}-row frame, byte for byte")

    # 5. --turbo 1 on 1x4: the bilateral grid's kernels at D = 1 band by band
    # (270 rows a band, no padding at 1080p; phase 5 held them to their plain
    # versions on these bands)
    counts = turbo1_mesh(torch, cfg, stencils, fast, cli, imageio, turbo_pad_rows, target, root,
                         "1080p", os.path.join(root, "turbo1_bilateral", names["layers"]),
                         os.path.join(exact_dir, names["bilateral"]),
                         os.path.join(root, "turbo1_bilateral", names["bilateral"]), False, smi)
    for k, n in counts.items():
        totals[k] += n

    # 6. the slab slice kernels with offsets at 4K D=2, and the HDR frame
    noisy_4k = anim["noisy_4k"]
    img = torch.from_numpy(noisy_4k).to("cuda")
    d, levels, bp = 2, turbo_levels(2), cfg.BilateralParams()
    small = fast.pool(img, d)
    lmin, step = fast.grid_range(small, levels)
    taps = fast._grid_taps(bp.sigma_spatial, d)
    grid = fast.build_grid(small, lmin, step, levels, taps, bp.border, 0.5 / bp.sigma_color**2,
                           d=d)
    ggrid = fast.build_guided_grid(small, small, lmin, step, levels, taps, bp.border,
                                   0.5 / bp.sigma_color**2, d=d)
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
              turbo_pad_rows, root, ldr_frames, ldr_kernels, smi):
    """Phase 10: HDR. The EXR animation (HDR_*) written and read back, the
    EXR codec timed; every kernel, in every form, against its plain version
    on its HDR frame (1080p and 4K, the grid kernels at each (D, K)), with
    the staged bilateral's walks; then gpu-denoise on the card: the exact
    battery against the plain versions on the same frames, the bilateral
    and layers configs with bf16 taps (Session(tiling=...)), the turbo runs
    of HDR_TURBO_RUNS, each gated at the JAX package's reading, --turbo 1
    --mesh 1x4 (turbo1_mesh), and
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
    counts = turbo1_mesh(torch, cfg, stencils, fast, cli, imageio, turbo_pad_rows, target, root,
                         "1080p HDR", os.path.join(root, "hdr_turbo_1", names["layers"]),
                         os.path.join(out_exact, names["bilateral"]), None, True, smi)
    for k, n in counts.items():
        totals[k] += n

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


# ---------------------------------------------------------------------------
# Phase 12: non-finite frames
# ---------------------------------------------------------------------------


def mesh_range(torch, small, levels: int, bands: int = 4):
    """The grid range of parallel/spatial.py:_grid_range over `bands` row
    bands of the pooled image, on one device: each band's RGB extrema, a NaN
    extremum replaced by +inf (the identity), reduced over the bands; then
    grid_range's step. On a frame whose NaN lies in one band, the other
    bands' finite range (the JAX package's pmin/pmax)."""
    rgb = small[..., :3]
    ext = torch.stack([torch.cat([b.amin((0, 1)), -b.amax((0, 1))])
                       for b in torch.tensor_split(rgb, bands)])
    ext = torch.where(ext.isnan(), float("inf"), ext).amin(0)
    lmin, lmax = ext[:3], -ext[3:]
    return lmin, (lmax - lmin).clamp_min(1e-6) / (levels - 1)


def d1_fringe(torch, what: str, got, want, grid) -> str:
    """The d = 1 slice kernel (own cell) against slice_grid_plain on a grid
    with non-finite cells, the known difference of ROADMAP.md queue C: the
    kernel's NaN, +inf and -inf a subset of the plain version's, each value
    where they differ one whose bilinear footprint (cells y..y+1, x..x+1 of
    its channel's plane, at any level) holds a non-finite cell the kernel
    does not read, and every value finite in both bit for bit."""
    torch.cuda.synchronize()
    bad = (~torch.isfinite(grid.float())).any(0)  # (H, W, 4)
    h, w = bad.shape[:2]
    yy = torch.arange(h, device=bad.device).add(1).clamp_max(h - 1)
    xx = torch.arange(w, device=bad.device).add(1).clamp_max(w - 1)
    foot = bad | bad[yy] | bad[:, xx] | bad[yy][:, xx]
    g_bad, w_bad = ~torch.isfinite(got), ~torch.isfinite(want)
    subset = not bool((g_bad & ~w_bad).any())
    kinds_agree = all(bool(((f(got) != f(want)) & g_bad).sum() == 0)
                      for f in (torch.isnan, torch.isposinf, torch.isneginf))
    apart = w_bad & ~g_bad
    finite = ~g_bad & ~w_bad
    bits = int((got.view(torch.int32)[finite] != want.view(torch.int32)[finite]).sum())
    check(subset and kinds_agree and not bool((apart & ~foot).any()) and bits == 0,
          f"{what}: kernel non-finite a subset {subset}, kinds agree {kinds_agree}, "
          f"{int((apart & ~foot).sum())} values apart outside the footprint, {bits} finite "
          f"values differ in their bits")
    return (f"{what}: {int(g_bad.sum())} non-finite values (plain {int(w_bad.sum())}; "
            f"{int(apart.sum())} apart, each a footprint cell the own-cell read skips, "
            f"queue C), {int(finite.sum())} finite values bit for bit")


NONFINITE_KERNELS = ("bilateral", "bilateral_guided", "bilateral_bf16", "bilateral_guided_bf16",
                     "nlm", "nlm_bf16", "nlm_hrw", "nlm_hrw_bf16", "normalize", "pool",
                     "build_grid", "slice_grid", "build_grid_d1", "slice_grid_d1", "fused_grid",
                     "build_guided_grid", "slice_guided_grid", "build_guided_grid_d1",
                     "slice_guided_grid_d1", "fused_guided")


def phase_nonfinite_kernels(torch, fast, stencils, cfg, frames_np, layer_np, frame_4k,
                            layer_4k) -> None:
    """Every kernel form on the kernels line against its plain version on
    non-finite frames (nonfinite_frame: +inf, -inf and two NaN values, the
    NaNs in bands 0 and 2 of a 1x4 mesh), under same_nonfinite's contract at
    each kernel's tolerance: at 1080p the four bilateral forms (target and
    albedo layer non-finite), the four NLM forms at F = 1 and F = 6 (a
    neighbour frame non-finite too) and normalize on their partials; the
    grid kernels at each setting of the turbo battery (D = 1, 2, 4, 8), and
    at 4K for each (D, K) of TURBO_CELLS, each on three grid ranges: the
    frame's own (not finite: a channel's every level NaN), the sharded
    range of a 1x4 mesh (mesh_range: the NaN bands left out, finite), and
    the finite frame's (a non-finite guide on a finite grid); at D = 1 the
    slab slices of the four bands against the whole slice's rows; the fused
    kernels bit for bit against the two kernels. Every kernel must launch
    (no wrapper hands the frame to its plain version)."""
    dev = torch.device("cuda")
    clamp = cfg.BorderPolicy.CLAMP
    bf16 = cfg.TilingConfig(compute_dtype="bfloat16")

    def on_card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    finite_t = on_card(frames_np[TARGET_FRAME])
    finite_l = on_card(layer_np)
    target = nonfinite_frame(finite_t)
    nbr = nonfinite_frame(on_card(frames_np[TARGET_FRAME - 1]), shift=1)
    layer = nonfinite_frame(finite_l, shift=2)
    frames6 = torch.stack([target, on_card(frames_np[0]), on_card(frames_np[1]), nbr, target,
                           on_card(frames_np[4])])
    valid6 = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0], device=dev)
    stencils.reset_launches()

    def hold(what, got, want, **kw):
        print("  " + same_nonfinite(torch, what, got, want, **kw))

    bp, lp = cfg.BilateralParams(), cfg.LayersParams()
    for tiling, dtype, sfx in ((None, "float32", ""), (bf16, "bfloat16", "_bf16")):
        hold(f"bilateral{sfx} 1080p", stencils.bilateral(target, bp, tiling),
             stencils.bilateral_plain(target, None, bp, True, dtype)[0], tol=TOL_BILATERAL)
        hold(f"bilateral_guided{sfx} 1080p",
             stencils.cross_bilateral_layers(target, layer, lp, tiling),
             stencils.bilateral_plain(target, layer, lp, False, dtype), tol=TOL_BILATERAL)
    np_ = cfg.NlmParams()
    turbo = cfg.NlmParams(search_stride=2)
    hrw = cfg.NlmParams(search_stride=2, weights_halfres=True)
    for name, p, tiling, dtype in (("nlm", np_, None, "float32"),
                                   ("nlm_bf16", turbo, bf16, "bfloat16"),
                                   ("nlm_hrw", hrw, None, "float32"),
                                   ("nlm_hrw_bf16", hrw, bf16, "bfloat16")):
        flips = HRW_BF16_FLIPS if name == "nlm_hrw_bf16" else None
        hold(f"{name} 1080p F=1", stencils.nlm_accumulate(target, nbr, p, tiling),
             stencils.nlm_plain(target, nbr[None], p, None, dtype), tol=TOL_NLM, flips=flips)
        wc6, nw6 = stencils.nlm_accumulate_frames(target, frames6, p, tiling, valid6)
        hold(f"{name} 1080p F=6, valid mask", (wc6, nw6),
             stencils.nlm_plain(target, frames6, p, valid6, dtype), tol=TOL_NLM, flips=flips)
        if name == "nlm":
            hold("normalize 1080p F=6 partials", stencils.normalize(wc6, nw6),
                 stencils.normalize_plain(wc6, nw6, cfg.NormalizeParams()), tol=TOL_NORMALIZE)

    cells = [("1080p", target, layer, finite_t, finite_l, d, turbo_levels(d), sigma_s)
             for d, sigma_s in TURBO_RUNS]
    img4k, lay4k = on_card(frame_4k), on_card(layer_4k)
    cells += [("4K", nonfinite_frame(img4k), nonfinite_frame(lay4k, shift=2), img4k, lay4k, d,
               levels, 2.0) for d, levels in TURBO_CELLS]
    for label, img, lay, fin_img, fin_lay, d, levels, sigma_s in cells:
        taps = fast._grid_taps(sigma_s, d)
        inv2sc = 0.5 / bp.sigma_color**2
        build, sliced = (D1_FORMS[k] if d == 1 else k for k in ("build_grid", "slice_grid"))
        case = f"{label} D={d} K={levels}"
        small = fast.pool(img, d, clamp)
        hold(f"pool {case}", small, fast.pool_plain(img, d, clamp), tol=TOL_POOL)
        fin_small = fast.pool_plain(fin_img, d, clamp)
        ranges = {"mesh range": (small, img, mesh_range(torch, small, levels)),
                  "finite frame's range, non-finite guide":
                      (fin_small, img, fast.grid_range(fin_small, levels))}
        if label == "1080p":
            ranges["own range"] = (small, img, fast.grid_range(small, levels))
        for rname, (sm, guide, (lmin, step)) in ranges.items():
            what = f"{case} {rname}"
            args = (sm, lmin, step, levels, taps, clamp, inv2sc, False)
            grid = fast.build_grid_plain(*args)
            got = fast.build_grid(*args, d=d)
            hold(f"{build} {what}", got, grid, bf16_ulps=None if d == 1 else 2)
            got = fast.slice_grid(guide, grid, lmin, 1.0 / step, d)
            want = fast.slice_grid_plain(guide, grid, lmin, 1.0 / step, d)
            if d == 1:
                print("  " + d1_fringe(torch, f"{sliced} {what}", got, want, grid))
                h, rows = guide.shape[0], guide.shape[0] // 4
                for i in range(4):
                    lo = max(i * rows - 1, 0)
                    slab = grid[:, lo : min((i + 1) * rows + 1, h)].contiguous()
                    band = guide[i * rows : (i + 1) * rows].contiguous()
                    hold(f"{sliced} {what} slab band {i}",
                         fast.slice_grid(band, slab, lmin, 1.0 / step, d, None, i * rows, h, lo),
                         got[i * rows : (i + 1) * rows])
                continue
            hold(f"{sliced} {what}", got, want, tol=TOL_SLICE)
            fused = fast.fused_grid(sm, guide, lmin, step, 1.0 / step, levels, taps, clamp,
                                    inv2sc, d)
            two = fast.slice_grid(guide, fast.build_grid(*args, d=d), lmin, 1.0 / step, d)
            hold(f"fused_grid {what} against build + slice", fused, two)
        # The guided grid: range weights from the layer, payload the target.
        gbuild, gslice = (D1_FORMS[k] if d == 1 else k
                          for k in ("build_guided_grid", "slice_guided_grid"))
        small_t, small_l = fast.pool(img, d, clamp), fast.pool(lay, d, clamp)
        fin_l = fast.pool_plain(fin_lay, d, clamp)
        granges = {"mesh range": (small_l, lay, mesh_range(torch, small_l, levels)),
                   "finite layer's range, non-finite guide":
                       (fin_l, lay, fast.grid_range(fin_l, levels))}
        if label == "1080p":
            granges["own range"] = (small_l, lay, fast.grid_range(small_l, levels))
        for rname, (sl, guide, (lmin, step)) in granges.items():
            what = f"{case} {rname}"
            args = (small_t, sl, lmin, step, levels, taps, clamp, inv2sc)
            grid = fast.build_guided_grid_plain(*args)
            got = fast.build_guided_grid(*args, d=d)
            hold(f"{gbuild} {what}", got, grid, bf16_ulps=None if d == 1 else 2)
            got = fast.slice_guided_grid(guide, grid, lmin, 1.0 / step, d)
            hold(f"{gslice} {what}", got,
                 fast.slice_guided_grid_plain(guide, grid, lmin, 1.0 / step, d), tol=TOL_SLICE)
            if d == 1:
                h, rows = guide.shape[0], guide.shape[0] // 4
                for i in range(4):
                    lo = max(i * rows - 1, 0)
                    slab = grid[:, lo : min((i + 1) * rows + 1, h)].contiguous()
                    band = guide[i * rows : (i + 1) * rows].contiguous()
                    hold(f"{gslice} {what} slab band {i}",
                         fast.slice_guided_grid(band, slab, lmin, 1.0 / step, d, i * rows, h, lo),
                         tuple(x[i * rows : (i + 1) * rows] for x in got))
            if d in (2, 4) and fast.fused_guided_fits(d, taps.size, dev):
                fused = fast.fused_guided(small_t, sl, guide, lmin, step, 1.0 / step, levels,
                                          taps, clamp, inv2sc, d)
                two = fast.slice_guided_grid(guide, fast.build_guided_grid(*args, d=d), lmin,
                                             1.0 / step, d)
                hold(f"fused_guided {what} against build + slice", fused, two)
    launched = {k: n for k, n in stencils.launches.items() if n}
    check(all(launched.get(k, 0) > 0 for k in NONFINITE_KERNELS),
          f"non-finite frames: a kernel form did not launch: {launched}")
    print(f"  non-finite frames: every kernel form launched {launched}")


def write_nonfinite_animation(imageio, render_frame, root: str) -> dict:
    """Phase 12's animation: phase 10's EXR animation (write_hdr_animation)
    with NONFINITE_ANIMATION's values written in, the target's albedo layer
    as a float32 EXR in place of its PNG (it holds the +inf). Returns the
    target's path."""
    anim = write_hdr_animation(imageio, render_frame, root, "nonfinite")
    base = os.path.dirname(anim["target"])
    for i, values in NONFINITE_ANIMATION["frames"].items():
        frame = anim["frames"][i].copy()
        for y, x, c, v in values:
            frame[(*scaled_position(y, x, *frame.shape[:2]), c)] = v
        imageio.save(os.path.join(base, f"Animation01_HDR_{i:04d}.exr"), frame)
    png = os.path.join(base, "RenderElements", f"albedo_{TARGET_FRAME:04d}.png")
    albedo = imageio.load(png)[0].copy()
    os.remove(png)
    for y, x, c, v in NONFINITE_ANIMATION["albedo"]:
        albedo[(*scaled_position(y, x, *albedo.shape[:2]), c)] = v
    imageio.save(png[: -len(".png")] + ".exr", albedo)
    return {"target": anim["target"]}


def nonfinite_masks(out: np.ndarray) -> np.ndarray:
    """(3, H, W, 4): where out is NaN, +inf, -inf."""
    return np.stack([np.isnan(out), np.isposinf(out), np.isneginf(out)])


def nonfinite_reading(out: np.ndarray, exact, boxes=()) -> dict:
    """One output's reading on phase 12's animation (the JAX package's by
    tools/nonfinite_jax_reading.py, the port's here): per channel the counts
    of NaN, +inf and -inf; a digest of their positions; and, against the
    exact output of its config (None for the exact configs themselves), dB
    over the RGB values finite in both and outside `boxes` ([channel, y0,
    y1, x0, x1] each), psnr_peak's formula with the exact output's largest
    finite RGB value as the peak."""
    masks = nonfinite_masks(out)
    reading = {"counts": masks.sum((1, 2)).T.tolist(),
               "digest": hashlib.sha256(np.packbits(masks).tobytes()).hexdigest()[:16],
               "db": None}
    if exact is None:
        return reading
    keep = np.isfinite(out[..., :3]) & np.isfinite(exact[..., :3])
    for c, y0, y1, x0, x1 in boxes:
        if c < 3:
            keep[y0:y1, x0:x1, c] = False
    a = out[..., :3][keep].astype(np.float64)
    b = exact[..., :3][keep].astype(np.float64)
    peak = float(exact[..., :3][np.isfinite(exact[..., :3])].max())
    mse = float(np.mean((a - b) ** 2))
    reading["db"] = math.inf if mse == 0.0 else round(10.0 * math.log10(peak * peak / mse), 4)
    return reading


def nonfinite_exact_key(run: str, key: str):
    """The exact config an output of phase 12's `run` is read against: its
    own config's (the grid configs the tiled bilateral's), none for the
    exact battery."""
    if run == "exact":
        return None
    return "bilateral" if key == "linear" else key


def phase_nonfinite(torch, cfg, stencils, cli, imageio, render_frame, root: str, smi: str):
    """Phase 12, end to end: the non-finite EXR animation
    (write_nonfinite_animation) through gpu-denoise --device cuda, each run
    of NONFINITE_RUNS, every output's reading (nonfinite_reading) held to
    the JAX package's (JAX_NONFINITE_READINGS): the same counts and digest,
    or, where the JAX package's banded matmuls spread a non-finite value
    over their tile (an entry with "boxes"), every non-finite value of the
    port's inside those boxes; dB no lower than the JAX package's less
    NONFINITE_DB_MARGIN (phase 10's gate), read over the same values.
    Returns the launch counts."""
    target = write_nonfinite_animation(imageio, render_frame, root)["target"]
    names = {k: c.output_name(True) for k, c in zip(cli.CONFIG_KEYS, cfg.GPU_BATTERY)}
    totals = dict.fromkeys(stencils.launches, 0)
    exact = {}
    for run, flags, keys in NONFINITE_RUNS:
        out_dir = os.path.join(root, "nonfinite_" + run.replace(" ", "_"))
        what = f"gpu-denoise <non-finite HDR target> {' '.join(flags)}".rstrip()
        t0 = time.perf_counter()
        stencils.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(
                err := io.StringIO()):
            rc, rank_counts = cli.run([target, "--device", "cuda", *flags, "--configs",
                                       ",".join(keys), "--output-dir", out_dir])
        check(rc == 0, f"{what} failed ({rc}): {err.getvalue().strip()[-2000:]}")
        counts = sum_counts(stencils, rank_counts)
        for k, n in counts.items():
            totals[k] += n
        print(f"  {what}: {time.perf_counter() - t0:.1f} s, launches "
              f"{ {k: n for k, n in counts.items() if n} }")
        for key in keys:
            out = imageio.load(os.path.join(out_dir, names[key]))[0]
            check(out.shape == (H, W, 4), f"{what} {key}: shape {out.shape}")
            if run == "exact":
                exact[key] = out
            name = f"{run} {key}"
            want = JAX_NONFINITE_READINGS[name]
            boxes = want.get("boxes", ())
            ref = nonfinite_exact_key(run, key)
            got = nonfinite_reading(out, None if ref is None else exact[ref], boxes)
            if boxes:
                outside = nonfinite_masks(out).any(0)
                for c, y0, y1, x0, x1 in boxes:
                    outside[y0:y1, x0:x1, c] = False
                check(not outside.any(), f"{what} {key}: {int(outside.sum())} non-finite values "
                                         f"outside the JAX package's {len(boxes)} boxes")
                rule = f"non-finite inside the JAX package's {len(boxes)} boxes"
            else:
                check(got["counts"] == want["counts"] and got["digest"] == want["digest"],
                      f"{what} {key}: counts {got['counts']} digest {got['digest']}, the JAX "
                      f"package's {want['counts']} {want['digest']}")
                rule = "counts and positions the JAX package's"
            if ref is not None:
                check(got["db"] >= want["db"] - NONFINITE_DB_MARGIN,
                      f"{what} {key}: {got['db']} dB vs exact, below the JAX package's "
                      f"{want['db']} less {NONFINITE_DB_MARGIN}")
            per_kind = np.asarray(got["counts"]).sum(0).tolist()
            db = "" if ref is None else f"; {got['db']} dB vs exact (JAX {want['db']})"
            print(f"    {key:10s} NaN/+inf/-inf {per_kind}, {rule}{db}")
    return totals


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
    from image_denoising_filter_tpu_torch.runtime.session import turbo_pad_rows

    check_no_jax()
    render_frame = load_render_frame()
    smi = nvidia_smi_line()
    print(f"[1/12] device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.ensure)  # g++ beside nvcc
        lib_path, log = _build.build()
        build_s = time.perf_counter() - t0
        native_info = native_build.result()
    print(f"[2/12] build: {build_s:.2f} s -> {os.path.relpath(lib_path, REPO)}; native host "
          f"library: route {native_info.route}, {native_info.build_s:.2f} s of g++ beside it")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())

    root = scratch_dir()
    try:
        anim = write_animation(imageio, render_frame, root)
        print(f"[3/12] kernels vs plain versions at {W}x{H}")
        kernels = phase_kernels(torch, stencils, cfg, anim["frames"], anim["layer"])
        print(f"[4/12] battery through gpu-denoise --device cuda ({N_FRAMES} frames + 3 layers)")
        counts, exact_dir, exec4 = phase_battery(cfg, stencils, cli, imageio, Session, anim, root)
        print(f"[5/12] turbo grid kernels vs plain versions at {W4K}x{H4K} and {W}x{H}")
        noisy_4k, layers_4k = render_frame(0.5, H4K, W4K, np.random.default_rng(SEED),
                                           noise=NOISE)
        turbo_kernels_results, fused_counts = phase_turbo_kernels(
            torch, fast, stencils, cfg, noisy_4k, anim["frames"][TARGET_FRAME])
        kernels.update(turbo_kernels_results)
        print(f"[6/12] guided grid kernels vs plain versions at {W4K}x{H4K} and {W}x{H}")
        albedo_4k = np.clip(layers_4k["albedo"], 0, 1)
        images = {
            "4K": (noisy_4k, albedo_4k),
            "1080p": (anim["frames"][TARGET_FRAME], anim["layer"]),
        }
        images = {k: tuple(torch.from_numpy(np.ascontiguousarray(x)).to("cuda") for x in v)
                  for k, v in images.items()}
        anim["noisy_4k"] = noisy_4k
        del layers_4k
        kernels.update(phase_guided_kernels(torch, fast, cfg, images))
        del images
        print("[7/12] turbo battery through gpu-denoise --turbo D --device cuda")
        totals = phase_turbo_battery(cfg, stencils, cli, imageio, anim, root, exact_dir)
        print("[8/12] CPU configs, parity, profile, content")
        t0 = time.perf_counter()
        profiled = phase_cpu_parity_profile(torch, cfg, stencils, cli, imageio, content,
                                            reference, native, kernels, anim, root, exact_dir)
        print(f"  phase 8: {time.perf_counter() - t0:.1f} s")
        for k, n in profiled.items():
            totals[k] += n
        print("[9/12] sharded: gpu-denoise --mesh on 4 ranks sharing the card over gloo")
        t0 = time.perf_counter()
        sharded = phase_sharded(torch, cfg, stencils, fast, cli, imageio, launch, dryrun,
                                turbo_pad_rows, anim, root, exact_dir, smi)
        print(f"  phase 9: {time.perf_counter() - t0:.1f} s")
        for k, n in sharded.items():
            totals[k] += n
        print("[10/12] HDR: an EXR animation through the kernels and gpu-denoise --device cuda")
        t0 = time.perf_counter()
        _, hdr_counts, hdr, hdr_dir, hdr_exec = phase_hdr(
            torch, cfg, stencils, fast, cli, imageio, dataset, native, Session, render_frame,
            turbo_pad_rows, root, anim["frames"], kernels, smi)
        print(f"  phase 10: {time.perf_counter() - t0:.1f} s")
        for k, n in hdr_counts.items():
            totals[k] += n
        print("[11/12] host runtime: the native library, the default run, the native frame "
              "loader, --all-frames, --mesh 1x4 on HDR")
        t0 = time.perf_counter()
        host_counts = phase_host_runtime(torch, cfg, stencils, cli, imageio, dataset, native,
                                         reference, Session, anim, hdr, root, exact_dir, exec4,
                                         hdr_dir, hdr_exec, smi)
        print(f"  phase 11: {time.perf_counter() - t0:.1f} s")
        for k, n in host_counts.items():
            totals[k] += n
        print("[12/12] non-finite frames: every kernel form against its plain version, and an "
              "EXR animation with NaN and +inf through gpu-denoise --device cuda")
        t0 = time.perf_counter()
        phase_nonfinite_kernels(torch, fast, stencils, cfg, anim["frames"], anim["layer"],
                                noisy_4k, albedo_4k)
        del albedo_4k
        nonfinite_counts = phase_nonfinite(torch, cfg, stencils, cli, imageio, render_frame,
                                           root, smi)
        print(f"  phase 12: {time.perf_counter() - t0:.1f} s")
        for k, n in nonfinite_counts.items():
            totals[k] += n
        print("output files of phases 3-12, by directory:")
        for line in output_digests(root):
            print("  " + line)
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
        # the same two kernels at D = 1, as the sharded --turbo 1 runs them
        # (phases 9 and 10) and the dry run's D = 1 case
        "build_grid_d1": (FAST_SOURCE, f"{JAX_FAST}:1018"),
        "slice_grid_d1": (FAST_SOURCE, f"{JAX_FAST}:502"),
        "fused_grid": (FAST_SOURCE, f"{JAX_FAST}:730"),
        "build_guided_grid": (FAST_SOURCE, f"{JAX_FAST}:1269"),
        "slice_guided_grid": (FAST_SOURCE, f"{JAX_FAST}:1372"),
        # at D = 1, as --turbo 1 runs them for the layers (phases 7, 9, 10)
        "build_guided_grid_d1": (FAST_SOURCE, f"{JAX_FAST}:1269"),
        "slice_guided_grid_d1": (FAST_SOURCE, f"{JAX_FAST}:1372"),
        "fused_guided": (FAST_SOURCE, f"{JAX_FAST}:1516"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": where,
         "launches": counts.get(name, 0) + fused_counts.get(name, 0) + totals[name],
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
