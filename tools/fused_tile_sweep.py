#!/usr/bin/env python3
"""Time the fused kernels and the d = 1 build with other blocks than
ops/fast.py gives them.

    python3 tools/fused_tile_sweep.py [--variants as_is,d2_12x64] [--only fused_grid]
    python3 tools/fused_tile_sweep.py --variants as_is,d1_rows4 \
        --only "build_grid 1080p d=1,build_guided 1080p d=1"

On the card, from the repository root. Copies the port into
build/sweep_<variant>/ with some of the kernels' block constants of
ops/fast.py replaced (the kernel reads them as macros, the tile helper as
Python), times each copy with tools/torch_kernel_ab.py's worker (by default
the fused_grid and fused_guided cases at 4K on chip_smoke.py's frame) in
turns, twice, and prints each variant's medians and the nvidia-smi line.
Every variant computes the same outputs: each case's SHA-256 must agree
across the variants, or the sweep fails.

Variants (name: the text of ops/fast.py replaced):
  as_is             the port as it is
  d2_12x64          the bilateral kernel at d = 2 on 12 x 64 pixel tiles first
  d2_32x64          the bilateral kernel at d = 2 on 32 x 64 pixel tiles first
  d4_16x128         the bilateral kernel at d = 4 on 16 x 128 pixel tiles first
  d8_16x256         the bilateral kernel at d = 8 on 16 x 256 pixel tiles first
  d8_64x256         the bilateral kernel at d = 8 on 64 x 256 pixel tiles first
  grid_min_blocks3  the bilateral kernel compiled for 3 blocks a multiprocessor
  grid_min_blocks5  ... for 5 blocks (at d = 2 shared memory holds 4)
  grid_blocks5_levels3
                    ... for 5 blocks, 3 levels a batch (5 blocks fit at d = 2)
  grid_range_all    the bilateral kernel reads its tiles' level range at every
                    d (the port: at d = 2 only, every level built at 4 and 8)
  strip4            a vertical-pass thread sums 4 cell rows (both kernels)
  d1_rows4          the d = 1 build: a vertical-pass thread sums 4 cell rows
                    (the port: 8)
  d1_rows4_groups2  ... 4 cell rows, the tiles' thread groups doubled (the
                    same strip heights as the port's, twice the threads)
  d1_rows2_groups4  ... 2 cell rows, the tiles' thread groups quadrupled
  d1_64x2_first     the d = 1 build takes 64 staged columns in 2 thread
                    groups first, where it fits two blocks a multiprocessor
  d1_96x1_first     ... 96 staged columns in one group first
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "image_denoising_filter_tpu_torch"
CONSTANTS = os.path.join(PACKAGE, "ops", "fast.py")
VARIANTS = {
    "as_is": (),
    "d2_12x64": (("    2: ((16, 64), (8, 64), (8, 32)),",
                  "    2: ((12, 64), (16, 64), (8, 64), (8, 32)),"),),
    "d2_32x64": (("    2: ((16, 64), (8, 64), (8, 32)),",
                  "    2: ((32, 64), (16, 64), (8, 64), (8, 32)),"),),
    "d4_16x128": (("    4: ((32, 128), (16, 128), (16, 64)),",
                   "    4: ((16, 128), (32, 128), (16, 64)),"),),
    "d8_16x256": (("    8: ((32, 256), (16, 256), (16, 128)),",
                   "    8: ((16, 256), (32, 256), (16, 128)),"),),
    "d8_64x256": (("    8: ((32, 256), (16, 256), (16, 128)),",
                   "    8: ((64, 256), (32, 256), (16, 256), (16, 128)),"),),
    "grid_min_blocks3": (("FUSED_GRID_MIN_BLOCKS = 4\n", "FUSED_GRID_MIN_BLOCKS = 3\n"),),
    "grid_min_blocks5": (("FUSED_GRID_MIN_BLOCKS = 4\n", "FUSED_GRID_MIN_BLOCKS = 5\n"),),
    "grid_blocks5_levels3": (("FUSED_GRID_MIN_BLOCKS = 4\n", "FUSED_GRID_MIN_BLOCKS = 5\n"),
                             ("FUSED_GRID_LEVELS = 6\n", "FUSED_GRID_LEVELS = 3\n")),
    "grid_range_all": (("FUSED_GRID_RANGE_DOWNSAMPLES = (2,)\n",
                        "FUSED_GRID_RANGE_DOWNSAMPLES = (2, 4, 8)\n"),),
    "strip4": (("FUSED_STRIP = 2\n", "FUSED_STRIP = 4\n"),),
    "d1_rows4": (("BUILD_D1_ROWS = 8\n", "BUILD_D1_ROWS = 4\n"),),
    "d1_rows4_groups2": (("BUILD_D1_ROWS = 8\n", "BUILD_D1_ROWS = 4\n"),
                         ("BUILD_D1_TILES = ((128, 2), (128, 1), (96, 2), (96, 1), (64, 4), (64, 2), "
                          "(64, 1), (32, 1),\n                  (80, 1))",
                          "BUILD_D1_TILES = ((128, 4), (128, 2), (96, 4), (96, 2), (64, 8), (64, 4), "
                          "(64, 2), (32, 2), (80, 2))")),
    "d1_rows2_groups4": (("BUILD_D1_ROWS = 8\n", "BUILD_D1_ROWS = 2\n"),
                         ("BUILD_D1_TILES = ((128, 2), (128, 1), (96, 2), (96, 1), (64, 4), (64, 2), "
                          "(64, 1), (32, 1),\n                  (80, 1))",
                          "BUILD_D1_TILES = ((128, 8), (128, 4), (96, 8), (96, 4), (64, 16), (64, 8), "
                          "(64, 4), (32, 4), (80, 2))")),
    "d1_64x2_first": (("BUILD_D1_TILES = (", "BUILD_D1_TILES = ((64, 2), "),),
    "d1_96x1_first": (("BUILD_D1_TILES = (", "BUILD_D1_TILES = ((96, 1), "),),
}


def make_copy(name: str) -> str:
    root = os.path.join(REPO, "build", f"sweep_{name}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, CONSTANTS)
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: ops/fast.py no longer holds {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def time_copy(root: str, only: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_kernel_ab.py"),
                           "--worker", root, "--only", only],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--only", default="fused_grid,fused_guided",
                    help="the worker's case prefixes, comma-separated")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    names = args.variants.split(",")
    roots = {name: make_copy(name) for name in names}
    runs = {name: [] for name in names}
    for _ in range(2):
        for name, root in roots.items():
            runs[name].append(time_copy(root, args.only))
    digests = {}
    for name, rs in runs.items():
        keys = [k for k in rs[0] if k not in ("root", "digests", "sm_clock_mhz")]
        medians = {k: round(statistics.median(r[k] for r in rs), 4) for k in keys}
        print(f"{name:12s} {json.dumps(medians)}")
        for r in rs:
            for case, digest in r["digests"].items():
                digests.setdefault(case, set()).add(digest)
    differ = sorted(case for case, seen in digests.items() if len(seen) > 1)
    print(f"outputs equal bit for bit across the variants: {not differ} {differ or ''}")
    print(smi)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
