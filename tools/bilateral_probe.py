#!/usr/bin/env python3
"""Where the exact bilateral kernel's time goes: time it with parts removed.

    python3 tools/bilateral_probe.py

On the card, from the repository root. Copies the port into
build/probe_<part>/ with the staged bilateral kernel (ops/csrc/stencils.cu:
bilateral_staged_kernel and the tap helpers it shares with the direct-load
instance) edited so that it skips one part of its work, times each copy
with tools/torch_kernel_ab.py's worker (the four forms at 1920x1080,
reference parameters, with uniform alpha as the main path runs them)
beside the kernel as it is, and prints the medians of two runs a copy:

  full         the kernel as it is
  no_exp2      the weight is its exponent (no MUFU.EX2, and no range test
               where a row takes exp2f)
  no_distance  the colour distance is 0 (no subtract, square or add)
  no_taps      no tap row is walked: staging, the centres and the stores

The copies compute wrong outputs; they exist only to be timed.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "image_denoising_filter_tpu_torch"
KERNEL = os.path.join(PACKAGE, "ops", "csrc", "stencils.cu")
# The edits of each part: (text in stencils.cu, its replacement).
NO_EXP2 = ("  const float wgt = bil_exp2<IN_RANGE>(__fmaf_rn(-ssd, col_coef, sp));",
           "  const float wgt = __fmaf_rn(-ssd, col_coef, sp);")
ACCUMULATE = ("#pragma unroll\n          for (int i = 0; i < N; ++i)\n"
              "            bil_accumulate<!UA, kInRange>")
NO_DISTANCE = (ACCUMULATE, "#pragma unroll\n          for (int i = 0; i < N; ++i) ssd[i] = 0.f;\n"
               + ACCUMULATE)
NO_TAPS = ("  for (int r = 0; r < runs.n; ++r) {\n    const int hw = runs.hw[r];\n    const int n_steps",
           "  for (int r = 0; r < 0; ++r) {\n    const int hw = runs.hw[r];\n    const int n_steps")
PARTS = {"full": (), "no_exp2": (NO_EXP2,), "no_distance": (NO_DISTANCE,),
         "no_taps": (NO_TAPS,)}
CASES = ("bilateral ua", "bilateral_guided ua", "bilateral_bf16 ua", "bilateral_guided_bf16 ua")


def make_copy(name: str, edits) -> str:
    root = os.path.join(REPO, "build", f"probe_{name}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, KERNEL)
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the kernel no longer holds the text to edit")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def time_copy(root: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_kernel_ab.py"),
                           "--worker", root, "--only", "bilateral"],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: v for k, v in run.items() if k in CASES}


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    roots = {name: make_copy(name, edits) for name, edits in PARTS.items()}
    runs = {name: [] for name in PARTS}
    for _ in range(2):
        for name, root in roots.items():
            runs[name].append(time_copy(root))
    for name, rs in runs.items():
        medians = {k: round(statistics.median(r[k] for r in rs), 4) for k in rs[0]}
        print(f"{name:12s} {json.dumps(medians)}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
