#!/usr/bin/env python3
"""Where the d = 1 grid build's time goes: time it with parts removed.

    python3 tools/build_d1_probe.py

On the card, from the repository root. Copies the port into
build/probe_d1_<part>/ with build_grid_d1_kernel (ops/csrc/fast.cu) edited
so that it skips one part of its work, times each copy with
tools/torch_kernel_ab.py's worker (the d = 1 builds at 1080p, K = 6: the
bilateral grid at 17 and 49 taps on chip_smoke.py's render, the guided grid
at 17 taps on random frames and on the HDR render) beside the kernel as it
is, twice in turns, and prints the medians and the nvidia-smi line:

  full           the kernel as it is
  no_horizontal  no cell summed across its columns or stored
  no_vertical    no vertical sum (the horizontal pass reads what is there)
  no_fields      each staged pixel's fields are its payload and layer
                 values, no range weight (the adds as they are)
  no_store       the cells staged in shared memory, none copied to the grid
  no_vloads      the horizontal pass's adds on values in registers, no
                 vertical sum loaded
  staging        the ring's copies, the barriers and the walk alone

The copies compute wrong grids; they exist only to be timed.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_HORIZONTAL = (("      for (int task = threadIdx.x; task < rows_in * groups_x; "
                  "task += blockDim.x) {",
                  "      for (int task = threadIdx.x; task < 0 * rows_in * groups_x; "
                  "task += blockDim.x) {"),)
NO_VERTICAL = (("      if (group < tile.groups)\n        d1_vertical<GUIDED>",
                "      if (false && group < tile.groups)\n        d1_vertical<GUIDED>"),)
NO_FIELDS = (("  const float3 w = guided_range_weights(l, lv, coef);\n",
              "  const float3 w = make_float3(l.x, l.y, l.z);\n"),)
NO_STORE = (("  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {\n    const int cy = i / cols;",
             "  for (int i = threadIdx.x; i < 0 * rows * cols; i += blockDim.x) {\n"
             "    const int cy = i / cols;"),)
NO_VLOADS = (("    next[q] = *reinterpret_cast<const float4*>(row + q * v_plane + ahead);",
              "    next[q] = make_float4(t8[0], t8[1], out[0][q], out[1][q]);"),)
PARTS = {"full": (), "no_horizontal": NO_HORIZONTAL, "no_vertical": NO_VERTICAL,
         "no_fields": NO_FIELDS, "no_store": NO_STORE, "no_vloads": NO_VLOADS,
         "staging": (*NO_HORIZONTAL, *NO_VERTICAL)}
CASES = "build_grid 1080p d=1,build_guided 1080p d=1"


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "fused_probe", os.path.join(REPO, "tools", "fused_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    roots = {name: probe.make_copy(f"d1_{name}", edits) for name, edits in PARTS.items()}
    runs = {name: [] for name in PARTS}
    for _ in range(2):
        for name, root in roots.items():
            proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_kernel_ab.py"),
                                   "--worker", root, "--only", CASES],
                                  capture_output=True, text=True, timeout=1200)
            if proc.returncode:
                raise SystemExit(proc.stdout + proc.stderr)
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[name].append({k: v for k, v in run.items() if k.startswith("build")})
    for name, rs in runs.items():
        medians = {k: round(statistics.median(r[k] for r in rs), 4) for k in rs[0]}
        print(f"{name:13s} {json.dumps(medians)}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
