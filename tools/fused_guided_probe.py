#!/usr/bin/env python3
"""Where the fused guided kernel's time goes: time it with parts removed.

    python3 tools/fused_guided_probe.py

On the card, from the repository root. Copies the port into
build/probe_<part>/ with the fused guided kernel (ops/csrc/fast.cu:
fused_guided_kernel) edited so that it skips one part of its work, times
each copy with tools/torch_kernel_ab.py's worker (fused_guided at 4K, D=2
and D=4, K=5, on chip_smoke.py's frame) beside the kernel as it is, and
prints the medians:

  full       the kernel as it is
  no_build   no level is built (the slice reads cells never written)
  no_slice   no pixel samples a level (the partials stay zero)
  neither    staging, the guide reads and the stores alone

The copies compute wrong outputs; they exist only to be timed. Also prints
how many levels each 16x64-pixel tile of the frame's albedo touches at
K=5 (the fused kernel builds the levels [floor(tmin), ceil(tmax)] of its
tile over the three channels), computed on the host.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "image_denoising_filter_tpu_torch"
KERNEL = os.path.join(PACKAGE, "ops", "csrc", "fast.cu")
# The edits of each part: (text in fused_guided_kernel, its replacement).
NO_BUILD = ("    for (int k = k0; k <= k1; ++k) {\n      vertical_strips<kGuidedStrip>",
            "    for (int k = k0; k <= k1 && false; ++k) {\n      vertical_strips<kGuidedStrip>")
NO_SLICE = ("        if (e0 == 0.f && e1 == 0.f && e2 == 0.f) continue;\n        float up[8];\n"
            "        sample_guided(cells + (k - k0)",
            "        continue;\n        float up[8];\n        sample_guided(cells + (k - k0)")
PARTS = {"full": (), "no_build": (NO_BUILD,), "no_slice": (NO_SLICE,),
         "neither": (NO_BUILD, NO_SLICE)}


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
                           "--worker", root, "--only", "fused_guided"],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: v for k, v in run.items() if k.startswith("fused_guided")}


def tile_levels(levels: int = 5, d: int = 2, ph: int = 16, pw: int = 64) -> dict:
    """Levels a ph x pw tile of chip_smoke.py's 4K albedo touches at K =
    levels: the mean and the count of tiles by levels touched."""
    sys.path.insert(0, REPO)
    import chip_smoke

    _, layers = chip_smoke.load_render_frame()(0.5, chip_smoke.H4K, chip_smoke.W4K,
                                               np.random.default_rng(chip_smoke.SEED),
                                               noise=chip_smoke.NOISE)
    albedo = np.clip(layers["albedo"], 0, 1).astype(np.float32)
    h, w, _ = albedo.shape
    small = albedo.reshape(h // d, d, w // d, d, 4).mean((1, 3))[..., :3]
    lmin = small.min((0, 1))
    step = np.maximum(small.max((0, 1)) - lmin, 1e-6) / (levels - 1)
    t = np.clip((albedo[..., :3] - lmin) / step, 0, levels - 1)
    tiles = t.reshape(h // ph, ph, w // pw, pw, 3)
    first = np.floor(tiles.min((1, 3)).min(-1))
    last = np.ceil(tiles.max((1, 3)).max(-1))
    touched = (last - first + 1).astype(int)
    return {"mean": float(touched.mean()),
            "tiles by levels": {int(n): int((touched == n).sum()) for n in np.unique(touched)}}


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
        print(f"{name:9s} {json.dumps(medians)}")
    print(f"levels a 16x64 tile touches at K=5, D=2: {json.dumps(tile_levels())}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
