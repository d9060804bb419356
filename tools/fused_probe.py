#!/usr/bin/env python3
"""Where the fused kernels' time goes: time them with parts removed.

    python3 tools/fused_probe.py

On the card, from the repository root. Copies the port into
build/probe_<part>/ with the fused kernels (ops/csrc/fast.cu:
fused_guided_kernel, fused_grid_kernel) edited so that they skip one part of
their work, times each copy with tools/torch_kernel_ab.py's worker
(fused_grid at 4K, D=2 K=5, D=4 K=5 and D=8 sigma_s 6 K=6 on chip_smoke.py's
noisy frame; fused_guided at D=2 and D=4, K=5, with that frame's albedo)
beside the kernels as they are, and prints the medians:

  full       the kernels as they are
  no_build   no level is built (the slice reads cells never written)
  no_slice   no pixel samples a level (the outputs stay zero)
  neither    staging, the guide reads and the stores alone

The copies compute wrong outputs; they exist only to be timed. Also prints
how many levels each tile touches (the fused kernels build the levels
[floor(tmin), ceil(tmax)] of their tile over the three channels), computed
on the host: the guided kernel's 16x64 tiles of the albedo at D=2 K=5, and
the bilateral kernel's tiles (ops/fast.py:fused_tile) of the noisy frame at
each D.
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
# The edits of each part: (text in fused_guided_kernel or fused_grid_kernel,
# its replacement), one for each kernel.
NO_BUILD = (("    for (int k = k0; k <= k1; ++k) {\n      vertical_strips<kFusedStrip>(st_t",
             "    for (int k = k0; k <= k1 && false; ++k) {\n      vertical_strips<kFusedStrip>(st_t"),
            ("    for (int k = k0; k <= k1; ++k) {\n      vertical_strips<kFusedStrip>(staged",
             "    for (int k = k0; k <= k1 && false; ++k) {\n"
             "      vertical_strips<kFusedStrip>(staged"))
NO_SLICE = (("        if (e0 == 0.f && e1 == 0.f && e2 == 0.f) continue;\n        float up[8];",
             "        continue;\n        float up[8];"),
            ("        if (e0 == 0.f && e1 == 0.f && e2 == 0.f) continue;\n"
             "        const Bf16x4* lv",
             "        continue;\n        const Bf16x4* lv"))
PARTS = {"full": (), "no_build": NO_BUILD, "no_slice": NO_SLICE,
         "neither": (*NO_BUILD, *NO_SLICE)}


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
                           "--worker", root, "--only", "fused"],
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode:
        raise SystemExit(proc.stdout + proc.stderr)
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    return {k: v for k, v in run.items() if k.startswith("fused")}


def levels_touched(img: np.ndarray, levels: int, d: int, ph: int, pw: int) -> dict:
    """Levels a ph x pw tile of img touches at K = levels, the grid range
    from img pooled at d: the mean and the count of tiles by levels
    touched."""
    h, w, _ = img.shape
    hp, wp = -(-h // ph) * ph, -(-w // pw) * pw
    padded = np.pad(img[..., :3], ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    small = img[: h // d * d, : w // d * d, :3].reshape(h // d, d, w // d, d, 3).mean((1, 3))
    lmin = small.min((0, 1))
    step = np.maximum(small.max((0, 1)) - lmin, 1e-6) / (levels - 1)
    t = np.clip((padded - lmin) / step, 0, levels - 1)
    tiles = t.reshape(hp // ph, ph, wp // pw, pw, 3)
    first = np.floor(tiles.min((1, 3)).min(-1))
    last = np.ceil(tiles.max((1, 3)).max(-1))
    touched = (last - first + 1).astype(int)
    return {"mean": float(touched.mean()),
            "tiles by levels": {int(n): int((touched == n).sum()) for n in np.unique(touched)}}


def tile_levels() -> dict:
    """levels_touched of the guided kernel's albedo tiles and of the
    bilateral kernel's tiles of the noisy frame, on chip_smoke.py's 4K
    frame."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from image_denoising_filter_tpu_torch.ops import fast

    noisy, layers = chip_smoke.load_render_frame()(0.5, chip_smoke.H4K, chip_smoke.W4K,
                                                   np.random.default_rng(chip_smoke.SEED),
                                                   noise=chip_smoke.NOISE)
    albedo = np.clip(layers["albedo"], 0, 1).astype(np.float32)
    out = {"fused_guided albedo 16x64 D=2 K=5": levels_touched(albedo, 5, 2, 16, 64)}
    for d, levels, sigma_s in ((2, 5, 2.0), (4, 5, 2.0), (8, 6, 6.0)):
        tile = fast.fused_tile(d, fast._grid_taps(sigma_s, d).size, 232448, 1)
        out[f"fused_grid noisy {tile.ph}x{tile.pw} D={d} K={levels}"] = levels_touched(
            noisy, levels, d, tile.ph, tile.pw)
    return out


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
    for where, touched in tile_levels().items():
        print(f"levels a tile touches, {where}: {json.dumps(touched)}")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
