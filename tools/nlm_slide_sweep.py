#!/usr/bin/env python3
"""Time the NLM kernel's sliding body with other block constants, on the card.

    python3 tools/nlm_slide_sweep.py 8:4 4:8 6:4 ...

Each argument is SEG:WARPS: NLM_SEG outputs a lane and a block of at most
WARPS warps (ops/stencils.py). Each runs in a process of its own, which sets
the constants, builds the kernels with them (a build of its own under
build/idf_torch_kernels/) and times, with chip_smoke.py:median_ms at
1920x1080 on random frames (seed 0, the frames of tools/torch_kernel_ab.py),
the reference NLM at F = 1 and F = 6, the turbo NLM (bf16 taps, stride 2)
and patch radii 1, 2 and 4; it prints one JSON line a variant with the times
in ms, a SHA-256 prefix of each output (every variant must compute the same
bits) and the reference tiles' registers, blocks a SM and spill bytes.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(variant: str) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from image_denoising_filter_tpu_torch import config as cfg
    from image_denoising_filter_tpu_torch.ops import _build, stencils

    seg, warps = map(int, variant.split(":"))
    stencils.NLM_SEG = seg
    stencils.NLM_SLIDE_WARPS = tuple(x for x in (8, 4, 2, 1) if x <= warps)
    stencils.nlm_tile.cache_clear()
    _build.build()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.uniform(0, 1, (6, 1080, 1920, 4)).astype(np.float32)).to(dev)
    frames[..., 3] = 1.0
    target = frames[0]
    bf16 = cfg.TilingConfig(compute_dtype="bfloat16")
    ref, turbo = cfg.NlmParams(), cfg.NlmParams(search_stride=2)
    cases = {
        "nlm": (lambda: stencils.nlm_accumulate(target, target, ref), 10),
        "nlm F=6": (lambda: stencils.nlm_accumulate_frames(target, frames, ref), 5),
        "nlm_bf16": (lambda: stencils.nlm_accumulate(target, target, turbo, bf16), 10),
        **{f"nlm p={p}": (lambda p=p: stencils.nlm_accumulate(
            target, target, cfg.NlmParams(patch_radius=p)), 10) for p in (1, 2, 4)},
    }
    out = {"variant": variant, "digests": {}}
    for name, (fn, reps) in cases.items():
        result = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for t in result:
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        out["digests"][name] = digest.hexdigest()[:16]
        out[name] = smoke.median_ms(torch, fn, reps)
    out["info"] = {k: stencils.kernel_info(k, dev, p) for k, p in (("nlm", ref),
                                                                 ("nlm_bf16", turbo))}
    return out


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        print(json.dumps(worker(sys.argv[2])))
        return 0
    for variant in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", variant],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
