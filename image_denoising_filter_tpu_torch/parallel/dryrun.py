"""Dry run of the sharded paths on N ranks, held against the oracles.

The port's counterpart of `__graft_entry__.py:dryrun_multichip`:

    python -m image_denoising_filter_tpu_torch.parallel.dryrun --ranks 4 --device cpu

factors N into a (frame, y) mesh (frame 2 where N is even), runs the sharded
temporal NLM at the full reference parameters (s=7, p=3, h=0.5; frames over
'frame' with one masked padding frame, rows over 'y' with the interior/edge
split), the same with the half-row weights, the sharded bilateral and the
sharded layers, each against its NumPy oracle (ops/reference.py), and the
sharded turbo grids (the bilateral grid at d = 2 and 1, the guided grid at
d = 2) against the single-device pipeline on the same device,
then prints one line per path. --device cuda runs the ranks on the card
(several ranks share one card over --dist-backend gloo). Any disagreement
raises and exits non-zero.

`run_cases` is the ranks' body, shared with the tests: it runs a list of
cases (whole-image numpy inputs, cut into each rank's bands) through the
sharded functions and writes the gathered outputs as .npy files.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import BilateralParams, LayersParams, NlmParams
from ..ops import fast, reference, stencils
from . import launch
from .mesh import FRAME_AXIS, make_mesh
from .spatial import (
    _grid_range,
    gather_rows,
    shard_rows,
    spatial_bilateral,
    spatial_bilateral_fast,
    spatial_cross_bilateral_layers,
    spatial_cross_bilateral_layers_fast,
    spatial_nlm_accumulate,
    temporal_nlm_sharded,
)


def _run_case(case: dict, mesh, device: torch.device) -> tuple[np.ndarray, ...]:
    """One case's outputs as whole images (the "grid_range" kind: lmin and
    step, a row each rank). case: {"kind", "inputs" (name -> numpy array of
    the whole image), "kw" (keyword arguments)}."""
    kind, kw = case["kind"], case.get("kw", {})
    x = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
         for k, v in case["inputs"].items()}

    def band(name):
        return shard_rows(x[name], mesh).contiguous()

    if kind == "bilateral":
        outs = (spatial_bilateral(band("img"), mesh=mesh, **kw),)
    elif kind == "bilateral_fast":
        outs = (spatial_bilateral_fast(band("img"), mesh=mesh, **kw),)
    elif kind == "nlm":
        outs = spatial_nlm_accumulate(band("target"), band("neighbour"), mesh=mesh, **kw)
    elif kind == "layers":
        outs = spatial_cross_bilateral_layers(band("target"), band("layer"), mesh=mesh, **kw)
    elif kind == "layers_fast":
        outs = spatial_cross_bilateral_layers_fast(band("target"), band("layer"), mesh=mesh,
                                                   **kw)
    elif kind == "grid_range":
        # the grid range of the pooled bands over 'y', one row a rank
        small = fast.pool(band("img"), kw["downsample"], kw.get("border", "clamp"))
        outs = tuple(o[None] for o in _grid_range(small, kw["levels"], mesh))
    elif kind == "temporal":
        # frames over 'frame' (each rank a block of them), rows over 'y'
        n_f, f = mesh.size(0), mesh.get_local_rank(FRAME_AXIS)
        frames, valid = x["frames"], x["valid"]
        per = frames.shape[0] // n_f
        mine = frames[f * per : (f + 1) * per]
        local = torch.stack([shard_rows(fr, mesh) for fr in mine]).contiguous()
        outs = (temporal_nlm_sharded(band("target"), local, mesh=mesh,
                                     valid=valid[f * per : (f + 1) * per].contiguous(), **kw),)
    else:
        raise KeyError(f"unknown case kind {kind!r}")
    return tuple(gather_rows(o, mesh).cpu().numpy() for o in outs)


def run_cases(cases: list, out_dir: str, mesh_shape: tuple, device_type: str) -> dict:
    """The ranks' body: make the (frame, y) mesh, run every case, and on
    global rank 0 write output i of case `name` to out_dir/name.i.npy. A case
    with "expect_error" must raise ValueError: its message goes to
    out_dir/name.error.txt. Returns this rank's kernel launch counts."""
    device = torch.device(device_type)
    mesh = make_mesh(mesh_shape, device_type)
    writer = dist.get_rank() == 0
    stencils.reset_launches()
    for case in cases:
        name = case["name"]
        try:
            outs = _run_case(case, mesh, device)
        except ValueError as e:
            if not case.get("expect_error"):
                raise
            if writer:
                with open(os.path.join(out_dir, f"{name}.error.txt"), "w") as f:
                    f.write(str(e))
            continue
        if case.get("expect_error"):
            raise AssertionError(f"case {name} did not raise")
        if writer:
            for i, o in enumerate(outs):
                np.save(os.path.join(out_dir, f"{name}.{i}.npy"), o)
    return dict(stencils.launches)


def run_session_cases(cases: list, out_dir: str, device_type: str) -> dict:
    """The ranks' body for Session runs: each case {"name", "target",
    "mesh" (its shape; F * Y is the world size), "method" ("run" or
    "run_turbo"), "cfg", "kw" (Session keyword arguments), "call_kw"} runs
    Session(target, mesh_shape=mesh, ...).method(cfg, **call_kw), the files
    into out_dir/name; global rank 0 writes RunResult.image to
    out_dir/name.0.npy. Returns this rank's kernel launch counts."""
    from ..runtime.session import Session

    stencils.reset_launches()
    for case in cases:
        name = case["name"]
        case_dir = os.path.join(out_dir, name)
        os.makedirs(case_dir, exist_ok=True)
        session = Session(case["target"], device=device_type, mesh_shape=case["mesh"],
                          output_dir=case_dir, **case.get("kw", {}))
        result = getattr(session, case.get("method", "run"))(case["cfg"],
                                                             **case.get("call_kw", {}))
        if dist.get_rank() == 0:
            np.save(os.path.join(out_dir, f"{name}.0.npy"), result.image)
    return dict(stencils.launches)


def load_outputs(out_dir: str, name: str) -> list[np.ndarray]:
    """Case `name`'s outputs as run_cases wrote them."""
    outs, i = [], 0
    while os.path.exists(path := os.path.join(out_dir, f"{name}.{i}.npy")):
        outs.append(np.load(path))
        i += 1
    return outs


# The half-row NLM's parameters (the turbo NLM with --weights-halfres).
HRW = NlmParams(search_stride=2, weights_halfres=True)


def mesh_for(ranks: int) -> tuple[int, int]:
    """(frame, y) for N ranks: frame 2 where N is even (frame data
    parallelism and spatial sharding both), else 1."""
    n_frame = 2 if ranks % 2 == 0 else 1
    return n_frame, ranks // n_frame


def dryrun_cases(ranks: int, rows_per_shard: int = 32, width: int = 128, seed: int = 0):
    """The dry run's cases and their whole-image inputs."""
    n_frame, n_y = mesh_for(ranks)
    h = rows_per_shard * n_y  # 32 rows a band > 3 * halo: the split path runs
    f_real, f = 2 * n_frame - 1, 2 * n_frame  # one padding frame, masked
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, (h, width, 4)).astype(np.float32)
    frames = rng.uniform(0, 1, (f, h, width, 4)).astype(np.float32)
    frames[f_real:] = 0.0
    valid = (np.arange(f) < f_real).astype(np.float32)
    layer = rng.uniform(0, 1, (h, width, 4)).astype(np.float32)
    temporal_in = {"target": target, "frames": frames, "valid": valid}
    cases = [
        {"name": "temporal", "kind": "temporal", "inputs": temporal_in,
         "kw": {"params": NlmParams()}},
        {"name": "temporal_hrw", "kind": "temporal", "inputs": temporal_in,
         "kw": {"params": HRW}},
        {"name": "bilateral", "kind": "bilateral", "inputs": {"img": target},
         "kw": {"params": BilateralParams(radius=6)}},
        {"name": "layers", "kind": "layers", "inputs": {"target": target, "layer": layer},
         "kw": {"params": LayersParams(radius=6)}},
        {"name": "bilateral_fast", "kind": "bilateral_fast", "inputs": {"img": target},
         "kw": {"params": BilateralParams(), "levels": 8, "downsample": 2}},
        {"name": "bilateral_fast_d1", "kind": "bilateral_fast", "inputs": {"img": target},
         "kw": {"params": BilateralParams(), "levels": 6, "downsample": 1}},
        {"name": "layers_fast", "kind": "layers_fast",
         "inputs": {"target": target, "layer": layer},
         "kw": {"params": LayersParams(), "levels": 6, "downsample": 2}},
    ]
    return cases, temporal_in, layer


def dryrun(ranks: int, device_type: str, backend: Optional[str] = None,
           timeout_s: float = launch.DEFAULT_TIMEOUT_S) -> dict:
    """Run the dry run's cases on `ranks` ranks and hold them to the oracles
    (AssertionError on a disagreement). Prints one line per path; returns
    the launch counts summed over the ranks."""
    n_frame, n_y = mesh_for(ranks)
    cases, temporal_in, layer = dryrun_cases(ranks)
    target = temporal_in["target"]
    frames = temporal_in["frames"][temporal_in["valid"] > 0]
    h, w = target.shape[:2]
    # The ranks' body by its module's name, also when this file runs as
    # __main__ (python -m): the spawned ranks import it from the package.
    from . import dryrun as module

    with tempfile.TemporaryDirectory(prefix="idf_dryrun_") as out_dir:
        counts = launch.run_ranks(ranks, module.run_cases, cases, out_dir, (n_frame, n_y),
                                  device_type,
                                  backend=backend, device_type=device_type, timeout_s=timeout_s)
        out = {c["name"]: load_outputs(out_dir, c["name"]) for c in cases}

    def check(got, want, what, **tol):
        err = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, err_msg=what, **tol)
        return err

    where = f"mesh (frame={n_frame}, y={n_y}) on {device_type}"
    params = NlmParams()
    wc = np.zeros((h, w, 4), np.float32)
    nw = np.zeros((h, w), np.float32)
    for fr in frames:
        pwc, pnw = reference.nlm_reference(target, fr, params)
        wc += pwc
        nw += pnw
    err = check(out["temporal"][0], reference.normalize_reference(wc, nw), "temporal NLM",
                rtol=2e-4, atol=1e-5)
    print(f"dryrun temporal NLM OK: {where}, s=7 p=3, {len(frames)} frames + 1 masked pad, "
          f"{h}x{w}, max|err| {err:.2e} vs oracle")
    # The single-device pipelines on the ranks' device type, in this process.
    dev = {k: torch.from_numpy(v).to(device_type) for k, v in temporal_in.items()}
    dev["layer"] = torch.from_numpy(layer).to(device_type)
    wc, nw = stencils.nlm_accumulate_frames(dev["target"], dev["frames"], HRW, None, dev["valid"])
    err = check(out["temporal_hrw"][0], stencils.normalize(wc, nw).cpu().numpy(),
                "half-row NLM", rtol=1e-5, atol=1e-6)
    print(f"dryrun sharded hrw NLM OK: max|err| {err:.2e} vs single-device")
    bp = BilateralParams(radius=6)
    err = check(out["bilateral"][0], reference.bilateral_reference(target, bp), "bilateral",
                rtol=1e-4, atol=1e-5)
    print(f"dryrun sharded bilateral OK: max|err| {err:.2e} vs oracle")
    lp = LayersParams(radius=6)
    got = stencils.normalize(*(torch.from_numpy(x) for x in out["layers"])).numpy()
    want = reference.normalize_reference(*reference.cross_bilateral_layers_reference(
        target, layer, lp))
    err = check(got, want, "layers", rtol=1e-4, atol=1e-5)
    print(f"dryrun sharded layers OK: max|err| {err:.2e} vs oracle")
    single = {
        "bilateral_fast": (fast.bilateral_fast(dev["target"], BilateralParams(), 8, 2),),
        "bilateral_fast_d1": (fast.grid_pipeline(dev["target"], BilateralParams(), 6, 1),),
        "layers_fast": fast.cross_bilateral_layers_fast(dev["target"], dev["layer"],
                                                        LayersParams(), 6, 2),
    }
    for name, wants in single.items():
        for got, want in zip(out[name], (x.cpu().numpy() for x in wants)):
            if not np.array_equal(got, want):
                raise AssertionError(f"sharded {name} differs from the single-device pipeline: "
                                     f"max|err| {np.abs(got - want).max():.3g}")
        print(f"dryrun sharded {name} OK: equal to the single-device pipeline bit for bit")
    total = dict.fromkeys(stencils.launches, 0)
    for rank_counts in counts:
        for k, n in rank_counts.items():
            total[k] += n
    return total


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m image_denoising_filter_tpu_torch.parallel.dryrun",
        description="run the sharded paths on N ranks against the oracles",
    )
    ap.add_argument("--ranks", type=int, default=4, help="number of ranks (default 4)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--dist-backend", choices=launch.BACKENDS, default=None,
                    help="torch.distributed backend (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    counts = dryrun(args.ranks, args.device, args.dist_backend)
    print(f"dryrun kernel launches over {args.ranks} ranks: "
          f"{ {k: n for k, n in counts.items() if n} }")
    return 0


if __name__ == "__main__":
    sys.exit(main())
