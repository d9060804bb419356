"""A shot of PNG frames on disk, denoised frame by frame as `gpu-denoise
--all-frames` does it (`cli._battery`): for each target a new Session with
one shared decoded-frame cache, then Session.run, which decodes, uploads,
runs the kernels, reads back and saves the PNG. The targets cycle through
the shots, so the cache (32 frames) never holds a frame when it comes round
again: each frame is decoded once a pass.

Set-up writes the shots with the benchmark's own PNG writer, one directory
a shot, frames named as the upstream reference's animations are, under the
run's TMPDIR, and removes them at the end.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness
from portbench.compare import max_abs_err, mismatch_share
from portbench.reference import png


@dataclasses.dataclass
class State:
    cell: harness.Cell
    family: object
    seed: int
    device: torch.device
    root: Path
    frames: np.ndarray          # (shots, shot_frames, H, W, 4) uint8, as written
    targets: list               # (path, shot, index in shot)
    session_kw: dict
    run_cfg: object
    log: object
    cache: dict = dataclasses.field(default_factory=dict)
    kept: dict = dataclasses.field(default_factory=dict)   # slot -> (target, image, png)


def setup(cell, family, seed, device, variant, log) -> State:
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    n = cfg["shot_frames"]
    t0 = time.perf_counter()
    frames = family.host_shots(cfg, traffic["shots"], seed, device)
    t1 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="portbench-files-"))
    targets, jobs = [], []
    for s in range(frames.shape[0]):
        shot_dir = root / "in" / f"shot_{s:02d}"
        shot_dir.mkdir(parents=True)
        for k in range(n):
            path = shot_dir / f"{traffic['prefix']}{s * n + k + 1:04d}.png"
            targets.append((str(path), s, k))
            jobs.append((path, frames[s, k]))
    with concurrent.futures.ThreadPoolExecutor(max_workers=traffic["writers"]) as ex:
        for fut in [ex.submit(_write, path, img, traffic["png_level"]) for path, img in jobs]:
            fut.result()
    t2 = time.perf_counter()
    session_kw, run_cfg = family.session(cfg, variant)
    if device.type == "cuda":
        from image_denoising_filter_tpu_torch.utils import imageio, native

        lib = native.ensure()
        log(f"native host library: route {lib.route}, "
            + (f"built in {lib.build_s:.3f} s" if lib.build_s else "found built")
            + f"; codec {imageio.codec()}")
    state = State(cell, family, seed, device, root, frames, targets, session_kw, run_cfg, log)
    t3 = time.perf_counter()
    _run(state, 0)  # the whole path once, outside the window
    state.cache.clear()
    log(f"{len(targets)} PNG frames in {frames.shape[0]} shots (made in {t1 - t0:.3f} s, "
        f"written in {t2 - t1:.3f} s); the path once in {time.perf_counter() - t3:.3f} s; "
        f"check sample of {cfg['check_frames']} frames")
    return state


def _write(path: Path, img: np.ndarray, level: int) -> None:
    path.write_bytes(png.encode(img, level))


def _run(state: State, i: int):
    """Target i % targets through a new Session, as `gpu-denoise --all-frames`
    runs it; the RunResult."""
    from image_denoising_filter_tpu_torch.runtime.session import Session

    path = state.targets[i % len(state.targets)][0]
    out_dir = state.root / "out" / Path(path).stem
    os.makedirs(out_dir, exist_ok=True)
    session = Session(path, device=state.device, output_dir=str(out_dir),
                      frame_cache=state.cache, **state.session_kw)
    return session.run(state.run_cfg)


def measure(state: State, seconds: float, trace: bool) -> harness.Window:
    sample = harness.Reservoir(state.cell.config["check_frames"], state.seed)
    totals = {"host_ns": 0, "transfer_ns": 0, "exec_ns": 0}
    frame_ns = []
    memory = harness.Memory(state.device)
    with harness.profiled(trace, state.device) as trace_path:
        with torch.profiler.record_function(harness.WINDOW_SPAN):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            i = 0
            while time.perf_counter() < deadline:
                with torch.profiler.record_function(harness.STEP_SPAN):
                    h0 = time.perf_counter_ns()
                    result = _run(state, i)
                    frame_ns.append(time.perf_counter_ns() - h0)
                totals["host_ns"] += frame_ns[-1]
                totals["transfer_ns"] += result.report.transfer_ns
                totals["exec_ns"] += result.report.exec_ns
                slot = sample.slot(i)
                if slot is not None:
                    state.kept[slot] = (i % len(state.targets), result.image,
                                        result.output_path)
                del result
                i += 1
            t1 = time.perf_counter()
    window = harness.Window(frames=i, seconds=t1 - t0, session=totals,
                            trace_path=trace_path())
    memory.close(window)
    ms = sorted(t / 1e6 for t in frame_ns)
    state.log(f"frame ms: min {ms[0]:.1f}, median {ms[len(ms) // 2]:.1f}, max {ms[-1]:.1f}; "
              f"transfer {totals['transfer_ns'] / 1e6 / i:.1f} and exec "
              f"{totals['exec_ns'] / 1e6 / i:.1f} a frame")
    return window


def check(state: State) -> dict:
    """For each sampled frame of the window: the largest absolute difference
    between the image the session read back and the plain reference's
    output, and the share of the saved PNG's bytes that differ from the
    reference's output cast as the upstream reference casts it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err, share = (0.0, 0.0) if state.kept else (float("inf"), 1.0)
    for _, (t, image, out_path) in sorted(state.kept.items()):
        _, s, k = state.targets[t]
        shot = torch.from_numpy(png.to_float(state.frames[s])).to(state.device)
        want = state.family.reference(state.cell.config,
                                      state.family.window_item(shot, k)).cpu().numpy()
        err = max(err, max_abs_err(image, want))
        with open(out_path, "rb") as f:
            saved = png.decode(f.read())
        share = max(share, mismatch_share(saved, png.quantize(want)))
    limits = state.cell.config["limits"]
    return {"max_abs_err": (err, limits["max_abs_err"]),
            "png_mismatch_share": (share, limits["png_mismatch_share"])}


def close(state: State) -> None:
    shutil.rmtree(state.root, ignore_errors=True)
