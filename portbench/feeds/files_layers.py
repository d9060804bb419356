"""Shots of PNG frames on disk, each frame with its own RenderElements
layers, denoised frame by frame as `gpu-denoise --all-frames --configs
layers` does it (`cli._battery`): for each target a new Session with one
shared decoded-frame cache, then Session.run with the layers config, which
finds the target's layers by its frame ID (utils/dataset.py), decodes the
target and its layers, uploads the target and the stacked layers, runs one
guided pass a layer and the normalize, reads back and saves the PNG. No
file comes round again before the cache (32 entries) has let it go, so each
target decodes four files a pass.

Set-up writes the frames as files_all_frames does and, beside each shot's
frames, one layer directory with every target's layers, named
<k>_<layer>_<frame ID>.png (k the layer's place in the configuration, so
that the scan's name order is the configuration's). The upstream scan takes
a file as a target's layer wherever the target's frame ID (the 4 characters
before the first '.' of its path) appears in the file's path, so a '.' or a
frame ID in the directories above the shots would give a target the wrong
layers. The Sessions therefore run from the shots' root, as a user runs
`gpu-denoise` from the directory that holds the shots, and take the
targets' paths relative to it: TMPDIR's name never reaches the scan. Set-up
checks, before the window, that the scan finds exactly each target's own
layers in the configuration's order. The window, its timing and the
clean-up are files_all_frames's.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from portbench.compare import max_abs_err, mismatch_share
from portbench.feeds import files_all_frames as base
from portbench.reference import png

close = base.close


@dataclasses.dataclass
class State(base.State):
    layers: np.ndarray = None   # (shots, shot_frames, L, H, W, 4) uint8, as written


def setup(cell, family, seed, device, variant, log) -> State:
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    frames, layers = family.host_shots(cfg, traffic["shots"], seed, device)
    t1 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="portbench-layers-"))
    try:
        targets, own = write_shots(root, cfg, traffic, frames, layers)
        t2 = time.perf_counter()
        check_layers(root, own)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    session_kw, run_cfg = family.session(cfg, variant)
    if device.type == "cuda":
        from image_denoising_filter_tpu_torch.utils import imageio, native

        lib = native.ensure()
        log(f"native host library: route {lib.route}, "
            + (f"built in {lib.build_s:.3f} s" if lib.build_s else "found built")
            + f"; codec {imageio.codec()}")
    state = State(cell, family, seed, device, root, frames, targets, session_kw, run_cfg, log,
                  layers=layers)
    t3 = time.perf_counter()
    with contextlib.chdir(root):
        base._run(state, 0)  # the whole path once, outside the window
    state.cache.clear()
    log(f"{len(targets)} PNG frames, each with {layers.shape[2]} layers, in {frames.shape[0]} "
        f"shots (made in {t1 - t0:.3f} s, written in {t2 - t1:.3f} s); the path once in "
        f"{time.perf_counter() - t3:.3f} s; check sample of {cfg['check_frames']} frames")
    return state


def write_shots(root: Path, cfg: dict, traffic: dict, frames: np.ndarray,
                layers: np.ndarray) -> tuple[list, dict]:
    """Each shot's frames in a directory of its own under root, named as
    files_all_frames names them, and every frame's layers in the shot's
    layer directory. Returns the targets (path, shot, index in shot) and a
    map from each target's path to its layers' paths, in order, all paths
    relative to root."""
    n = cfg["shot_frames"]
    targets, jobs, own = [], [], {}
    for s in range(frames.shape[0]):
        shot_dir = Path("in") / f"shot_{s:02d}"
        layer_dir = shot_dir / traffic["layer_dir"]
        (root / layer_dir).mkdir(parents=True)
        for k in range(n):
            fid = f"{s * n + k + 1:04d}"
            path = shot_dir / f"{traffic['prefix']}{fid}.png"
            names = [layer_dir / f"{j + 1}_{name}_{fid}.png"
                     for j, name in enumerate(cfg["layers"])]
            targets.append((str(path), s, k))
            own[str(path)] = [str(p) for p in names]
            jobs += [(root / path, frames[s, k]),
                     *((root / p, x) for p, x in zip(names, layers[s, k]))]
    with concurrent.futures.ThreadPoolExecutor(max_workers=traffic["writers"]) as ex:
        for fut in [ex.submit(base._write, path, img, traffic["png_level"]) for path, img in jobs]:
            fut.result()
    return targets, own


def check_layers(root: Path, own: dict) -> None:
    """Raise unless the program's scan (dataset.discover with layers), run
    from root as the Sessions run, finds for each target exactly its own
    layers, in order: own maps a target's path to its layers' paths, both
    relative to root."""
    from image_denoising_filter_tpu_torch.utils import dataset

    with contextlib.chdir(root):
        for target, paths in own.items():
            found = list(dataset.discover(target, use_layers=True).layers)
            if found != paths:
                raise RuntimeError(
                    f"the layer scan finds {found} for {target}, not its own layers {paths}: "
                    "the upstream scan matches a layer by the 4 characters before the first '.' "
                    "of the target's path (utils/dataset.py), so the shots' paths may hold no "
                    "other '.' and no frame ID but their own")


def measure(state: State, seconds: float, trace: bool):
    """files_all_frames's window, run from the shots' root (the targets'
    paths are relative to it)."""
    with contextlib.chdir(state.root):
        return base.measure(state, seconds, trace)


def check(state: State) -> dict:
    """For each sampled frame of the window: the largest absolute difference
    between the image the session read back and the plain reference's
    output over the target and its layers as written, and the share of the
    saved PNG's bytes that differ from the reference's output cast as the
    upstream reference casts it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    err, share = (0.0, 0.0) if state.kept else (float("inf"), 1.0)
    for _, (t, image, out_path) in sorted(state.kept.items()):
        _, s, k = state.targets[t]
        frames, layers = (torch.from_numpy(png.to_float(x[s])).to(state.device)
                          for x in (state.frames, state.layers))
        item = state.family.window_item(frames, layers, k)
        want = state.family.reference(state.cell.config, item).cpu().numpy()
        err = max(err, max_abs_err(image, want))
        with open(out_path, "rb") as f:
            saved = png.decode(f.read())
        share = max(share, mismatch_share(saved, png.quantize(want)))
    limits = state.cell.config["limits"]
    return {"max_abs_err": (err, limits["max_abs_err"]),
            "png_mismatch_share": (share, limits["png_mismatch_share"])}
