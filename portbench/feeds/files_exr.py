"""A shot of float32 EXR frames on disk, denoised frame by frame as
`gpu-denoise --all-frames` does it on a `.exr` target (`cli._battery`): for
each target a new Session with one shared decoded-frame cache, then
Session.run, which decodes, uploads, runs the kernels, reads back and saves
the EXR (A, B, G, R FLOAT, ZIP, alpha kept). The window, its timing and the
clean-up are files_all_frames's, so both files cells time the same loop.

Set-up writes the shots with the benchmark's own EXR writer (ZIP at the
traffic's zlib level), one directory a shot, frames named as the upstream
reference's HDR animations are, under the run's TMPDIR, and removes them at
the end.
"""

from __future__ import annotations

import concurrent.futures
import struct
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from portbench.compare import mismatch_share
from portbench.feeds.files_all_frames import State, _run, close, measure  # noqa: F401
from portbench.reference import exr


def setup(cell, family, seed, device, variant, log) -> State:
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    n = cfg["shot_frames"]
    t0 = time.perf_counter()
    frames = family.host_shots(cfg, traffic["shots"], seed, device)
    t1 = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="portbench-exr-"))
    targets, jobs = [], []
    for s in range(frames.shape[0]):
        shot_dir = root / "in" / f"shot_{s:02d}"
        shot_dir.mkdir(parents=True)
        for k in range(n):
            path = shot_dir / f"{traffic['prefix']}{s * n + k + 1:04d}.exr"
            targets.append((str(path), s, k))
            jobs.append((path, frames[s, k]))
    with concurrent.futures.ThreadPoolExecutor(max_workers=traffic["writers"]) as ex:
        for fut in [ex.submit(_write, path, img, traffic["zip_level"]) for path, img in jobs]:
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
    mb = sum(Path(p).stat().st_size for p, _, _ in targets) / 1e6
    log(f"{len(targets)} EXR frames in {frames.shape[0]} shots, {mb:.1f} MB (made in "
        f"{t1 - t0:.3f} s, written in {t2 - t1:.3f} s); the path once in "
        f"{time.perf_counter() - t3:.3f} s; check sample of {cfg['check_frames']} frames")
    return state


def _write(path: Path, img: np.ndarray, level: int) -> None:
    path.write_bytes(exr.encode(img, exr.ZIP, level))


def rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| / max(1, |want|) over every value: inf where
    either holds a NaN, or where the shapes differ. HDR values reach tens,
    so an absolute error grows with the value; below 1 it stays absolute."""
    if got.shape != want.shape:
        return float("inf")
    got, want = got.astype(np.float64), want.astype(np.float64)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    return float(np.nan_to_num(err, nan=np.inf).max())


def format_mismatch(image: exr.Image, cfg: dict) -> int:
    """0 where the file's channels, pixel types and compression are the
    configuration's, else 1."""
    want = cfg["exr"]
    return int(image.channels != want["channels"]
               or any(t != want["pixel_type"] for t in image.types)
               or image.compression != want["compression"])


def bits_mismatch_share(got: np.ndarray, want: np.ndarray) -> float:
    """The share of float32 values whose bits differ (1.0 where the shapes
    differ)."""
    if got.shape != want.shape:
        return 1.0
    return mismatch_share(np.ascontiguousarray(got, np.float32).view(np.uint32),
                          np.ascontiguousarray(want, np.float32).view(np.uint32))


def check(state: State) -> dict:
    """For each sampled frame of the window, the saved EXR decoded by the
    benchmark's own reader: its largest relative difference from the plain
    reference's output over the frames as written (float32 EXR is
    lossless), whether it is not the configuration's format, and the share
    of its values that differ bit for bit from the image the session read
    back."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = state.cell.config
    err, fmt, share = (0.0, 0, 0.0) if state.kept else (float("inf"), 1, 1.0)
    for _, (t, image, out_path) in sorted(state.kept.items()):
        _, s, k = state.targets[t]
        shot = torch.from_numpy(state.frames[s]).to(state.device)
        want = state.family.reference(cfg, state.family.window_item(shot, k)).cpu().numpy()
        try:
            saved = exr.decode(Path(out_path).read_bytes())
        except (ValueError, KeyError, IndexError, OSError, struct.error, zlib.error) as e:
            state.log(f"the saved file {out_path} does not read: {e}")
            err, fmt, share = float("inf"), 1, 1.0
            continue
        err = max(err, rel_err(saved.rgba, want))
        fmt = max(fmt, format_mismatch(saved, cfg))
        share = max(share, bits_mismatch_share(saved.rgba, image))
    limits = cfg["limits"]
    return {"max_rel_err": (err, limits["max_rel_err"]),
            "exr_format_mismatch": (fmt, limits["exr_format_mismatch"]),
            "saved_readback_mismatch_share": (share, limits["saved_readback_mismatch_share"])}
