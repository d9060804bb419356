"""The temporal NLM family in the upstream reference's overlap loop: a
target and its overlap window (the target, then its shot's frames, capped
at framesToUse, the last entry dropped: reference/temporal_nlm_overlap.py),
through the port's TemporalNlmDenoiser (device traffic) or Session.run with
the overlap config, which streams the window through the FramePrefetcher
(file traffic). Inputs, models and the PNG frames are the temporal NLM
family's."""

from __future__ import annotations

import torch

from image_denoising_filter_tpu_torch import config
from portbench import work
from portbench.families import temporal_nlm as base
from portbench.reference import temporal_nlm_overlap as reference_mod

params = base.params
tiling = base.tiling
shots = base.shots
host_shots = base.host_shots
entry = base.entry


def window_item(shot: torch.Tensor, k: int) -> dict:
    """Target k of a shot with the frames of its overlap window (the
    program's input), and the shot and k (the reference's)."""
    return {"target": shot[k], "frames": shot[reference_mod.window(k, shot.shape[0])],
            "shot": shot, "k": k}


def reference(cfg: dict, item: dict) -> torch.Tensor:
    return reference_mod.temporal_nlm_overlap(item["shot"], item["k"], cfg["params"],
                                              _max_frames(cfg))


def device_pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    _max_frames(cfg)
    pool = shots(cfg, traffic["pool_shots"], seed, device)
    return [window_item(shot, k) for shot in pool for k in range(shot.shape[0])]


def _max_frames(cfg: dict) -> int:
    """The configuration's frame cap, which window_item takes as the
    upstream's framesToUse."""
    if cfg["max_frames"] != reference_mod.FRAMES_TO_USE:
        raise ValueError(f"max_frames {cfg['max_frames']}: the overlap window is the "
                         f"upstream's framesToUse = {reference_mod.FRAMES_TO_USE}")
    return cfg["max_frames"]


def session(cfg: dict, variant: str) -> tuple[dict, object]:
    """Session's keyword arguments and the RunConfig it runs: `gpu-denoise
    --configs overlap`."""
    kw, _ = base.session(cfg, variant)
    return kw, config.RunConfig(nlm=True, multiframe=True, overlap=True,
                                max_frames=_max_frames(cfg))


def step_work(cfg: dict) -> tuple[int, int]:
    """One target's work: the window's F frames read once and the output
    written once; the NLM over F frames and every search offset, then the
    normalize."""
    px = cfg["height"] * cfg["width"]
    f = len(reference_mod.window(0, cfg["shot_frames"], _max_frames(cfg)))
    _, nlm_ops = work.kernel_work("nlm", px, frames=f,
                                  cands=work.nlm_candidates(cfg["params"]["search_radius"]))
    _, norm_ops = work.kernel_work("normalize", px)
    return 16 * f * px + 16 * px, nlm_ops + norm_ops
