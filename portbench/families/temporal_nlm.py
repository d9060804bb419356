"""The temporal NLM family: a target and the F frames of its window (the
target first, then every frame of its shot, as `dataset.discover` lists
them), through the port's TemporalNlmDenoiser (device traffic) or
Session.run with the multiframe NLM config (file traffic)."""

from __future__ import annotations

import numpy as np
import torch

from image_denoising_filter_tpu_torch import config, models
from portbench import content, work
from portbench.reference import temporal_nlm as reference_mod


def params(cfg: dict):
    return config.NlmParams(**cfg["params"])


def tiling(variant: str):
    """The program's tap precision: the configuration's float32, or bf16
    taps, the program's own lower-precision path, for the control."""
    return None if variant == "program" else config.TilingConfig(compute_dtype="bfloat16")


def shots(cfg: dict, n_shots: int, seed: int, device) -> torch.Tensor:
    """(n_shots, shot_frames, H, W, 4) noisy float32 frames on the device:
    shot s shows scene s, whatever the seed, so every seed brings the same
    work; the noise is drawn from the seed."""
    return torch.stack([
        content.noisy_shot(cfg["height"], cfg["width"], cfg["shot_frames"], s,
                           cfg["noise"], cfg["pan"], content.generator(seed, s, device), device)
        for s in range(n_shots)])


def window_item(shot: torch.Tensor, k: int) -> dict:
    """Target k of a shot with its window of frames: the target, then the
    shot's frames."""
    frames = torch.cat([shot[k:k + 1], shot])
    return {"target": frames[0], "frames": frames}


def device_pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    pool = shots(cfg, traffic["pool_shots"], seed, device)
    return [window_item(shot, k) for shot in pool for k in range(shot.shape[0])]


def entry(cfg: dict, variant: str):
    model = models.TemporalNlmDenoiser(params(cfg), tiling=tiling(variant))
    return lambda item: model(item["target"], item["frames"])


def reference(cfg: dict, item: dict) -> torch.Tensor:
    return reference_mod.temporal_nlm(item["target"], item["frames"], cfg["params"])


def host_shots(cfg: dict, n_shots: int, seed: int, device) -> np.ndarray:
    """(n_shots, shot_frames, H, W, 4) uint8 frames, as a renderer saves
    them: round(255 x)."""
    u8 = (shots(cfg, n_shots, seed, device) * 255.0).round().to(torch.uint8)
    return u8.cpu().numpy()


def session(cfg: dict, variant: str) -> tuple[dict, object]:
    """Session's keyword arguments and the RunConfig it runs."""
    return ({"nlm_params": params(cfg), "nlm_tiling": tiling(variant)},
            config.RunConfig(nlm=True, multiframe=True))


def step_work(cfg: dict) -> tuple[int, int]:
    """One target's work: the window's F frames (the target is its first)
    read once and the output written once; the NLM over F frames and every
    search offset, then the normalize."""
    px = cfg["height"] * cfg["width"]
    f = cfg["shot_frames"] + 1
    _, nlm_ops = work.kernel_work("nlm", px, frames=f,
                                  cands=work.nlm_candidates(cfg["params"]["search_radius"]))
    _, norm_ops = work.kernel_work("normalize", px)
    return 16 * f * px + 16 * px, nlm_ops + norm_ops
