"""The layer-guided family from disk: each noisy target and its own three
G-buffer layers (albedo, normal, depth) as a renderer saves them, 8-bit
PNGs, through Session.run with the layers config (`gpu-denoise
--all-frames --configs layers`). The scenes, noise, model, plain reference
and step's work are the layer-guided family's."""

from __future__ import annotations

import numpy as np
import torch

from image_denoising_filter_tpu_torch import config
from portbench.families import layer_guided as base

params = base.params
tiling = base.tiling
reference = base.reference
step_work = base.step_work


def _u8(x: torch.Tensor) -> np.ndarray:
    """float32 in [0, 1] as a renderer's 8-bit file holds it: round(255 x)."""
    return (x * 255.0).round().to(torch.uint8).cpu().numpy()


def host_shots(cfg: dict, n_shots: int, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """The frames (n_shots, shot_frames, H, W, 4) and each frame's layers
    (n_shots, shot_frames, L, H, W, 4), in the configuration's order, as
    uint8: the layer-guided family's pool of n_shots shots."""
    pool = base.device_pool(cfg, {"pool_shots": n_shots}, seed, device)
    shape = (n_shots, cfg["shot_frames"])
    frames = np.stack([_u8(item["target"]) for item in pool])
    layers = np.stack([_u8(item["layers"]) for item in pool])
    return frames.reshape(shape + frames.shape[1:]), layers.reshape(shape + layers.shape[1:])


def window_item(frames: torch.Tensor, layers: torch.Tensor, k: int) -> dict:
    """Target k of a shot with its own layers, as float32 the program
    decodes them: frames (shot_frames, H, W, 4), layers (shot_frames, L, H,
    W, 4), each in the order the Session finds them."""
    return {"target": frames[k], "layers": layers[k]}


def session(cfg: dict, variant: str) -> tuple[dict, object]:
    """Session's keyword arguments and the RunConfig it runs: `gpu-denoise
    --configs layers` (GPU_BATTERY[1])."""
    return ({"layers_params": params(cfg), "tiling": tiling(variant)},
            config.RunConfig(nlm=False, linear=False, use_layers=True))
