"""The layer-guided family: a noisy target and its own noise-free G-buffer
layers (albedo, normal, depth), through the port's LayerGuidedDenoiser:
one cross-bilateral pass a layer into shared sums, then one normalize."""

from __future__ import annotations

import torch

from image_denoising_filter_tpu_torch import config, models
from portbench import content, work
from portbench.reference import layer_guided as reference_mod


def params(cfg: dict):
    return config.LayersParams(**cfg["params"])


def tiling(variant: str):
    """float32 taps as configured, or the program's bf16 taps for the
    control."""
    return None if variant == "program" else config.TilingConfig(compute_dtype="bfloat16")


def device_pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    """pool_shots shots of shot_frames targets, the sphere moving through
    shot s from phase s / pool_shots whatever the seed, so every seed brings
    the same work; each target noisy (its noise drawn from the seed for the
    shot in one call) with its own layers."""
    h, w, n = cfg["height"], cfg["width"], cfg["shot_frames"]
    n_shots = traffic["pool_shots"]
    items = []
    for s in range(n_shots):
        phase = s / n_shots
        renders = [content.render_frame_device(min(1.0, (k + phase) / n), h, w, device)
                   for k in range(n)]
        clean = torch.stack([c for c, _ in renders])
        noise = cfg["noise"] * torch.randn(clean[..., :3].shape,
                                           generator=content.generator(seed, s, device),
                                           device=device)
        noisy = torch.cat([(clean[..., :3] + noise).clamp(0.0, 1.0), clean[..., 3:]], -1)
        for k, (_, layers) in enumerate(renders):
            items.append({"target": noisy[k].contiguous(),
                          "layers": torch.stack([layers[name] for name in cfg["layers"]])})
    return items


def entry(cfg: dict, variant: str):
    model = models.LayerGuidedDenoiser(params(cfg), tiling=tiling(variant))
    return lambda item: model(item["target"], item["layers"])


def reference(cfg: dict, item: dict) -> torch.Tensor:
    return reference_mod.layer_guided(item["target"], item["layers"], cfg["params"])


def step_work(cfg: dict) -> tuple[int, int]:
    """One target's work: the target and its L layers read once, the output
    written once; L guided passes over the truncation disk, the L - 1
    accumulations of the four colour sums and the weight sum, the
    normalize."""
    p = cfg["params"]
    px = cfg["height"] * cfg["width"]
    n_layers = len(cfg["layers"])
    disk = work.disk_taps(p["radius"], p["sigma_spatial"], p["truncate_eps"])
    _, tap_ops = work.kernel_work("bilateral_guided", px, disk=disk)
    _, norm_ops = work.kernel_work("normalize", px)
    return 16 * (n_layers + 2) * px, n_layers * tap_ops + 5 * (n_layers - 1) * px + norm_ops
