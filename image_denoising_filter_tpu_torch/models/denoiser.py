"""Denoiser model families of the reference's battery, as `nn.Module`s.

Counterpart of image_denoising_filter_tpu/models/denoiser.py. The six GPU
configurations (src/main.cpp:1953-1973) map onto four families:

  * BilateralDenoiser   -- plain bilateral, tiled (CUDA kernel) or linear
                           (whole-image tensor ops) layout
  * LayerGuidedDenoiser -- cross-bilateral over G-buffer layers, accumulate
                           then normalize
  * NlmDenoiser         -- single-frame non-local means (the target matched
                           against itself, src/main.cpp:1521-1528)
  * TemporalNlmDenoiser -- multiframe NLM: partials accumulated over the
                           neighbour frames, then one normalize

The models hold no weights: their parameters are the frozen config
dataclasses. They run on the device of their input tensors; the layer and
frame loops that the JAX package scans are Python loops here.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..config import (
    BilateralParams,
    LayersParams,
    NlmParams,
    NormalizeParams,
    TilingConfig,
)

from ..ops import eager, stencils
from ..utils import timing

TILED = "tiled"
LINEAR = "linear"
Sums = tuple[torch.Tensor, torch.Tensor]  # (weightColor, normWeight)


def _check_layout(layout: str) -> str:
    if layout not in (TILED, LINEAR):
        raise ValueError(f"unknown layout {layout!r}")
    return layout


def carry_from_numpy(
    wc: np.ndarray, nw: np.ndarray, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor]:
    """A (weightColor, normWeight) accumulation carry from host arrays -- for
    instance one produced by the JAX package -- as float32 tensors on
    `device`, ready for TemporalNlmDenoiser.accumulate_one / finalize. The
    tensors are copies: the carry owns its memory."""
    return (
        torch.tensor(np.asarray(wc), dtype=torch.float32, device=device),
        torch.tensor(np.asarray(nw), dtype=torch.float32, device=device),
    )


def fold(acc: Optional[Sums], part: Sums) -> Sums:
    """Add the partials part = (weightColor, normWeight) into the sums acc
    in place and return acc; acc None starts the sums from part, copied if
    it is a view (a cropped output), so a fold writes into no memory but
    the sums' own. Pass part straight from the op: no partial then outlives
    its fold, and the sums peak at two sets."""
    if acc is None:
        return tuple(p.clone() if p._base is not None else p for p in part)
    acc[0].add_(part[0])
    acc[1].add_(part[1])
    return acc


class _Normalizing(nn.Module):
    """Shared normalize step of the two-pass families: the kernel on the
    tiled layout, tensor ops on the linear one."""

    def __init__(self, norm_params: NormalizeParams, layout: str,
                 tiling: Optional[TilingConfig]) -> None:
        super().__init__()
        self.norm_params = norm_params
        self.layout = _check_layout(layout)
        self.tiling = tiling

    def _normalize(self, wc: torch.Tensor, nw: torch.Tensor) -> torch.Tensor:
        if self.layout == TILED:
            return stencils.normalize(wc, nw, self.norm_params, self.tiling)
        return eager.normalize_eager(wc, nw, self.norm_params)


class BilateralDenoiser(nn.Module):
    """Plain bilateral filter (tiled or linear layout)."""

    def __init__(
        self,
        params: BilateralParams = BilateralParams(),
        layout: str = TILED,
        tiling: Optional[TilingConfig] = None,
    ) -> None:
        super().__init__()
        self.params = params
        self.layout = _check_layout(layout)
        self.tiling = tiling

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        with timing.span(timing.FORWARD):
            if self.layout == TILED:
                return stencils.bilateral(img, self.params, self.tiling)
            return eager.bilateral_eager(img, self.params)


class LayerGuidedDenoiser(_Normalizing):
    """Cross-bilateral guided by G-buffer layers: one accumulation pass per
    layer into shared (weightColor, normWeight) sums, then one normalize
    (the reference's per-layer dispatch loop, src/main.cpp:1608-1624)."""

    def __init__(
        self,
        params: LayersParams = LayersParams(),
        norm_params: NormalizeParams = NormalizeParams(),
        layout: str = TILED,
        tiling: Optional[TilingConfig] = None,
    ) -> None:
        super().__init__(norm_params, layout, tiling)
        self.params = params

    def forward(self, target: torch.Tensor, layers: Iterable[torch.Tensor]) -> torch.Tensor:
        """target: (H, W, 4); layers: (L, H, W, 4) stacked G-buffer layers."""
        with timing.span(timing.FORWARD):
            h, w, _ = target.shape
            acc = (torch.zeros((h, w, 4), dtype=torch.float32, device=target.device),
                   torch.zeros((h, w), dtype=torch.float32, device=target.device))
            for layer in layers:
                if self.layout == TILED:
                    fold(acc, stencils.cross_bilateral_layers(target, layer, self.params,
                                                              self.tiling))
                else:
                    fold(acc, eager.cross_bilateral_layers_eager(target, layer, self.params))
            return self._normalize(*acc)


class NlmDenoiser(_Normalizing):
    """Single-frame non-local means: the target is matched against itself."""

    def __init__(
        self,
        params: NlmParams = NlmParams(),
        norm_params: NormalizeParams = NormalizeParams(),
        layout: str = TILED,
        tiling: Optional[TilingConfig] = None,
    ) -> None:
        super().__init__(norm_params, layout, tiling)
        self.params = params

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        with timing.span(timing.FORWARD):
            if self.layout == TILED:
                wc, nw = stencils.nlm_accumulate(img, img, self.params, self.tiling)
            else:
                wc, nw = eager.nlm_eager(img, img, self.params)
            return self._normalize(wc, nw)


class TemporalNlmDenoiser(_Normalizing):
    """Multiframe temporal NLM: partials accumulate across the neighbour
    frames (each adds its norm seed, shaders/nonlocal.comp:32, 61-62), then
    one normalize (src/main.cpp:1649-1652)."""

    def __init__(
        self,
        params: NlmParams = NlmParams(),
        norm_params: NormalizeParams = NormalizeParams(),
        layout: str = TILED,
        tiling: Optional[TilingConfig] = None,
    ) -> None:
        super().__init__(norm_params, layout, tiling)
        self.params = params

    def forward(self, target: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """target: (H, W, 4); frames: (F, H, W, 4) neighbour frames (the
        target itself is frames[0] in the reference's loop)."""
        with timing.span(timing.FORWARD):
            return self.finalize(self.accumulate(target, frames))

    def accumulate(
        self, target: torch.Tensor, frames: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Accumulated (weightColor, normWeight) over all frames: one
        frame-batched kernel launch on the tiled layout, a frame loop on the
        linear one."""
        if self.layout == TILED:
            return stencils.nlm_accumulate_frames(target, frames, self.params, self.tiling)
        h, w, _ = target.shape
        acc = (torch.zeros((h, w, 4), dtype=torch.float32, device=target.device),
               torch.zeros((h, w), dtype=torch.float32, device=target.device))
        for frame in frames:
            fold(acc, eager.nlm_eager(target, frame, self.params))
        return acc

    def accumulate_one(
        self,
        target: torch.Tensor,
        frame: torch.Tensor,
        carry: Optional[tuple[torch.Tensor, torch.Tensor]],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Streaming form: fold one frame's partials into the carry in place,
        or start it from them (frames arriving one at a time)."""
        if self.layout == TILED:
            return fold(carry, stencils.nlm_accumulate(target, frame, self.params, self.tiling))
        return fold(carry, eager.nlm_eager(target, frame, self.params))

    def finalize(self, carry: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return self._normalize(carry[0], carry[1])
