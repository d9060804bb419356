"""image_denoising_filter_tpu_torch: the PyTorch / CUDA port of
image_denoising_filter_tpu, for one NVIDIA H100.

Subpackages, each the counterpart of the JAX package's module of the same
name:
  ops      -- hand-written CUDA kernels (built at first use) with their plain
              PyTorch versions, and the whole-image linear-layout ops
  models   -- denoiser families as nn.Modules (bilateral, layer-guided, NLM,
              temporal NLM)
  runtime  -- session orchestration and frame prefetch
  cli      -- the `gpu-denoise` command (the battery)
  utils    -- the shared image and dataset utilities, re-exported

Configuration dataclasses and the image, dataset, timing and progress
utilities are imported from image_denoising_filter_tpu; those modules import
no JAX, and both packages hold the very same parameter objects (`config` is
re-exported here). This package imports torch and never jax.
"""

__version__ = "0.1.0"

from image_denoising_filter_tpu import config  # noqa: F401
