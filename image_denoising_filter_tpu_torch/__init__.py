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
  config   -- the parameter dataclasses and the battery (`GPU_BATTERY`)
  utils    -- image I/O, dataset discovery, timing report, progress bar

`config` and `utils` are the port's own copies of the JAX package's modules
of the same names, held equal to them by the tests: this package imports
torch, never jax, and nothing of image_denoising_filter_tpu.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
