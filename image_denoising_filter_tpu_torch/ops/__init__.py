"""Device stencils of the exact battery.

  * `stencils.*` -- hand-written CUDA kernels (tiled layout, the production
    path on the card), each with its plain PyTorch version and launch count;
  * `eager.*` -- whole-image tensor ops, the linear-layout config.

The turbo grid family (image_denoising_filter_tpu/ops/fast.py) is not ported
yet.
"""

from .eager import (  # noqa: F401
    bilateral_eager,
    cross_bilateral_layers_eager,
    nlm_eager,
    normalize_eager,
)
from .stencils import (  # noqa: F401
    bilateral,
    cross_bilateral_layers,
    nlm_accumulate,
    nlm_accumulate_frames,
    normalize,
)
