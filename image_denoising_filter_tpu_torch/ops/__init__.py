"""Device stencils of the battery and of the turbo bilateral grid.

  * `stencils.*` -- hand-written CUDA kernels of the exact battery (tiled
    layout, the production path on the card), each with its plain PyTorch
    version and launch count;
  * `fast.*` -- the turbo bilateral grid (`bilateral_fast`): hand-written
    CUDA kernels for the pool, the grid build and the grid slice, with
    their plain versions and launch counts;
  * `eager.*` -- whole-image tensor ops: the linear-layout config, and the
    grid's lattice path (`bilateral_fast_eager`, the turbo mode at
    downsample 1).

Not ported yet: the turbo NLM (half-res weights, bf16 taps) and the turbo
layers grid (ROADMAP.md queue A items 8 and 9).
"""

from .eager import (  # noqa: F401
    bilateral_eager,
    bilateral_fast_eager,
    cross_bilateral_layers_eager,
    nlm_eager,
    normalize_eager,
)
from .fast import bilateral_fast  # noqa: F401
from .stencils import (  # noqa: F401
    bilateral,
    cross_bilateral_layers,
    nlm_accumulate,
    nlm_accumulate_frames,
    normalize,
)
