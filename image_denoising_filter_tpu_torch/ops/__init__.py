"""Device stencils of the battery and of the turbo grids.

  * `stencils.*` -- hand-written CUDA kernels of the exact battery (tiled
    layout, the production path on the card) and of the turbo NLM (bf16
    taps, and the half-row weights of `weights_halfres`), each with its
    plain PyTorch version and launch count;
  * `fast.*` -- the turbo grids: the bilateral grid (`bilateral_fast`:
    pool, grid build, grid slice; `grid_pipeline(fused=True)` the fused
    build+slice) and the layer-guided grid
    (`cross_bilateral_layers_fast`: pool, guided build and slice, or the
    fused guided build+slice), hand-written CUDA kernels with their plain
    versions and launch counts, and `normalize_layers_fast`;
  * `eager.*` -- whole-image tensor ops: the linear-layout config, and the
    bilateral grid's lattice path (`bilateral_fast_eager`, the turbo mode at
    downsample 1);
  * `reference` -- the NumPy oracles of every kernel, the CPU bilateral
    (`cpu_bilateral_reference`, the cpu1/cpu8 configs where the native
    library is not built) and `psnr`/`ssim`: a copy of the JAX package's
    ops/reference.py.
"""

from .eager import (  # noqa: F401
    bilateral_eager,
    bilateral_fast_eager,
    cross_bilateral_layers_eager,
    nlm_eager,
    normalize_eager,
)
from .fast import (  # noqa: F401
    bilateral_fast,
    cross_bilateral_layers_fast,
    normalize_layers_fast,
)
from .stencils import (  # noqa: F401
    bilateral,
    cross_bilateral_layers,
    nlm_accumulate,
    nlm_accumulate_frames,
    normalize,
)
