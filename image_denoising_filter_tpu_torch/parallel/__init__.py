"""Multi-device sharding on torch.distributed: a (frame, y) mesh of ranks,
spatial row sharding with halo exchange, frame-level data parallelism
(counterpart of image_denoising_filter_tpu/parallel/). `launch.run_ranks`
starts the ranks; `dryrun` checks the sharded paths against the oracles."""

from .mesh import FRAME_AXIS, SPATIAL_AXIS, make_mesh  # noqa: F401
from .spatial import (  # noqa: F401
    gather_rows,
    shard_rows,
    spatial_bilateral,
    spatial_bilateral_fast,
    spatial_cross_bilateral_layers,
    spatial_cross_bilateral_layers_fast,
    spatial_nlm_accumulate,
    temporal_nlm_sharded,
)
