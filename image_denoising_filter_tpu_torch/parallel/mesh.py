"""Device mesh of the multi-device paths: ranks on a named ('frame', 'y') mesh.

Counterpart of image_denoising_filter_tpu/parallel/mesh.py. The JAX package
runs one controller over a `Mesh` of devices; here each mesh position is one
process (a rank of `torch.distributed`), and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` with the same axis names: 'frame'
carries frame-level data parallelism (temporal NLM partials summed over it)
and 'y' spatial row sharding (halo rows exchanged between neighbours along
it). Rank r sits at (r // Y, r % Y) of an (F, Y) mesh.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

FRAME_AXIS = "frame"
SPATIAL_AXIS = "y"


def make_mesh(shape: Optional[Sequence[int]] = None, device_type: str = "cuda") -> DeviceMesh:
    """The (frame, y) mesh over the ranks of the initialised process group.

    shape=None puts every rank on the spatial axis, (1, world): spatial
    sharding is the only way to split one frame's work. A collective call:
    every rank makes the same mesh. The mesh spans the whole process group,
    whose world size must equal F * Y. (The JAX package takes the first F * Y
    devices; a rank left out of the mesh here would hang its peers'
    collectives, so a mismatch raises.)"""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs an initialised torch.distributed process group: run the "
            "ranks through parallel.launch.run_ranks, or under torchrun"
        )
    world = dist.get_world_size()
    shape = (1, world) if shape is None else tuple(int(n) for n in shape)
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"a mesh shape is (frame, y) with both at least 1, got {shape}")
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh shape {shape} needs {math.prod(shape)} ranks, the process group has {world}"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=(FRAME_AXIS, SPATIAL_AXIS))
