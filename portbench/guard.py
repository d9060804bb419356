"""The run's guard against the JAX package: the port under test imports no
JAX, and nothing of the JAX package it was ported from."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "image_denoising_filter_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among the module names (sys.modules by
    default), each compared whole: the part before the first dot."""
    names = sys.modules if names is None else names
    return sorted({name.split(".", 1)[0] for name in names} & set(FORBIDDEN))
