"""Shared helpers of the benchmark's CPU tests: cells at a size the CPU
runs in a second (the port's wrappers take their plain versions for CPU
tensors)."""

import dataclasses
import time

import pytest

from portbench import harness

TINY = {"height": 24, "width": 32}
CELLS = ("tnlm-1080p-device", "xbf-4k-device", "tnlm-1080p-files")


def tiny(name: str, root=harness.ROOT) -> harness.Cell:
    cell = harness.find_cell(root, name)
    traffic = dict(cell.traffic)
    if "shots" in traffic:
        traffic["shots"] = 2
    return dataclasses.replace(cell, config=dict(cell.config, **TINY), traffic=traffic)


def run_tiny(name: str, seed: int = 2**31 + 7, trace: bool = False, variant="program",
             root=harness.ROOT, cell=None) -> dict:
    cell = cell or tiny(name, root)
    return harness.run_cell(root, cell, seed, 0.3, trace, "cpu", time.perf_counter(),
                            log=lambda m: None, variant=variant)


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is there (decided in the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
