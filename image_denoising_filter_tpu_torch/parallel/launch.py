"""Start the ranks of a multi-device run and join them, or join one under torchrun.

The JAX package drives every device from one process; `torch.distributed`
runs one process per rank. `run_ranks(world, fn, *args)` spawns `world`
processes, joins each to a process group through a file store in a private
temporary directory (no TCP port, so concurrent runs cannot collide), runs
`fn(*args)` in every rank and returns the ranks' results in rank order. It
waits with a deadline: when a rank fails, or the deadline passes, every rank
is killed and the failure is raised with the failing rank's traceback.

Rank r runs on `cuda:{r % device_count}` (several ranks may share one card
over gloo; NCCL takes one rank a card) or on the CPU. The CUDA kernels are
compiled once before the spawn; under torchrun rank 0 builds them while the
others wait at a barrier, so no two processes build into the same directory.

`fn` is pickled by its import path, so it is a module-level function of an
importable module; the ranks import neither the caller's test files nor JAX.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0
# After a deadline or a failure, how long the ranks get to exit before SIGKILL.
_GRACE_S = 5.0


def default_backend(device_type: str) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def check_backend(backend: str, device_type: str, world: int) -> None:
    """Refuse a backend that cannot run `world` ranks on `device_type`: NCCL
    moves CUDA tensors only, and takes one rank a card. Nothing falls back
    to another backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown torch.distributed backend {backend!r}: use one of {BACKENDS}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}: use cuda or cpu")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ranks on cuda requested but no CUDA device is available "
            "(torch.cuda.is_available() is false)"
        )
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("--dist-backend nccl needs --device cuda: NCCL moves CUDA tensors only")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"--dist-backend nccl takes one rank a card: {world} ranks, {cards} card(s); "
                "use --dist-backend gloo to run several ranks on one card"
            )


def _device_for(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        return device
    return torch.device("cpu")


def _load_kernels(device_type: str, rank: int) -> None:
    """Rank 0 builds (or loads) the kernel library; the others load it after
    a barrier."""
    if device_type != "cuda":
        return
    from ..ops import _build

    if rank == 0:
        _build.library()
    dist.barrier()
    if rank != 0:
        _build.library()


def init_rank(backend: str, device_type: str, rank: int, world: int, init_method: str,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join this process to the process group as `rank` of `world`, on its
    device, with the kernels loaded. Returns the rank's device."""
    device = _device_for(rank, device_type)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _load_kernels(device_type, rank)
    return device


def init_from_env(backend: str, device_type: str) -> torch.device:
    """Join under torchrun: rank and world size from RANK and WORLD_SIZE,
    the card from LOCAL_RANK, the rendezvous through env://."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    check_backend(backend, device_type, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    device = _device_for(local, device_type)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    _load_kernels(device_type, rank)
    return device


def under_torchrun() -> bool:
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def _rank_main(rank: int, world: int, fn: Callable, args: tuple, backend: str,
               device_type: str, store_dir: str, timeout_s: float) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)
    init_rank(backend, device_type, rank, world, f"file://{store_dir}/store", timeout_s)
    try:
        result = fn(*args)
        with open(os.path.join(store_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _kill(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + _GRACE_S
    for p in ctx.processes:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def run_ranks(world: int, fn: Callable, *args: Any, backend: Optional[str] = None,
              device_type: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(*args) in `world` spawned ranks of one process group and return
    their results, rank 0's first. backend None takes default_backend. A
    rank that raises, exits or outlives timeout_s fails the run: every rank
    is stopped and the error raised (TimeoutError for the deadline)."""
    backend = backend or default_backend(device_type)
    check_backend(backend, device_type, world)
    if device_type == "cuda":
        from ..ops import _build

        _build.build()  # compiled once here, loaded by every rank
    with tempfile.TemporaryDirectory(prefix="idf_ranks_") as store_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main,
            args=(world, fn, args, backend, device_type, store_dir, timeout_s),
            nprocs=world, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic()), grace_period=_GRACE_S):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s:g} s")
        finally:
            _kill(ctx)
        results = []
        for rank in range(world):
            with open(os.path.join(store_dir, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
