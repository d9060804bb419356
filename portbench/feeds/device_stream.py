"""Frames that already live on the card (an in-engine or interactive
denoiser), one stream, a closed loop: each frame calls the family's entry
on the next item of a pool made at set-up, and waits for its output.

A frame's time runs from the entry's call to its output being ready, on the
device's clock (CUDA events: one recorded as the call is made on an idle
stream, one after the call, then a synchronize). Frames per second are
every frame of the window over the window's time on the host's clock.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench import harness
from portbench.compare import max_abs_err


@dataclasses.dataclass
class State:
    cell: harness.Cell
    family: object
    seed: int
    device: torch.device
    pool: list
    fn: object
    slots: torch.Tensor
    kept: dict = dataclasses.field(default_factory=dict)   # slot -> pool index


def setup(cell, family, seed, device, variant, log) -> State:
    device = torch.device(device)
    t0 = time.perf_counter()
    pool = family.device_pool(cell.config, cell.traffic, seed, device)
    _sync(device)
    t1 = time.perf_counter()
    fn = family.entry(cell.config, variant)
    out = fn(pool[0])  # every item has one shape: this warms up all the cell uses
    slots = torch.empty((cell.config["check_frames"], *out.shape), dtype=out.dtype,
                        device=device)
    del out
    _sync(device)
    log(f"pool of {len(pool)} items on {device} made in {t1 - t0:.3f} s; first call "
        f"{time.perf_counter() - t1:.3f} s; check sample of {slots.shape[0]} frames")
    return State(cell, family, seed, device, pool, fn, slots)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(state: State, seconds: float, trace: bool) -> harness.Window:
    cuda = state.device.type == "cuda"
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sample = harness.Reservoir(state.slots.shape[0], state.seed)
    times = []
    memory = harness.Memory(state.device)
    with harness.profiled(trace, state.device) as trace_path:
        with torch.profiler.record_function(harness.WINDOW_SPAN):
            t0 = time.perf_counter()
            deadline = t0 + seconds
            i = 0
            while time.perf_counter() < deadline:
                idx = i % len(state.pool)
                with torch.profiler.record_function(harness.STEP_SPAN):
                    if cuda:
                        start.record()
                        out = state.fn(state.pool[idx])
                        end.record()
                        torch.cuda.synchronize(state.device)
                        times.append(start.elapsed_time(end))
                    else:
                        h0 = time.perf_counter()
                        out = state.fn(state.pool[idx])
                        times.append((time.perf_counter() - h0) * 1e3)
                slot = sample.slot(i)
                if slot is not None:
                    state.slots[slot].copy_(out)
                    state.kept[slot] = idx
                    _sync(state.device)
                del out
                i += 1
            t1 = time.perf_counter()
    window = harness.Window(frames=i, seconds=t1 - t0, frame_ms=times,
                            trace_path=trace_path())
    memory.close(window)
    return window


def check(state: State) -> dict:
    """The largest absolute difference between a sampled output of the
    window and the plain reference's output for the same item."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state.fn = None
    err = 0.0 if state.kept else float("inf")
    for slot, idx in sorted(state.kept.items()):
        want = state.family.reference(state.cell.config, state.pool[idx])
        err = max(err, max_abs_err(state.slots[slot], want))
        del want
    return {"max_abs_err": (err, state.cell.config["limits"]["max_abs_err"])}


def close(state: State) -> None:
    state.pool.clear()
