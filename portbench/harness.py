"""The benchmark's harness: one cell of BENCHMARK.json, run once.

Everything a cell is made of is found by its name, so that a cell, a
configuration, a traffic mix or a per-layer metric is added with new files
and new entries in BENCHMARK.json, never by an edit here:

  BENCHMARK.json's "configs"[].file   the configuration (sizes, parameters,
                                      the limits of its comparison)
  portbench/traffic/<traffic>.json    the traffic mix; its "feed" names
  portbench/feeds/<feed>.py           the loop that offers it to the program
  portbench/families/<family>.py      the configuration's "family": its
                                      inputs, the program's entry, the plain
                                      reference and the step's work
  portbench/metrics/<metric>.py       one reader a per-layer metric

A feed module has setup(cell, family, seed, device, variant) -> state,
measure(state, seconds, trace) -> Window, check(state) -> {name: (value,
limit)} and close(state). A metric module has read(reading) -> float or
None (nothing to read).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

from . import trace as trace_mod
from .guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[1]
WINDOW_SPAN = "portbench.window"
STEP_SPAN = "portbench.step"
VARIANTS = ("program", "control")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict       # the configuration's file, with its "name"
    traffic: dict      # the traffic mix's file, with its "name"
    end_to_end: list   # BENCHMARK.json's entries that this cell reports
    per_layer: list


@dataclasses.dataclass
class Window:
    """What a feed measured: frames whose output was complete, the
    window's seconds on the host's clock (from its start to the last
    frame's output), and, where the feed has them, each frame's device
    time, the program's own timing totals, the memory it took and the
    trace's path."""

    frames: int
    seconds: float
    frame_ms: Optional[list] = None
    session: Optional[dict] = None
    peak_work_bytes: Optional[int] = None
    memory_peak_bytes: Optional[int] = None
    trace_path: Optional[str] = None


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader gets from a traced run."""

    family: str
    frames: int
    window: tuple          # (start, end) of the window span, microseconds
    steps: list            # (start, end) of every step span
    trace: trace_mod.Trace
    step_work: tuple       # (bytes, operations) of one step
    session: Optional[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file at path, loaded as a module (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def part(root: Path, kind: str, name: str, suffix: str) -> Path:
    return root / "portbench" / kind / f"{name}{suffix}"


def find_cell(root: Path, name: str) -> Cell:
    """The cell `name` of root's BENCHMARK.json, with its configuration and
    traffic read, and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(root / configs[w["config"]]["file"]), name=w["config"])
    traffic = dict(load_json(part(root, "traffic", w["traffic"], ".json")), name=w["traffic"])

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def family(root: Path, cell: Cell):
    return load_module(part(root, "families", cell.config["family"], ".py"),
                       f"portbench_family_{cell.config['family']}")


def feed(root: Path, cell: Cell):
    return load_module(part(root, "feeds", cell.traffic["feed"], ".py"),
                       f"portbench_feed_{cell.traffic['feed']}")


def metric(root: Path, name: str):
    return load_module(part(root, "metrics", name, ".py"),
                       "portbench_metric_" + name.replace(".", "_").replace("-", "_"))


class Reservoir:
    """A uniform sample of k of the window's frames, drawn from the seed as
    the frames come (reservoir sampling): slot(i) is the slot that frame i
    takes, or None."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = np.random.default_rng([seed % 2**63, 1])

    def slot(self, i: int) -> Optional[int]:
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


@contextlib.contextmanager
def profiled(trace: bool, device):
    """A torch.profiler session of the host and, on a card, the device,
    while trace is set; yields a function that writes the trace and
    returns its path (under TMPDIR), or None."""
    import torch

    if not trace:
        yield lambda: None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        holder = {}
        yield lambda: holder.get("path")
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    holder["path"] = path


class Memory:
    """The card memory a window takes beyond what is held at its start
    (peak allocated less allocated then), and the process's peak."""

    def __init__(self, device) -> None:
        import torch

        self.cuda = torch.device(device).type == "cuda"
        if self.cuda:
            torch.cuda.synchronize()
            self.before_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            self.base = torch.cuda.memory_allocated()

    def close(self, window: Window) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            window.peak_work_bytes = peak - self.base
            window.memory_peak_bytes = max(self.before_peak, peak)


def nvidia_smi() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().splitlines()[0]


def kernel_library(log) -> None:
    """Build or find the port's kernel library, and say which."""
    from image_denoising_filter_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, text = _build.build()
    _build.library()
    log(f"kernel library {path.parent.name}: "
        + (f"built cold in {time.perf_counter() - t0:.3f} s" if text else "found built"))


def end_to_end(cell: Cell, window: Window, setup_s: float) -> dict:
    """The cell's end-to-end metrics from the window. A metric's name is its
    quantity, with a suffix after a dot where cells of another kind report
    the quantity under a bound of their own (frames_per_s.files)."""
    values = {
        "frames_per_s": window.frames / window.seconds,
        "setup_s": setup_s,
        "frame_ms_p95": None if not window.frame_ms else p95(window.frame_ms),
        "peak_work_mib": None if window.peak_work_bytes is None
        else window.peak_work_bytes / 2**20,
    }
    out = {}
    for m in cell.end_to_end:
        value = values[m["name"].split(".")[0]]
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value with at least
    95% of all values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, -(-95 * len(ordered) // 100) - 1)]


def per_layer(root: Path, cell: Cell, reading: Reading) -> dict:
    out = {}
    for m in cell.per_layer:
        value = metric(root, m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(root: Path, cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print, variant: str = "program") -> dict:
    """Run the cell once on `device` and return its result: the contract's
    keys, the numbers compared under "checks" (last), and "breakdown" for a
    traced run."""
    import torch

    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}")
    fam, fd = family(root, cell), feed(root, cell)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        kernel_library(log)
    state = fd.setup(cell, fam, seed, device, variant, log)
    try:
        guard()
        setup_s = time.perf_counter() - t_start
        window = fd.measure(state, seconds, trace)
        if cuda:
            log(f"card after the window: {nvidia_smi()}")
        checks = fd.check(state)
    finally:
        fd.close(state)
    guard()
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    result = {
        "correct": correct,
        "attempted": window.frames,
        "failed": 0,
        "metrics": {},
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": cell.chips if cuda else 1,
            "memory_peak_bytes": window.memory_peak_bytes or 0,
        },
    }
    if trace:
        reading = traced_reading(cell, fam, window)
        try:
            busy = trace_mod.busy_ms(reading.trace.device_in(*reading.window)) / 1e3
            result["metrics"] = per_layer(root, cell, reading)
            result["device"]["busy_s"] = busy
            result["device"]["window_s"] = (reading.window[1] - reading.window[0]) / 1e6
            result["breakdown"] = trace_mod.breakdown(reading.trace, reading.window,
                                                      {STEP_SPAN: reading.steps})
        finally:
            os.unlink(window.trace_path)
    else:
        result["metrics"] = end_to_end(cell, window, setup_s)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def traced_reading(cell: Cell, fam, window: Window) -> Reading:
    tr = trace_mod.read_trace(window.trace_path, (WINDOW_SPAN, STEP_SPAN))
    (win,) = tr.spans[WINDOW_SPAN]
    return Reading(family=cell.config["family"], frames=window.frames,
                   window=win, steps=tr.spans.get(STEP_SPAN, []), trace=tr,
                   step_work=fam.step_work(cell.config), session=window.session)


class ForbiddenImport(RuntimeError):
    pass


def guard() -> None:
    """Raise ForbiddenImport where this process holds JAX or the JAX
    package."""
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(f"the run imported {', '.join(found)}: the benchmark measures "
                              "the PyTorch port alone")


def emit(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
