"""Timing report: per-run transfer vs execution time, like the reference.

The reference accumulates two counters per run from Vulkan timestamp queries --
exec ns (dispatch) and transfer ns (buffer copies) -- and prints them in green
(PRINT_TIME, src/main.cpp:21-23, 1924-1927, 1095-1102); the CPU path prints
wall-clock seconds via a chrono Timer (src/timer.hpp:6-28, PRINT_TIME2
src/main.cpp:1929-1933).

On the card the session segments device time from host<->device transfer
time around `torch.cuda.synchronize`: transfers are the timed uploads and
readbacks, execution is the timed kernel work. Both are monotonic-clock ns.

Spans and counters. `span(name)` times one stretch of the host's work. While
a torch profiler records, it also opens `torch.profiler.record_function(name)`,
so the stretch lies in the profiler's trace on the clock of the device's
kernels and copies, and adds its host ns and a count to `totals`; `count(name)`
adds to a counter there. With no profiler on, a span costs one profiler check
and two clock reads, and `totals` is left alone. `totals` holds only the last
profiled stretch: the first span or count that finds a profiler recording
after one that found none clears it. A span nested in an open span of the
same layer (its name up to the last dot) is taken out of the outer one's
total, as a transfer is taken out of exec, so the spans of one layer are
disjoint. Spans open and close on the thread that runs the Session.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

_FG = "\033[32m"  # green foreground, like the reference's ANSI codes
_BG = "\033[40m"
_CLEAR = "\033[0m"

# The Session's phases (runtime/session.py, runtime/prefetch.py) and the
# models' forward (models/denoiser.py), as a trace and `totals` name them.
SESSION = "idf.session."
OPEN = SESSION + "open"          # Session construction: the device, the mesh
LOAD = SESSION + "load"          # a frame's cache lookup and, on a miss, its decode or wait
UPLOAD = SESSION + "upload"      # host -> device, a TimingReport transfer
WARMUP = SESSION + "warmup"      # the untimed model run before exec
EXEC = SESSION + "exec"          # TimingReport.execute (the CPU filter in run_cpu)
READBACK = SESSION + "readback"  # device -> host, a TimingReport transfer
SAVE = SESSION + "save"          # quantize, encode and write the output
FORWARD = "idf.model.forward"
CACHE_HIT = "frame_cache.hit"    # counters of the Session's cache lookups (prefetch.RunFrames)
CACHE_MISS = "frame_cache.miss"
DECODES_AHEAD = "session.decodes_ahead"  # a run's misses sent to the native decode threads
PNG_BANDS = "png_encode.bands"   # row bands of png.encode_bands, the PNG save
# The overlap loop's FramePrefetcher (runtime/prefetch.py): a layer of its
# own, so its spans, which lie inside the Session's load, upload and exec,
# are not taken out of them.
PREFETCH = "idf.prefetch."
PREFETCH_WAIT = PREFETCH + "wait"    # the loop's thread waiting for a decoded miss
PREFETCH_PIN = PREFETCH + "pin"      # a frame's copy into pinned staging (CUDA only)
PREFETCH_FRAMES = "prefetch.frames"  # frames the prefetcher hands out
PREFETCH_CACHE_HIT = "prefetch.cache_hit"    # window items served without a decode
PREFETCH_CACHE_MISS = "prefetch.cache_miss"  # window items sent to the decoder
# The layers config's G-buffer layers (Session._run_layers): a layer of its
# own, so its spans, which hold the Session's load and lie inside its
# upload, are not taken out of them.
LAYERS = "idf.layers."
LAYERS_LOAD = LAYERS + "load"      # the wait for the target's layers and their copy into a stack
LAYERS_UPLOAD = LAYERS + "upload"  # the stacked layers' host -> device copy
LAYERS_LOADED = "layers.loaded"    # layers handed to the model
# The EXR codec (utils/imageio.py), native or Python: a layer of its own, so
# its spans, which lie inside the Session's load and save, are not taken out
# of them.
EXR = "idf.exr."
EXR_ENCODE = EXR + "encode"        # a frame's encode to EXR bytes (the file write is outside)
EXR_DECODE = EXR + "decode"        # a file's decode on the calling thread
EXR_BYTES = "exr_encode.bytes"     # bytes of the encoded files

# name -> [host ns, count] of the last profiled stretch (a counter's ns is 0).
totals: dict[str, list[int]] = {}
_profiled = False  # whether the last span or count found a profiler recording
_open: list = []   # [name, layer, ns of nested spans of its layer] of open spans


def _recording() -> bool:
    global _profiled
    on = torch.autograd._profiler_enabled()
    if on and not _profiled:
        totals.clear()
    _profiled = on
    return on


class Span:
    """One timed stretch of the host's work (the module docstring); `ns` is
    its host time once it has closed."""

    __slots__ = ("name", "ns", "_t0", "_record")

    def __init__(self, name: str) -> None:
        self.name = name
        self.ns = 0
        self._record = None

    def __enter__(self) -> Span:
        if _recording():
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
            _open.append([self.name, self.name.rpartition(".")[0], 0])
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.ns = time.perf_counter_ns() - self._t0
        if self._record is None:
            return
        name, layer, nested = _open.pop()
        total = totals.setdefault(name, [0, 0])
        total[0] += self.ns - nested
        total[1] += 1
        for outer in reversed(_open):
            if outer[1] == layer:
                outer[2] += self.ns
                break
        self._record.__exit__(*exc)
        self._record = None


def span(name: str) -> Span:
    """A context manager that times the host's work under `name`."""
    return Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` in totals while a profiler records."""
    if _recording():
        totals.setdefault(name, [0, 0])[1] += n


class Timer:
    """Wall-clock timer (src/timer.hpp:6-28 analog)."""

    def __init__(self) -> None:
        self._start = time.perf_counter()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start


@dataclasses.dataclass
class TimingReport:
    """Accumulated transfer/exec ns for one run (m_transferTimeElapsed /
    m_execTimeElapsed analogs, src/main.cpp:81-86).

    The two counters are DISJOINT by construction, like the reference's
    timestamp intervals (exec = t1-t0, transfer = t2-t1, src/main.cpp:
    1095-1102): a transfer() region entered while an execute() region is open
    (e.g. the prefetcher uploading frame k+1 under frame k's kernel) is
    credited to transfer_ns and subtracted from the enclosing exec_ns.
    Each region is a span: transfer(UPLOAD or READBACK), execute() EXEC."""

    transfer_ns: int = 0
    exec_ns: int = 0
    _exec_depth: int = dataclasses.field(default=0, repr=False, compare=False)

    @contextlib.contextmanager
    def transfer(self, name: str):
        s = Span(name)
        try:
            with s:
                yield
        finally:
            self.transfer_ns += s.ns
            if self._exec_depth > 0:
                self.exec_ns -= s.ns

    @contextlib.contextmanager
    def execute(self):
        self._exec_depth += 1
        s = Span(EXEC)
        try:
            with s:
                yield
        finally:
            self._exec_depth -= 1
            self.exec_ns += s.ns

    def print(self) -> None:
        """PRINT_TIME format (src/main.cpp:1924-1927)."""
        print(
            f"{_FG}{_BG}transfer time: {self.transfer_ns}ns; "
            f"execution time: {self.exec_ns}ns\n{_CLEAR}"
        )


def print_cpu_time(timer: Timer) -> None:
    """PRINT_TIME2 format (src/main.cpp:1929-1933)."""
    print(f"{_FG}{_BG}Time taken: {timer.elapsed()} sec\n{_CLEAR}")
    timer.reset()
