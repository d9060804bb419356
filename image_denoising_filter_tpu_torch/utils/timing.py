"""Timing report: per-run transfer vs execution time, like the reference.

The reference accumulates two counters per run from Vulkan timestamp queries --
exec ns (dispatch) and transfer ns (buffer copies) -- and prints them in green
(PRINT_TIME, src/main.cpp:21-23, 1924-1927, 1095-1102); the CPU path prints
wall-clock seconds via a chrono Timer (src/timer.hpp:6-28, PRINT_TIME2
src/main.cpp:1929-1933).

On the card the session segments device time from host<->device transfer
time around `torch.cuda.synchronize`: transfers are the timed uploads and
readbacks, execution is the timed kernel work. Both are monotonic-clock ns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

_FG = "\033[32m"  # green foreground, like the reference's ANSI codes
_BG = "\033[40m"
_CLEAR = "\033[0m"


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
    credited to transfer_ns and subtracted from the enclosing exec_ns."""

    transfer_ns: int = 0
    exec_ns: int = 0
    _exec_depth: int = dataclasses.field(default=0, repr=False, compare=False)

    @contextlib.contextmanager
    def transfer(self):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dt = time.perf_counter_ns() - t0
            self.transfer_ns += dt
            if self._exec_depth > 0:
                self.exec_ns -= dt

    @contextlib.contextmanager
    def execute(self):
        self._exec_depth += 1
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._exec_depth -= 1
            self.exec_ns += time.perf_counter_ns() - t0

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
