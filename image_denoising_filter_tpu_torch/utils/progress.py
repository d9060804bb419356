"""Terminal progress bar (the cpptqdm analog, braille theme).

The reference shows braille-themed tqdm bars during image loads and CPU
filtering (src/main.cpp:169-183, 1821-1826; vendored cpptqdm). Disabled
automatically when stdout is not a TTY or IDF_NO_PROGRESS is set.
"""

from __future__ import annotations

import os
import sys
import time

_BRAILLE = " ⡀⡄⡆⡇⣇⣧⣷⣿"


class ProgressBar:
    def __init__(self, label: str = "", width: int = 40) -> None:
        self.label = label
        self.width = width
        self._last = 0.0
        self._enabled = sys.stdout.isatty() and not os.environ.get("IDF_NO_PROGRESS")

    def progress(self, current: int, total: int) -> None:
        if not self._enabled or total <= 0:
            return
        now = time.monotonic()
        if now - self._last < 0.05 and current + 1 < total:
            return
        self._last = now
        frac = min(max(current / total, 0.0), 1.0)
        cells = frac * self.width
        full = int(cells)
        part = int((cells - full) * (len(_BRAILLE) - 1))
        bar = _BRAILLE[-1] * full + (_BRAILLE[part] if full < self.width else "")
        bar = bar.ljust(self.width)
        sys.stdout.write(f"\r{self.label} |{bar}| {frac * 100:5.1f}%")
        sys.stdout.flush()

    def finish(self) -> None:
        if self._enabled:
            self.progress(1, 1)
            sys.stdout.write("\n")
            sys.stdout.flush()
