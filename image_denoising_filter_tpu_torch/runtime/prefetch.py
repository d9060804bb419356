"""Double-buffered host-to-device frame streaming: the copy/compute overlap.

Counterpart of image_denoising_filter_tpu/runtime/prefetch.py. The reference
overlaps the copy of frame k+1 with the NLM dispatch on frame k
(src/main.cpp:889-989, 1554-1572; README.md:43-51). On a CUDA device the
uploads run from pinned host memory with `non_blocking=True` on a side
stream, so they proceed under the kernels of the consumer stream; each frame
is handed out only after the consumer stream has been made to wait on its
upload's event.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils import native
from ..utils.timing import TimingReport


class FramePrefetcher:
    """Iterate device-resident frames with `depth` uploads in flight.

    loader: maps an item (e.g. a file path) to a host (H, W, 4) float32
    array. Uploads are timed into `report.transfer` when a TimingReport is
    given (the upload issue; on CUDA the copy itself runs asynchronously).
    On a CPU device the frames are plain host tensors.

    native_paths: the items are file paths, decoded ahead of use on the
    native library's C++ worker threads (utils/native.FrameLoader). On a
    CUDA device that loader or an error; on a CPU device without a native
    library, `loader` on this thread. `loader` says which ran: "native" or
    "python".
    """

    def __init__(
        self,
        items: Iterable,
        loader: Callable[[object], np.ndarray],
        device: torch.device | str,
        depth: int = 2,
        report: Optional[TimingReport] = None,
        native_paths: bool = False,
    ) -> None:
        self._items = list(items)
        self._loader = loader
        self._device = torch.device(device)
        self._depth = max(1, depth)
        self._report = report
        self._stream = (
            torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        )
        self._native = None
        self.loader = "python"
        if native_paths:
            try:
                self._native = native.FrameLoader(self._items, lookahead=self._depth + 2)
                self.loader = "native"
            except (ImportError, OSError):
                if self._device.type == "cuda":
                    raise

    def _host(self, idx: int) -> np.ndarray:
        if self._native is not None:
            return self._native.get(idx)
        return self._loader(self._items[idx])

    def _copy(self, host: torch.Tensor):
        if self._stream is None:
            return host.to(self._device), None
        # The caching host allocator keeps each pinned block alive until the
        # copy that reads it has finished, so the block can be dropped here.
        pinned = host.pin_memory()
        with torch.cuda.stream(self._stream):
            dev = pinned.to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _upload(self, idx: int):
        """Decode frame idx (untimed, like the JAX prefetcher) and issue its
        upload (timed as transfer)."""
        host = torch.from_numpy(np.ascontiguousarray(self._host(idx), np.float32))
        if self._report is None:
            return self._copy(host)
        with self._report.transfer():
            return self._copy(host)

    def __iter__(self) -> Iterator[torch.Tensor]:
        pending = []
        n = len(self._items)
        for i in range(min(self._depth, n)):
            pending.append(self._upload(i))
        for i in range(n):
            if i + self._depth < n:
                pending.append(self._upload(i + self._depth))
            dev, done = pending.pop(0)
            if done is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(done)
                # the tensor was allocated on the side stream but is used
                # (and freed) on the consumer stream
                dev.record_stream(consumer)
            yield dev

    def __len__(self) -> int:
        return len(self._items)
