"""Double-buffered host-to-device frame streaming: the copy/compute overlap.

Counterpart of image_denoising_filter_tpu/runtime/prefetch.py. The reference
overlaps the copy of frame k+1 with the NLM dispatch on frame k
(src/main.cpp:889-989, 1554-1572; README.md:43-51). On a CUDA device the
uploads run from pinned host memory with `non_blocking=True` on a side
stream, so they proceed under the kernels of the consumer stream; each frame
is handed out only after the consumer stream has been made to wait on its
upload's event.

The decoded-frame cache that a Session may share across targets (a dict,
path -> DecodedFrame, least recent first) keeps one policy, `cache_lookup`
and `cache_insert`, for the Session's loads (`RunFrames`, which decodes a
run's misses together on the native decode threads) and the prefetcher's
window.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..utils import imageio, native, timing
from ..utils.timing import TimingReport

FRAME_CACHE_MAX = 32  # decoded frames a shared cache keeps


class DecodedFrame:
    """A decoded (H, W, 4) float32 frame `img`, as the cache keeps it, and
    whether its alpha is one constant (a NaN alpha is not): scanned at the
    first ask and kept with the frame, so each decode is scanned at most
    once. Reads as its frame where an array is expected."""

    def __init__(self, img: np.ndarray) -> None:
        self.img = img

    @functools.cached_property
    def uniform_alpha(self) -> bool:
        a = self.img[..., 3]
        return bool(a.min() == a.max())

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        return np.array(self.img, dtype=dtype, copy=copy)


def cache_lookup(cache: dict, key) -> Optional[DecodedFrame]:
    """The frame cached under key, touched as the most recent; None on a miss."""
    img = cache.pop(key, None)
    if img is not None:
        cache[key] = img
    return img


def cache_insert(cache: dict, key, entry: DecodedFrame) -> None:
    """Cache entry under key as the most recent, evicting the least recent
    frames beyond FRAME_CACHE_MAX."""
    cache.pop(key, None)
    cache[key] = entry
    while len(cache) > FRAME_CACHE_MAX:
        cache.pop(next(iter(cache)))


class RunFrames:
    """The decoded frames of one Session run, handed out in order by `take`.

    At the first take each path is looked up in the shared cache (None: no
    cache, every path misses uncounted), in order, and counted as CACHE_HIT
    or CACHE_MISS; a hit's frame is held from then on, and a repeat of a
    path is served by its first occurrence, as a hit. Where a native library
    is loaded and two or more distinct paths miss, they all decode at once
    on one native.FrameLoader, one thread a host core and as many frames
    ahead (DECODES_AHEAD counts them); a single miss, or every miss where no
    library is loaded, decodes on the loop's thread, as does a file the
    native decoder refuses (imageio.load's Python codec reads it). Each
    frame is (re)inserted into the cache as it is handed out, so the cache
    ends in the order that looking the paths up one at a time leaves. The
    waits lie in LOAD spans, one a take. Close it (or use it as a context
    manager) to stop the decode threads."""

    def __init__(self, paths: Iterable, cache: Optional[dict]) -> None:
        self._paths = list(paths)
        self._cache = cache
        self._last = {path: i for i, path in enumerate(self._paths)}
        self._held: dict = {}    # path -> DecodedFrame: the hits, and misses that recur
        self._misses: dict = {}  # path -> its place among the distinct misses
        self._native = None
        self._next = 0

    def _start(self) -> None:
        for path in self._paths:
            if path not in self._held and path not in self._misses:
                entry = None if self._cache is None else cache_lookup(self._cache, path)
                if entry is None:
                    self._misses[path] = len(self._misses)
                    if self._cache is not None:
                        timing.count(timing.CACHE_MISS)
                    continue
                self._held[path] = entry
            if self._cache is not None:
                timing.count(timing.CACHE_HIT)
        if len(self._misses) > 1 and native.available():
            n = min(len(self._misses), len(os.sched_getaffinity(0)))
            self._native = native.FrameLoader(list(self._misses), lookahead=n, threads=n)
            timing.count(timing.DECODES_AHEAD, len(self._misses))

    def _decode(self, path, out: Optional[np.ndarray]) -> np.ndarray:
        if self._native is not None:
            try:
                return self._native.get(self._misses[path], out)
            except ValueError:
                pass  # the native decoder refuses the file
        img = imageio.load(path)[0]
        if out is None:
            return img
        np.copyto(out, img)
        return out

    def take(self, out: Optional[np.ndarray] = None) -> DecodedFrame:
        """The run's next frame, its array copied into `out` (an (H, W, 4)
        float32 slot) where given; a miss decoded there is cached as a view
        of it."""
        with timing.span(timing.LOAD):
            if self._next == 0:
                self._start()
            i, self._next = self._next, self._next + 1
            path = self._paths[i]
            entry = self._held.pop(path, None)
            if entry is None:
                entry = DecodedFrame(self._decode(path, out))
            elif out is not None:
                np.copyto(out, entry.img)
            if self._last[path] > i:
                self._held[path] = entry
            if self._cache is not None:
                cache_insert(self._cache, path, entry)
            return entry

    def close(self) -> None:
        self._held.clear()
        if self._native is not None:
            self._native.close()
            self._native = None

    def __enter__(self) -> RunFrames:
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FramePrefetcher:
    """Iterate device-resident frames with `depth` uploads in flight.

    loader: maps an item (e.g. a file path) to a host (H, W, 4) float32
    array. Uploads are timed into `report.transfer` when a TimingReport is
    given (the upload issue; on CUDA the copy itself runs asynchronously).
    On a CPU device the frames are plain host tensors.

    native_paths: the items are file paths, decoded ahead of use on the
    native library's C++ worker threads (utils/native.FrameLoader). On a
    CUDA device that loader or an error; on a CPU device without a native
    library, `loader` on this thread. `loader` says which decodes: "native"
    or "python". The native loader's threads stop when the iteration ends,
    is abandoned or raises, so its frames stream once.

    The window is decoded once an item: a repeated item is served from its
    first occurrence's frame. frame_cache: a decoded-frame cache shared with
    the Session (keyed by item). Each item is looked up there when the
    prefetcher is built, and a hit's frame is held from then on, so a later
    eviction cannot take it. Only the misses are decoded, each distinct item
    once and in window order (the native loader runs over them alone, and
    not at all when every item hits), and each decoded miss is inserted.

    Spans and counters (utils/timing.py): PREFETCH_WAIT while the loop's
    thread waits for a decoded miss, PREFETCH_PIN around the pinned
    staging, PREFETCH_FRAMES once a frame handed out, PREFETCH_CACHE_MISS
    once an item sent to the decoder and PREFETCH_CACHE_HIT once any other
    item (a cached one, or a repeat), so the two sum to the window.
    """

    def __init__(
        self,
        items: Iterable,
        loader: Callable[[object], np.ndarray],
        device: torch.device | str,
        depth: int = 2,
        report: Optional[TimingReport] = None,
        native_paths: bool = False,
        frame_cache: Optional[dict] = None,
    ) -> None:
        self._items = list(items)
        self._loader = loader
        self._device = torch.device(device)
        self._depth = max(1, depth)
        self._report = report
        self._stream = (
            torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        )
        self._cache = frame_cache
        # item -> its frame: the cache's hits from now, a miss once decoded
        self._frames: dict = {}
        self._misses: list = []  # the distinct items to decode, in window order
        for item in self._items:
            if item not in self._frames and item not in self._misses:
                entry = None if frame_cache is None else cache_lookup(frame_cache, item)
                if entry is None:
                    self._misses.append(item)
                    timing.count(timing.PREFETCH_CACHE_MISS)
                    continue
                self._frames[item] = entry.img
            timing.count(timing.PREFETCH_CACHE_HIT)
        self._native = None
        self.loader = "python"
        if native_paths:
            try:
                if self._misses:
                    self._native = native.FrameLoader(self._misses, lookahead=self._depth + 2)
                elif not native.available():
                    raise native.NativeUnavailable("no native library to decode misses")
                self.loader = "native"
            except (ImportError, OSError):
                if self._device.type == "cuda":
                    raise

    def _host(self, idx: int) -> np.ndarray:
        item = self._items[idx]
        img = self._frames.get(item)
        if img is None:
            with timing.span(timing.PREFETCH_WAIT):
                if self._native is not None:
                    img = self._native.get(self._misses.index(item))
                else:
                    img = self._loader(item)
            self._frames[item] = img
            if self._cache is not None:
                cache_insert(self._cache, item, DecodedFrame(img))
        return img

    def _copy(self, host: torch.Tensor):
        if self._stream is None:
            return host.to(self._device), None
        # The caching host allocator keeps each pinned block alive until the
        # copy that reads it has finished, so the block can be dropped here.
        with timing.span(timing.PREFETCH_PIN):
            pinned = host.pin_memory()
        with torch.cuda.stream(self._stream):
            dev = pinned.to(self._device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return dev, done

    def _upload(self, idx: int):
        """Decode frame idx (untimed by the report, like the JAX prefetcher;
        the span LOAD) and issue its upload (timed as transfer)."""
        with timing.span(timing.LOAD):
            host = torch.from_numpy(np.ascontiguousarray(self._host(idx), np.float32))
        if self._report is None:
            return self._copy(host)
        with self._report.transfer(timing.UPLOAD):
            return self._copy(host)

    def __iter__(self) -> Iterator[torch.Tensor]:
        pending = []
        n = len(self._items)
        try:
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
                timing.count(timing.PREFETCH_FRAMES)
                yield dev
        finally:
            self._frames.clear()
            if self._native is not None:
                self._native.close()

    def __len__(self) -> int:
        return len(self._items)
