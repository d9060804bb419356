"""A Session run's loads through prefetch.RunFrames: the run's cache misses
decode together on the native library's decode threads (or on the loop's
thread where no library is loaded, or for a single miss), and the layers
land straight in the stacked upload's buffer. Held against the loads as a
run's Session._load calls made them, one file at a time: the same images
and PNG bytes, the same cache counters and the same cache afterwards (but
for a run whose own misses would evict one of its later hits: the run holds
it, and decodes one file fewer); the counter session.decodes_ahead, the
native decoder's fallback, and the bound on the frames decoded ahead of a
long window."""

import os
import struct
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import (
    LayersParams,
    NlmParams,
    RunConfig,
)
from image_denoising_filter_tpu_torch.runtime import Session, prefetch
from image_denoising_filter_tpu_torch.runtime import session as session_mod
from image_denoising_filter_tpu_torch.utils import dataset, imageio, native, png, timing

torch.set_num_threads(1)

LAYERS = RunConfig(use_layers=True)
MULTIFRAME = RunConfig(nlm=True, multiframe=True)
BATCHED = "batched"  # MULTIFRAME with batch_frames
SINGLE = RunConfig()
PARAMS = dict(layers_params=LayersParams(radius=2),
              nlm_params=NlmParams(search_radius=2, patch_radius=1))
N_FRAMES, H, W = 5, 20, 28
LAYER_NAMES = ("albedo", "normal", "depth")
TARGETS = (1, 2)  # the frames with layers, run in turn on one cache


def _frame(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.1, 0.9, (H, W, 4)).astype(np.float32)
    img[..., 3] = 1.0
    return img


def _rgba16_png(img: np.ndarray) -> bytes:
    """img as a 16-bit RGBA PNG (colour type 6), which the native decoder
    refuses and the Python codec reads (its high bytes)."""
    px = np.round(img * 65535).astype(">u2")
    lines = b"".join(b"\0" + row.tobytes() for row in px)
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 16, 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(lines)) + png._chunk(b"IEND", b""))


def _write_shot(root, rgba16_layer=None):
    """N_FRAMES frames, and three layers for each of TARGETS; the paths of
    the frames. rgba16_layer: a layer name written as 16-bit PNGs."""
    (root / "RenderElements").mkdir(parents=True)
    paths = []
    for i in range(N_FRAMES):
        paths.append(str(root / f"frame_{i:04d}.png"))
        imageio.save(paths[-1], _frame(i))
    for t in TARGETS:
        for j, name in enumerate(LAYER_NAMES):
            path = root / "RenderElements" / f"{name}_{t:04d}.png"
            if name == rgba16_layer:
                path.write_bytes(_rgba16_png(_frame(10 * t + j)))
            else:
                imageio.save(str(path), _frame(10 * t + j))
    return paths


@pytest.fixture(scope="module")
def shot(tmp_path_factory):
    return _write_shot(tmp_path_factory.mktemp("shot"))


@pytest.fixture(scope="module")
def native_root(tmp_path_factory):
    if native._cxx() is None:
        pytest.skip("no C++ compiler found (set CXX or put g++ on PATH)")
    path = tmp_path_factory.mktemp("native_root")
    native.build(path)
    return path


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """No native library loaded or found: the process's library is left as
    it was found."""
    monkeypatch.setattr(native, "_loaded", native._Loaded())
    monkeypatch.delenv("IDF_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "MAKE_LIB", tmp_path / "no_make" / native.LIB_NAME)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "no_build")


@pytest.fixture
def with_library(no_library, native_root):
    native.ensure(native_root)


@pytest.fixture(params=["python", "native"])
def loader(request, no_library):
    if request.param == "native":
        native.ensure(request.getfixturevalue("native_root"))
    return request.param


@pytest.fixture(autouse=True)
def profiler_off():
    """A count with no profiler on, so that a test's first profiled span
    starts a new stretch whatever ran before it in this process."""
    timing.count("tests.profiler_off")


@pytest.fixture
def threads_started(monkeypatch):
    """The (paths, lookahead, threads) of each native.FrameLoader made from
    here on."""
    made = []

    class Spied(native.FrameLoader):
        def __init__(self, paths, lookahead=4, threads=4):
            made.append((list(paths), lookahead, threads))
            super().__init__(paths, lookahead=lookahead, threads=threads)

    monkeypatch.setattr(native, "FrameLoader", Spied)
    return made


class SerialFrames:
    """The loads as a run made them before RunFrames (Session._load one file
    at a time, in the run's order): a cache lookup, counted, and on a miss
    imageio.load on this thread and an insert; the layers stacked from the
    frames."""

    def __init__(self, paths, cache):
        self._paths = iter(paths)
        self._cache = cache

    def take(self, out=None):
        entry = _serial_load(next(self._paths), self._cache)
        if out is not None:
            np.copyto(out, entry.img)
        return entry

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def _serial_load(path, cache):
    with timing.span(timing.LOAD):
        if cache is None:
            return prefetch.DecodedFrame(imageio.load(path)[0])
        entry = prefetch.cache_lookup(cache, path)
        if entry is not None:
            timing.count(timing.CACHE_HIT)
            return entry
        timing.count(timing.CACHE_MISS)
        entry = prefetch.DecodedFrame(imageio.load(path)[0])
        prefetch.cache_insert(cache, path, entry)
        return entry


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _counters():
    return {name: timing.totals.get(name, [0, 0])[1]
            for name in (timing.CACHE_HIT, timing.CACHE_MISS, timing.DECODES_AHEAD)}


def _cfg(kind):
    return {"layers": LAYERS, "multiframe": MULTIFRAME, BATCHED: MULTIFRAME,
            "single": SINGLE}[kind]


def _run_targets(shot, out, kind, cache, warm):
    """Session.run of each of TARGETS in turn on one cache, after
    the serial loads of the `warm` paths into it, each target under a
    profiler of its own: for each, the saved PNG's bytes, the image read
    back and the run's counters; then the cache's keys in order."""
    for path in warm:
        _serial_load(path, cache)
    runs = []
    for t in TARGETS:
        (out / str(t)).mkdir(parents=True)
        timing.count("tests.profiler_off")
        with _profiler():
            result = Session(shot[t], device="cpu", output_dir=str(out / str(t)), **PARAMS,
                             frame_cache=cache, batch_frames=kind == BATCHED).run(_cfg(kind))
        with open(result.output_path, "rb") as f:
            runs.append((f.read(), result.image.tobytes(), _counters()))
    return runs, list(cache)


def _run_paths(target, kind):
    """The paths a run of `kind` hands to RunFrames, in order."""
    cfg = _cfg(kind)
    ds = dataset.discover(target, multiframe=cfg.multiframe, use_layers=cfg.use_layers)
    others = ds.layers if cfg.use_layers else ds.frames if cfg.multiframe else []
    return [ds.target, *others]


def _warm(shot, kind):
    """A layer of the first target and the frame after it: a shot whose
    runs mix hits and misses."""
    layer = _run_paths(shot[TARGETS[0]], "layers")[1]
    return [layer, shot[TARGETS[0] + 1]] if kind == "layers" else [shot[TARGETS[0] + 1]]


@pytest.mark.parametrize("kind", ["layers", "multiframe", BATCHED])
def test_a_run_loads_as_one_file_at_a_time_did(shot, tmp_path, monkeypatch, loader, kind):
    """Each target's PNG bytes and image, its cache hits and misses, and the
    cache's keys in order afterwards, as with Session._load one file at a
    time; session.decodes_ahead counts a run's distinct misses where the
    native threads decode them, two or more, and is 0 on the Python path."""
    warm = _warm(shot, kind)
    cache: dict = {}
    for path in warm:
        _serial_load(path, cache)
    misses = []
    for t in TARGETS:
        paths = _run_paths(shot[t], kind)
        misses.append(len({p for p in paths if p not in cache}))
        for p in paths:
            cache[p] = None
    got, got_keys = _run_targets(shot, tmp_path / "ahead", kind, {}, warm)
    monkeypatch.setattr(session_mod, "RunFrames", SerialFrames)
    want, want_keys = _run_targets(shot, tmp_path / "serial", kind, {}, warm)
    assert got_keys == want_keys
    for (g_png, g_img, g_count), (w_png, w_img, w_count), n in zip(got, want, misses):
        assert g_png == w_png and g_img == w_img
        assert g_count[timing.CACHE_HIT] == w_count[timing.CACHE_HIT]
        assert g_count[timing.CACHE_MISS] == w_count[timing.CACHE_MISS]
        assert g_count[timing.DECODES_AHEAD] == (n if loader == "native" and n > 1 else 0)
        assert w_count[timing.DECODES_AHEAD] == 0
    assert any(n > 1 for n in misses)


@pytest.mark.parametrize("kind, warm", [("single", False), ("layers", True)],
                         ids=["single_frame", "layers_cached"])
def test_a_single_miss_starts_no_threads(shot, tmp_path, with_library, threads_started,
                                         kind, warm):
    """One miss (a single-frame config's target, or a target whose layers
    are all cached) decodes on the loop's thread: no loader, no count."""
    cache: dict = {}
    paths = _run_paths(shot[TARGETS[0]], kind)
    if warm:
        for p in paths[1:]:
            _serial_load(p, cache)
    with _profiler():
        Session(shot[TARGETS[0]], device="cpu", output_dir=str(tmp_path), **PARAMS,
                frame_cache=cache).run(_cfg(kind))
    assert threads_started == []
    assert _counters()[timing.CACHE_MISS] == 1
    assert timing.DECODES_AHEAD not in timing.totals


def test_the_python_path_starts_no_threads(shot, tmp_path, loader, threads_started):
    with _profiler():
        Session(shot[TARGETS[0]], device="cpu", output_dir=str(tmp_path), **PARAMS,
                frame_cache={}).run(LAYERS)
    assert len(threads_started) == (1 if loader == "native" else 0)
    if loader == "native":
        assert threads_started[0][0] == _run_paths(shot[TARGETS[0]], "layers")
        n = min(4, len(os.sched_getaffinity(0)))
        assert threads_started[0][1:] == (n, n)
    assert timing.totals.get(timing.DECODES_AHEAD, [0, 0])[1] == (4 if loader == "native" else 0)


def test_a_16bit_layer_falls_back_to_the_python_codec(tmp_path, monkeypatch, with_library):
    """A layer the native decoder refuses (16-bit) is read on the loop's
    thread by imageio.load; the run saves what the serial loads save."""
    shot = _write_shot(tmp_path / "shot", rgba16_layer="normal")
    target = shot[TARGETS[0]]
    layer, = [p for p in _run_paths(target, "layers") if "normal" in p]
    with pytest.raises(ValueError):
        native.png_decode(Path(layer).read_bytes())
    loads = []
    load = imageio.load
    monkeypatch.setattr(imageio, "load", lambda p: loads.append(p) or load(p))
    cache: dict = {}
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with _profiler():
        got = Session(target, device="cpu", output_dir=str(tmp_path / "a"), **PARAMS,
                      frame_cache=cache).run(LAYERS)
    assert loads == [layer]
    assert timing.totals[timing.DECODES_AHEAD][1] == 4
    np.testing.assert_array_equal(cache[layer].img, load(layer)[0])
    monkeypatch.setattr(session_mod, "RunFrames", SerialFrames)
    want = Session(target, device="cpu", output_dir=str(tmp_path / "b"), **PARAMS,
                   frame_cache={}).run(LAYERS)
    assert got.image.tobytes() == want.image.tobytes()
    with open(got.output_path, "rb") as a, open(want.output_path, "rb") as b:
        assert a.read() == b.read()


def test_a_long_window_holds_at_most_lookahead_frames_ahead(tmp_path, monkeypatch,
                                                            with_library, threads_started):
    """Twelve misses on a host of three cores: one loader of three threads
    and three frames ahead. With the files past the window renamed away
    while the first frame is taken, no decode thread reaches them (a
    thread that did would fail, and the frame would fall back to
    imageio.load); every frame is imageio.load's, in order."""
    paths = []
    for i in range(12):
        paths.append(str(tmp_path / f"frame_{i:04d}.png"))
        imageio.save(paths[-1], _frame(100 + i))
    want = [imageio.load(p)[0] for p in paths]
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2})
    loads = []
    load = imageio.load
    monkeypatch.setattr(imageio, "load", lambda p: loads.append(p) or load(p))
    beyond = paths[1 + 3:]
    for p in beyond:
        os.rename(p, p + "-away")
    with prefetch.RunFrames(paths, {}) as frames:
        got = [frames.take().img]
        time.sleep(0.3)
        for p in beyond:
            os.rename(p + "-away", p)
        got += [frames.take().img for _ in paths[1:]]
    assert threads_started == [(paths, 3, 3)]
    assert loads == []
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_repeats_decode_once_and_layers_land_in_their_slots(shot, with_library,
                                                            threads_started):
    """A path that recurs is decoded once and handed out again; frames taken
    into slots of one buffer are cached as views of it, a hit copied into
    its slot."""
    a, b, c = shot[0], shot[1], shot[2]
    cache: dict = {}
    _serial_load(c, cache)
    buf = np.zeros((3, H, W, 4), np.float32)
    with prefetch.RunFrames([a, b, a, c], cache) as frames:
        first = frames.take()
        for slot in buf:
            frames.take(out=slot)
    assert threads_started[0][0] == [a, b]
    for slot, path in zip(buf, (b, a, c)):
        np.testing.assert_array_equal(slot, imageio.load(path)[0])
    assert np.shares_memory(cache[b].img, buf) and cache[a] is first
    assert not np.shares_memory(cache[c].img, buf)
    assert list(cache) == [b, a, c]


def test_frame_loader_get_into_a_slot(tmp_path, with_library):
    """get(i, out) copies frame i into out and returns it; a frame that fails
    to decode is released, so the next get still runs."""
    paths = [str(tmp_path / f"f{i}.png") for i in range(3)]
    for i, p in enumerate(paths):
        imageio.save(p, _frame(50 + i))
    Path(paths[1]).write_bytes(_rgba16_png(_frame(51)))
    loader = native.FrameLoader(paths, lookahead=3, threads=3)
    try:
        out = np.empty((H, W, 4), np.float32)
        assert loader.get(0, out) is out
        np.testing.assert_array_equal(out, imageio.load(paths[0])[0])
        with pytest.raises(ValueError, match="decode failed"):
            loader.get(1, out)
        np.testing.assert_array_equal(loader.get(2), imageio.load(paths[2])[0])
    finally:
        loader.close()


def test_a_run_holds_a_hit_its_own_misses_would_evict(shot, no_library):
    """A cache full to FRAME_CACHE_MAX whose least recent entry is a path of
    the run, after a miss: loads one file at a time evict it with the
    miss's insert and decode it again; the run holds it from its lookup, so
    it decodes one file fewer and counts a hit more, and the cache ends the
    same."""
    a, b = shot[0], shot[1]

    def full_cache():
        cache: dict = {}
        _serial_load(b, cache)
        for k in range(prefetch.FRAME_CACHE_MAX - 1):
            prefetch.cache_insert(cache, f"other_{k}", prefetch.DecodedFrame(np.zeros((1, 1, 4))))
        return cache

    counts, keys = [], []
    for frames_of in (prefetch.RunFrames, SerialFrames):
        cache = full_cache()
        timing.count("tests.profiler_off")
        with _profiler(), frames_of([a, b], cache) as frames:
            got = [frames.take().img for _ in range(2)]
        counts.append(_counters())
        keys.append(list(cache))
        for g, path in zip(got, (a, b)):
            np.testing.assert_array_equal(g, imageio.load(path)[0])
    assert counts[0][timing.CACHE_HIT] == 1 and counts[0][timing.CACHE_MISS] == 1
    assert counts[1][timing.CACHE_HIT] == 0 and counts[1][timing.CACHE_MISS] == 2
    assert keys[0] == keys[1]
