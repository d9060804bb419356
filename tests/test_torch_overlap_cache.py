"""The overlap loop on the Session's shared decoded-frame cache: the
prefetcher looks each window item up there and decodes only the misses,
each distinct one once, on the native loader where a library is built and
on the loop's thread otherwise. A shot through the cache decodes each file
once and gives every target's image and PNG bytes of the run without it;
the prefetcher's edges (every item cached, repeated misses, no cache, where
a repeat is still decoded once), the cache's bound, its frames left as
decoded, and the prefetcher's counters."""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import NlmParams, RunConfig
from image_denoising_filter_tpu_torch.runtime import FramePrefetcher, Session
from image_denoising_filter_tpu_torch.runtime import prefetch
from image_denoising_filter_tpu_torch.utils import imageio, native, png, timing

torch.set_num_threads(1)

OVERLAP = RunConfig(nlm=True, multiframe=True, overlap=True, max_frames=10)
NLM = NlmParams(search_radius=2, patch_radius=1)
N_FRAMES, H, W = 10, 12, 16


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


@pytest.fixture(scope="module")
def shot(tmp_path_factory):
    """N_FRAMES noisy opaque PNGs in one directory, as paths."""
    root = tmp_path_factory.mktemp("shot")
    rng = np.random.default_rng(23)
    paths = []
    for i in range(N_FRAMES):
        img = np.concatenate([rng.random((H, W, 3)), np.ones((H, W, 1))], -1)
        paths.append(str(root / f"frame_{i:04d}.png"))
        with open(paths[-1], "wb") as f:
            f.write(png.encode(np.round(img * 255).astype(np.uint8), 1))
    return paths


@pytest.fixture
def decodes(monkeypatch):
    """The paths decoded from here on, in order: each imageio.load, and
    each path a native.FrameLoader starts over (its threads decode them
    all)."""
    seen = []
    load = imageio.load

    def counted_load(path):
        seen.append(path)
        return load(path)

    class CountedLoader(native.FrameLoader):
        def __init__(self, paths, **kw):
            super().__init__(paths, **kw)
            seen.extend(paths)

    monkeypatch.setattr(imageio, "load", counted_load)
    monkeypatch.setattr(native, "FrameLoader", CountedLoader)
    return seen


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _run_shot(paths, out, frame_cache):
    """Session.run(OVERLAP) for every target of the shot in turn, on one
    frame_cache: each target's RunResult and saved PNG bytes."""
    runs = []
    for k, path in enumerate(paths):
        (out / str(k)).mkdir(parents=True)
        result = Session(path, device="cpu", output_dir=str(out / str(k)), nlm_params=NLM,
                         frame_cache=frame_cache).run(OVERLAP)
        with open(result.output_path, "rb") as f:
            runs.append((result, f.read()))
    return runs


def test_a_shot_through_the_cache_decodes_each_file_once(shot, tmp_path, loader, decodes):
    """Ten targets of a ten-frame shot: without a cache, each target's own
    load and its window of 9, whose first 8 frames hold targets 0-7 twice
    (each decoded once); with one, each file once; each target's image and
    PNG bytes the same bit for bit."""
    uncached = _run_shot(shot, tmp_path / "uncached", None)
    assert len(decodes) == 8 * (1 + 8) + 2 * (1 + 9)
    del decodes[:]
    cache: dict = {}
    cached = _run_shot(shot, tmp_path / "cached", cache)
    assert sorted(decodes) == sorted(shot)
    assert sorted(cache) == sorted(shot)
    for (want, want_png), (got, got_png) in zip(uncached, cached):
        assert want.frame_loader == got.frame_loader == loader
        np.testing.assert_array_equal(got.image, want.image)
        assert got_png == want_png


# A window of the shot's frames by index, the frames cached before the
# prefetcher is built (None: no cache), the frames it decodes, and its
# counts of cache hits and misses.
WINDOWS = {
    "all_cached": ([0, 1, 2, 1], [0, 1, 2], [], 4, 0),
    "repeated_misses": ([0, 1, 0, 2, 1], [], [0, 1, 2], 2, 3),
    "mixed": ([3, 0, 0, 1, 2, 3], [0], [3, 1, 2], 3, 3),
    "no_cache": ([0, 1, 0], None, [0, 1], 1, 2),
}


@pytest.mark.parametrize("case", list(WINDOWS))
def test_the_prefetcher_decodes_each_distinct_miss_once(shot, loader, decodes, case):
    """Only the misses reach a decoder, each distinct one once and in
    window order (no FrameLoader where none misses, and `loader` still says
    which would decode); every frame handed out is the file's decode; the
    misses are cached; the counters sum to the window."""
    window, cached, decoded, hits, misses = WINDOWS[case]
    items = [shot[i] for i in window]
    cache = None if cached is None else {}
    for i in cached or []:
        prefetch.cache_insert(cache, shot[i], prefetch.DecodedFrame(imageio.load(shot[i])[0]))
    del decodes[:]
    with _profiler():
        pf = FramePrefetcher(items, lambda p: imageio.load(p)[0], "cpu", native_paths=True,
                             frame_cache=cache)
        frames = [f.numpy().copy() for f in pf]
    assert pf.loader == loader
    assert decodes == [shot[i] for i in decoded]
    assert (pf._native is not None) == (loader == "native" and bool(decoded))
    for item, frame in zip(items, frames):
        np.testing.assert_array_equal(frame, imageio.load(item)[0])
    if cache is not None:
        assert sorted(cache) == sorted(set(items))
    counted = [timing.totals.get(name, [0, 0])[1]
               for name in (timing.PREFETCH_CACHE_HIT, timing.PREFETCH_CACHE_MISS)]
    assert counted == [hits, misses]
    assert timing.totals[timing.PREFETCH_FRAMES] == [0, len(window)]


def test_a_held_hit_outlives_its_eviction(shot, no_library):
    """A hit is resolved when the prefetcher is built: the frame reaches
    the window though the cache has dropped it since."""
    frame = imageio.load(shot[0])[0]
    cache: dict = {}
    prefetch.cache_insert(cache, shot[0], prefetch.DecodedFrame(frame))
    pf = FramePrefetcher([shot[0], shot[1]], lambda p: imageio.load(p)[0], "cpu",
                         frame_cache=cache)
    cache.clear()
    got = [f.numpy() for f in pf]
    np.testing.assert_array_equal(got[0], frame)
    assert list(cache) == [shot[1]]


def test_the_cache_never_exceeds_its_bound(tmp_path, no_library):
    """Forty distinct frames through the prefetcher, then through a
    Session's loads: the cache holds at most FRAME_CACHE_MAX frames, the
    most recent ones."""
    paths = []
    for i in range(40):
        paths.append(str(tmp_path / f"f_{i:02d}.png"))
        imageio.save(paths[-1], np.full((2, 3, 4), i / 64.0, np.float32))
    cache: dict = {}
    for _ in FramePrefetcher(paths, lambda p: imageio.load(p)[0], "cpu", frame_cache=cache):
        assert len(cache) <= prefetch.FRAME_CACHE_MAX
    assert list(cache) == paths[-prefetch.FRAME_CACHE_MAX:]
    session = Session(paths[0], device="cpu", output_dir=str(tmp_path), frame_cache=cache)
    for p in paths:
        session._load(p)
        assert len(cache) <= prefetch.FRAME_CACHE_MAX
    assert list(cache) == paths[-prefetch.FRAME_CACHE_MAX:]


def test_cached_frames_are_unchanged_by_runs_on_the_cpu(shot, tmp_path, no_library):
    """On a CPU device the uploads share the cached arrays' memory: after
    the overlap loop has filtered them for three targets, each cached frame
    is still its file's decode."""
    cache: dict = {}
    _run_shot(shot[:3], tmp_path, cache)
    assert sorted(cache) == shot[:8]  # the first target's window: frames 0-7
    for path, frame in cache.items():
        np.testing.assert_array_equal(frame, imageio.load(path)[0])


@pytest.mark.parametrize("targets, counts", [
    ([0], [(2, 7)]),             # frame 0 cached by the target's load, 1-7 miss
    ([0, 1, 9], [(2, 7), (9, 0), (9, 0)]),
    ([9], [(1, 8)]),             # frame 9 cached by the target's load, 0-7 miss
], ids=["first_target", "one_shot", "late_target"])
def test_a_profiled_run_counts_each_window_item_once(shot, tmp_path, no_library, targets,
                                                     counts):
    """Each Session.run's window of nine: the prefetcher's hits and misses
    sum to nine, the misses are the frames no earlier load or window
    cached, and the waits are the misses' decodes."""
    cache: dict = {}
    for k, (hits, misses) in zip(targets, counts):
        (tmp_path / str(k)).mkdir()
        timing.count("tests.profiler_off")  # each run's totals a stretch of their own
        with _profiler():
            Session(shot[k], device="cpu", output_dir=str(tmp_path / str(k)), nlm_params=NLM,
                    frame_cache=cache).run(OVERLAP)
        t = timing.totals
        assert t.get(timing.PREFETCH_CACHE_HIT, [0, 0])[1] == hits
        assert t.get(timing.PREFETCH_CACHE_MISS, [0, 0])[1] == misses
        assert t.get(timing.PREFETCH_WAIT, [0, 0])[1] == misses
        assert t[timing.PREFETCH_FRAMES] == [0, 9]
