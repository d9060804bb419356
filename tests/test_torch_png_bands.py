"""The port's banded PNG encoder (utils/png.py:encode_bands), imageio.save's
PNG path: one band writes png.encode's file byte for byte (and the native
encoder's, where the library builds); more bands write the same filtered
stream and pixels, wrap, clamp and non-finite values included, in a file at
most 0.1% larger; the band count from the frame's size and the cores; the
png_encode.bands counter under a profiler, and the benchmark's reader of it
(portbench/metrics/png_bands_per_frame.py)."""

import concurrent.futures
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.config import NlmParams, RunConfig
from image_denoising_filter_tpu_torch.utils import content, imageio, native, png, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from portbench import harness  # noqa: E402


def _frame(rng, h, w, kind="unit"):
    """An (h, w, 4) float32 frame: values in [0, 1] ("unit"), or spread
    below 0 and above 1 with NaN and +-inf scattered ("wild")."""
    if kind == "unit":
        return rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    x = rng.normal(0.5, 1.5, (h, w, 4)).astype(np.float32)
    flat = x.reshape(-1)
    for value in (np.nan, np.inf, -np.inf):
        flat[rng.integers(0, flat.size, max(1, flat.size // 50))] = value
    return x


def _cast(clamp):
    return lambda rows: imageio.quantize(rows, clamp)


def _idat(data: bytes) -> bytes:
    out, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        if data[pos + 4:pos + 8] == b"IDAT":
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


@pytest.fixture
def bands(monkeypatch):
    """Make band_count give `cores` bands of at least `band_bytes` filtered
    bytes, whatever this machine's cores."""
    def set_(cores, band_bytes=png._BAND_BYTES):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
        monkeypatch.setattr(png, "_BAND_BYTES", band_bytes)
    return set_


@pytest.mark.parametrize("clamp", [False, True], ids=["wrap", "clamp"])
@pytest.mark.parametrize("kind", ["unit", "wild"])
@pytest.mark.parametrize("shape", [(1, 1), (12, 14), (37, 53), (64, 300)])
def test_one_band_is_png_encode_byte_for_byte(rng, shape, kind, clamp):
    x = _frame(rng, *shape, kind)
    assert png.band_count(*shape) == 1
    with np.errstate(invalid="ignore"):
        got = png.encode_bands(x, _cast(clamp))
        assert got == png.encode(imageio.quantize(x, clamp))


# (height, width, cores, band bytes) -> bands: a height the count does not
# divide, bands of one row, the widest frame a band's minimum keeps to few
BAND_CASES = [
    (23, 16, 4, 130, 4),
    (5, 8, 8, 33, 5),
    (40, 300, 3, 8192, 3),
    (97, 41, 7, 1000, 7),
    (2, 3, 8, 1, 2),
]


@pytest.mark.parametrize("clamp", [False, True], ids=["wrap", "clamp"])
@pytest.mark.parametrize("kind", ["unit", "wild"])
@pytest.mark.parametrize("h,w,cores,band_bytes,n", BAND_CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[4]}bands" for c in BAND_CASES])
def test_bands_decode_to_the_quantized_frame(rng, bands, h, w, cores, band_bytes, n, kind,
                                             clamp):
    """Several bands: png.decode and the standard library's inflate read back
    the quantized frame and png.encode's filtered stream exactly."""
    x = _frame(rng, h, w, kind)
    bands(cores, band_bytes)
    assert png.band_count(h, w) == n
    with np.errstate(invalid="ignore"):
        data = png.encode_bands(x, _cast(clamp))
        want = imageio.quantize(x, clamp)
        whole = png.encode(want)
    np.testing.assert_array_equal(png.decode(data), want)
    assert zlib.decompress(_idat(data)) == zlib.decompress(_idat(whole))
    assert data[:33] == whole[:33]  # signature and IHDR


def test_bands_of_a_noisy_render_cost_at_most_a_thousandth(bands):
    """A 512x512 render with noise in four bands of 256 KiB: a file at most
    0.1% larger than one band's, with the same pixels."""
    rng = np.random.default_rng(11)
    x = content.synthetic_render(512, 512, seed=3)
    x[..., :3] += rng.normal(0, 0.08, x[..., :3].shape).astype(np.float32)
    x = np.clip(x, 0, 1)
    bands(8)
    assert png.band_count(512, 512) == 4
    data = png.encode_bands(x, _cast(True))
    one = png.encode(imageio.quantize(x, True))
    assert data != one
    assert len(one) < len(data) <= 1.001 * len(one)
    np.testing.assert_array_equal(png.decode(data), imageio.quantize(x, True))


@pytest.mark.parametrize("h,w,cores,n", [
    (1080, 1920, 8, 8),      # the 1080p frame on the card's host: 8.3 MB
    (1080, 1920, 64, 31),    # no band under 256 KiB
    (1080, 1920, 1, 1),
    (255, 256, 8, 1),        # 255 x 1025 bytes: under 512 KiB
    (256, 256, 8, 1),        # 262,400 bytes
    (512, 256, 8, 2),        # 524,800: two bands of at least 256 KiB
    (65536, 1, 8, 1),        # 5 bytes a row: 320 KiB
])
def test_band_count_from_the_size_and_the_cores(bands, h, w, cores, n):
    bands(cores)
    assert png.band_count(h, w) == n


@pytest.mark.parametrize("above", [False, True])
@pytest.mark.parametrize("rows", [1, 2, 9])
def test_filter_rows_is_png_encodes_filter(rng, rows, above):
    """filter_rows on the rows under a given row is png.encode's filtered
    stream of those rows under it; the image's first row has none above."""
    img = rng.integers(0, 256, (rows + 1, 6, 4), dtype=np.uint8)
    img[1::2, :3] = img[0, :3]  # rows that Up, and pixels that Sub, make small
    want = zlib.decompress(_idat(png.encode(img)))
    flat = img.reshape(rows + 1, -1)
    if above:  # the rows under the first: png.encode's stream past its first line
        assert png.filter_rows(flat[1:], flat[0]).tobytes() == want[6 * 4 + 1:]
    else:
        assert png.filter_rows(flat).tobytes() == want


@pytest.mark.parametrize("cut", [0, 1, 7, 1000, 4999, 5000])
def test_adler32_join_is_the_whole_streams(rng, cut):
    data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    a, b = data[:cut], data[cut:]
    assert png._adler32_join(zlib.adler32(a), zlib.adler32(b), len(b)) == zlib.adler32(data)


def test_encodes_from_many_threads_at_once(rng, bands):
    """Twice as many threads as the pool's, each encoding banded frames at
    once with a short switch interval: every file is the one a lone encode
    writes."""
    bands(4, 400)
    frames = [_frame(rng, 20 + k, 30) for k in range(16)]
    want = [png.encode_bands(x, _cast(True)) for x in frames]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            got = [f.result(timeout=60) for f in
                   [ex.submit(png.encode_bands, x, _cast(True)) for x in frames * 4]]
    finally:
        sys.setswitchinterval(interval)
    assert got == want * 4


def test_save_writes_the_banded_file(rng, tmp_path, bands):
    """imageio.save's PNG is encode_bands's, whichever codec loads."""
    x = _frame(rng, 30, 40)
    bands(3, 800)
    path = str(tmp_path / "a.png")
    imageio.save(path, x)
    with open(path, "rb") as f:
        assert f.read() == png.encode_bands(x, _cast(False))
    np.testing.assert_array_equal(imageio.load(path)[0],
                                  imageio.to_float(imageio.quantize(x)))


def test_bands_count_under_a_profiler(rng, tmp_path, bands):
    """png_encode.bands adds each encode's bands while a profiler records,
    and nothing with none."""
    x = _frame(rng, 24, 20)
    timing.count("tests.profiler_off")
    bands(4, 81 * 2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        imageio.save(str(tmp_path / "a.png"), x)
        bands(1)
        imageio.save(str(tmp_path / "b.png"), x)
    assert timing.totals[timing.PNG_BANDS] == [0, 4 + 1]
    imageio.save(str(tmp_path / "c.png"), x)
    assert timing.totals[timing.PNG_BANDS] == [0, 4 + 1]


def test_a_profiled_run_counts_one_band_a_small_frame(rng, tmp_path):
    """Session.run's save counts its bands: one for a frame under 512 KiB."""
    target = str(tmp_path / "frame_0001.png")
    imageio.save(target, _frame(rng, 16, 24))
    (tmp_path / "out").mkdir()
    timing.count("tests.profiler_off")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        Session(target, device="cpu", output_dir=str(tmp_path / "out"),
                nlm_params=NlmParams(search_radius=1, patch_radius=1)).run(RunConfig(nlm=True))
    assert timing.totals[timing.PNG_BANDS] == [0, 1]


@pytest.mark.parametrize("totals,frames,want", [
    ({"png_encode.bands": [0, 16]}, 2, 8.0),
    ({"png_encode.bands": [0, 3], "frame_cache.hit": [0, 9]}, 3, 1.0),
])
def test_reader_of_the_bands_counter(monkeypatch, totals, frames, want):
    monkeypatch.setattr(timing, "totals", totals)
    reader = harness.metric(harness.ROOT, "png_bands_per_frame")
    assert reader.read(_reading(frames)) == pytest.approx(want)


def test_reader_finds_nothing_without_the_counter(monkeypatch):
    """None where no band was counted, and where the program keeps no totals
    (a program without the counter)."""
    reader = harness.metric(harness.ROOT, "png_bands_per_frame")
    monkeypatch.setattr(timing, "totals", {"idf.session.save": [7, 1]})
    assert reader.read(_reading(2)) is None
    monkeypatch.delattr(timing, "totals")
    assert reader.read(_reading(2)) is None


def _reading(frames):
    return harness.Reading(family="temporal_nlm", frames=frames, window=(0.0, 1.0), steps=[],
                           trace=None, step_work=(0, 0), session=None)


@pytest.fixture(scope="module")
def native_root(tmp_path_factory):
    if native._cxx() is None:
        pytest.skip("no C++ compiler found (set CXX or put g++ on PATH)")
    path = tmp_path_factory.mktemp("native_root")
    native.build(path)
    return path


@pytest.mark.parametrize("clamp", [False, True], ids=["wrap", "clamp"])
def test_one_band_is_the_native_encoders_file(rng, monkeypatch, native_root, clamp):
    """One band writes what the native library's png_encode writes."""
    monkeypatch.setattr(native, "_loaded", native._Loaded())
    monkeypatch.delenv("IDF_NATIVE_LIB", raising=False)
    native.ensure(native_root)
    for shape in [(12, 14), (37, 53), (255, 256)]:
        x = _frame(rng, *shape, "wild")
        with np.errstate(invalid="ignore"):
            want = native.png_encode(imageio.quantize(x, clamp))
            assert png.encode_bands(x, _cast(clamp)) == want
