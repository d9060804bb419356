"""The benchmark's own PNG writer and reader, and its LDR casts, against
the port's codec and casts."""

import struct
import zlib

import numpy as np
import pytest

from image_denoising_filter_tpu_torch.utils import imageio, png as port_png
from portbench.reference import png


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (24, 32), (7, 129)])
def test_write_then_read_gives_the_same_bytes(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 4), dtype=np.uint8)
    assert np.array_equal(png.decode(png.encode(img)), img)
    assert np.array_equal(port_png.decode(png.encode(img)), img)


@pytest.mark.parametrize("seed", [0, 1])
def test_reads_the_ports_filtered_files(seed):
    rng = np.random.default_rng(seed)
    img = np.repeat(rng.integers(0, 256, (20, 1, 4), dtype=np.uint8), 33, 1)  # Sub and Up rows
    img[::3] = rng.integers(0, 256, img[::3].shape, dtype=np.uint8)
    assert np.array_equal(png.decode(port_png.encode(img)), img)


def _filtered(img: np.ndarray, kind: int) -> bytes:
    """img written with every row under filter `kind` (3 Average, 4 Paeth)."""
    h, w, _ = img.shape
    rows = img.reshape(h, 4 * w).astype(np.int64)
    out = []
    for y in range(h):
        prev = rows[y - 1] if y else np.zeros(4 * w, np.int64)
        line = []
        for i in range(4 * w):
            a = rows[y, i - 4] if i >= 4 else 0
            b, c = prev[i], (prev[i - 4] if i >= 4 else 0)
            if kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line.append((rows[y, i] - pred) % 256)
        out.append(bytes([kind]) + bytes(line))
    raw = zlib.compress(b"".join(out))
    return (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + png._chunk(b"IDAT", raw) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [3, 4])
def test_reads_average_and_paeth_rows(kind):
    img = np.random.default_rng(kind).integers(0, 256, (6, 9, 4), dtype=np.uint8)
    data = _filtered(img, kind)
    assert np.array_equal(port_png.decode(data), img)
    assert np.array_equal(png.decode(data), img)


def test_refuses_a_damaged_file():
    data = bytearray(png.encode(np.zeros((2, 2, 4), np.uint8)))
    data[-20] ^= 0xFF
    with pytest.raises((ValueError, zlib.error)):
        png.decode(bytes(data))


def test_casts_are_the_ports():
    x = np.random.default_rng(3).uniform(-0.5, 1.5, (16, 16, 4)).astype(np.float32)
    assert np.array_equal(png.quantize(x), imageio.quantize(x, clamp=False))
    u8 = np.arange(256, dtype=np.uint8).reshape(4, 16, 4)
    assert np.array_equal(png.to_float(u8), imageio.to_float(u8))
