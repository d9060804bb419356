"""The benchmark's own PNG writer and reader, on the standard library's zlib.

The writer makes the files cell's inputs: 8-bit RGBA, no filter. The reader
reads the program's outputs back for the comparison: 8-bit RGB or RGBA
(colour types 2 and 6), not interlaced, any of the five row filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode(rgba: np.ndarray, level: int = 1) -> bytes:
    """An (H, W, 4) uint8 image as PNG bytes."""
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) uint8, got {rgba.dtype} {rgba.shape}")
    h, w, _ = rgba.shape
    raw = np.zeros((h, 1 + 4 * w), np.uint8)   # filter byte 0 on every row
    raw[:, 1:] = rgba.reshape(h, 4 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One row's bytes from its filtered bytes and the row above (uint8)."""
    if kind == 0:
        return row
    if kind == 2:
        return row + prev
    if kind == 1:
        lanes = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(lanes, axis=0) % 256).astype(np.uint8).reshape(-1)
    out = np.zeros_like(row)
    for i in range(row.size):
        a = int(out[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        if kind == 3:
            pred = (a + b) // 2
        elif kind == 4:
            pred = _paeth(a, b, int(prev[i - bpp]) if i >= bpp else 0)
        else:
            raise ValueError(f"unknown PNG filter {kind}")
        out[i] = (int(row[i]) + pred) % 256
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes as an (H, W, 4) uint8 image (RGB gets alpha 255)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")
    bpp = 4 if ctype == 6 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + bpp * w)
    out = np.empty((h, bpp * w), np.uint8)
    prev = np.zeros(bpp * w, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    img = out.reshape(h, w, bpp)
    if bpp == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    return img


def to_float(rgba_u8: np.ndarray) -> np.ndarray:
    """LDR bytes as float32 in [0, 1]: x * (1/255) (src/main.cpp:1125-1128)."""
    return rgba_u8.astype(np.float32) * np.float32(1.0 / 255.0)


def quantize(rgba: np.ndarray) -> np.ndarray:
    """float32 as LDR bytes by the upstream reference's unclamped cast,
    (unsigned char)(255 * x) (src/main.cpp:97-102): truncated, modulo 256."""
    scaled = np.asarray(rgba, np.float32) * np.float32(255.0)
    return (np.trunc(scaled).astype(np.int64) & 0xFF).astype(np.uint8)
