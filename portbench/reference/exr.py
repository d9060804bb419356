"""The benchmark's own OpenEXR writer and reader, on numpy and the standard
library's zlib, written from the file format's description (single-part
scanline files: a header of attributes, a table of block offsets, then
blocks of scanlines, each line's channels in name order).

The writer makes the EXR files cell's inputs: RGBA as channels A, B, G, R,
FLOAT (float32), compression NONE or ZIP (16 lines a block) at a given zlib
level. The reader reads the program's outputs back for the comparison:
compression NONE, ZIPS (1 line a block) or ZIP; HALF or FLOAT channels. It
returns the channels, their pixel types and the compression with the pixels,
so that the comparison can hold the saved file to its format.

Nothing of the program under test is imported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
NONE, ZIPS, ZIP = 0, 2, 3
LINES = {NONE: 1, ZIPS: 1, ZIP: 16}                  # scanlines a block
PIXEL_TYPES = {1: "HALF", 2: "FLOAT"}                # pixel type number -> name
DTYPES = {"HALF": "<f2", "FLOAT": "<f4"}
RGBA_ORDER = ("A", "B", "G", "R")                    # the channels in name order


class Image:
    """A decoded file: channels in the file's order, each one's pixel type
    ("HALF" or "FLOAT"), the compression's number, and the pixels as an (H,
    W, 4) float32 RGBA array; a channel the file lacks reads NaN."""

    def __init__(self, channels: list, types: list, compression: int,
                 rgba: np.ndarray) -> None:
        self.channels = channels
        self.types = types
        self.compression = compression
        self.rgba = rgba


def _attr(name: str, kind: str, body: bytes) -> bytes:
    return name.encode() + b"\0" + kind.encode() + b"\0" + struct.pack("<i", len(body)) + body


def _zip_pack(raw: bytes) -> np.ndarray:
    """ZIP's byte reorder before deflate: the even bytes, then the odd ones;
    then each byte as its difference from the one before, plus 128."""
    b = np.frombuffer(raw, np.uint8)
    order = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
    out = order.copy()
    out[1:] = (order[1:] - order[:-1] + 128) & 0xFF
    return out.astype(np.uint8)


def _zip_unpack(packed: np.ndarray) -> np.ndarray:
    """The inverse of _zip_pack."""
    d = packed.astype(np.int64)
    d[1:] -= 128
    order = (np.cumsum(d) & 0xFF).astype(np.uint8)
    half = (order.size + 1) // 2
    out = np.empty_like(order)
    out[0::2], out[1::2] = order[:half], order[half:]
    return out


def encode(rgba: np.ndarray, compression: int = ZIP, level: int = 6) -> bytes:
    """An (H, W, 4) float32 RGBA image as a scanline EXR: channels A, B, G,
    R, FLOAT; compression NONE or ZIP (deflate at `level`)."""
    if rgba.dtype != np.float32 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) float32, got {rgba.dtype} {rgba.shape}")
    if compression not in (NONE, ZIP):
        raise ValueError(f"the writer takes NONE or ZIP, not compression {compression}")
    h, w, _ = rgba.shape
    chlist = b"".join(c.encode() + b"\0" + struct.pack("<iB3xii", 2, 0, 1, 1)
                      for c in RGBA_ORDER) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<iI", MAGIC, 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([compression]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    # (H, channel in name order, W): a block's bytes are its rows in turn.
    lines = np.ascontiguousarray(rgba[..., [3, 2, 1, 0]].transpose(0, 2, 1)).astype("<f4")
    n = LINES[compression]
    blocks = []
    for y0 in range(0, h, n):
        raw = lines[y0:y0 + n].tobytes()
        data = raw
        if compression == ZIP:
            packed = zlib.compress(_zip_pack(raw).tobytes(), level)
            data = packed if len(packed) < len(raw) else raw
        blocks.append(struct.pack("<iI", y0, len(data)) + data)
    offsets, pos = [], len(header) + 8 * len(blocks)
    for block in blocks:
        offsets.append(pos)
        pos += len(block)
    return header + struct.pack(f"<{len(offsets)}q", *offsets) + b"".join(blocks)


def _cstr(data: bytes, pos: int) -> tuple[str, int]:
    end = data.index(b"\0", pos)
    return data[pos:end].decode("latin-1"), end + 1


def decode(data: bytes) -> Image:
    """A single-part scanline EXR's channels, pixel types, compression and
    pixels. Raises ValueError on anything else."""
    if len(data) < 8 or struct.unpack_from("<i", data, 0)[0] != MAGIC:
        raise ValueError("not an OpenEXR file")
    version = struct.unpack_from("<I", data, 4)[0]
    if version & 0xFF != 2 or version & (0x200 | 0x800 | 0x1000):
        raise ValueError(f"not a single-part scanline file (version field {version:#x})")
    attrs, pos = {}, 8
    while True:
        name, pos = _cstr(data, pos)
        if not name:
            break
        _, pos = _cstr(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        attrs[name] = data[pos + 4:pos + 4 + size]
        pos += 4 + size
    channels, types, cpos, body = [], [], 0, attrs["channels"]
    while body[cpos] != 0:
        cname, cpos = _cstr(body, cpos)
        ptype, _, xs, ys = struct.unpack_from("<iB3xii", body, cpos)
        cpos += 16
        if ptype not in PIXEL_TYPES or (xs, ys) != (1, 1):
            raise ValueError(f"channel {cname}: pixel type {ptype}, sampling {xs}x{ys}")
        channels.append(cname)
        types.append(PIXEL_TYPES[ptype])
    compression = attrs["compression"][0]
    if compression not in LINES:
        raise ValueError(f"compression {compression} is not NONE, ZIPS or ZIP")
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    # Each scanline holds every channel's w values in turn, in the file's order.
    row = np.dtype([(c, DTYPES[t], (w,))
                    for c, t in zip(channels, types)])
    rows = np.empty(h, row)
    n = LINES[compression]
    offsets = struct.unpack_from(f"<{-(-h // n)}q", data, pos)
    for off in offsets:
        y, size = struct.unpack_from("<iI", data, off)
        y -= ymin
        if not 0 <= y < h:
            raise ValueError(f"a block at row {y + ymin} lies outside the data window")
        lines = min(n, h - y)
        expected = lines * row.itemsize
        block = data[off + 8:off + 8 + size]
        if compression != NONE and size < expected:
            block = _zip_unpack(np.frombuffer(zlib.decompress(block), np.uint8)).tobytes()
        if len(block) != expected:
            raise ValueError(f"the block at row {y + ymin} holds {len(block)} bytes, "
                             f"not {expected}")
        rows[y:y + lines] = np.frombuffer(block, row)
    rgba = np.full((h, w, 4), np.nan, np.float32)
    for i, c in enumerate("RGBA"):
        if c in channels:
            rgba[..., i] = rows[c].astype(np.float32)
    return Image(channels, types, compression, rgba)
