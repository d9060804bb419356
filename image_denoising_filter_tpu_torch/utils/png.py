"""Pure-Python PNG codec (decode to RGBA8, encode from RGBA8).

Plays the role lodepng plays in the reference (vendored codec,
src/main.cpp:190-229 decode, src/main.cpp:1710-1716 encode): every PNG is decoded
*to RGBA8* regardless of its native color type, and outputs are always RGBA8.

This is the fallback path; the native C++ codec in `native/` (see
utils/native.py) is used when built, with per-file fallback here for the
subset it doesn't cover. Decode supports bit depths 1/2/4/8/16, color types
0/2/3/4/6, all five filter types, and Adam7 interlacing -- the full set of
files lodepng's decoder accepts (16-bit samples take their high byte, like
lodepng's default RGBA8 conversion; sub-byte grayscale is scaled to 0..255).
Encode writes color type 6 (RGBA8) with per-row adaptive None/Sub/Up
filtering. `encode_bands` writes the same file from a float frame and its
cast, the frame cut into row bands that cast, filter and deflate on a pool of
host threads (imageio.save's PNG path).
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import threading
import zlib

import numpy as np

from . import timing

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngError(ValueError):
    pass


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode(rgba: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode an (H, W, 4) uint8 array as a PNG (color type 6, 8-bit)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise PngError(f"expected (H, W, 4) uint8, got {rgba.shape}")
    h, w, _ = rgba.shape

    # Adaptive per-row filter between None(0), Sub(1), Up(2) -- all three are
    # vectorizable both ways; pick the one with the smallest absolute residual
    # (the standard minimum-sum-of-absolute-differences heuristic).
    raw = rgba.reshape(h, w * 4).astype(np.int16)
    left = np.zeros_like(raw)
    left[:, 4:] = raw[:, :-4]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    cand = np.stack(
        [raw, (raw - left) & 0xFF, (raw - up) & 0xFF], axis=0
    ).astype(np.uint8)
    # Sum of bytes interpreted as signed distance from the 0/256 wrap point.
    c = cand.astype(np.int16)
    cost = np.where(c < 128, c, 256 - c).sum(axis=2)
    choice = np.argmin(cost, axis=0).astype(np.uint8)
    lines = bytearray()
    for y in range(h):
        f = int(choice[y])
        lines.append(f)
        lines += cand[f, y].tobytes()

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (
        _PNG_SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(bytes(lines), compress_level))
        + _chunk(b"IEND", b"")
    )


# encode_bands: the least filtered bytes a band takes (a frame under twice
# this is one band), deflate's window, and the pool of host threads, made on
# first use in each process (a forked child has none of its parent's threads).
_BAND_BYTES = 256 << 10
_WINDOW = 32 << 10
_pool: concurrent.futures.ThreadPoolExecutor | None = None
_pool_pid = 0
_pool_lock = threading.Lock()


def _threads() -> concurrent.futures.ThreadPoolExecutor:
    global _pool, _pool_pid
    with _pool_lock:
        if _pool is None or _pool_pid != os.getpid():
            _pool = concurrent.futures.ThreadPoolExecutor(
                len(os.sched_getaffinity(0)), thread_name_prefix="png-band")
            _pool_pid = os.getpid()
        return _pool


def band_count(h: int, w: int) -> int:
    """The row bands encode_bands cuts an (h, w) RGBA frame into: one a core
    this process may run on, each with at least _BAND_BYTES filtered bytes,
    and at least one row."""
    return max(1, min(len(os.sched_getaffinity(0)), h * (4 * w + 1) // _BAND_BYTES, h))


def filter_rows(rows: np.ndarray, above: np.ndarray | None = None) -> np.ndarray:
    """PNG scanlines of (n, stride) uint8 RGBA rows: each row's filter byte,
    then the row under the None, Sub or Up filter whose bytes, read as
    signed, sum smallest in magnitude (encode's choice, ties to the lower
    filter). Up takes the first row against `above`, the row over it in
    the image (none for the image's first row). Returns (n, stride + 1)."""
    sub = rows.copy()
    sub[:, 4:] -= rows[:, :-4]  # uint8 arithmetic wraps mod 256
    up = rows.copy()
    up[1:] -= rows[:-1]
    if above is not None:
        up[0] -= above
    cands = (rows, sub, up)
    # |int8(c)| as uint8 is min(c, 256 - c), 128 included
    cost = np.stack([np.abs(c.view(np.int8)).view(np.uint8).sum(axis=1, dtype=np.int64)
                     for c in cands])
    choice = np.argmin(cost, axis=0).astype(np.uint8)
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = choice
    out[:, 1:] = rows
    for f in (1, 2):
        picked = choice == f
        out[picked, 1:] = cands[f][picked]
    return out


def _adler32_join(a1: int, a2: int, n2: int) -> int:
    """The Adler-32 of x + y from a1 = adler32(x), and a2 = adler32(y) of
    y's n2 bytes."""
    base = 65521
    lo = ((a1 & 0xFFFF) + (a2 & 0xFFFF) - 1) % base
    hi = ((a1 >> 16) + (a2 >> 16) + n2 * ((a1 & 0xFFFF) - 1)) % base
    return hi << 16 | lo


def encode_bands(frame: np.ndarray, cast, compress_level: int = 6) -> bytes:
    """Encode `cast(frame)` as a PNG as encode does, on band_count's row
    bands of the (H, W, 4) frame at once, one a thread of the pool.

    Each band casts its rows with `cast` (float rows -> uint8 RGBA rows; the
    row above the band is cast again for Up), filters them as filter_rows
    does, and deflates them raw at `compress_level`, primed with the last
    32 KiB of the band above and ended with a sync flush (the last band:
    finished). One IDAT holds the zlib header, the bands' bodies in order
    and the Adler-32 of the whole filtered stream. One band gives encode's
    bytes; more give the same filtered stream and pixels in a stream a
    little larger. Counts the bands as png_encode.bands."""
    if frame.ndim != 3 or frame.shape[2] != 4:
        raise PngError(f"expected (H, W, 4), got {frame.shape}")
    h, w, _ = frame.shape
    n = band_count(h, w)
    timing.count(timing.PNG_BANDS, n)
    cuts = [h * k // n for k in range(n + 1)]
    run = map if n == 1 else _threads().map

    def lines(k: int) -> np.ndarray:
        y0, y1 = cuts[k], cuts[k + 1]
        rows = cast(frame[max(y0 - 1, 0):y1]).reshape(-1, 4 * w)
        if y0 == 0:
            return filter_rows(rows)
        return filter_rows(rows[1:], rows[0])

    bands = [b.reshape(-1) for b in run(lines, range(n))]

    def deflate(k: int) -> tuple[bytes, int]:
        z = (zlib.compressobj(compress_level, zlib.DEFLATED, -15, zdict=bands[k - 1][-_WINDOW:])
             if k else zlib.compressobj(compress_level, zlib.DEFLATED, -15))
        body = z.compress(bands[k]) + z.flush(zlib.Z_FINISH if k == n - 1 else zlib.Z_SYNC_FLUSH)
        return body, zlib.adler32(bands[k])

    parts = list(run(deflate, range(n)))
    adler = parts[0][1]
    for band, (_, a) in zip(bands[1:], parts[1:]):
        adler = _adler32_join(adler, a, band.size)
    idat = b"".join([zlib.compress(b"", compress_level)[:2], *(body for body, _ in parts),
                     struct.pack(">I", adler)])
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return _PNG_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filtering (byte-level). data holds h scanlines of
    1 filter byte + `stride` bytes; bpp = filter distance in bytes (>= 1).
    Returns (h, stride) uint8."""
    arr = np.frombuffer(data, np.uint8)
    if arr.size != h * (stride + 1):
        raise PngError("bad IDAT length")
    arr = arr.reshape(h, stride + 1)
    filters = arr[:, 0]
    rows = arr[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        f = int(filters[y])
        row = rows[y]
        if f == 0:
            rec = row
        elif f == 1:  # Sub: cumulative sum per byte lane modulo 256
            lanes = row.reshape(-1, bpp)
            rec = np.cumsum(lanes, axis=0, dtype=np.int64).reshape(-1) & 0xFF
        elif f == 2:  # Up
            rec = (row + prior) & 0xFF
        elif f == 3:  # Average -- sequential in x over pixels
            rec = np.empty(stride, np.int32)
            for x in range(stride):
                left = rec[x - bpp] if x >= bpp else 0
                rec[x] = (row[x] + ((left + prior[x]) >> 1)) & 0xFF
        elif f == 4:  # Paeth -- sequential in x over pixels
            rec = np.empty(stride, np.int32)
            for x in range(stride):
                a = rec[x - bpp] if x >= bpp else 0
                b = prior[x]
                c = prior[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                rec[x] = (row[x] + pred) & 0xFF
        else:
            raise PngError(f"unknown filter type {f}")
        out[y] = rec
        prior = rec
    return out.astype(np.uint8)


#: Adam7 pass grid: (x0, y0, dx, dy)
_ADAM7 = [
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
]


def _extract_samples(
    rows: np.ndarray, w: int, channels: int, bitdepth: int
) -> np.ndarray:
    """(h, stride)-byte scanlines -> (h, w, channels) raw samples
    (uint8 for depth <= 8, uint16 for 16)."""
    h = rows.shape[0]
    if bitdepth == 8:
        return rows[:, : w * channels].reshape(h, w, channels)
    if bitdepth == 16:
        be = rows[:, : w * channels * 2].reshape(h, w * channels, 2)
        vals = (be[..., 0].astype(np.uint16) << 8) | be[..., 1]
        return vals.reshape(h, w, channels)
    # 1/2/4-bit: MSB-first packed samples
    bits = np.unpackbits(rows, axis=1)[:, : w * channels * bitdepth]
    groups = bits.reshape(h, w * channels, bitdepth)
    weights = (1 << np.arange(bitdepth - 1, -1, -1)).astype(np.uint8)
    vals = (groups * weights).sum(axis=2).astype(np.uint8)
    return vals.reshape(h, w, channels)


def decode(data: bytes) -> np.ndarray:
    """Decode a PNG to an (H, W, 4) uint8 RGBA array (lodepng::decode analog).

    Accepts bit depths 1/2/4/8/16, color types 0/2/3/4/6, Adam7 interlacing,
    and tRNS transparency (palette alpha and 16-bit color keys)."""
    if data[:8] != _PNG_SIG:
        raise PngError("not a PNG file")
    pos = 8
    w = h = None
    bitdepth = colortype = None
    interlace = 0
    idat = bytearray()
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, colortype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            if bitdepth not in (1, 2, 4, 8, 16):
                raise PngError(f"bad bit depth {bitdepth}")
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if w is None:
        raise PngError("missing IHDR")
    channels = _CHANNELS.get(colortype)
    if channels is None:
        raise PngError(f"color type {colortype} not supported")

    raw = zlib.decompress(bytes(idat))
    sample_dt = np.uint16 if bitdepth == 16 else np.uint8
    px = np.zeros((h, w, channels), sample_dt)
    bpp = max(1, channels * bitdepth // 8)
    rpos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else [(0, 0, 1, 1)]:
        wp = (w - x0 + dx - 1) // dx
        hp = (h - y0 + dy - 1) // dy
        if wp <= 0 or hp <= 0:
            continue
        stride = (wp * channels * bitdepth + 7) // 8
        nbytes = hp * (stride + 1)
        rows = _unfilter(raw[rpos : rpos + nbytes], hp, stride, bpp)
        rpos += nbytes
        px[y0::dy, x0::dx] = _extract_samples(rows, wp, channels, bitdepth)

    # Convert raw samples to RGBA8, following lodepng's default conversion:
    # 16-bit takes the high byte; sub-byte grayscale scales to 0..255;
    # palette indices index PLTE; tRNS supplies palette alpha or a color key.
    if colortype == 3:
        if palette is None:
            raise PngError("palette image without PLTE")
        idx = px[..., 0]
        if int(idx.max(initial=0)) >= palette.shape[0]:
            raise PngError("palette index out of range")
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(palette.shape[0], 255, np.uint8)
            alpha[: trns.size] = trns
            out[..., 3] = alpha[idx]
        else:
            out[..., 3] = 255
        return out

    key_mask = None
    if trns is not None and colortype in (0, 2):
        key = np.frombuffer(trns[: 2 * channels], ">u2").astype(np.uint16)
        if bitdepth < 16:
            key = key.astype(sample_dt)
        key_mask = np.all(px == key[None, None, :], axis=-1)

    if bitdepth == 16:
        px8 = (px >> 8).astype(np.uint8)
    elif bitdepth < 8:
        px8 = (px.astype(np.uint16) * (255 // ((1 << bitdepth) - 1))).astype(np.uint8)
    else:
        px8 = px

    out = np.empty((h, w, 4), np.uint8)
    if colortype == 6:
        out[:] = px8
    elif colortype == 2:
        out[..., :3] = px8
        out[..., 3] = 255
    elif colortype == 0:
        out[..., :3] = px8
        out[..., 3] = 255
    elif colortype == 4:
        out[..., :3] = px8[..., :1]
        out[..., 3] = px8[..., 1]
    if key_mask is not None:
        out[..., 3] = np.where(key_mask, 0, out[..., 3])
    return out


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())
