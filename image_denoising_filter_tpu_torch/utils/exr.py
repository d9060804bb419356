"""Pure-Python OpenEXR scanline codec.

Plays the role tinyexr plays in the reference (LoadEXR/SaveEXR,
src/main.cpp:151-186, 1688-1708): HDR images round-trip as float32 RGBA with the
alpha channel preserved (the README calls out alpha preservation explicitly,
README.md:57-59).

Decode supports single-part scanline AND tiled EXRs (ONE_LEVEL / MIPMAP /
RIPMAP tile layouts; the full-resolution level (0, 0) feeds the image, like
tinyexr) with HALF/FLOAT/UINT channels and compression NONE (0), RLE (1),
ZIPS (2), ZIP (3), PIZ (4) and PXR24 (5) -- the full set tinyexr's loader
accepts plus PXR24. The PIZ path (bitmap LUT + Huffman + 2D wavelet) and
PXR24 path are independent implementations validated against the system
OpenEXR library in tests (tests/test_io.py golden files via
native/exr_oracle.cpp). Encode writes NONE/ZIPS/ZIP, matching the reference's
SaveEXR output. Deep, multipart, and B44/DWA files raise ExrError (tinyexr
rejects those too).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_HALF = 1
_FLOAT = 2
_UINT = 0

#: scanlines per compressed block, by compression id
_COMPRESSION_LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16}
_ENCODE_COMPRESSION_LINES = {0: 1, 2: 1, 3: 16}


class ExrError(ValueError):
    pass


def _read_nullterm(data: bytes, pos: int) -> tuple[str, int]:
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _predictor_decode(buf: np.ndarray) -> np.ndarray:
    """Reverse OpenEXR's ZIP delta predictor: d[i] stored as
    raw[i] - raw[i-1] + 128 + 256 (mod 256); recover with a cumulative sum."""
    shifted = buf.astype(np.int64)
    shifted[1:] -= 128 + 256
    return (np.cumsum(shifted) & 0xFF).astype(np.uint8)


def _predictor_encode(buf: np.ndarray) -> np.ndarray:
    out = buf.astype(np.int32)
    out[1:] = (out[1:] - out[:-1].astype(np.int32) + (128 + 256)) & 0xFF
    return out.astype(np.uint8)


def _deinterleave(buf: np.ndarray) -> np.ndarray:
    """Reverse OpenEXR's ZIP split-interleave: first half holds even bytes,
    second half holds odd bytes."""
    n = buf.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = buf[:half]
    out[1::2] = buf[half:]
    return out


def _interleave(buf: np.ndarray) -> np.ndarray:
    n = buf.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[:half] = buf[0::2]
    out[half:] = buf[1::2]
    return out


def _zip_decompress(block: bytes, expected: int) -> bytes:
    raw = zlib.decompress(block)
    if len(raw) != expected:
        raise ExrError("ZIP block has wrong decompressed size")
    buf = np.frombuffer(raw, np.uint8)
    return _deinterleave(_predictor_decode(buf.copy())).tobytes()


def _zip_compress(raw: bytes) -> bytes:
    buf = _predictor_encode(_interleave(np.frombuffer(raw, np.uint8)))
    return zlib.compress(buf.tobytes(), 6)


def _rle_decompress(block: bytes, expected: int) -> bytes:
    """RLE (compression 1): signed-count byte runs, then the same
    predictor + split-interleave post-pass as ZIP."""
    out = bytearray()
    pos, n = 0, len(block)
    while pos < n and len(out) < expected:
        d = block[pos]
        pos += 1
        if d >= 128:  # negative count: -d literal bytes follow
            count = 256 - d
            out += block[pos : pos + count]
            pos += count
        else:  # repeat next byte (count + 1) times
            if pos >= n:
                raise ExrError("truncated RLE block")
            out += block[pos : pos + 1] * (d + 1)
            pos += 1
    if len(out) != expected:
        raise ExrError("RLE block has wrong decompressed size")
    buf = np.frombuffer(bytes(out), np.uint8)
    return _deinterleave(_predictor_decode(buf.copy())).tobytes()


# -- PIZ (compression 4): bitmap LUT + Huffman + 2D wavelet -------------------
# Independent implementation of the OpenEXR PIZ scheme, validated against the
# system OpenEXR library (tests/test_io.py uses native/exr_oracle.cpp).

_HUF_ENCSIZE = 65537
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN
_HUF_DECBITS = 14


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def get(self, n: int) -> int:
        while self.lc < n:
            if self.pos >= len(self.data):
                raise ExrError("truncated Huffman data")
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        return (self.c >> self.lc) & ((1 << n) - 1)


def _huf_unpack_enc_table(br: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == _LONG_ZEROCODE_RUN:
            zerun = br.get(8) + _SHORTEST_LONG_RUN
            i += zerun
        elif l >= _SHORT_ZEROCODE_RUN:
            i += l - _SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    if i > _HUF_ENCSIZE:
        raise ExrError("corrupt Huffman table")
    return lengths


def _huf_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical code values per OpenEXR's scheme. Returns codes[]."""
    n = np.bincount(lengths[lengths > 0], minlength=59).astype(np.int64)
    c = 0
    first = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        first[i] = c
        c = nc
    codes = np.zeros(_HUF_ENCSIZE, np.int64)
    nxt = first.copy()
    sym_order = np.nonzero(lengths > 0)[0]
    for s in sym_order:
        l = lengths[s]
        codes[s] = nxt[l]
        nxt[l] += 1
    return codes


def _huf_decode(data: bytes, n_raw: int) -> np.ndarray:
    im, iM, _tlen, n_bits, _room = struct.unpack_from("<IIIII", data, 0)
    if not (0 <= im < _HUF_ENCSIZE and 0 <= iM < _HUF_ENCSIZE):
        raise ExrError("corrupt Huffman header")
    br = _BitReader(data, 20)
    lengths = _huf_unpack_enc_table(br, im, iM)
    codes = _huf_canonical_codes(lengths)

    # Fast table for codes <= 14 bits; longer codes via a dict.
    table_sym = np.full(1 << _HUF_DECBITS, -1, np.int64)
    table_len = np.zeros(1 << _HUF_DECBITS, np.int64)
    long_codes: dict[tuple[int, int], int] = {}
    for s in np.nonzero(lengths > 0)[0]:
        l = int(lengths[s])
        cd = int(codes[s])
        if l <= _HUF_DECBITS:
            base = cd << (_HUF_DECBITS - l)
            table_sym[base : base + (1 << (_HUF_DECBITS - l))] = s
            table_len[base : base + (1 << (_HUF_DECBITS - l))] = l
        else:
            long_codes[(l, cd)] = int(s)

    out = np.empty(n_raw, np.uint16)
    o = 0
    # Bit-accurate stream over exactly n_bits bits starting at br.pos.
    stream = data[br.pos :]
    acc = int.from_bytes(stream, "big")
    total_bits = 8 * len(stream)
    # The encoder pads the FRONT of the last byte? No: bits are MSB-first,
    # n_bits counts the valid prefix.
    consumed = 0
    rlc = iM
    get_sym = table_sym
    get_len = table_len
    while o < n_raw:
        if consumed >= n_bits:
            raise ExrError("Huffman data exhausted early")
        # peek up to 14 bits (zero-padded past the end, as OpenEXR does)
        remain = total_bits - consumed
        if remain >= _HUF_DECBITS:
            idx = (acc >> (remain - _HUF_DECBITS)) & ((1 << _HUF_DECBITS) - 1)
        else:
            idx = (acc << (_HUF_DECBITS - remain)) & ((1 << _HUF_DECBITS) - 1)
        s = get_sym[idx]
        if s >= 0:
            l = int(get_len[idx])
        else:
            s = None
            for l in range(_HUF_DECBITS + 1, 59):
                if remain >= l:
                    cd = (acc >> (remain - l)) & ((1 << l) - 1)
                else:
                    cd = (acc << (l - remain)) & ((1 << l) - 1)
                if (l, cd) in long_codes:
                    s = long_codes[(l, cd)]
                    break
            if s is None:
                raise ExrError("invalid Huffman code")
        consumed += l
        if s == rlc:
            remain = total_bits - consumed
            if remain < 8:
                raise ExrError("truncated run length")
            cs = (acc >> (remain - 8)) & 0xFF
            consumed += 8
            if o == 0:
                raise ExrError("run length with no previous symbol")
            out[o : o + cs] = out[o - 1]
            o += cs
        else:
            out[o] = s
            o += 1
    return out


def _wdec14(l: np.ndarray, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    ls = l.astype(np.int16).astype(np.int32)
    hi = h.astype(np.int16).astype(np.int32)
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai.astype(np.int16)
    b = (ai - hi).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wdec16(l: np.ndarray, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(a: np.ndarray, mx: int) -> None:
    """In-place 2D wavelet decode of a (ny, nx) uint16 view (OpenEXR wav2)."""
    ny, nx = a.shape
    wdec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ey, ex = ny - p2, nx - p2
        if ey >= 0 and ex >= 0:
            v00 = a[0 : ey + 1 : p2, 0 : ex + 1 : p2]
            v01 = a[0 : ey + 1 : p2, p : ex + p + 1 : p2]
            v10 = a[p : ey + p + 1 : p2, 0 : ex + 1 : p2]
            v11 = a[p : ey + p + 1 : p2, p : ex + p + 1 : p2]
            i00, i10 = wdec(v00, v10)
            i01, i11 = wdec(v01, v11)
            r00, r01 = wdec(i00, i01)
            r10, r11 = wdec(i10, i11)
            v00[:], v01[:], v10[:], v11[:] = r00, r01, r10, r11
            if nx & p:  # leftover column: 1D vertical pairs
                col = ((ex) // p2 + 1) * p2
                l_ = a[0 : ey + 1 : p2, col]
                h_ = a[p : ey + p + 1 : p2, col]
                i0, i1 = wdec(l_, h_)
                a[0 : ey + 1 : p2, col] = i0
                a[p : ey + p + 1 : p2, col] = i1
            if ny & p:  # leftover line: 1D horizontal pairs
                row = ((ey) // p2 + 1) * p2
                l_ = a[row, 0 : ex + 1 : p2]
                h_ = a[row, p : ex + p + 1 : p2]
                i0, i1 = wdec(l_, h_)
                a[row, 0 : ex + 1 : p2] = i0
                a[row, p : ex + p + 1 : p2] = i1
        p2 = p
        p >>= 1


def _piz_decompress(
    block: bytes, expected: int, ch_bytes, w: int, nlines: int
) -> bytes:
    """PIZ (compression 4): bitmap -> LUT, Huffman, per-channel 2D wavelet."""
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", block, pos)
    pos += 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz : max_nz + 1] = np.frombuffer(block[pos : pos + nb], np.uint8)
        pos += nb
    (length,) = struct.unpack_from("<i", block, pos)
    pos += 4
    if length < 0 or pos + length > len(block):
        raise ExrError("corrupt PIZ block")

    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = np.nonzero(bits)[0].astype(np.uint16)
    max_value = len(lut) - 1

    sizes = [2 if np.dtype(dt).itemsize == 4 else 1 for _, dt in ch_bytes]
    n_raw = sum(w * nlines * s for s in sizes)
    tmp = _huf_decode(block[pos : pos + length], n_raw)

    off = 0
    for (cname, dt), size in zip(ch_bytes, sizes):
        cnt = w * nlines * size
        plane = tmp[off : off + cnt].reshape(nlines, w * size)  # view into tmp
        off += cnt
        for j in range(size):
            _wav2_decode(plane[:, j::size], max_value)
    tmp = lut[tmp]  # applyLut AFTER the wavelet, over the whole buffer
    off = 0
    out = bytearray()
    mapped = []
    for (cname, dt), size in zip(ch_bytes, sizes):
        cnt = w * nlines * size
        mapped.append(tmp[off : off + cnt].reshape(nlines, w * size))
        off += cnt
    for y in range(nlines):
        for plane in mapped:
            out += np.ascontiguousarray(plane[y], dtype="<u2").tobytes()
    if len(out) != expected:
        raise ExrError("PIZ block has wrong decompressed size")
    return bytes(out)


def _pxr24_decompress(
    block: bytes, expected: int, ch_bytes, w: int, nlines: int
) -> bytes:
    """PXR24 (compression 5): zlib over byte-planar, per-plane-deltaed words
    (FLOAT truncated to 24 bits, HALF kept losslessly)."""
    raw = np.frombuffer(zlib.decompress(block), np.uint8)
    pos = 0
    out = bytearray()
    for _y in range(nlines):
        for cname, dt in ch_bytes:
            isz = np.dtype(dt).itemsize
            if isz == 4 and dt == np.float32:
                b0 = raw[pos : pos + w].astype(np.uint32)
                b1 = raw[pos + w : pos + 2 * w].astype(np.uint32)
                b2 = raw[pos + 2 * w : pos + 3 * w].astype(np.uint32)
                pos += 3 * w
                diff = (b0 << 16) | (b1 << 8) | b2
                word = np.cumsum(diff, dtype=np.uint32)
                out += (word << 8).astype("<u4").tobytes()
            elif isz == 2:
                b0 = raw[pos : pos + w].astype(np.uint32)
                b1 = raw[pos + w : pos + 2 * w].astype(np.uint32)
                pos += 2 * w
                diff = (b0 << 8) | b1
                word = np.cumsum(diff, dtype=np.uint32) & 0xFFFF
                out += word.astype("<u2").tobytes()
            else:  # UINT
                b = [
                    raw[pos + i * w : pos + (i + 1) * w].astype(np.uint32)
                    for i in range(4)
                ]
                pos += 4 * w
                diff = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
                word = np.cumsum(diff, dtype=np.uint32)
                out += word.astype("<u4").tobytes()
    if len(out) != expected:
        raise ExrError("PXR24 block has wrong decompressed size")
    return bytes(out)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def decode(data: bytes) -> np.ndarray:
    """Decode an EXR to (H, W, 4) float32 RGBA (missing channels zero-filled,
    missing alpha = 1)."""
    magic, version = struct.unpack_from("<iI", data, 0)
    if magic != _MAGIC:
        raise ExrError("not an EXR file")
    tiled = bool(version & 0x200)
    if version & (0x800 | 0x1000):
        raise ExrError("deep/multipart EXR not supported")

    pos = 8
    channels: list[tuple[str, int]] = []
    compression = None
    data_window = None
    line_order = 0
    tile_desc = None
    while True:
        name, pos = _read_nullterm(data, pos)
        if not name:
            break
        atype, pos = _read_nullterm(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        body = data[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while body[cpos] != 0:
                cname, cpos = _read_nullterm(body, cpos)
                ptype, _pl, _xs, _ys = struct.unpack_from("<iBxxxii", body, cpos)
                cpos += 16
                channels.append((cname, ptype))
        elif name == "compression":
            compression = body[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", body)
        elif name == "lineOrder":
            line_order = body[0]  # parsed but placement uses block-header y
        elif name == "tiles":
            txs, tys, tmode = struct.unpack_from("<IIB", body, 0)
            tile_desc = (txs, tys, tmode)

    if compression not in _COMPRESSION_LINES:
        raise ExrError(
            f"compression type {compression} not supported "
            "(NONE/RLE/ZIPS/ZIP/PIZ/PXR24 only)"
        )
    if data_window is None:
        raise ExrError("missing dataWindow")
    xmin, ymin, xmax, ymax = data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1

    dtypes = {_HALF: np.float16, _FLOAT: np.float32, _UINT: np.uint32}
    ch_bytes = [(n, dtypes[t]) for n, t in channels]
    px_bytes = sum(np.dtype(d).itemsize for _, d in ch_bytes)

    planes = {n: np.zeros((h, w), d) for n, d in ch_bytes}

    def decompress(block, size, expected, bw, nlines):
        if compression == 0 or size >= expected:
            # Blocks are stored raw when compression doesn't shrink them
            # (OpenEXR convention: compressed blocks are always < raw size).
            return block[:expected]
        if compression == 1:
            return _rle_decompress(block, expected)
        if compression in (2, 3):
            return _zip_decompress(block, expected)
        if compression == 4:
            return _piz_decompress(block, expected, ch_bytes, bw, nlines)
        return _pxr24_decompress(block, expected, ch_bytes, bw, nlines)

    def place(raw, x0, y0, bw, nlines):
        bpos = 0
        for line in range(nlines):
            # lineOrder only affects the order blocks appear in the file; the
            # block header's y is absolute and lines within a block ascend.
            y = y0 + line
            for cname, dt in ch_bytes:  # channels stored alphabetically per line
                nb = bw * np.dtype(dt).itemsize
                planes[cname][y, x0 : x0 + bw] = np.frombuffer(
                    raw[bpos : bpos + nb], dt
                )
                bpos += nb

    if tiled:
        if tile_desc is None:
            raise ExrError("tiled EXR missing tiles attribute")
        txs, tys, tmode = tile_desc
        level_mode = tmode & 0xF
        round_up = (tmode >> 4) & 0xF  # 0 = down, 1 = up
        if txs == 0 or tys == 0 or level_mode > 2:
            raise ExrError("corrupt tile description")

        def _lsize(n, l):
            return max(1, -(-n // (1 << l)) if round_up else n >> l)

        def _nlev(n):
            lv, s = 1, n
            while s > 1:
                s = _lsize(n, lv)
                lv += 1
            return lv

        # Offset-table length: tiles across all levels (ONE_LEVEL has just
        # level (0, 0); MIPMAP shrinks x and y together; RIPMAP all pairs).
        if level_mode == 0:
            lpairs = [(0, 0)]
        elif level_mode == 1:
            lpairs = [(l, l) for l in range(_nlev(max(w, h)))]
        else:
            lpairs = [
                (lx, ly)
                for ly in range(_nlev(h))
                for lx in range(_nlev(w))
            ]
        ntiles = sum(
            (-(-_lsize(w, lx) // txs)) * (-(-_lsize(h, ly) // tys))
            for lx, ly in lpairs
        )
        offsets = struct.unpack_from(f"<{ntiles}q", data, pos)
        for off in offsets:
            dx, dy, lx, ly, size = struct.unpack_from("<4iI", data, off)
            if lx or ly:
                continue  # only the full-resolution level feeds the image
            x0, y0 = dx * txs, dy * tys
            if not (0 <= x0 < w and 0 <= y0 < h):
                raise ExrError("tile outside data window")
            bw = min(txs, w - x0)
            nlines = min(tys, h - y0)
            expected = nlines * bw * px_bytes
            block = data[off + 20 : off + 20 + size]
            place(decompress(block, size, expected, bw, nlines), x0, y0, bw, nlines)
    else:
        lines_per_block = _COMPRESSION_LINES[compression]
        nblocks = -(-h // lines_per_block)
        row_bytes = w * px_bytes
        offsets = struct.unpack_from(f"<{nblocks}q", data, pos)
        for off in offsets:
            y0, size = struct.unpack_from("<iI", data, off)
            block = data[off + 8 : off + 8 + size]
            y0 -= ymin
            if not (0 <= y0 < h):
                raise ExrError("scanline block outside data window")
            nlines = min(lines_per_block, h - y0)
            expected = nlines * row_bytes
            place(decompress(block, size, expected, w, nlines), 0, y0, w, nlines)

    out = np.zeros((h, w, 4), np.float32)
    for i, cname in enumerate("RGBA"):
        if cname in planes:
            out[..., i] = planes[cname].astype(np.float32)
        elif cname == "A":
            out[..., 3] = 1.0
    return out


def encode(rgba: np.ndarray, half: bool = False, compression: int = 3) -> bytes:
    """Encode (H, W, 4) float RGBA as a scanline EXR (alpha preserved).

    Default FLOAT pixels + ZIP compression, matching the reference's
    SaveEXR(..., components=4, save_as_fp16=0, ...) call (src/main.cpp:1699).
    """
    rgba = np.asarray(rgba, np.float32)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ExrError(f"expected (H, W, 4) float, got {rgba.shape}")
    if compression not in _ENCODE_COMPRESSION_LINES:
        raise ExrError(f"unsupported encode compression {compression} (NONE/ZIPS/ZIP)")
    h, w, _ = rgba.shape
    dt = np.float16 if half else np.float32
    ptype = _HALF if half else _FLOAT

    # Channels must be listed (and stored per scanline) alphabetically: A B G R.
    ch_order = [("A", 3), ("B", 2), ("G", 1), ("R", 0)]

    def attr(name: str, atype: str, body: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(body)) + body
        )

    chlist = b""
    for cname, _ in ch_order:
        chlist += cname.encode() + b"\x00" + struct.pack("<iBxxxii", ptype, 0, 1, 1)
    chlist += b"\x00"

    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<iI", _MAGIC, 2)
        + attr("channels", "chlist", chlist)
        + attr("compression", "compression", bytes([compression]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00"
    )

    lines_per_block = _COMPRESSION_LINES[compression]
    nblocks = -(-h // lines_per_block)
    blocks = []
    planes = [rgba[..., idx].astype(dt) for _, idx in ch_order]
    for b in range(nblocks):
        y0 = b * lines_per_block
        nlines = min(lines_per_block, h - y0)
        raw = b""
        for line in range(nlines):
            for plane in planes:
                raw += plane[y0 + line].tobytes()
        if compression == 0:
            payload = raw
        else:
            payload = _zip_compress(raw)
            if len(payload) >= len(raw):  # OpenEXR stores raw if ZIP doesn't help
                payload = raw
        blocks.append((y0, payload))

    table_pos = len(header) + 8 * nblocks
    offsets = []
    pos = table_pos
    for y0, payload in blocks:
        offsets.append(pos)
        pos += 8 + len(payload)

    out = bytearray(header)
    for off in offsets:
        out += struct.pack("<q", off)
    for y0, payload in blocks:
        out += struct.pack("<iI", y0, len(payload))
        out += payload
    return bytes(out)


def write(path: str, rgba: np.ndarray, half: bool = False, compression: int = 3) -> None:
    with open(path, "wb") as f:
        f.write(encode(rgba, half=half, compression=compression))
