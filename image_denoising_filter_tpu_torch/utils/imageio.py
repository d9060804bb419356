"""Image load/save dispatch with the reference's exact LDR<->float semantics.

The reference decides HDR-ness by extension: `.exr` => HDR float path, anything
else => LDR PNG path (src/main.cpp:1380, 1735). LDR bytes become floats via
`x * (1/255)` on upload (src/main.cpp:1125-1128) and floats become bytes via an
*unclamped* `(unsigned char)(255 * x)` cast on readback (src/main.cpp:97-102) --
values > 1 wrap modulo 256 and negatives are UB in C; we reproduce the wrap via
int truncation mod 256, which matches the common-case behavior and is
well-defined. Use `quantize(..., clamp=True)` for the sane mode.

The PNG save is png.encode_bands, whatever `codec()` says: the frame's row
bands quantize, filter and deflate on the host's cores into one zlib stream.
Decodes and the EXR save take the codec `codec()` names. An EXR decode on
the calling thread and an EXR save's encode lie in the spans
`timing.EXR_DECODE` and `timing.EXR_ENCODE`; `timing.EXR_BYTES` counts the
encoded bytes.
"""

from __future__ import annotations

import os

import numpy as np

from . import exr as _exr
from . import native as _native
from . import png as _png
from . import timing as _timing


def _read_png(path: str) -> np.ndarray:
    if _native.available():
        with open(path, "rb") as f:
            data = f.read()
        try:
            return _native.png_decode(data)
        except ValueError:
            # Per-file fallback: the Python decoder covers a wider subset
            # (interlaced, 16-bit, sub-byte depths).
            return _png.decode(data)
    return _png.read(path)


def _write_png(path: str, rgba: np.ndarray, clamp: bool) -> None:
    data = _png.encode_bands(np.asarray(rgba), lambda rows: quantize(rows, clamp))
    with open(path, "wb") as f:
        f.write(data)


def _read_exr(path: str) -> np.ndarray:
    with _timing.span(_timing.EXR_DECODE):
        if _native.available():
            with open(path, "rb") as f:
                data = f.read()
            try:
                return _native.exr_decode(data)
            except ValueError:
                # Per-file fallback: the Python decoder additionally covers
                # RLE/PIZ/PXR24 compression.
                return _exr.decode(data)
        return _exr.read(path)


def _write_exr(path: str, rgba: np.ndarray) -> None:
    with _timing.span(_timing.EXR_ENCODE):
        if _native.available():
            data = _native.exr_encode(np.ascontiguousarray(rgba, np.float32))
        else:
            data = _exr.encode(rgba)
    _timing.count(_timing.EXR_BYTES, len(data))
    with open(path, "wb") as f:
        f.write(data)


def codec() -> str:
    """The codec that load and the EXR save run in this process: "native"
    (the C++ codecs (lodepng/tinyexr role) of the native library that
    utils/native.py loaded or found; a file they cannot decode falls back to
    the Python codec) or "python" (utils/png.py and utils/exr.py). Read at
    each call, so they take the library that native.ensure() builds from
    then on. The PNG save is png.encode_bands under either."""
    return "native" if _native.available() else "python"


def is_hdr_path(path: str) -> bool:
    """`.exr` extension => HDR (src/main.cpp:1380)."""
    return os.path.splitext(path)[1] == ".exr"


def to_float(rgba_u8: np.ndarray) -> np.ndarray:
    """LDR bytes -> float32 in [0, 1] via x * (1/255) (src/main.cpp:1125-1128)."""
    return rgba_u8.astype(np.float32) * np.float32(1.0 / 255.0)


def quantize(rgba_f32: np.ndarray, clamp: bool = False) -> np.ndarray:
    """float32 -> LDR bytes via (unsigned char)(255 * x) (src/main.cpp:97-102).

    clamp=False reproduces the reference's unclamped cast (wraps mod 256);
    clamp=True is the well-behaved saturating mode.
    """
    scaled = np.asarray(rgba_f32, np.float32) * np.float32(255.0)
    if clamp:
        return np.clip(np.trunc(scaled), 0.0, 255.0).astype(np.uint8)
    return (np.trunc(scaled).astype(np.int64) & 0xFF).astype(np.uint8)


def load(path: str) -> tuple[np.ndarray, bool]:
    """Load an image as float32 (H, W, 4) RGBA. Returns (image, is_hdr)."""
    if is_hdr_path(path):
        return _read_exr(path), True
    return to_float(_read_png(path)), False


def save(path: str, rgba: np.ndarray, hdr: bool | None = None, clamp: bool = False) -> None:
    """Save a float32 (H, W, 4) RGBA image; HDR-ness from extension by default."""
    if hdr is None:
        hdr = is_hdr_path(path)
    if hdr:
        _write_exr(path, rgba)
    else:
        _write_png(path, rgba, clamp)
