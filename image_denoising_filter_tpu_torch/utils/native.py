"""ctypes bindings for the native runtime library (native/idf_native.cpp).

The native library mirrors the reference's native host components: the OpenMP
CPU bilateral (src/main.cpp:1732-1921) and the lodepng/tinyexr codec roles.
Pure-Python implementations in utils/png.py / utils/exr.py are the behavioral
spec; tests assert byte-for-byte agreement where formats are deterministic.

Build with `make -C native`. Loading order: $IDF_NATIVE_LIB, then
<repo>/native/libidf_native.so, then alongside this package.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..config import CpuBilateralParams

_SEARCH = (
    os.environ.get("IDF_NATIVE_LIB"),
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libidf_native.so"),
    os.path.join(os.path.dirname(__file__), "libidf_native.so"),
)


class NativeUnavailable(ImportError):
    pass


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    for path in _SEARCH:
        if path and os.path.exists(path):
            lib = ctypes.CDLL(path)
            break
    else:
        raise NativeUnavailable(
            "libidf_native.so not built (run `make -C native`)"
        )

    lib.idf_free.argtypes = [ctypes.c_void_p]
    lib.idf_cpu_bilateral.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.idf_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.idf_png_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.idf_exr_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.idf_exr_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.idf_num_threads.restype = ctypes.c_int
    return lib


def available() -> bool:
    try:
        _lib()
        return True
    except NativeUnavailable:
        return False


def cpu_bilateral(
    img: np.ndarray, params: CpuBilateralParams | None = None, num_threads: int = 1
) -> np.ndarray:
    """OpenMP CPU bilateral oracle (RunOnCPU analog). img: (H, W, 4) float32."""
    if params is None:
        params = CpuBilateralParams()
    lib = _lib()
    img = np.ascontiguousarray(img, np.float32)
    h, w, _ = img.shape
    out = np.empty_like(img)
    lib.idf_cpu_bilateral(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, params.radius,
        params.sigma_spatial, params.sigma_color,
        int(params.blue_bug), int(params.skip_border),
        int(params.force_alpha_one), num_threads,
    )
    return out


def png_decode(data: bytes) -> np.ndarray:
    lib = _lib()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.idf_png_decode(data, len(data), ctypes.byref(buf), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"native png decode failed (code {rc})")
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 4)).copy()
    finally:
        lib.idf_free(buf)
    return arr


def png_encode(rgba: np.ndarray, level: int = 6) -> bytes:
    lib = _lib()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, _ = rgba.shape
    buf = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    rc = lib.idf_png_encode(
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, level,
        ctypes.byref(buf), ctypes.byref(size),
    )
    if rc != 0:
        raise ValueError(f"native png encode failed (code {rc})")
    try:
        out = ctypes.string_at(buf, size.value)
    finally:
        lib.idf_free(buf)
    return out


def exr_decode(data: bytes) -> np.ndarray:
    lib = _lib()
    buf = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.idf_exr_decode(data, len(data), ctypes.byref(buf), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"native exr decode failed (code {rc})")
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 4)).copy()
    finally:
        lib.idf_free(buf)
    return arr


def exr_encode(rgba: np.ndarray, half: bool = False, compression: int = 3) -> bytes:
    lib = _lib()
    rgba = np.ascontiguousarray(rgba, np.float32)
    h, w, _ = rgba.shape
    buf = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    rc = lib.idf_exr_encode(
        rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w, h,
        int(half), compression, ctypes.byref(buf), ctypes.byref(size),
    )
    if rc != 0:
        raise ValueError(f"native exr encode failed (code {rc})")
    try:
        out = ctypes.string_at(buf, size.value)
    finally:
        lib.idf_free(buf)
    return out


class FrameLoader:
    """Threaded native frame loader: background decode with bounded lookahead.

    Wraps idf_loader_* (native/idf_native.cpp): frames decode on C++ worker
    threads while the device computes, so host decode never serializes the
    streaming pipeline. Iterate to get float32 (H, W, 4) arrays in order.
    """

    def __init__(self, paths, lookahead: int = 4, threads: int = 4) -> None:
        lib = _lib()
        lib.idf_loader_create.restype = ctypes.c_void_p
        lib.idf_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.idf_loader_get.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.idf_loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.idf_loader_destroy.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._paths = [os.fspath(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        self._handle = lib.idf_loader_create(arr, len(self._paths), lookahead, threads)

    def __len__(self) -> int:
        return len(self._paths)

    def get(self, idx: int) -> np.ndarray:
        """Fetch frame idx (blocking). Gets must be monotonically increasing:
        get(i) releases every frame <= i; a later get(j <= i) raises."""
        data = ctypes.POINTER(ctypes.c_float)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.idf_loader_get(
            self._handle, idx, ctypes.byref(data), ctypes.byref(w), ctypes.byref(h)
        )
        if rc == 200:
            raise ValueError(f"frame index {idx} out of range (0..{len(self._paths) - 1})")
        if rc == 201:
            raise ValueError(f"frame {idx} already released (gets must be monotonic)")
        if rc != 0:
            raise ValueError(f"frame decode failed for {self._paths[idx]} (code {rc})")
        out = np.ctypeslib.as_array(data, shape=(h.value, w.value, 4)).copy()
        self._lib.idf_loader_release(self._handle, idx)
        return out

    def __iter__(self):
        for i in range(len(self._paths)):
            yield self.get(i)

    def close(self) -> None:
        if self._handle:
            self._lib.idf_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:
            pass
