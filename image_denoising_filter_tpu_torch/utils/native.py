"""ctypes bindings for the native runtime library (native/idf_native.cpp).

The native library mirrors the reference's native host components: the OpenMP
CPU bilateral (src/main.cpp:1732-1921), the lodepng/tinyexr codec roles and
the threaded frame loader of the overlap config. Pure-Python implementations
in utils/png.py / utils/exr.py are the behavioral spec; tests assert
byte-for-byte agreement where formats are deterministic.

Loading order: $IDF_NATIVE_LIB, then <repo>/native/libidf_native.so (built
by `make -C native`), then the port's own build of native/idf_native.cpp in
build/idf_torch_native/<hash>/ at the repository root, where the hash covers
the source, the compiler, the flags and the route taken. Nothing builds at
import: `ensure()` builds the port's library where none is found, and a
Session on a CUDA device calls it.

`build()` compiles the source as it is, with native/Makefile's flags, by the
first of three routes that links OpenMP:
  a. the Makefile's one command, -fopenmp at compile and at link;
  b. where the link cannot read gcc's libgomp.spec: compile with -fopenmp
     -c, then link libgomp.so.1 by path (the compiler's own, else the one
     PyTorch ships) with an rpath to its directory;
  c. where omp.h is missing: route b, with the port's one-declaration omp.h
     (utils/omp_include/) on the include path; omp_get_max_threads is the
     one OpenMP function the source calls.
A compiler that takes no -fopenmp, or finds no libgomp to link, is an error
that carries the compiler's message: a build without OpenMP would run the
cpu8 config on one thread.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..config import CpuBilateralParams

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "idf_native.cpp"
MAKE_LIB = _REPO / "native" / "libidf_native.so"
BUILD_ROOT = _REPO / "build" / "idf_torch_native"
OMP_INCLUDE = Path(__file__).resolve().parent / "omp_include"
LIB_NAME = "libidf_native.so"
INFO_NAME = "build.json"
# native/Makefile's CXXFLAGS and LDFLAGS; routes b and c link LIBS and
# libgomp by path instead of LDFLAGS.
CXXFLAGS = ("-O3", "-fPIC", "-fopenmp", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-fopenmp", "-lz", "-lpthread")
LIBS = ("-lz", "-lpthread")
ROUTES = ("a", "b", "c")
_BUILD_TIMEOUT_S = 300


class NativeUnavailable(ImportError):
    pass


class NativeBuildError(RuntimeError):
    """The port's build of the native library failed, or the library found
    has no OpenMP; the message carries the compiler's."""


@dataclasses.dataclass(frozen=True)
class NativeLibrary:
    """The loaded native library and how it came to be.

    route: "a", "b" or "c" for the port's build (see the module docstring),
    "IDF_NATIVE_LIB" or "make -C native" for a library built elsewhere;
    threads: idf_num_threads(), OpenMP's default team size in this process;
    openmp: whether the library links an OpenMP runtime; compiler: the
    compiler's first --version line and libgomp the libgomp.so.1 the build
    linked ("" for a library built elsewhere); build_s and log: the seconds
    this process spent building it and the compiler's output (0.0 and ""
    when it was found built)."""

    path: str
    route: str
    threads: int
    openmp: bool
    compiler: str = ""
    libgomp: str = ""
    build_s: float = 0.0
    log: str = ""


class _Loaded:
    """The library this process loaded (one a process), or that none was
    found by the loading order."""

    def __init__(self) -> None:
        self.lib: Optional[ctypes.CDLL] = None
        self.info: Optional[NativeLibrary] = None
        self.missing = False


_loaded = _Loaded()


def _run(cmd: list[str]) -> tuple[int, str]:
    """(exit code, stdout + stderr) of a compiler command; 127 where it
    cannot start."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
    except OSError as e:
        return 127, str(e)
    return res.returncode, res.stdout + res.stderr


def _cxx() -> Optional[str]:
    """The C++ compiler: $CXX, then g++, as found on PATH; None without one."""
    for cand in (os.environ.get("CXX"), "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    return None


def _library_path(root: Path | str, cxx: str, route: str) -> Path:
    """Where the port's build by `cxx` along `route` lives under root."""
    digest = hashlib.sha256()
    for part in (cxx, route, *CXXFLAGS, *LDFLAGS, *LIBS):
        digest.update(part.encode() + b"\0")
    digest.update(SOURCE.read_bytes())
    if route == "c":
        digest.update((OMP_INCLUDE / "omp.h").read_bytes())
    return Path(root) / digest.hexdigest()[:16] / LIB_NAME


def _print_file(cxx: str, name: str) -> Optional[str]:
    """The file `cxx -print-file-name=name` resolves to, if it exists (the
    compiler prints the bare name where it finds none)."""
    rc, text = _run([cxx, f"-print-file-name={name}"])
    path = text.strip()
    return path if rc == 0 and os.path.isabs(path) and os.path.isfile(path) else None


def _libgomp(cxx: str) -> str:
    """The libgomp.so.1 routes b and c link by path: the compiler's own,
    else the one PyTorch ships (torch/lib, or torch.libs in some wheels)."""
    path = _print_file(cxx, "libgomp.so.1")
    if path:
        return path
    spec = importlib.util.find_spec("torch")
    for base in (spec.submodule_search_locations or []) if spec else []:
        for d in (Path(base) / "lib", Path(base).parent / "torch.libs"):
            found = sorted(d.glob("libgomp*.so*"))
            if found:
                return str(found[0])
    raise NativeBuildError(
        f"no libgomp.so.1 to link: `{cxx} -print-file-name=libgomp.so.1` names no "
        "file and PyTorch ships none"
    )


def _compile(cxx: str, tmp: Path) -> tuple[str, str, str]:
    """Build tmp/LIB_NAME by the first route that works. Returns (route,
    compiler log, the libgomp linked)."""
    out, obj = tmp / LIB_NAME, tmp / "idf_native.o"
    rc, log = _run([cxx, *CXXFLAGS, str(SOURCE), "-o", str(out), *LDFLAGS])
    if rc == 0:
        return "a", log, _print_file(cxx, "libgomp.so.1") or "-lgomp"
    if "omp.h" in log:
        route, include = "c", ("-I", str(OMP_INCLUDE))
    elif "libgomp.spec" in log:
        route, include = "b", ()
    else:
        raise NativeBuildError(
            f"{cxx} could not build {SOURCE.name} with OpenMP (rc {rc}):\n{log.strip()}"
        )
    rc, text = _run([cxx, *CXXFLAGS, *include, "-c", str(SOURCE), "-o", str(obj)])
    log += text
    if rc:
        raise NativeBuildError(
            f"route {route}: {cxx} could not compile {SOURCE.name} with -fopenmp "
            f"(rc {rc}):\n{log.strip()}"
        )
    libgomp = _libgomp(cxx)
    rpath = f"-Wl,-rpath,{os.path.dirname(libgomp)}"
    rc, text = _run([cxx, "-shared", str(obj), "-o", str(out), libgomp, rpath, *LIBS])
    log += text
    if rc:
        raise NativeBuildError(
            f"route {route}: {cxx} could not link {libgomp} (rc {rc}):\n{log.strip()}"
        )
    return route, log, libgomp


def build(root: Path | str = BUILD_ROOT) -> tuple[Path, str, str]:
    """Compile native/idf_native.cpp into root unless a build of this source
    by this compiler is there. Returns (library path, route, compiler log;
    empty when nothing was compiled). The work happens in a private
    temporary directory and the library is renamed into place last, after
    its build.json, so concurrent builds never load a half-written file."""
    cxx = _cxx()
    if cxx is None:
        raise NativeBuildError("no C++ compiler: set CXX or put g++ on PATH")
    for route in ROUTES:
        lib = _library_path(root, cxx, route)
        if lib.exists():
            return lib, route, ""
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root, prefix="tmp-") as tmp:
        route, log, libgomp = _compile(cxx, Path(tmp))
        lib = _library_path(root, cxx, route)
        lib.parent.mkdir(parents=True, exist_ok=True)
        version = _run([cxx, "--version"])[1].strip().splitlines()
        info = {"route": route, "compiler": version[0] if version else cxx,
                "libgomp": libgomp}
        Path(tmp, INFO_NAME).write_text(json.dumps(info))
        os.replace(Path(tmp, INFO_NAME), lib.parent / INFO_NAME)
        os.replace(Path(tmp, LIB_NAME), lib)
    return lib, route, log


def _find(root: Path | str) -> Optional[tuple[str, str]]:
    """(path, route) of the first library of the loading order, or None."""
    given = os.environ.get("IDF_NATIVE_LIB")
    if given and os.path.exists(given):
        return given, "IDF_NATIVE_LIB"
    if MAKE_LIB.exists():
        return str(MAKE_LIB), "make -C native"
    cxx = _cxx()
    if cxx is not None:
        for route in ROUTES:
            lib = _library_path(root, cxx, route)
            if lib.exists():
                return str(lib), route
    return None


def _load(path: str, route: str, build_s: float = 0.0, log: str = "") -> None:
    """Load the library at path into _loaded, with its C signatures."""
    lib = ctypes.CDLL(path)
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
    info_path = Path(path).parent / INFO_NAME
    built = json.loads(info_path.read_text()) if route in ROUTES and info_path.exists() else {}
    _loaded.lib = lib
    _loaded.info = NativeLibrary(
        path=path, route=route, threads=lib.idf_num_threads(),
        # dlsym on the library's handle searches it and its dependencies
        # only: the symbol resolves where the library links libgomp.
        openmp=hasattr(lib, "omp_get_max_threads"),
        compiler=built.get("compiler", ""), libgomp=built.get("libgomp", ""),
        build_s=build_s, log=log,
    )
    _loaded.missing = False


def _lib() -> ctypes.CDLL:
    """The loaded library; the first call searches the loading order."""
    if _loaded.lib is None:
        found = None if _loaded.missing else _find(BUILD_ROOT)
        if found is None:
            _loaded.missing = True
            raise NativeUnavailable(
                "libidf_native.so not built (run `make -C native`, or native.ensure())"
            )
        _load(*found)
    return _loaded.lib


def ensure(root: Path | str = BUILD_ROOT) -> NativeLibrary:
    """The native library with OpenMP, loaded: the first of the loading
    order, else the port's build into root, made now. Raises
    NativeBuildError where the build fails or the library has no OpenMP."""
    if _loaded.lib is None:
        found = _find(root)
        build_s, log = 0.0, ""
        if found is None:
            t0 = time.perf_counter()
            path, route, log = build(root)
            found, build_s = (str(path), route), time.perf_counter() - t0
        _load(*found, build_s, log)
    info = _loaded.info
    if not info.openmp:
        raise NativeBuildError(
            f"{info.path} ({info.route}) links no OpenMP runtime: the cpu8 config would "
            "run on one thread"
        )
    return info


def available() -> bool:
    """Whether a native library is loaded or found by the loading order
    (searched once a process until ensure() builds one)."""
    try:
        _lib()
        return True
    except (NativeUnavailable, OSError):
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
        self._lib = _lib()
        lib = self._lib
        self._paths = [os.fspath(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        self._handle = lib.idf_loader_create(arr, len(self._paths), lookahead, threads)

    def __len__(self) -> int:
        return len(self._paths)

    def get(self, idx: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        """Fetch frame idx (blocking): a new array, or copied into `out`
        (float32, the frame's shape), which is returned. Gets must be
        monotonically increasing: get(i) releases every frame <= i, one that
        failed to decode too; a later get(j <= i) raises, as does a get
        after close()."""
        if not self._handle:
            raise ValueError("frame loader already closed")
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
        try:
            if rc != 0:
                raise ValueError(f"frame decode failed for {self._paths[idx]} (code {rc})")
            frame = np.ctypeslib.as_array(data, shape=(h.value, w.value, 4))
            if out is None:
                return frame.copy()
            np.copyto(out, frame)
            return out
        finally:
            self._lib.idf_loader_release(self._handle, idx)

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
