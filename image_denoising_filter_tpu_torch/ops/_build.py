"""Build the port's CUDA kernels at first use and load them with ctypes.

`nvcc` compiles each source of `ops/csrc/` into an object, all sources at
once in parallel processes, and links the objects into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library goes to `build/idf_torch_kernels/<hash>/libidf_torch_kernels.so` at
the repository root, where the hash covers the sources and the flags (with
the kernels' block macros from ops/stencils.py and ops/fast.py): a changed
source builds anew, an unchanged one loads what is there. Nothing is
committed and nothing falls back: without `nvcc` the build raises.

The build directory is found relative to the package, so the kernels build
from a source checkout or an editable install (`pip install -e .`); a
non-editable install would put `build/` beside site-packages, and is not a
supported way to run the port on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("stencils.cu", "fast.cu")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "idf_torch_kernels"
LIB_NAME = "libidf_torch_kernels.so"
# No --use_fast_math: the exact kernels are held to rtol 1e-4, and fast
# exp2/division would spend that margin. -Xptxas -v reports registers,
# shared memory and spills of every kernel in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600


def _flags() -> tuple[str, ...]:
    """NVCC_FLAGS and the kernels' blocks, which ops/stencils.py (the
    bilateral and NLM kernels) and ops/fast.py (the grid build and the fused
    kernels) define."""
    from . import fast, stencils

    return NVCC_FLAGS + stencils.nvcc_defines() + fast.nvcc_defines()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of image_denoising_filter_tpu_torch "
        "are compiled from ops/csrc at first use and need the CUDA toolkit "
        "(put nvcc on PATH or set CUDA_HOME)"
    )


def _library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(_flags()).encode())
    for name in _SOURCES:
        digest.update(name.encode())
        digest.update((_CSRC / name).read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build() -> tuple[Path, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns (library path, compiler log); the log is empty when nothing was
    compiled. One nvcc per source, all started together, then one link. The
    work happens in a private temporary directory and the library is renamed
    into place, so concurrent builds never load a half-written file."""
    lib = _library_path()
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp, Path(s).stem + ".o") for s in _SOURCES]
        procs = []
        try:
            for src, obj in zip(_SOURCES, objs):
                with open(obj.with_suffix(".log"), "w") as log:
                    cmd = [nvcc, *_flags(), "-c", "-o", str(obj), str(_CSRC / src)]
                    procs.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
            rcs = [p.wait(timeout=_BUILD_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = "".join(obj.with_suffix(".log").read_text() for obj in objs)
        if any(rcs):
            raise RuntimeError(f"nvcc failed with codes {rcs}:\n{text}")
        out = Path(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(out), *map(str, objs)],
            capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S,
        )
        text += link.stdout + link.stderr
        if link.returncode:
            raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n{text}")
        os.replace(out, lib)
    return lib, text


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), with its C
    signatures declared: every pointer and the stream as c_void_p, the int
    out-parameters as c_int pointers, normalize's pixel count as 64 bits."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    i32p = ctypes.POINTER(i32)
    lib.idf_bilateral.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, ptr, i32, f32, f32, i32, i32, i32, i32, i32, ptr, ptr,
    ]
    lib.idf_bilateral.restype = i32
    lib.idf_bilateral_info.argtypes = [i32, i32, i32, i32, i32, i32, i32, i32p]
    lib.idf_bilateral_info.restype = i32
    lib.idf_nlm.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr, i32, f32, f32, f32, i32, i32, i32,
        ptr, ptr,
    ]
    lib.idf_nlm.restype = i32
    lib.idf_max_shared_bytes.argtypes = [i32p]
    lib.idf_max_shared_bytes.restype = i32
    lib.idf_nlm_info.argtypes = [i32, i32, i32, i32, i32, i32p]
    lib.idf_nlm_info.restype = i32
    lib.idf_nlm_hrw.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr, i32, f32, f32, f32, i32, i32, i32, ptr, ptr,
    ]
    lib.idf_nlm_hrw.restype = i32
    lib.idf_nlm_hrw_info.argtypes = [i32, i32, i32, i32p]
    lib.idf_nlm_hrw_info.restype = i32
    lib.idf_normalize.argtypes = [ptr, ptr, ptr, i64, f32, f32, f32, f32, ptr]
    lib.idf_normalize.restype = i32
    lib.idf_pool.argtypes = [ptr, ptr, i32, i32, i32, i32, ptr]
    lib.idf_pool.restype = i32
    lib.idf_build_grid.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, ptr, i32, f32, i32, i32, ptr, ptr,
    ]
    lib.idf_build_grid.restype = i32
    lib.idf_build_grid_info.argtypes = [i32, i32, i32p]
    lib.idf_build_grid_info.restype = i32
    lib.idf_build_grid_d1.argtypes = lib.idf_build_grid.argtypes
    lib.idf_build_grid_d1.restype = i32
    lib.idf_build_grid_d1_info.argtypes = [i32, i32, i32p]
    lib.idf_build_grid_d1_info.restype = i32
    lib.idf_slice_grid.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.idf_slice_grid.restype = i32
    lib.idf_slice_grid_bilinear.argtypes = lib.idf_slice_grid.argtypes
    lib.idf_slice_grid_bilinear.restype = i32
    lib.idf_build_guided_grid.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr, i32, f32, i32, ptr, ptr,
    ]
    lib.idf_build_guided_grid.restype = i32
    lib.idf_build_guided_grid_info.argtypes = [i32, i32, i32p]
    lib.idf_build_guided_grid_info.restype = i32
    lib.idf_build_guided_grid_d1.argtypes = lib.idf_build_guided_grid.argtypes
    lib.idf_build_guided_grid_d1.restype = i32
    lib.idf_build_guided_grid_d1_info.argtypes = [i32, i32, i32p]
    lib.idf_build_guided_grid_d1_info.restype = i32
    lib.idf_slice_guided_grid.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.idf_slice_guided_grid.restype = i32
    lib.idf_fused_grid.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, ptr, i32, f32, i32, i32, i32, ptr, ptr,
    ]
    lib.idf_fused_grid.restype = i32
    lib.idf_fused_grid_info.argtypes = [i32, i32, i32, i32p]
    lib.idf_fused_grid_info.restype = i32
    lib.idf_fused_guided.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, ptr, i32, f32, i32, i32, ptr, ptr,
    ]
    lib.idf_fused_guided.restype = i32
    lib.idf_fused_guided_info.argtypes = [i32, i32, i32p]
    lib.idf_fused_guided_info.restype = i32
    return lib
