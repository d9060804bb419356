"""The port's build of the native host library (utils/native.py) and what
runs on it: the route choice with fake compilers, the build's hash, real
builds of native/idf_native.cpp by each route, the OpenMP CPU bilateral
against both packages' NumPy oracles, the C++ codecs and the threaded frame
loader against the Python codecs, `Session.run_cpu(8)` and the overlap
prefetcher on the library, and two processes building at once.

Every build goes into a temporary build root; no test writes
native/libidf_native.so or the default build/idf_torch_native/. The real
builds need a C++ compiler with OpenMP (g++ here) and skip without one.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from image_denoising_filter_tpu import config as jconfig
from image_denoising_filter_tpu.ops import reference as jreference
from image_denoising_filter_tpu_torch.config import CpuBilateralParams, RunConfig
from image_denoising_filter_tpu_torch.ops import reference
from image_denoising_filter_tpu_torch.runtime import FramePrefetcher, Session
from image_denoising_filter_tpu_torch.utils import exr, imageio, native, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def fresh(monkeypatch, tmp_path):
    """No library loaded, none given by $IDF_NATIVE_LIB or `make -C native`:
    each test starts as a process that has loaded nothing, and leaves the
    process's library as it found it."""
    monkeypatch.setattr(native, "_loaded", native._Loaded())
    monkeypatch.delenv("IDF_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "MAKE_LIB", tmp_path / "no_make" / native.LIB_NAME)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "default_root")


@pytest.fixture(scope="module")
def real_cxx():
    cxx = native._cxx()
    if cxx is None:
        pytest.skip("no C++ compiler found (set CXX or put g++ on PATH)")
    return cxx


@pytest.fixture(scope="module")
def root(real_cxx, tmp_path_factory):
    """A build root holding the port's build by the default compiler."""
    path = tmp_path_factory.mktemp("native_root")
    native.build(path)
    return path


def _fake(tmp_path, name, body):
    """A fake compiler: a shell script that logs its arguments and runs
    `body` (a case on " $* "); where the body falls through it writes the
    file after -o and succeeds."""
    path = tmp_path / name
    log = tmp_path / f"{name}.log"
    path.write_text(f"""#!/bin/sh
echo "$*" >> {log}
case " $* " in
{body}
esac
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
[ -n "$out" ] && : > "$out"
exit 0
""")
    path.chmod(0o755)
    return str(path), log


GOMP_FAKE = """  *" -print-file-name=libgomp.so.1 "*) echo {gomp}; exit 0;;"""
NO_SPEC = """  *" -shared -fopenmp "*) echo "g++: fatal error: cannot read spec file 'libgomp.spec': No such file or directory" >&2; exit 1;;"""
NO_OMP_H = """  *" -I "*) ;;
  *" -fopenmp "*) echo "idf_native.cpp:22:10: fatal error: omp.h: No such file or directory" >&2; exit 1;;"""
NO_OPENMP = """  *" -fopenmp "*) echo "c++: error: unrecognized command-line option '-fopenmp'" >&2; exit 1;;"""


def _build_with(monkeypatch, cxx, root):
    monkeypatch.setenv("CXX", cxx)
    path, route, _ = native.build(root)
    info = json.loads((path.parent / native.INFO_NAME).read_text())
    assert info["route"] == route
    return path, route, info


# ---------------------------------------------------------------------------
# The route choice, in pure Python (fake compilers)
# ---------------------------------------------------------------------------


def test_route_a_is_the_makefiles_command(monkeypatch, tmp_path):
    gomp = tmp_path / "libgomp.so.1"
    gomp.touch()
    cxx, log = _fake(tmp_path, "cxx", GOMP_FAKE.format(gomp=gomp))
    path, route, info = _build_with(monkeypatch, cxx, tmp_path / "root")
    assert route == "a" and path.exists() and info["libgomp"] == str(gomp)
    build_cmd = log.read_text().splitlines()[0].split()
    assert build_cmd[:len(native.CXXFLAGS)] == list(native.CXXFLAGS)
    assert build_cmd[-len(native.LDFLAGS):] == list(native.LDFLAGS)


def test_route_b_where_the_link_finds_no_libgomp_spec(monkeypatch, tmp_path):
    gomp = tmp_path / "gomp_dir" / "libgomp.so.1"
    gomp.parent.mkdir()
    gomp.touch()
    cxx, log = _fake(tmp_path, "cxx", NO_SPEC + "\n" + GOMP_FAKE.format(gomp=gomp))
    path, route, info = _build_with(monkeypatch, cxx, tmp_path / "root")
    assert route == "b" and path.exists() and info["libgomp"] == str(gomp)
    compile_cmd, link_cmd = [
        line.split() for line in log.read_text().splitlines() if "-o" in line.split()][1:3]
    assert "-c" in compile_cmd and "-fopenmp" in compile_cmd and "-I" not in compile_cmd
    assert "-fopenmp" not in link_cmd and str(gomp) in link_cmd
    assert f"-Wl,-rpath,{gomp.parent}" in link_cmd


def test_route_b_links_pytorchs_libgomp_where_the_compiler_has_none(monkeypatch, tmp_path):
    """-print-file-name prints the bare name where the compiler finds no
    such file: the link takes the libgomp PyTorch ships."""
    import torch

    cxx, _ = _fake(tmp_path, "cxx", NO_SPEC + "\n" + GOMP_FAKE.format(gomp="libgomp.so.1"))
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    if not any(f.startswith("libgomp") for f in os.listdir(torch_lib)):
        pytest.skip("this PyTorch ships no libgomp in torch/lib")
    _, route, info = _build_with(monkeypatch, cxx, tmp_path / "root")
    assert route == "b" and info["libgomp"].startswith(torch_lib)


def test_no_libgomp_anywhere_raises(monkeypatch, tmp_path):
    cxx, _ = _fake(tmp_path, "cxx", NO_SPEC + "\n" + GOMP_FAKE.format(gomp="libgomp.so.1"))
    monkeypatch.setattr(native.importlib.util, "find_spec", lambda name: None)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(native.NativeBuildError, match="no libgomp.so.1 to link"):
        native.build(tmp_path / "root")


def test_route_c_where_omp_h_is_missing(monkeypatch, tmp_path):
    gomp = tmp_path / "libgomp.so.1"
    gomp.touch()
    cxx, log = _fake(tmp_path, "cxx", NO_OMP_H + "\n" + GOMP_FAKE.format(gomp=gomp))
    path, route, info = _build_with(monkeypatch, cxx, tmp_path / "root")
    assert route == "c" and path.exists()
    compile_cmd = [line.split() for line in log.read_text().splitlines()
                   if "-c" in line.split()][0]
    i = compile_cmd.index("-I")
    assert compile_cmd[i + 1] == str(native.OMP_INCLUDE)
    assert (native.OMP_INCLUDE / "omp.h").read_text().count("omp_get_max_threads") == 1


def test_no_openmp_raises_with_the_compilers_message(monkeypatch, tmp_path):
    cxx, _ = _fake(tmp_path, "cxx", NO_OPENMP)
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(native.NativeBuildError, match="unrecognized command-line option"):
        native.ensure(tmp_path / "root")
    assert not any((tmp_path / "root").glob(f"*/{native.LIB_NAME}"))


def test_a_failing_compiler_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(native.NativeBuildError, match="/bin/false"):
        native.ensure(tmp_path / "root")
    assert os.listdir(tmp_path / "root") == []
    assert not native.available()


def test_no_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(native.NativeBuildError, match="no C\\+\\+ compiler"):
        native.build(tmp_path / "root")


def test_hash_covers_source_flags_route_and_compiler(monkeypatch, tmp_path):
    base = native._library_path(tmp_path, "/usr/bin/g++", "a")
    assert base == native._library_path(tmp_path, "/usr/bin/g++", "a")
    assert base.name == native.LIB_NAME and base.parent.parent == tmp_path
    others = [native._library_path(tmp_path, "/usr/bin/g++", "b"),
              native._library_path(tmp_path, "/usr/bin/g++", "c"),
              native._library_path(tmp_path, "/usr/bin/clang++", "a")]
    src = tmp_path / "idf_native.cpp"
    src.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", src)
    others.append(native._library_path(tmp_path, "/usr/bin/g++", "a"))
    monkeypatch.setattr(native, "SOURCE", native._REPO / "native" / "idf_native.cpp")
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ("-march=x86-64-v3",))
    others.append(native._library_path(tmp_path, "/usr/bin/g++", "a"))
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS[:-1])
    monkeypatch.setattr(native, "LDFLAGS", native.LDFLAGS + ("-s",))
    others.append(native._library_path(tmp_path, "/usr/bin/g++", "a"))
    assert len({base, *others}) == 1 + len(others)


def test_loading_order(monkeypatch, tmp_path, root):
    """$IDF_NATIVE_LIB, then `make -C native`'s library, then the port's
    build; nothing builds while a library is found."""
    (built,) = root.glob(f"*/{native.LIB_NAME}")
    assert native._find(root) == (str(built), "a")
    make_lib = tmp_path / "make" / native.LIB_NAME
    make_lib.parent.mkdir()
    make_lib.write_bytes(built.read_bytes())
    monkeypatch.setattr(native, "MAKE_LIB", make_lib)
    assert native._find(root) == (str(make_lib), "make -C native")
    monkeypatch.setenv("IDF_NATIVE_LIB", str(built))
    assert native._find(root) == (str(built), "IDF_NATIVE_LIB")
    monkeypatch.setenv("CXX", "/bin/false")
    info = native.ensure(root)
    assert (info.route, info.build_s, info.compiler) == ("IDF_NATIVE_LIB", 0.0, "")


def test_nothing_found_is_not_available_until_ensure(real_cxx, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "root")
    assert not native.available() and imageio.codec() == "python"
    with pytest.raises(native.NativeUnavailable):
        native.cpu_bilateral(np.zeros((4, 4, 4), np.float32))
    info = native.ensure(tmp_path / "root")
    assert info.route == "a" and info.build_s > 0.0 and info.openmp
    assert native.available() and imageio.codec() == "native"


# ---------------------------------------------------------------------------
# Real builds
# ---------------------------------------------------------------------------


def _wrapper(tmp_path, name, body, real_cxx):
    """A compiler that refuses what `body` refuses and hands everything else
    to the real compiler."""
    path = tmp_path / name
    path.write_text(f"""#!/bin/sh
case " $* " in
{body}
esac
exec {real_cxx} "$@"
""")
    path.chmod(0o755)
    return str(path)


def test_real_build_route_a(root):
    info = native.ensure(root)
    assert info.route == "a" and info.openmp and info.threads >= 1
    assert info.compiler and info.libgomp
    assert info.build_s == 0.0 and info.log == ""  # found, not built


@pytest.mark.parametrize("route, body", [("b", NO_SPEC), ("c", NO_OMP_H)], ids=["b", "c"])
def test_real_build_routes_b_and_c(monkeypatch, tmp_path, real_cxx, route, body):
    monkeypatch.setenv("CXX", _wrapper(tmp_path, "cxx", body, real_cxx))
    info = native.ensure(tmp_path / "root")
    assert info.route == route and info.openmp and info.libgomp
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (33, 47, 4)).astype(np.float32)
    one = native.cpu_bilateral(img, CpuBilateralParams(), 1)
    np.testing.assert_array_equal(native.cpu_bilateral(img, CpuBilateralParams(), 8), one)
    np.testing.assert_allclose(one, reference.cpu_bilateral_reference(img), rtol=0, atol=1e-6)


def test_a_library_without_openmp_is_refused(monkeypatch, tmp_path, real_cxx):
    monkeypatch.setattr(native, "CXXFLAGS", tuple(f for f in native.CXXFLAGS if f != "-fopenmp"))
    monkeypatch.setattr(native, "LDFLAGS", tuple(f for f in native.LDFLAGS if f != "-fopenmp"))
    with pytest.raises(native.NativeBuildError, match="links no OpenMP"):
        native.ensure(tmp_path / "root")
    assert native._loaded.info.threads == 1 and not native._loaded.info.openmp


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path, real_cxx):
    code = (
        "import json, sys, numpy as np\n"
        "from image_denoising_filter_tpu_torch.utils import native\n"
        "info = native.ensure(sys.argv[1])\n"
        "img = np.random.default_rng(0).uniform(0, 1, (24, 30, 4)).astype(np.float32)\n"
        "out = native.cpu_bilateral(img, None, 4)\n"
        "print(json.dumps({'path': info.path, 'route': info.route, 'openmp': info.openmp,\n"
        "                  'sum': float(out.sum())}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "IDF_NATIVE_LIB"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "root")], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert got[0] == got[1] and got[0]["route"] == "a" and got[0]["openmp"]
    assert sorted(os.listdir(tmp_path / "root")) == [os.path.basename(
        os.path.dirname(got[0]["path"]))]  # no temporary directory left


# ---------------------------------------------------------------------------
# What runs on the library
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64), (33, 47)], ids=["48x64", "33x47"])
@pytest.mark.parametrize("params", [CpuBilateralParams(), CpuBilateralParams(radius=3)],
                         ids=["cpu_params", "radius3"])
def test_cpu_bilateral_threads_and_oracles(root, shape, params):
    native.ensure(root)
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(0, 1, (*shape, 4)).astype(np.float32)
    one = native.cpu_bilateral(img, params, 1)
    np.testing.assert_array_equal(native.cpu_bilateral(img, params, 8), one)
    np.testing.assert_allclose(one, reference.cpu_bilateral_reference(img, params),
                               rtol=0, atol=1e-6)
    jparams = jconfig.CpuBilateralParams(**{f: getattr(params, f) for f in (
        "radius", "sigma_spatial", "sigma_color", "blue_bug", "skip_border",
        "force_alpha_one")})
    np.testing.assert_allclose(one, jreference.cpu_bilateral_reference(img, jparams),
                               rtol=0, atol=1e-6)


def test_png_codec_against_python(root, tmp_path):
    native.ensure(root)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    np.testing.assert_array_equal(png.decode(native.png_encode(img)), img)
    np.testing.assert_array_equal(native.png_decode(png.encode(img)), img)
    f = rng.uniform(0, 1, (37, 53, 4)).astype(np.float32)
    path = str(tmp_path / "a.png")
    imageio.save(path, f, clamp=True)  # the native encoder
    with open(path, "rb") as fh:
        want = imageio.to_float(png.decode(fh.read()))
    np.testing.assert_array_equal(imageio.load(path)[0], want)


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("compression", [0, 2, 3])
def test_exr_codec_against_python(root, half, compression):
    native.ensure(root)
    img = np.random.default_rng(compression).normal(0, 3, (21, 33, 4)).astype(np.float32)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(exr.decode(native.exr_encode(img, half, compression)), want)
    np.testing.assert_array_equal(native.exr_decode(exr.encode(img, half, compression)), want)


def _animation(tmp_path, ext, n=4):
    rng = np.random.default_rng(5)
    paths = []
    for i in range(n):
        img = rng.uniform(-0.5, 3.0, (19, 26, 4)).astype(np.float32)
        if ext == "png":
            img = np.clip(img, 0, 1)
        path = str(tmp_path / f"frame_{i:04d}.{ext}")
        imageio.save(path, img)
        paths.append(path)
    return paths


@pytest.mark.parametrize("ext", ["png", "exr"])
def test_frame_loader_against_load(root, tmp_path, ext):
    paths = _animation(tmp_path, ext)
    native.ensure(root)
    loader = native.FrameLoader(paths, lookahead=2, threads=2)
    try:
        for path, got in zip(paths, loader):
            np.testing.assert_array_equal(got, imageio.load(path)[0])
    finally:
        loader.close()


@pytest.mark.parametrize("built", [False, True], ids=["no_library", "library"])
def test_prefetcher_reports_its_loader_on_cpu(root, tmp_path, built):
    """On a CPU device the native loader where a library is found, else
    the loader on this thread."""
    paths = _animation(tmp_path, "png")
    if built:
        native.ensure(root)
    pf = FramePrefetcher(paths, lambda p: imageio.load(p)[0], "cpu", native_paths=True)
    assert pf.loader == ("native" if built else "python")
    for path, frame in zip(paths, pf):
        np.testing.assert_array_equal(frame.numpy(), imageio.load(path)[0])


def test_session_overlap_frame_loader_on_cpu(root, tmp_path):
    paths = _animation(tmp_path, "png", n=3)
    native.ensure(root)
    out = tmp_path / "out"
    out.mkdir()
    res = Session(paths[1], device="cpu", output_dir=str(out)).run(
        RunConfig(nlm=True, multiframe=True, overlap=True))
    assert res.frame_loader == "native"
    assert Session(paths[1], device="cpu", output_dir=str(out)).run(
        RunConfig(nlm=True)).frame_loader is None


@pytest.mark.parametrize("ext", ["png", "exr"])
def test_session_run_cpu_runs_the_native_oracle(root, tmp_path, monkeypatch, ext):
    """run_cpu(8) with the library: the OpenMP oracle on 8 threads (the
    NumPy oracle is not called), its file within 1 LSB (PNG) or 1e-6
    (float32 EXR) of the NumPy oracle's."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 1, (40, 52, 4)).astype(np.float32)
    img[..., 3] = 1.0
    target = str(tmp_path / f"frame_0000.{ext}")
    imageio.save(target, img)
    loaded = imageio.load(target)[0]
    want = reference.cpu_bilateral_reference(loaded)
    native.ensure(root)

    def numpy_oracle(*args, **kwargs):
        raise AssertionError("the NumPy oracle ran")

    monkeypatch.setattr(reference, "cpu_bilateral_reference", numpy_oracle)
    path, secs = Session(target, device="cpu", output_dir=str(tmp_path),
                         clamp_output=True).run_cpu(8)
    assert path.endswith(f"output-cpu.{ext}") and secs > 0.0
    got = imageio.load(path)[0]
    if ext == "png":
        want = imageio.to_float(imageio.quantize(want, clamp=True))
        assert np.abs(got - want).max() * 255 <= 1.0 + 1e-3
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
