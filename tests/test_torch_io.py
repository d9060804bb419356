"""The port's own copies of the image codecs and of dataset discovery
(image_denoising_filter_tpu_torch/utils: exr, png, imageio, dataset) held
against the JAX package's, which tests/test_io.py and tests/test_native.py
cover.

The same numpy inputs go through both packages: encodes are compared byte
for byte, decodes array for array (bit for bit: the codecs are lossless, or
round to half alike). Files in the compressions the encoders do not write
(RLE, PIZ, PXR24, tiled) come from native/exr_oracle, which writes and
reads them with the system OpenEXR library, as tests/test_io.py makes them;
without the oracle those cases skip.
"""

import io
import os
import struct
import subprocess
import zlib

import numpy as np
import pytest

from image_denoising_filter_tpu.utils import dataset as jdataset
from image_denoising_filter_tpu.utils import exr as jexr
from image_denoising_filter_tpu.utils import imageio as jimageio
from image_denoising_filter_tpu.utils import png as jpng
from image_denoising_filter_tpu_torch.utils import dataset, exr, imageio, png

_ORACLE = os.path.join(os.path.dirname(__file__), "..", "native", "exr_oracle")
COMPRESSIONS = {0: "none", 1: "rle", 2: "zips", 3: "zip", 4: "piz", 5: "pxr24"}


@pytest.fixture
def oracle():
    if not os.path.exists(_ORACLE):
        pytest.skip("native/exr_oracle not built (make -C native oracle)")
    return _ORACLE


def _hdr(rng, shape):
    """HDR RGBA: negative values, values far above 1, a non-uniform alpha."""
    img = rng.normal(0.0, 2.0, shape).astype(np.float32)
    img[..., :3] *= rng.uniform(0.5, 60.0, shape[:2] + (1,)).astype(np.float32)
    img[..., 3] = rng.uniform(0.0, 1.0, shape[:2])
    return img


def _oracle_file(oracle, path, img, mode, *args):
    h, w, _ = img.shape
    subprocess.run([oracle, mode, path, str(w), str(h), *map(str, args)],
                   input=np.ascontiguousarray(img, np.float32).tobytes(), check=True)
    out = subprocess.run([oracle, "read", path], capture_output=True, check=True)
    return np.frombuffer(out.stdout, np.float32).reshape(h, w, 4)


# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("compression", [0, 2, 3], ids=["none", "zips", "zip"])
def test_exr_encode_matches_jax(rng, compression, half):
    """The encoders write the same bytes; both decoders read them back to the
    image (rounded to half with half pixels)."""
    img = _hdr(rng, (21, 33, 4))
    data = exr.encode(img, half=half, compression=compression)
    assert data == jexr.encode(img, half=half, compression=compression)
    want = img.astype(np.float16).astype(np.float32) if half else img
    np.testing.assert_array_equal(exr.decode(data), want)
    np.testing.assert_array_equal(jexr.decode(data), want)


@pytest.mark.filterwarnings("ignore:overflow encountered in cast:RuntimeWarning")
@pytest.mark.parametrize("compression", [0, 2, 3], ids=["none", "zips", "zip"])
def test_exr_half_overflow_matches_jax(compression):
    """Values beyond half's 65504 written as half: both packages write the
    same bytes (infinities of the value's sign) and read them alike."""
    img = np.array([[[7e4, -1e5, 65504.0, 0.5], [65520.0, -65519.0, 3e38, 1.0]]], np.float32)
    data = exr.encode(img, half=True, compression=compression)
    assert data == jexr.encode(img, half=True, compression=compression)
    got = exr.decode(data)
    np.testing.assert_array_equal(got, jexr.decode(data))
    assert got[0, 0, 0] == np.inf and got[0, 0, 1] == -np.inf and got[0, 0, 2] == 65504.0


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("compression", list(COMPRESSIONS), ids=list(COMPRESSIONS.values()))
def test_exr_decode_matches_jax_and_openexr(oracle, tmp_path, rng, compression, half):
    """Every compression utils/exr.py decodes, in files the system OpenEXR
    library writes: the port reads what the JAX package and OpenEXR read,
    ragged last blocks and a one-row image included."""
    for h, w in [(20, 24), (33, 17), (1, 5)]:
        img = _hdr(rng, (h, w, 4))
        path = str(tmp_path / f"o_{compression}_{int(half)}_{h}x{w}.exr")
        want = _oracle_file(oracle, path, img, "write", compression, int(half))
        got = exr.read(path)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jexr.read(path))
        loaded, hdr = imageio.load(path)
        assert hdr
        np.testing.assert_array_equal(loaded, want)


@pytest.mark.parametrize("mip", [0, 1, 2], ids=["one_level", "mipmap", "ripmap"])
@pytest.mark.parametrize("compression", [0, 3, 4], ids=["none", "zip", "piz"])
def test_exr_tiled_decode_matches_jax(oracle, tmp_path, rng, compression, mip):
    """Tiled files, partial edge tiles, the three level modes: the port reads
    level (0, 0) as the JAX package does."""
    img = _hdr(rng, (33, 40, 4))
    path = str(tmp_path / f"t_{compression}_{mip}.exr")
    want = _oracle_file(oracle, path, img, "writetiled", compression, 16, 8, mip)
    got = exr.read(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jexr.read(path))


def test_exr_alpha_preserved(tmp_path, rng):
    """imageio.save of an HDR image keeps every channel as float32, alpha
    included (the reference saves .exr with alpha, README.md:57-59); each
    package reads the other's file."""
    img = _hdr(rng, (17, 23, 4))
    path = str(tmp_path / "a.exr")
    imageio.save(path, img)
    got, hdr = imageio.load(path)
    assert hdr
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(jimageio.load(path)[0], img)
    jpath = str(tmp_path / "j.exr")
    jimageio.save(jpath, img)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()


def test_exr_errors_match_jax():
    """What neither decoder reads, both refuse alike."""
    bad = struct.pack("<iI", 20000630, 2) + b"compression\0compression\0" + struct.pack("<i", 1) \
        + bytes([7]) + b"\0"
    for mod in (exr, jexr):
        with pytest.raises(ValueError):
            mod.decode(bad)
    with pytest.raises(exr.ExrError):
        exr.encode(np.zeros((2, 2, 4), np.float32), compression=4)


# ---------------------------------------------------------------------------
# PNG and the LDR cast
# ---------------------------------------------------------------------------


def _pil_png(image, **save_kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, "PNG", **save_kw)
    return buf.getvalue()


def _png_case(name, rng) -> bytes:
    from PIL import Image

    if name == "rgba":
        return _pil_png(Image.fromarray(rng.integers(0, 256, (19, 23, 4), np.uint8)))
    if name == "rgba_interlaced":
        return _pil_png(Image.fromarray(rng.integers(0, 256, (37, 53, 4), np.uint8)),
                        interlace=True)
    if name == "rgb":
        return _pil_png(Image.fromarray(rng.integers(0, 256, (11, 9, 3), np.uint8)))
    if name == "gray_alpha":
        return _pil_png(Image.fromarray(rng.integers(0, 256, (8, 12, 2), np.uint8), "LA"))
    if name == "gray16":
        im = Image.new("I;16", (31, 25))
        im.putdata([int(v) for v in rng.integers(0, 65536, 31 * 25)])
        return _pil_png(im)
    if name == "palette4_interlaced":
        im = Image.fromarray(rng.integers(0, 16, (22, 18)).astype(np.uint8), "P")
        im.putpalette([int(x) for x in rng.integers(0, 256, 48)])
        return _pil_png(im, bits=4, interlace=True)
    if name == "gray1":
        return _pil_png(Image.fromarray(rng.integers(0, 2, (20, 30)).astype(bool)))
    # rgb16: 16-bit RGB, hand-built (PIL writes none)
    rgb16 = rng.integers(0, 65536, (9, 7, 3)).astype(np.uint16)
    lines = b"".join(b"\0" + row.astype(">u2").tobytes() for row in rgb16)
    ihdr = struct.pack(">IIBBBBB", 7, 9, 16, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(lines)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("name", ["rgba", "rgba_interlaced", "rgb", "gray_alpha", "gray16",
                                  "palette4_interlaced", "gray1", "rgb16"])
def test_png_decode_matches_jax(rng, name):
    """The PNG decoders read every colour type, depth and interlace the
    same."""
    data = _png_case(name, rng)
    got = png.decode(data)
    np.testing.assert_array_equal(got, jpng.decode(data))
    assert got.dtype == np.uint8 and got.shape[-1] == 4


@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_png_encode_matches_jax(rng, kind):
    """The encoders pick the same row filters and write the same bytes, and
    the round trip is the identity."""
    if kind == "noise":
        img = rng.integers(0, 256, (33, 47, 4), dtype=np.uint8)
    else:
        yy, xx = np.mgrid[0:64, 0:100]
        img = np.stack([xx % 256, yy % 256, (xx + yy) % 256, np.full_like(xx, 255)],
                       -1).astype(np.uint8)
    data = png.encode(img)
    assert data == jpng.encode(img)
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("clamp", [False, True], ids=["wrap", "clamp"])
def test_ldr_cast_matches_jax(rng, clamp):
    """to_float and quantize, values outside [0, 1] included (the
    reference's unclamped cast wraps them)."""
    x = rng.normal(0.5, 2.0, (13, 17, 4)).astype(np.float32)
    np.testing.assert_array_equal(imageio.quantize(x, clamp=clamp),
                                  jimageio.quantize(x, clamp=clamp))
    b = rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)
    np.testing.assert_array_equal(imageio.to_float(b), jimageio.to_float(b))


@pytest.mark.parametrize("ext", [".png", ".exr"])
def test_load_save_dispatch_matches_jax(tmp_path, rng, ext):
    """imageio.save writes each package's bytes; load returns the same
    array and the same HDR flag, by extension."""
    img = _hdr(rng, (12, 14, 4)) if ext == ".exr" else rng.uniform(0, 1, (12, 14, 4)).astype(
        np.float32)
    ours, theirs = str(tmp_path / f"p{ext}"), str(tmp_path / f"j{ext}")
    imageio.save(ours, img, clamp=True)
    jimageio.save(theirs, img, clamp=True)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, hdr = imageio.load(ours)
    want, jhdr = jimageio.load(ours)
    np.testing.assert_array_equal(got, want)
    assert hdr == jhdr == (ext == ".exr") == imageio.is_hdr_path(ours)


def test_codec_names_the_codec_that_runs(monkeypatch):
    """codec() says which codec load and save run: the native library where
    it loaded or was found, else the Python codecs; read at each call."""
    monkeypatch.setattr(imageio._native, "available", lambda: False)
    assert imageio.codec() == "python"
    monkeypatch.setattr(imageio._native, "available", lambda: True)
    assert imageio.codec() == "native"


# ---------------------------------------------------------------------------
# Discovery of an EXR animation with LDR PNG layers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exr_anim(tmp_path_factory):
    """Three EXR frames and, as tools/make_dataset.py writes them, PNG layers
    (albedo, normal, depth) of every frame in RenderElements/."""
    root = tmp_path_factory.mktemp("exranim")
    os.makedirs(root / "RenderElements")
    rng = np.random.default_rng(3)
    for i in range(3):
        imageio.save(str(root / f"Animation01_HDR_{i:04d}.exr"), _hdr(rng, (6, 8, 4)))
        for name in ("albedo", "normal", "depth"):
            imageio.save(str(root / "RenderElements" / f"{name}_{i:04d}.png"),
                         rng.uniform(0, 1, (6, 8, 4)).astype(np.float32))
    return str(root / "Animation01_HDR_0001.exr")


@pytest.mark.parametrize("multiframe,use_layers,max_frames",
                         [(False, False, 10), (True, False, 10), (True, False, 2),
                          (True, True, None), (False, True, 10)])
def test_discover_exr_target_matches_jax(exr_anim, multiframe, use_layers, max_frames):
    """An EXR target: the frames are the directory's .exr files, the target
    first and again in order; the layers the target frame's PNGs; the same
    Dataset as the JAX package's."""
    got = dataset.discover(exr_anim, multiframe=multiframe, use_layers=use_layers,
                           max_frames=max_frames)
    want = jdataset.discover(exr_anim, multiframe=multiframe, use_layers=use_layers,
                             max_frames=max_frames)
    assert (got.target, got.frames, got.layers, got.is_hdr) == (
        want.target, want.frames, want.layers, want.is_hdr)
    assert got.is_hdr and got.frames[0] == exr_anim
    assert all(f.endswith(".exr") for f in got.frames)
    if multiframe:
        assert len(got.frames) == min(4, max_frames or 4)
    assert [os.path.basename(p) for p in got.layers] == (
        ["albedo_0001.png", "depth_0001.png", "normal_0001.png"] if use_layers else [])
    assert dataset.frame_id(exr_anim) == jdataset.frame_id(exr_anim) == "0001"
