"""Non-finite frames through the port on the CPU against the JAX package:
frames with +inf, -inf and NaN values (an HDR render's diverged sample, a
depth or emission layer's background) through every kernel module's plain
version, the Session's battery and turbo runs, and the sharded turbo grids
on a 1x4 mesh of gloo ranks.

The port runs with device "cpu", so every wrapper takes its plain version;
the JAX side runs its Pallas kernels in interpret mode, as its own tests
run them, and its sharded functions on the 8-device virtual CPU mesh of
tests/conftest.py. The contract, as chip_smoke.py:same_nonfinite states it
for the card's kernels:

  * the same positions of NaN, +inf and -inf in both packages' outputs;
  * every value finite in both within that kernel's existing tolerance:
    rtol 1e-4 / atol 1e-5 for the exact bilateral and layers, 2e-4 / 1e-4
    for NLM (the bf16 forms with XLA's CPU rounding given to the port, as
    tests/test_torch_stencils.py and tests/test_torch_turbo.py give it),
    the pipeline contract of tests/test_torch_fast.py for the grids.

The one allowed difference is where the JAX package's banded matmuls meet a
non-finite value: its pool, its grid builds' blur and its slices' upsample
multiply a whole tile by the band's zeros, and 0 * inf or 0 * NaN is NaN, so
one non-finite value turns its whole tile NaN (ROADMAP.md queue C). The port
sums the taps directly, as the ground rules have it (no banded matmul), so
its non-finite values stay within the blur's reach. There the port's
non-finite positions must lie among the JAX package's, and the two agree
wherever both are finite. That is the half-row NLM's Pallas kernel (its
row pooling and upsample are banded matmuls), the guided grid (the turbo
layers), whose
range comes from the layer so that a non-finite target value shows the
spread on one device, and every sharded grid, whose range leaves a NaN band
out. On one device a non-finite value in the bilateral grid's own frame
makes its channel's range non-finite and every value of the channel NaN in
both packages, which hides the spread.

The sharded grid range (parallel/spatial.py:_grid_range) is held to the JAX
package's pmin/pmax over the same bands' extrema, which drop a NaN whatever
band holds it (gloo's MIN keeps it when rank 0 holds it: the fault this
file's band-0 cases catch).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import ops as jops
from image_denoising_filter_tpu import parallel as jpar
from image_denoising_filter_tpu.ops import fast as jfast
from image_denoising_filter_tpu.ops import xla
from image_denoising_filter_tpu.runtime import Session as JaxSession
from image_denoising_filter_tpu_torch import cli
from image_denoising_filter_tpu_torch.config import (
    GPU_BATTERY,
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    TilingConfig,
)
from image_denoising_filter_tpu_torch.ops import eager, fast, stencils
from image_denoising_filter_tpu_torch.parallel import dryrun, launch
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import imageio
from test_torch_config import jax_params
from test_torch_fast import _assert_turbo_close
from test_torch_stencils import xla_cpu_bilateral_sq_diff
from test_torch_turbo import _xla_cpu_sq_diff

torch.set_num_threads(2)

H, W = 40, 64
INF, NAN = float("inf"), float("nan")
# (row, column, channel, value): each kind in its own channel and row.
VALUES = {"pos_inf": (6, 9, 0, INF), "neg_inf": (17, 30, 1, -INF), "nan": (29, 50, 2, NAN)}
ALL = tuple(VALUES)
BF16 = TilingConfig(compute_dtype="bfloat16")
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_NLM = dict(rtol=2e-4, atol=1e-4)
BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
K = 5
KINDS = (np.isnan, np.isposinf, np.isneginf)


def _frame(seed, kinds=ALL, shift=0, h=H, w=W):
    """Smooth noisy RGBA content in [0, 1], alpha 1, with the VALUES of
    `kinds` written in, their columns moved by `shift`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 9.0 + seed), 0.5 + 0.4 * np.cos(yy / 7.0),
                    np.where(xx > w / 2, 0.8, 0.2), np.ones((h, w))], -1)
    img[..., :3] += rng.normal(0, 0.05, (h, w, 3))
    img = np.clip(img, 0, 1).astype(np.float32)
    for kind in kinds:
        y, x, c, v = VALUES[kind]
        img[y, (x + shift) % w, c] = v
    return img


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _allclose(tol):
    return lambda g, w: np.testing.assert_allclose(g, w, **tol)


def _turbo_close(g, w):
    _assert_turbo_close(g, w, 1.0)


def _check_finite(got, want, close):
    finite = np.isfinite(got) & np.isfinite(want)
    if finite.any():
        close(got[finite], want[finite])


def _assert_same_nonfinite(got, want, close):
    """The contract: the same NaN, +inf and -inf positions, and close() on
    the values finite in both."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    for kind in KINDS:
        np.testing.assert_array_equal(kind(got), kind(want), err_msg=kind.__name__)
    _check_finite(got, want, close)


def _assert_nonfinite_within(got, want, close):
    """The tile-spread rule: got's non-finite values (any kind) a subset of
    want's, and close() on the values finite in both."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    extra = ~np.isfinite(got) & np.isfinite(want)
    assert not extra.any(), f"{int(extra.sum())} non-finite values where the other is finite"
    _check_finite(got, want, close)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """A CPU tensor takes the plain version: no wrapper launches a kernel."""
    stencils.reset_launches()
    yield
    assert all(n == 0 for n in stencils.launches.values()), stencils.launches


def test_frames_hold_what_the_cases_need():
    """Each kind in its own channel and row of the target; the neighbour
    frame and the layer hold the same kinds elsewhere."""
    img = _frame(0)
    for kind, (y, x, c, _) in VALUES.items():
        assert {np.isnan: "nan", np.isposinf: "pos_inf", np.isneginf: "neg_inf"}[
            next(f for f in KINDS if f(img[y, x, c]))] == kind
    assert int((~np.isfinite(img)).sum()) == 3
    assert len({c for _, _, c, _ in VALUES.values()}) == len({y for y, *_ in VALUES.values()}) == 3
    assert not np.array_equal(~np.isfinite(_frame(1, shift=23)), ~np.isfinite(img))


# ---------------------------------------------------------------------------
# The exact kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["float32", "bf16"])
@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
def test_bilateral_and_guided_partials(form, border, monkeypatch):
    """The bilateral (fused normalize) and one layer's guided partials, with
    float32 and bf16 taps, on a non-finite target and a non-finite layer."""
    monkeypatch.setattr(stencils, "_bilateral_sq_diff_bf16", xla_cpu_bilateral_sq_diff)
    tiling = BF16 if form == "bf16" else None
    target, layer = _frame(0), _frame(2, shift=23)
    bp, lp = BilateralParams(radius=3, border=border), LayersParams(radius=3, border=border)
    _assert_same_nonfinite(stencils.bilateral(_t(target), bp, tiling),
                           jops.bilateral(target, jax_params(bp), jax_params(tiling)),
                           _allclose(TOL))
    wc, nw = stencils.cross_bilateral_layers(_t(target), _t(layer), lp, tiling)
    jwc, jnw = jops.cross_bilateral_layers(target, layer, jax_params(lp), jax_params(tiling))
    _assert_same_nonfinite(wc, jwc, _allclose(TOL))
    _assert_same_nonfinite(nw, jnw, _allclose(TOL))


def test_linear_layout():
    """The linear config's bilateral (ops/eager.py) against the JAX XLA one."""
    target = _frame(0)
    _assert_same_nonfinite(eager.bilateral_eager(_t(target), BP),
                           jops.bilateral_xla(target, jax_params(BP)), _allclose(TOL))


NLM_CASES = {
    "single_frame": (NP_, None, 1),
    "frame_batched": (NP_, None, 3),
    "bf16": (NlmParams(search_radius=2, patch_radius=1, search_stride=2), BF16, 3),
    "half_row_f32": (NlmParams(search_radius=3, search_stride=2, weights_halfres=True), None, 2),
    "half_row_bf16": (NlmParams(search_radius=3, search_stride=2, weights_halfres=True), BF16,
                      2),
}


@pytest.mark.parametrize("name", NLM_CASES)
def test_nlm(name, monkeypatch):
    """Single-frame, frame-batched, bf16 and half-row NLM on a non-finite
    target and neighbour frames; the half-row float32 form against the XLA
    oracle, as tests/test_torch_hrw.py holds it, the bf16 form against the
    Pallas kernel under the tile-spread rule. Then normalize on the
    partials."""
    monkeypatch.setattr(eager, "_sq_diff_bf16", _xla_cpu_sq_diff)
    params, tiling, n = NLM_CASES[name]
    target = _frame(0)
    frames = np.stack([target] + [_frame(10 + i, shift=11 * (i + 1)) for i in range(n - 1)])
    if n == 1:
        wc, nw = stencils.nlm_accumulate(_t(target), _t(frames[0]), params, tiling)
        jwc, jnw = jops.nlm_accumulate(target, frames[0], jax_params(params), jax_params(tiling))
    else:
        wc, nw = stencils.nlm_accumulate_frames(_t(target), _t(frames), params, tiling)
        if name == "half_row_f32":
            jwc = jnw = 0.0
            for f in frames:
                pwc, pnw = xla.nlm_xla(target, f, jax_params(params))
                jwc, jnw = jwc + np.asarray(pwc), jnw + np.asarray(pnw)
        else:
            jwc, jnw = jops.nlm_accumulate_frames(target, frames, jax_params(params),
                                                  jax_params(tiling))
    if name == "half_row_bf16":
        # The JAX kernel pools row pairs and upsamples the weights with banded
        # matmuls (stencils.py:679-786): the tile spread of the module
        # docstring, along the rows.
        _assert_nonfinite_within(wc, jwc, _allclose(TOL_NLM))
        _assert_nonfinite_within(nw, jnw, _allclose(TOL_NLM))
        assert np.isfinite(_np(wc)).sum() > np.isfinite(_np(jwc)).sum()
    else:
        _assert_same_nonfinite(wc, jwc, _allclose(TOL_NLM))
        _assert_same_nonfinite(nw, jnw, _allclose(TOL_NLM))
    if name == "frame_batched":
        _assert_same_nonfinite(stencils.normalize(wc, nw),
                               jops.normalize(np.asarray(jwc), np.asarray(jnw)), _allclose(TOL))


# ---------------------------------------------------------------------------
# The bilateral grid on one device
# ---------------------------------------------------------------------------


def _planar(img):
    return jnp.transpose(jnp.asarray(img), (2, 0, 1))


def _hwc(planar):
    return np.transpose(np.asarray(planar, np.float32), (1, 2, 0))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_pool_keeps_each_value_where_the_jax_pool_spreads_it(d):
    """The pool: the port's mean of d x d pixels keeps a non-finite value in
    its own cell, of its own kind; the JAX package's banded matmuls turn
    every cell of its tile NaN (0 * inf), and agree elsewhere."""
    img = _frame(0)
    got = fast.pool(_t(img), d, BorderPolicy.CLAMP).numpy()
    want = _hwc(jfast._pool_pallas(_planar(img), d))
    _assert_nonfinite_within(got, want, _allclose(dict(rtol=1e-6, atol=0.0)))
    for y, x, c, v in VALUES.values():
        cell = got[y // d, x // d, c]
        assert (np.isnan(cell) if np.isnan(v) else cell == v)
    assert int((~np.isfinite(got)).sum()) == 3 < int((~np.isfinite(want)).sum())


GRID_CASES = [(kind, 2, fused) for kind in ALL for fused in (False, True)] + [
    ("nan", d, fused) for d in (4, 8) for fused in (False, True)]


@pytest.mark.parametrize("kind,d,fused", GRID_CASES)
def test_grid_pipeline(kind, d, fused):
    """The grid pipeline, build + slice and fused, against the JAX Pallas
    pipeline: the frame's non-finite value makes its channel's range
    non-finite, and every value of that channel (and alpha, under green's)
    NaN in both; the other channels finite and at the pipeline contract."""
    img = _frame(0, (kind,))
    bp = BilateralParams()
    levels = 5 if d in (2, 4) else 6
    got = fast.grid_pipeline(_t(img), bp, levels, d, fused=fused)
    want = _hwc(jfast._grid_pipeline_planar(_planar(img), jax_params(bp), levels, d,
                                            fused=fused))
    _assert_same_nonfinite(got, want, _turbo_close)
    channel = VALUES[kind][2]
    assert np.isnan(got.numpy()[..., channel]).all()
    assert np.isfinite(got.numpy()[..., [c for c in range(3) if c != channel]]).all()


@pytest.mark.parametrize("kind", ALL + ("all",))
def test_lattice_d1(kind):
    """--turbo 1 on one device: the eager lattice in both packages."""
    img = _frame(0, ALL if kind == "all" else (kind,))
    got = fast.bilateral_fast(_t(img), BilateralParams(), 6, 1)
    want = jfast.bilateral_fast(img, jax_params(BilateralParams()), 6, 1)
    _assert_same_nonfinite(got, want, _allclose(TOL))


# ---------------------------------------------------------------------------
# The guided grid
# ---------------------------------------------------------------------------


GUIDED_CASES = [(d, fused, "finite") for d in (1, 2, 4, 8) for fused in (False, True)] + [
    (2, fused, "non_finite") for fused in (False, True)]


@pytest.mark.parametrize("d,fused,layer_kind", GUIDED_CASES)
def test_guided_grid(d, fused, layer_kind):
    """The guided grid, fused and not, on the target with all three kinds.
    With a finite layer (which sets the range) the grid carries the
    target's values: the port keeps them within the blur's reach, the JAX
    package's banded matmuls spread each over its tile (module docstring),
    so the port's non-finite values lie among the JAX package's, and the
    normalized outputs agree at the pipeline contract wherever both are
    finite. With the layer's own three kinds every channel's range is
    non-finite, and every value NaN in both."""
    target = _frame(0)
    layer = _frame(2, ALL if layer_kind == "non_finite" else (), shift=23)
    lp = LayersParams()
    wc, nw = fast.cross_bilateral_layers_fast(_t(target), _t(layer), lp, K, d, fused=fused)
    jwc, jnw = jfast.cross_bilateral_layers_fast(target, layer, jax_params(lp), K, d,
                                                 fused=fused)
    got = fast.normalize_layers_fast(wc, nw).numpy()
    want = np.asarray(jfast.normalize_layers_fast(jwc, jnw))
    if layer_kind == "non_finite":
        _assert_same_nonfinite(got, want, _turbo_close)
        assert np.isnan(got).all()
        return
    _assert_nonfinite_within(got, want, _turbo_close)
    kept, spread = int((~np.isfinite(got)).sum()), int((~np.isfinite(want)).sum())
    assert 0 < kept < spread


# ---------------------------------------------------------------------------
# Sessions on a non-finite EXR animation
# ---------------------------------------------------------------------------

PARAMS = dict(bilateral_params=BP, layers_params=LP, nlm_params=NP_)
IDS = ["bilateral", "layers", "linear", "nlm", "multiframe", "overlap"]
NAMES = {k: c.output_name(True) for k, c in zip(IDS, GPU_BATTERY)}


@pytest.fixture(scope="module")
def anim(tmp_path_factory):
    """Three EXR frames, the target (1) and a neighbour (0) non-finite, and
    the target's layers: the albedo as EXR with +inf (a background), the
    normal as PNG. Returns the target's path."""
    root = tmp_path_factory.mktemp("nonfinite")
    os.makedirs(root / "RenderElements")
    for i in range(3):
        frame = _frame(i, ALL if i < 2 else (), shift=17 * (1 - i))
        imageio.save(str(root / f"Animation01_HDR_{i:04d}.exr"), frame)
    albedo = _frame(5, ())
    albedo[12, 44, 0] = INF
    imageio.save(str(root / "RenderElements" / "albedo_0001.exr"), albedo)
    imageio.save(str(root / "RenderElements" / "normal_0001.png"), _frame(6, ()))
    return str(root / "Animation01_HDR_0001.exr")


@pytest.mark.parametrize("cfg", GPU_BATTERY, ids=IDS)
def test_session_battery(anim, tmp_path, cfg):
    """Every exact config through both Sessions: the same non-finite
    positions, the finite values at the exact tolerances."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = JaxSession(anim, output_dir=str(tmp_path / "jax"), warmup=False,
                      **{k: jax_params(v) for k, v in PARAMS.items()}).run(jax_params(cfg))
    got = Session(anim, device="cpu", output_dir=str(tmp_path / "port"), **PARAMS).run(cfg)
    np.testing.assert_array_equal(imageio.load(got.output_path)[0], got.image)
    assert not np.isfinite(got.image).all()
    _assert_same_nonfinite(got.image, want.image, _allclose(TOL_NLM if cfg.nlm else TOL))


@pytest.mark.parametrize("key", ["bilateral", "linear", "layers"])
def test_session_run_turbo(anim, tmp_path, key):
    """Session.run_turbo at --turbo 2 on the non-finite target: the
    bilateral grid against the JAX Pallas pipeline (tpu-denoise's chip
    path; its CPU Session takes the XLA lattice, held too): every channel's
    range is non-finite, so every value NaN in all three; the layers
    against the JAX Session's, under the tile-spread rule."""
    cfg = GPU_BATTERY[IDS.index(key)]
    got = Session(anim, device="cpu", output_dir=str(tmp_path), **PARAMS).run_turbo(
        cfg, downsample=2).image
    (tmp_path / "jax").mkdir()
    want = JaxSession(anim, output_dir=str(tmp_path / "jax"), warmup=False,
                      **{k: jax_params(v) for k, v in PARAMS.items()}).run_turbo(
        jax_params(cfg), downsample=2).image
    if key == "layers":
        _assert_nonfinite_within(got, want, _turbo_close)
        assert np.isfinite(got).any()
        return
    grid = _hwc(jfast._grid_pipeline_planar(_planar(imageio.load(anim)[0]), jax_params(BP), K, 2))
    _assert_same_nonfinite(got, grid, _turbo_close)
    _assert_same_nonfinite(got, want, _turbo_close)
    assert np.isnan(got).all()


@functools.lru_cache(maxsize=None)
def _cli_turbo2(anim, out_dir, package):
    argv = [anim, "--turbo", "2", "--radius", "3", "--search-radius", "2", "--patch-radius", "1",
            "--configs", "nlm,multiframe,overlap", "--output-dir", out_dir]
    if package == "jax":
        from image_denoising_filter_tpu import cli as jcli

        assert jcli.main(argv) == 0
    else:
        import unittest.mock

        with unittest.mock.patch.object(eager, "_sq_diff_bf16", _xla_cpu_sq_diff):
            assert cli.main([*argv, "--device", "cpu"]) == 0
    return out_dir


@pytest.mark.parametrize("key", ["nlm", "multiframe", "overlap"])
def test_cli_turbo2_nlm_configs(anim, tmp_path_factory, key):
    """gpu-denoise --turbo 2 against tpu-denoise for the NLM configs (bf16
    taps, stride 2): the same non-finite positions, the NLM tolerance."""
    base = tmp_path_factory.getbasetemp()
    dirs = {p: _cli_turbo2(anim, str(base / f"turbo2_{p}"), p) for p in ("jax", "port")}
    got = imageio.load(os.path.join(dirs["port"], NAMES[key]))[0]
    want = imageio.load(os.path.join(dirs["jax"], NAMES[key]))[0]
    _assert_same_nonfinite(got, want, _allclose(TOL_NLM))


# ---------------------------------------------------------------------------
# The sharded turbo grids on a 1x4 mesh
# ---------------------------------------------------------------------------

SH, SW = 64, 48  # 16 rows a band
# (row, column, channel, value) of each sharded frame: NaN in band 0, NaN in
# band 2, +inf in band 0.
MESH_FRAMES = {"nan_band0": (5, 17, 1, NAN), "nan_band2": (37, 17, 1, NAN),
               "inf_band0": (5, 17, 1, INF)}
MESH_CASES = [(frame, kind, d) for frame in MESH_FRAMES for kind in ("bilateral", "layers")
              for d in (1, 2)]
# The grid range's cases: one pooled band's NaN (each band in turn), a
# channel NaN in every band, and a band's +inf and -inf.
RANGE_FRAMES = {
    **{f"nan_band{b}": [(16 * b + 5, 17, 1, NAN)] for b in range(4)},
    "nan_channel": [(y, 3, 2, NAN) for y in (5, 21, 37, 53)],
    "inf_band0": [(5, 17, 0, INF)],
    "neg_inf_band3": [(53, 30, 2, -INF)],
    "finite": [],
}


def _mesh_frame(seed, values):
    img = _frame(seed, (), h=SH, w=SW)
    for y, x, c, v in values:
        img[y, x, c] = v
    return img


def _mesh_case(frame, kind, d):
    name = f"{kind}_{frame}_d{d}"
    kw = dict(levels=6, downsample=d)
    if kind == "bilateral":
        return {"name": name, "kind": "bilateral_fast",
                "inputs": {"img": _mesh_frame(0, [MESH_FRAMES[frame]])},
                "kw": dict(params=BilateralParams(), **kw)}
    return {"name": name, "kind": "layers_fast",
            "inputs": {"target": _mesh_frame(0, []),
                       "layer": _mesh_frame(2, [MESH_FRAMES[frame]])},
            "kw": dict(params=LayersParams(), **kw)}


CASES = [_mesh_case(*c) for c in MESH_CASES] + [
    {"name": f"range_{frame}", "kind": "grid_range", "inputs": {"img": _mesh_frame(0, values)},
     "kw": dict(levels=6, downsample=2)} for frame, values in RANGE_FRAMES.items()]


@pytest.fixture(scope="module")
def mesh_outputs(tmp_path_factory):
    """Every case's gathered outputs from one launch of four gloo ranks."""
    out_dir = str(tmp_path_factory.mktemp("mesh1x4"))
    launch.run_ranks(4, dryrun.run_cases, CASES, out_dir, (1, 4), "cpu", device_type="cpu",
                     timeout_s=300.0)
    return lambda name: dryrun.load_outputs(out_dir, name)


def _sharded_range(small, levels):
    """The JAX package's sharded grid range (parallel/spatial.py:262-264) on
    a pooled image: each band's min and max, then pmin and pmax over the
    'y' axis of a 1x4 mesh."""
    from jax.sharding import PartitionSpec as P

    mesh = jpar.make_mesh((1, 4))

    @functools.partial(jax.shard_map, mesh=mesh, in_specs=P("y", None, None),
                       out_specs=(P(), P()), check_vma=False)
    def run(local):
        lmin = jax.lax.pmin(jnp.min(local[..., :3], axis=(0, 1)), "y")
        lmax = jax.lax.pmax(jnp.max(local[..., :3], axis=(0, 1)), "y")
        return lmin, jnp.maximum(lmax - lmin, 1e-6) / (levels - 1)

    return tuple(np.array(x) for x in run(jnp.asarray(small)))


@pytest.mark.parametrize("frame", RANGE_FRAMES)
def test_sharded_grid_range_is_the_jax_packages(mesh_outputs, frame):
    """parallel/spatial.py:_grid_range on four gloo ranks equals the JAX
    package's pmin/pmax over the same pooled bands, every rank alike: a
    band's NaN extremum is left out whichever band holds it, a channel NaN
    in every band gives lmin +inf, lmax -inf and the least step, 1e-6 /
    (K - 1); +inf and -inf stay."""
    lmin, step = mesh_outputs(f"range_{frame}")
    assert lmin.shape == step.shape == (4, 3)
    small = fast.pool(_t(_mesh_frame(0, RANGE_FRAMES[frame])), 2, BorderPolicy.CLAMP).numpy()
    want_lmin, want_step = _sharded_range(small, 6)
    for rank in range(4):
        np.testing.assert_array_equal(lmin[rank], want_lmin)
        np.testing.assert_array_equal(step[rank], want_step)
    if frame == "nan_channel":
        assert lmin[0, 2] == INF and step[0, 2] == np.float32(1e-6) / np.float32(5)
    if frame.startswith("nan_band"):
        assert np.isfinite(lmin).all() and np.isfinite(step).all()


def _single_device(case, lmin, step):
    """What the sharded grid computes, on one device: the pipeline on the
    whole frame with the sharded range (the seam construction makes the two
    equal bit for bit, tests/test_torch_sharding.py)."""
    kw, d = case["kw"], case["kw"]["downsample"]
    levels, border = kw["levels"], kw["params"].border
    taps = fast._grid_taps(kw["params"].sigma_spatial, d)
    inv2sc = 0.5 / kw["params"].sigma_color**2
    if case["kind"] == "bilateral_fast":
        img = _t(case["inputs"]["img"])
        grid = fast.build_grid(fast.pool(img, d, border), lmin, step, levels, taps, border,
                               inv2sc, d=d)
        return (fast.slice_grid(img, grid, lmin, 1.0 / step, d),), grid
    target, layer = _t(case["inputs"]["target"]), _t(case["inputs"]["layer"])
    grid = fast.build_guided_grid(fast.pool(target, d, border), fast.pool(layer, d, border),
                                  lmin, step, levels, taps, border, inv2sc, d=d)
    return fast.slice_guided_grid(layer, grid, lmin, 1.0 / step, d), grid


@pytest.mark.parametrize("frame,kind,d", MESH_CASES)
def test_sharded_turbo(mesh_outputs, frame, kind, d):
    """--turbo 2 and --turbo 1 on --mesh 1x4 (the sharded bilateral grid and
    the sharded layers) on a frame with a NaN in band 0, a NaN in band 2 or
    a +inf in band 0. The port's output is its single-device pipeline's on
    the sharded range, NaN positions and finite bits alike. Against the JAX
    package's sharded function the finite values agree at the bf16 grid
    contract; the non-finite ones follow the tile spread: with a NaN, the
    range leaves its band out in both packages and the port's NaN values
    lie among the JAX package's; with a +inf the port's range takes it, a
    channel non-finite as on one device, where the JAX pool's matmul turns it
    into NaN over its tile, which pmax leaves out (ROADMAP.md queue C): the
    JAX package's non-finite values lie among the port's."""
    case = next(c for c in CASES if c["name"] == f"{kind}_{frame}_d{d}")
    got = mesh_outputs(case["name"])
    layer_or_img = case["inputs"]["img" if kind == "bilateral" else "layer"]
    small = fast.pool(_t(layer_or_img), d, BorderPolicy.CLAMP)
    lmin, step = (torch.from_numpy(x) for x in _sharded_range(small.numpy(), 6))
    single, grid = _single_device(case, lmin, step)
    for g, w in zip(got, single):
        _assert_same_nonfinite(g, w, np.testing.assert_array_equal)
    kw = case["kw"]
    if kind == "bilateral":
        want = (jpar.spatial_bilateral_fast(layer_or_img, jax_params(kw["params"]),
                                            jpar.make_mesh((1, 4)), 6, d),)
    else:
        want = jpar.spatial_cross_bilateral_layers_fast(
            case["inputs"]["target"], layer_or_img, jax_params(kw["params"]),
            jpar.make_mesh((1, 4)), 6, d)
    close = _turbo_close
    if kind == "layers":
        # normalized, with the reference's telescoped delta rounding added to
        # the port's partials, at the JAX sharded layers' contract (4 bf16
        # ulps, tests/test_torch_sharding.py)
        from test_sharding import _assert_bf16_grid_close
        from test_torch_guided import _delta_rounding

        partials = torch.cat(single, -1) + _delta_rounding(_t(layer_or_img), grid, lmin,
                                                           1.0 / step, d)
        got = (fast.normalize_layers_fast(partials[..., :4], partials[..., 4:]).numpy(),)
        want = (np.asarray(jfast.normalize_layers_fast(*want)),)

        def close(g, w):
            _assert_bf16_grid_close(g, w, ulps=4)
    for g, w in zip(got, want):
        w = _np(w)
        if frame.startswith("nan"):
            _assert_nonfinite_within(g, w, close)
            assert np.isfinite(g).any()
            if frame == "nan_band0":  # the port's NaN values stay in band 0's reach
                assert np.isfinite(g[SH // 2 :]).all()
        else:
            _assert_nonfinite_within(w, g, close)
    assert np.isfinite(step.numpy()).all() == frame.startswith("nan")
