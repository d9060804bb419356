"""The port's sharded paths (parallel/) on the CPU, over gloo, against the JAX
package's sharded functions and against the port's single-device path.

The JAX side runs as tests/test_sharding.py runs it, on the 8-device virtual
CPU mesh of tests/conftest.py. The port side runs in ranks of
torch.distributed: one module-scoped launch per mesh shape (1x2, 1x4, 2x2,
4x1) runs every case of that shape through parallel.dryrun.run_cases, the
ranks' body in the port package (a spawned rank imports neither this file
nor jax), which writes each case's gathered output as .npy; the tests only
compare. Each case of tests/test_sharding.py has its counterpart here, with
the same inputs. Tolerances, each with its reason:

  * against the JAX sharded function: the JAX tests' own, rtol 1e-4 /
    atol 1e-5 for the exact bilateral and layers, 2e-4 / 1e-4 for NLM (the
    TPU box-sums its SSD by shift-doubling, ROADMAP.md queue C); the turbo
    grids at the stored-grid bf16 contract (_assert_bf16_grid_close) after
    the reference's bf16 delta rounding is added back to the port's output
    (tests/test_torch_fast.py, tests/test_torch_guided.py);
  * against the port's single-device path on the same device: bit for bit
    for every 1xY exact case and for the turbo grids (the seam cells are
    built from real neighbour cells, the slab slice clamps to the image's
    grid rows); the temporal NLM over F > 1 frame ranks regroups the frame
    partials in the SUM over 'frame', held at rtol 1e-5 / atol 1e-6.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import parallel as jpar
from image_denoising_filter_tpu.config import TilingConfig as JaxTilingConfig
from image_denoising_filter_tpu.ops import fast as jfast
from image_denoising_filter_tpu.ops import reference as ref
from image_denoising_filter_tpu_torch.config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    TilingConfig,
)
from image_denoising_filter_tpu_torch.ops import eager, fast, stencils
from image_denoising_filter_tpu_torch.parallel import dryrun, launch, make_mesh, spatial
from test_torch_config import jax_params

torch.set_num_threads(1)

BP = BilateralParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
BF16 = TilingConfig(compute_dtype="bfloat16")
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_NLM = dict(rtol=2e-4, atol=1e-4)
TOL_REGROUPED = dict(rtol=1e-5, atol=1e-6)
# A launch of the ranks, start-up included, ends well inside this.
RANKS_TIMEOUT_S = 300.0


def _frame(seed, h=32, w=32):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (h, w, 4)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _temporal_inputs(n_real=8, n_pad=0):
    target = _frame(0)
    real = [_frame(10 + i) for i in range(n_real)] if n_pad == 0 else [
        _frame(20 + i) for i in range(n_real)]
    frames = np.stack(real + [np.zeros_like(real[0])] * n_pad)
    valid = np.asarray([1.0] * n_real + [0.0] * n_pad, np.float32)
    return {"target": target, "frames": frames, "valid": valid}


def _hrw(**kw):
    return NlmParams(search_stride=2, weights_halfres=True, **kw)


def _case(name, mesh, kind, inputs, expect_error=False, **kw):
    return name, mesh, {"name": name, "kind": kind, "inputs": inputs, "kw": kw,
                        "expect_error": expect_error}


# (name, mesh shape, the ranks' case): every case of tests/test_sharding.py
# at meshes of at most 4 ranks, and the refusals.
CASES = [
    _case("bilateral_1x2", (1, 2), "bilateral", {"img": _frame(0)}, params=BP),
    _case("bilateral_1x4", (1, 4), "bilateral", {"img": _frame(0)}, params=BP),
    _case("bilateral_2x2", (2, 2), "bilateral", {"img": _frame(0)}, params=BP),
    _case("bilateral_zero", (1, 4), "bilateral", {"img": _frame(1)},
          params=BilateralParams(radius=3, border=BorderPolicy.ZERO)),
    _case("fast_1x2_d2", (1, 2), "bilateral_fast", {"img": _frame(2, 128, 48)},
          params=BilateralParams(), levels=8, downsample=2),
    _case("fast_1x4_d2", (1, 4), "bilateral_fast", {"img": _frame(2, 128, 48)},
          params=BilateralParams(), levels=8, downsample=2),
    _case("fast_1x2_d4", (1, 2), "bilateral_fast", {"img": _frame(2, 128, 48)},
          params=BilateralParams(), levels=8, downsample=4),
    _case("fast_zero", (1, 2), "bilateral_fast", {"img": _frame(3, 64, 48)},
          params=BilateralParams(border=BorderPolicy.ZERO), levels=8, downsample=2),
    _case("fast_1x2_d1", (1, 2), "bilateral_fast", {"img": _frame(2, 128, 48)},
          params=BilateralParams(), levels=8, downsample=1),
    _case("fast_1x4_d1", (1, 4), "bilateral_fast", {"img": _frame(2, 128, 48)},
          params=BilateralParams(), levels=8, downsample=1),
    _case("fast_zero_d1", (1, 4), "bilateral_fast", {"img": _frame(2, 128, 48)},
          params=BilateralParams(border=BorderPolicy.ZERO), levels=8, downsample=1),
    _case("fast_1x2_d1_s6", (1, 2), "bilateral_fast", {"img": _frame(2, 128, 48)},
          params=BilateralParams(sigma_spatial=6.0), levels=8, downsample=1),
    _case("nlm", (1, 4), "nlm", {"target": _frame(0), "neighbour": _frame(1)}, params=NP_),
    _case("linear_1x2", (1, 2), "bilateral", {"img": _frame(3)}, params=BP, linear=True),
    _case("linear_1x4", (1, 4), "bilateral", {"img": _frame(3)}, params=BP, linear=True),
    _case("linear_nlm", (1, 4), "nlm", {"target": _frame(0), "neighbour": _frame(1)},
          params=NP_, linear=True),
    _case("split", (1, 2), "bilateral", {"img": _frame(4, 64, 32)}, params=BP),
    _case("temporal_2x2", (2, 2), "temporal", _temporal_inputs(), params=NP_),
    _case("temporal_4x1", (4, 1), "temporal", _temporal_inputs(), params=NP_),
    _case("temporal_1x4", (1, 4), "temporal", _temporal_inputs(), params=NP_),
    _case("valid_mask", (4, 1), "temporal", _temporal_inputs(5, 3), params=NP_),
    _case("layers_fast_1x2", (1, 2), "layers_fast",
          {"target": _frame(2, 128, 48), "layer": _frame(7, 128, 48)},
          params=LayersParams(), levels=8, downsample=2),
    _case("layers_fast_1x4", (1, 4), "layers_fast",
          {"target": _frame(2, 128, 48), "layer": _frame(7, 128, 48)},
          params=LayersParams(), levels=8, downsample=2),
    _case("nlm_turbo", (1, 4), "nlm", {"target": _frame(0), "neighbour": _frame(1)},
          params=NlmParams(search_radius=2, patch_radius=1, search_stride=2), tiling=BF16),
    _case("nlm_hrw", (1, 4), "nlm", {"target": _frame(0, h=64), "neighbour": _frame(1, h=64)},
          params=_hrw(), tiling=BF16),
    # refusals: 17 rows a band (odd), an odd halo (s + p = 9), the temporal
    # path's guard, a band shorter than the halo; one 'y' rank refuses nothing
    _case("hrw_odd_rows", (1, 4), "nlm",
          {"target": _frame(0, h=68), "neighbour": _frame(1, h=68)}, True, params=_hrw()),
    _case("hrw_odd_halo", (1, 4), "nlm",
          {"target": _frame(0, h=64), "neighbour": _frame(1, h=64)}, True,
          params=_hrw(search_radius=6)),
    _case("hrw_temporal", (2, 2), "temporal",
          {"target": _frame(0, h=34), "frames": np.stack([_frame(1, h=34)] * 2),
           "valid": np.ones(2, np.float32)}, True, params=_hrw()),
    _case("hrw_one_y", (4, 1), "nlm", {"target": _frame(0, h=68), "neighbour": _frame(1, h=68)},
          params=_hrw()),
    _case("short_band", (1, 4), "bilateral", {"img": _frame(5, h=8)}, True, params=BP),
    # 16 rows a band under the 25-row pooled halo of the d = 1 grid at sigma_s 6
    _case("fast_d1_short_band", (1, 4), "bilateral_fast", {"img": _frame(2, 64, 48)}, True,
          params=BilateralParams(sigma_spatial=6.0), levels=8, downsample=1),
]
MESH_OF = {name: mesh for name, mesh, _ in CASES}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """outputs(name) -> case `name`'s outputs from the ranks (or its error
    message), the ranks of each mesh shape started once."""
    runs = {}

    def get(name):
        mesh = MESH_OF[name]
        if mesh not in runs:
            out_dir = str(tmp_path_factory.mktemp(f"mesh{mesh[0]}x{mesh[1]}"))
            cases = [case for _, m, case in CASES if m == mesh]
            try:
                launch.run_ranks(mesh[0] * mesh[1], dryrun.run_cases, cases, out_dir, mesh,
                                 "cpu", device_type="cpu", timeout_s=RANKS_TIMEOUT_S)
                runs[mesh] = out_dir
            except Exception as e:  # every case of the mesh fails with it
                runs[mesh] = e
        if isinstance(runs[mesh], Exception):
            raise runs[mesh]
        error = os.path.join(runs[mesh], f"{name}.error.txt")
        if os.path.exists(error):
            with open(error) as f:
                return f.read()
        return dryrun.load_outputs(runs[mesh], name)

    return get


def _inputs(name):
    return next(case["inputs"] for n, _, case in CASES if n == name)


def _jmesh(shape):
    return jpar.make_mesh(shape)


def _np(*xs):
    return tuple(np.asarray(x) for x in xs)


def _assert_all_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# The mesh and the launcher
# ---------------------------------------------------------------------------


def test_mesh_needs_a_process_group_of_its_size(tmp_path):
    """The counterpart of test_eight_devices_available: make_mesh refuses
    without a process group, and a shape whose size is not the world's (a
    rank outside the mesh would hang its peers)."""
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 2), "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh((1, 2), "cpu")
        mesh = make_mesh(None, "cpu")
        assert mesh.mesh_dim_names == ("frame", "y") and tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_run_ranks_raises_a_failing_ranks_error():
    with pytest.raises(Exception, match="FileNotFoundError"):
        launch.run_ranks(2, os.path.getsize, "/nonexistent/idf", device_type="cpu",
                         timeout_s=RANKS_TIMEOUT_S)


def test_run_ranks_stops_at_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.run_ranks(2, time.sleep, 600, device_type="cpu", timeout_s=8)
    assert time.monotonic() - t0 < 60


def test_backend_checks_name_the_flag():
    with pytest.raises(ValueError, match="--dist-backend nccl"):
        launch.check_backend("nccl", "cpu", 2)
    with pytest.raises(ValueError, match="unknown"):
        launch.check_backend("mpi", "cpu", 2)
    assert launch.default_backend("cpu") == "gloo" and launch.default_backend("cuda") == "nccl"


# ---------------------------------------------------------------------------
# The exact paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x2", "1x4", "2x2"])
def test_spatial_bilateral_matches_oracle(outputs, mesh):
    (got,) = outputs(f"bilateral_{mesh}")
    img = _frame(0)
    f, y = map(int, mesh.split("x"))
    want = jpar.spatial_bilateral(img, jax_params(BP), _jmesh((f, y)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, ref.bilateral_reference(img, jax_params(BP)), **TOL)
    np.testing.assert_array_equal(got, stencils.bilateral(_t(img), BP).numpy())


def test_spatial_bilateral_zero_border(outputs):
    (got,) = outputs("bilateral_zero")
    p = BilateralParams(radius=3, border=BorderPolicy.ZERO)
    img = _frame(1)
    want = jpar.spatial_bilateral(img, jax_params(p), _jmesh((1, 4)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, ref.bilateral_reference(img, jax_params(p)), **TOL)
    np.testing.assert_array_equal(got, stencils.bilateral(_t(img), p).numpy())


def test_spatial_nlm_matches_oracle(outputs):
    got = outputs("nlm")
    t, n = _frame(0), _frame(1)
    want = jpar.spatial_nlm_accumulate(t, n, jax_params(NP_), _jmesh((1, 4)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL_NLM)
    for g, w in zip(got, ref.nlm_reference(t, n, jax_params(NP_))):
        np.testing.assert_allclose(g, w, **TOL)
    _assert_all_equal(got, stencils.nlm_accumulate(_t(t), _t(n), NP_))


@pytest.mark.parametrize("n_y", [2, 4])
def test_spatial_bilateral_linear_layout_sharded(outputs, n_y):
    """The linear layout shards over the same mesh (ops/eager.py on the
    bands): a --mesh run does not fall back to one device for it."""
    (got,) = outputs(f"linear_1x{n_y}")
    img = _frame(3)
    want = jpar.spatial_bilateral(img, jax_params(BP), _jmesh((1, n_y)), linear=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got, ref.bilateral_reference(img, jax_params(BP)), **TOL)
    np.testing.assert_array_equal(got, eager.bilateral_eager(_t(img), BP).numpy())


def test_spatial_nlm_linear_layout_sharded(outputs):
    got = outputs("linear_nlm")
    t, n = _frame(0), _frame(1)
    want = jpar.spatial_nlm_accumulate(t, n, jax_params(NP_), _jmesh((1, 4)), linear=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL_NLM)
    _assert_all_equal(got, eager.nlm_eager(_t(t), _t(n), NP_))


def test_split_halo_interior_edge_stitching(outputs):
    """32-row bands with a 3-row halo take the interior/edge split: the
    stitched output is the single-device kernel's, bit for bit."""
    (got,) = outputs("split")
    img = _frame(4, h=64, w=32)
    want = jpar.spatial_bilateral(img, jax_params(BP), _jmesh((1, 2)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_array_equal(got, stencils.bilateral(_t(img), BP).numpy())
    assert img.shape[0] // 2 >= 3 * BP.effective_radius


def _temporal_single(inputs, params=NP_):
    x = {k: _t(v) for k, v in inputs.items()}
    wc, nw = stencils.nlm_accumulate_frames(x["target"], x["frames"], params, None, x["valid"])
    return stencils.normalize(wc, nw).numpy()


def _temporal_oracle(inputs):
    real = inputs["frames"][inputs["valid"] > 0]
    wc = np.zeros(inputs["target"].shape, np.float32)
    nw = np.zeros(inputs["target"].shape[:2], np.float32)
    for f in real:
        pwc, pnw = ref.nlm_reference(inputs["target"], f, jax_params(NP_))
        wc += pwc
        nw += pnw
    return ref.normalize_reference(wc, nw)


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "1x4"])
def test_temporal_nlm_sharded_full(outputs, mesh):
    """Frames over 'frame', rows over 'y': the SUM of the partials over
    'frame' equals the sequential frame loop and normalize."""
    (got,) = outputs(f"temporal_{mesh}")
    inputs = _inputs(f"temporal_{mesh}")
    f, y = map(int, mesh.split("x"))
    want = jpar.temporal_nlm_sharded(inputs["target"], inputs["frames"], jax_params(NP_),
                                     mesh=_jmesh((f, y)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL_NLM)
    np.testing.assert_allclose(got, _temporal_oracle(inputs), rtol=2e-4, atol=1e-5)
    single = _temporal_single(inputs)
    if f == 1:
        np.testing.assert_array_equal(got, single)
    else:
        np.testing.assert_allclose(got, single, **TOL_REGROUPED)


def test_temporal_nlm_sharded_valid_mask(outputs):
    """Padding frames (valid 0) add neither weights nor their norm seed: 5
    frames padded to 8 equal the 5-frame loop."""
    (got,) = outputs("valid_mask")
    inputs = _inputs("valid_mask")
    import jax.numpy as jnp

    want = jpar.temporal_nlm_sharded(inputs["target"], inputs["frames"], jax_params(NP_),
                                     mesh=_jmesh((4, 2)), valid=jnp.asarray(inputs["valid"]))
    np.testing.assert_allclose(got, np.asarray(want), **TOL_NLM)
    np.testing.assert_allclose(got, _temporal_oracle(inputs), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got, _temporal_single(inputs), **TOL_REGROUPED)


def _check_bf16_nlm(got, t, n, params, monkeypatch):
    """bf16 taps: the sharded partials are the single-device port's as
    shipped, bit for bit; the JAX sharded kernel meets the port's
    single-device partials given XLA's CPU rounding of the squared
    difference (tests/test_torch_turbo.py) at the NLM tolerance."""
    from test_torch_turbo import _xla_cpu_sq_diff

    _assert_all_equal(got, stencils.nlm_accumulate(_t(t), _t(n), params, BF16))
    want = jpar.spatial_nlm_accumulate(t, n, jax_params(params), _jmesh((1, 4)),
                                       JaxTilingConfig(compute_dtype="bfloat16"))
    monkeypatch.setattr(eager, "_sq_diff_bf16", _xla_cpu_sq_diff)
    for g, w in zip(stencils.nlm_accumulate(_t(t), _t(n), params, BF16), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL_NLM)


def test_spatial_nlm_turbo_params_sharded(outputs, monkeypatch):
    """The turbo NLM (stride-2 search, bf16 taps) shards like the exact one."""
    params = NlmParams(search_radius=2, patch_radius=1, search_stride=2)
    _check_bf16_nlm(outputs("nlm_turbo"), _frame(0), _frame(1), params, monkeypatch)


def test_spatial_nlm_weights_halfres_sharded(outputs, monkeypatch):
    """Even bands (16 rows) and an even halo (10) keep the half-row pooling
    lattice: the sharded partials are the single-device kernel's."""
    _check_bf16_nlm(outputs("nlm_hrw"), _frame(0, h=64), _frame(1, h=64), _hrw(), monkeypatch)


def test_spatial_nlm_weights_halfres_odd_offset_refused(outputs):
    """Odd bands or an odd halo would shift the half-row lattice band by
    band: the sharded entries refuse them, as the JAX package's do; one 'y'
    rank has no offset to refuse."""
    for name in ("hrw_odd_rows", "hrw_odd_halo", "hrw_temporal"):
        assert "even-row pooling lattice" in outputs(name), name
    with pytest.raises(ValueError, match="even-row pooling lattice"):
        jpar.spatial_nlm_accumulate(_frame(0, h=68), _frame(1, h=68), jax_params(_hrw()),
                                    _jmesh((1, 4)))
    got = outputs("hrw_one_y")
    assert all(np.isfinite(g).all() for g in got)
    _assert_all_equal(got, stencils.nlm_accumulate(_t(_frame(0, h=68)), _t(_frame(1, h=68)),
                                                   _hrw()))


def test_a_band_shorter_than_the_halo_raises(outputs):
    assert "halo" in outputs("short_band")


# ---------------------------------------------------------------------------
# The turbo grids
# ---------------------------------------------------------------------------


def _grid_delta_rounding(img, params, levels, d):
    """The reference's bf16 delta rounding of the single-device port grid
    (tests/test_torch_fast.py:_delta_rounding), which the sharded grid
    equals bit for bit."""
    from test_torch_fast import _delta_rounding

    small = fast.pool(img, d, params.border)
    lmin, step = fast.grid_range(small, levels)
    grid = fast.build_grid(small, lmin, step, levels, fast._grid_taps(params.sigma_spatial, d),
                           params.border, 0.5 / params.sigma_color**2, d=d)
    return _delta_rounding(img, grid, lmin, 1.0 / step, d, False)


def _check_fast(got, img, params, n_y, levels, d):
    """The sharded grid against the single-device two-kernel pipeline, bit
    for bit (at d = 1 that is grid_pipeline, not bilateral_fast: one device
    runs the eager lattice there), and against the JAX sharded grid."""
    from test_sharding import _assert_bf16_grid_close

    single = fast.grid_pipeline(_t(img), params, levels, d)
    if d > 1:
        assert torch.equal(single, fast.bilateral_fast(_t(img), params, levels, d))
    np.testing.assert_array_equal(got, single.numpy())
    want = jpar.spatial_bilateral_fast(img, jax_params(params), _jmesh((1, n_y)), levels, d)
    with_delta = single + _grid_delta_rounding(_t(img), params, levels, d)
    _assert_bf16_grid_close(with_delta.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_y,d", [(2, 2), (4, 2), (2, 4)])
def test_spatial_bilateral_fast_matches_single_device(outputs, n_y, d):
    """The sharded turbo grid equals the single-device pipeline bit for bit:
    the seam cells blur over real neighbour cells and each band slices a
    slab with one real grid row from each neighbour. The JAX package's
    sharded grid meets it at the stored-grid bf16 contract."""
    (got,) = outputs(f"fast_1x{n_y}_d{d}")
    _check_fast(got, _frame(2, h=128, w=48), BilateralParams(), n_y, 8, d)


def test_spatial_bilateral_fast_zero_border(outputs):
    (got,) = outputs("fast_zero")
    _check_fast(got, _frame(3, h=64, w=48), BilateralParams(border=BorderPolicy.ZERO), 2, 8, 2)


@pytest.mark.parametrize("name,n_y,border", [("fast_1x2_d1", 2, BorderPolicy.CLAMP),
                                             ("fast_1x4_d1", 4, BorderPolicy.CLAMP),
                                             ("fast_zero_d1", 4, BorderPolicy.ZERO)])
def test_spatial_bilateral_fast_d1_matches_single_device(outputs, name, n_y, border):
    """The sharded grid at d = 1 (gpu-denoise --turbo 1 --mesh; 17 blur taps,
    a 9-row pooled halo): the single-device pipeline grid_pipeline(..., 1)
    bit for bit, and the JAX package's spatial_bilateral_fast(d=1), which
    runs its Pallas kernels at d = 1, at the stored-grid bf16 contract."""
    (got,) = outputs(name)
    _check_fast(got, _frame(2, h=128, w=48), BilateralParams(border=border), n_y, 8, 1)


def test_spatial_bilateral_fast_d1_wide_blur(outputs):
    """sigma_s 6 at d = 1: 49 taps and a 25-row pooled halo, which 64-row
    bands hold; bit for bit the single-device pipeline."""
    (got,) = outputs("fast_1x2_d1_s6")
    params = BilateralParams(sigma_spatial=6.0)
    assert spatial._grid_geometry(64, 1, 6.0, "bilateral")[1] == 25
    single = fast.grid_pipeline(_t(_frame(2, h=128, w=48)), params, 8, 1)
    np.testing.assert_array_equal(got, single.numpy())


def test_spatial_bilateral_fast_d1_short_band_raises_as_jax_does(outputs):
    """Bands of 16 rows under the 25-row halo of sigma_s 6 at d = 1: the port
    raises, and so does the JAX package's sharded grid (its halo exchange
    refuses a shard shorter than the halo)."""
    assert "25-row halo" in outputs("fast_d1_short_band")
    params = jax_params(BilateralParams(sigma_spatial=6.0))
    with pytest.raises(ValueError, match="25-row halo"):
        jpar.spatial_bilateral_fast(_frame(2, 64, 48), params, _jmesh((1, 4)), 8, 1)


@pytest.mark.parametrize("n_y", [2, 4])
def test_spatial_layers_fast_matches_single_device(outputs, n_y):
    """The sharded guided grid's partials equal the single-device ones bit
    for bit; normalized, the JAX package's sharded layers meet them at the
    stored-grid bf16 contract of its own test (4 ulps: the division of two
    planes that each may flip)."""
    from test_sharding import _assert_bf16_grid_close
    from test_torch_guided import _delta_rounding

    got = outputs(f"layers_fast_1x{n_y}")
    tgt, layer = _t(_frame(2, h=128, w=48)), _t(_frame(7, h=128, w=48))
    params = LayersParams()
    single = fast.cross_bilateral_layers_fast(tgt, layer, params, 8, 2)
    _assert_all_equal(got, single)
    jwc, jnw = jpar.spatial_cross_bilateral_layers_fast(
        tgt.numpy(), layer.numpy(), jax_params(params), _jmesh((1, n_y)), 8, 2)
    want = np.asarray(jfast.normalize_layers_fast(np.asarray(jwc), np.asarray(jnw)))
    small_t, small_l = fast.pool(tgt, 2), fast.pool(layer, 2)
    lmin, step = fast.grid_range(small_l, 8)
    grid = fast.build_guided_grid(small_t, small_l, lmin, step, 8, fast._grid_taps(2.0, 2),
                                  params.border, 0.5 / params.sigma_color**2, d=2)
    partials = torch.cat(single, -1) + _delta_rounding(layer, grid, lmin, 1.0 / step, 2)
    out = fast.normalize_layers_fast(partials[..., :4], partials[..., 4:]).numpy()
    _assert_bf16_grid_close(out, want, ulps=4)


def test_sharded_turbo_refuses_bands_off_the_grid():
    """A band whose rows do not divide by d raises before any collective."""
    with pytest.raises(ValueError, match="divisible by the downsample"):
        spatial._grid_geometry(27, 2, 2.0, "bilateral")
    taps, halo = spatial._grid_geometry(32, 4, 2.0, "bilateral")
    assert halo == (taps.size - 1) // 2 + 1


def test_cases_cover_every_mesh_shape():
    assert sorted(set(MESH_OF.values())) == [(1, 2), (1, 4), (2, 2), (4, 1)]
    assert all(dataclasses.is_dataclass(case["kw"]["params"]) for _, _, case in CASES)


# ---------------------------------------------------------------------------
# The slab slice (the plain versions of the slice kernels' slab form)
# ---------------------------------------------------------------------------


def _slab_of(grid, gy_off, rows):
    """Grid rows [gy_off, gy_off + rows); a row above the image is NaN,
    which the slice must never read."""
    slab = torch.full((grid.shape[0], rows) + tuple(grid.shape[2:]), float("nan"),
                      dtype=grid.dtype)
    lo, hi = max(gy_off, 0), min(gy_off + rows, grid.shape[1])
    slab[:, lo - gy_off : hi - gy_off] = grid[:, lo:hi]
    return slab


@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_slab_slice_equals_the_whole_slice(d, border):
    """Each band of a 4-way split sliced against its slab of rows_s + 2 grid
    rows (y_off, hs_all, gy_off) equals the whole-image slice's rows bit for
    bit, both grids, the outermost bands included; (0, hs, 0) is the
    whole-image slice itself."""
    h, w = 16 * d, 40
    img = _t(_frame(6, h, w))
    layer = _t(_frame(8, h, w))
    small, small_l = fast.pool(img, d, border), fast.pool(layer, d, border)
    lmin, step = fast.grid_range(small, 5)
    taps = fast._grid_taps(2.0, d)
    grid = fast.build_grid(small, lmin, step, 5, taps, border, 12.5, d=d)
    ggrid = fast.build_guided_grid(small, small_l, lmin, step, 5, taps, border, 12.5, d=d)
    whole = fast.slice_grid(img, grid, lmin, 1.0 / step, d)
    gwhole = fast.slice_guided_grid(layer, ggrid, lmin, 1.0 / step, d)
    hs = h // d
    assert torch.equal(fast.slice_grid(img, grid, lmin, 1.0 / step, d, None, 0, hs, 0), whole)
    rows = h // 4
    for i in range(4):
        band = slice(i * rows, (i + 1) * rows)
        off = (i * rows, hs, i * rows // d - 1)
        slab = _slab_of(grid, off[2], rows // d + 2)
        got = fast.slice_grid(img[band], slab, lmin, 1.0 / step, d, None, *off)
        assert torch.equal(got, whole[band]), f"band {i}"
        got = fast.slice_guided_grid(layer[band], _slab_of(ggrid, off[2], rows // d + 2), lmin,
                                     1.0 / step, d, *off)
        assert all(torch.equal(g, part[band]) for g, part in zip(got, gwhole)), f"band {i}"


def test_slab_slice_refuses_what_it_cannot_read():
    img = _t(_frame(6, 32, 40))
    small = fast.pool(img, 2)
    lmin, step = fast.grid_range(small, 5)
    grid = fast.build_grid(small, lmin, step, 5, fast._grid_taps(2.0, 2), BorderPolicy.CLAMP,
                           12.5, d=2)
    band = img[8:16]
    with pytest.raises(ValueError, match="multiple of d"):
        fast.slice_grid(band, grid[:, 3:9], lmin, 1.0 / step, 2, None, 9, 16, 3)
    with pytest.raises(ValueError, match="miss rows"):
        fast.slice_grid(band, grid[:, 4:8], lmin, 1.0 / step, 2, None, 8, 16, 4)
    with pytest.raises(ValueError, match="hs_all"):
        fast.slice_grid(band, grid[:, :4], lmin, 1.0 / step, 2, None, 8, None, 0)
    assert fast.check_slab(8, 2, 6, 8, 16, 3) == (8, 16, 3)
