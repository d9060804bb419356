"""Session and gpu-denoise on a mesh of ranks (CPU, gloo): the sharded battery
against the JAX package's sharded Session (8-device virtual CPU mesh) and
against the port's single-device Session.

The port's Sessions run in ranks through parallel.dryrun.run_session_cases
(the ranks' body in the port package); one module-scoped launch per world
size runs every case of that size (the 1x4 and 2x2 meshes share one launch of
four ranks). Tolerances: against the JAX Session, the JAX sharded tests' own
(rtol 1e-4 / atol 1e-5; the sharded turbo at the stored-grid bf16 contract
after the reference's delta rounding, as tests/test_torch_sharding.py holds
it); against the port's single-device Session, bit for bit for every config
on a 1xY mesh and for the spatial configs on 2x2 (they replicate over
'frame'), and rtol 1e-5 / atol 1e-6 for the temporal NLM over two frame
ranks, whose SUM over 'frame' regroups the frames' partials.
"""

import filecmp
import functools
import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu.runtime import Session as JaxSession
from image_denoising_filter_tpu_torch import cli
from image_denoising_filter_tpu_torch.config import (
    GPU_BATTERY,
    BilateralParams,
    LayersParams,
    NlmParams,
    RunConfig,
)
from image_denoising_filter_tpu_torch.ops import fast
from image_denoising_filter_tpu_torch.parallel import dryrun, launch
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import imageio
from test_torch_config import jax_params

torch.set_num_threads(1)

BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
PARAMS = dict(bilateral_params=BP, layers_params=LP, nlm_params=NP_)
IDS = ["bilateral", "layers", "linear", "nlm", "multiframe", "overlap"]
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_REGROUPED = dict(rtol=1e-5, atol=1e-6)
RANKS_TIMEOUT_S = 300.0


def _make_anim(root, n_frames=4, uniform_alpha=False):
    """tests/test_sharded_session.py's animation: 48x64 frames and one
    albedo layer of frame 0001; returns the target."""
    rng = np.random.default_rng(0)
    os.makedirs(f"{root}/RenderElements", exist_ok=True)
    for i in range(n_frames):
        img = rng.uniform(0, 1, (48, 64, 4)).astype(np.float32)
        if uniform_alpha:
            img[..., 3] = 1.0
        imageio.save(f"{root}/frame_{i:04d}.png", img)
    imageio.save(f"{root}/RenderElements/albedo_0001.png",
                 rng.uniform(0, 1, (48, 64, 4)).astype(np.float32))
    return f"{root}/frame_0001.png"


def _odd_rows(root):
    os.makedirs(root, exist_ok=True)
    target = f"{root}/odd_0000.png"
    imageio.save(target, np.random.default_rng(1).uniform(0, 1, (47, 64, 4)).astype(np.float32))
    return target


def _turbo_frame(root):
    os.makedirs(root, exist_ok=True)
    target = f"{root}/turbo_0000.png"
    imageio.save(target, np.random.default_rng(2).uniform(0, 1, (50, 64, 4)).astype(np.float32))
    return target


def _short_frame(root):
    """20 rows: on 1x2 at d = 1 the row rule pads to two bands of 13
    (d (rg + 1), rg = 12 at sigma_s 2)."""
    os.makedirs(root, exist_ok=True)
    target = f"{root}/short_0000.png"
    imageio.save(target, np.random.default_rng(3).uniform(0, 1, (20, 64, 4)).astype(np.float32))
    return target


def _streams(root):
    """7 frames of 64x32 over a 2-wide 'frame' axis: 4 chunks, one padded."""
    os.makedirs(root, exist_ok=True)
    for i in range(7):
        imageio.save(f"{root}/f_{i:04d}.png",
                     np.random.default_rng(i).uniform(0, 1, (64, 32, 4)).astype(np.float32))
    return f"{root}/f_0000.png"


def _cases(base):
    """(name, mesh, target, method, cfg, Session kw, call kw) of every case."""
    anim = _make_anim(f"{base}/anim")
    ua = _make_anim(f"{base}/anim_ua", uniform_alpha=True)
    cases = []
    for mesh in ((1, 4), (2, 2)):
        for cfg, key in zip(GPU_BATTERY, IDS):
            cases.append((f"{key}_{mesh[0]}x{mesh[1]}", mesh, anim, "run", cfg, PARAMS, {}))
    for cfg, key in zip(GPU_BATTERY, IDS):
        cases.append((f"{key}_ua", (1, 4), ua, "run", cfg, PARAMS, {}))
    cases += [
        ("odd_rows", (1, 4), _odd_rows(f"{base}/odd"), "run", RunConfig(),
         {"bilateral_params": BP}, {}),
        ("streams", (2, 2), _streams(f"{base}/streams"), "run",
         RunConfig(nlm=True, multiframe=True), {"nlm_params": NP_}, {}),
        ("turbo", (1, 2), _turbo_frame(f"{base}/turbo"), "run_turbo", RunConfig(),
         {"bilateral_params": BilateralParams()}, {"levels": 8, "downsample": 2}),
        ("turbo_layers", (1, 2), anim, "run_turbo", RunConfig(use_layers=True),
         {"layers_params": LayersParams()}, {"levels": 6, "downsample": 2}),
        ("turbo_d4", (1, 4), anim, "run_turbo", RunConfig(),
         {"bilateral_params": BilateralParams()}, {"levels": 5, "downsample": 4}),
        ("turbo_d1", (1, 2), _short_frame(f"{base}/short"), "run_turbo", RunConfig(),
         {"bilateral_params": BilateralParams()}, {"downsample": 1}),
    ]
    return {c[0]: c for c in cases}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """sharded(name) -> (RunResult.image of rank 0, the case); the ranks of
    each world size started once."""
    base = str(tmp_path_factory.mktemp("sessions"))
    cases = _cases(base)
    runs = {}

    def get(name):
        case = cases[name]
        world = case[1][0] * case[1][1]
        if world not in runs:
            out_dir = str(tmp_path_factory.mktemp(f"ranks{world}"))
            todo = [{"name": n, "mesh": m, "target": t, "method": meth, "cfg": cfg, "kw": kw,
                     "call_kw": ckw}
                    for n, m, t, meth, cfg, kw, ckw in cases.values() if m[0] * m[1] == world]
            try:
                launch.run_ranks(world, dryrun.run_session_cases, todo, out_dir, "cpu",
                                 device_type="cpu", timeout_s=RANKS_TIMEOUT_S)
                runs[world] = out_dir
            except Exception as e:  # every case of that size fails with it
                runs[world] = e
        if isinstance(runs[world], Exception):
            raise runs[world]
        (image,) = dryrun.load_outputs(runs[world], name)
        return image, case

    return get


def _single(case, tmp_path):
    name, _, target, method, cfg, kw, call_kw = case
    out = tmp_path / f"single_{name}"
    out.mkdir(exist_ok=True)
    session = Session(target, device="cpu", output_dir=str(out), **kw)
    return getattr(session, method)(cfg, **call_kw).image


@functools.lru_cache(maxsize=None)
def _jax(name, mesh, target, method, cfg, out_dir, kw_items, call_items):
    kw = {k: jax_params(v) for k, v in kw_items}
    session = JaxSession(target, output_dir=out_dir, mesh_shape=mesh, **kw)
    return getattr(session, method)(jax_params(cfg), **dict(call_items)).image


def _jax_sharded(case, tmp_path):
    name, mesh, target, method, cfg, kw, call_kw = case
    out = tmp_path / f"jax_{name}"
    out.mkdir(exist_ok=True)
    return _jax(name, mesh, target, method, cfg, str(out), tuple(kw.items()),
                tuple(call_kw.items()))


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("key", IDS)
def test_sharded_session_matches_single(sharded, tmp_path, key, mesh):
    """Every config on the mesh: the JAX sharded Session's output, and the
    port's single-device Session's, bit for bit where nothing regroups."""
    got, case = sharded(f"{key}_{mesh}")
    np.testing.assert_allclose(got, _jax_sharded(case, tmp_path), **TOL)
    single = _single(case, tmp_path)
    if mesh == "2x2" and key in ("multiframe", "overlap"):
        np.testing.assert_allclose(got, single, **TOL_REGROUPED)
    else:
        np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("key", IDS)
def test_sharded_session_keeps_the_uniform_alpha_rule(sharded, tmp_path, key):
    """With a constant alpha the single-device Session switches the kernels
    to uniform alpha (per frame in the multiframe loop); the mesh runs make
    the same choice, so every config stays bit for bit on 1x4."""
    got, case = sharded(f"{key}_ua")
    np.testing.assert_array_equal(got, _single(case, tmp_path))


def test_sharded_session_odd_rows(sharded, tmp_path):
    """47 rows do not divide over 4 'y' ranks: the row padding and the crop
    leave no trace."""
    got, case = sharded("odd_rows")
    assert got.shape == (47, 64, 4)
    np.testing.assert_allclose(got, _jax_sharded(case, tmp_path), **TOL)
    np.testing.assert_array_equal(got, _single(case, tmp_path))


def test_session_sharded_temporal_streams_chunks(sharded, tmp_path):
    """7 frames in chunks of the 2-wide 'frame' axis (one padding frame,
    masked): the single-device multiframe output, up to the regrouped sum."""
    got, case = sharded("streams")
    np.testing.assert_allclose(got, _jax_sharded(case, tmp_path), **TOL)
    np.testing.assert_allclose(got, _single(case, tmp_path), **TOL_REGROUPED)


def _padded_single(target, rows, fn):
    loaded, _ = imageio.load(target)
    padded = np.pad(loaded, ((0, rows - loaded.shape[0]), (0, 0), (0, 0)), mode="edge")
    return fn(torch.from_numpy(padded)).numpy()[: loaded.shape[0]]


def test_sharded_session_turbo(sharded, tmp_path):
    """The sharded turbo pads 50 rows to 2 bands of 26 (they divide by d and
    hold the pooled halo), runs the banded grid pipeline and crops: equal to
    the single-device pipeline on the same padded frame bit for bit; the JAX
    sharded Session meets it at the stored-grid bf16 contract."""
    from test_sharding import _assert_bf16_grid_close
    from test_torch_sharding import _grid_delta_rounding

    got, case = sharded("turbo")
    bp = BilateralParams()
    assert got.shape == (50, 64, 4)
    want = _padded_single(case[2], 52, lambda x: fast.bilateral_fast(x, bp, 8, 2))
    np.testing.assert_array_equal(got, want)
    delta = _padded_single(case[2], 52, lambda x: _grid_delta_rounding(x, bp, 8, 2))
    _assert_bf16_grid_close(got + delta, _jax_sharded(case, tmp_path))


def test_sharded_session_turbo_d4_pads_each_band(sharded):
    """48 rows over 4 'y' ranks at d = 4: bands of 20 rows, d (rg + 1) with
    rg = ceil(13 / 4), so 80 rows in all, edge padded; equal to the
    single-device pipeline on that frame."""
    got, case = sharded("turbo_d4")
    want = _padded_single(case[2], 80,
                          lambda x: fast.bilateral_fast(x, BilateralParams(), 5, 4))
    np.testing.assert_array_equal(got, want)


def test_sharded_session_turbo_d1(sharded, tmp_path):
    """--turbo 1 on a mesh: 20 rows padded to two bands of 13, the grid
    kernels at d = 1 (K = 6) band by band, cropped: bit for bit the
    single-device two-kernel pipeline grid_pipeline(..., 1) on the same
    padded frame, not the eager lattice one device runs at d = 1; the JAX
    sharded Session meets it at the stored-grid bf16 contract."""
    from test_sharding import _assert_bf16_grid_close
    from test_torch_sharding import _grid_delta_rounding

    got, case = sharded("turbo_d1")
    bp = BilateralParams()
    assert got.shape == (20, 64, 4)
    want = _padded_single(case[2], 26, lambda x: fast.grid_pipeline(x, bp, 6, 1))
    np.testing.assert_array_equal(got, want)
    lattice = _single(case, tmp_path)
    assert not np.array_equal(got, lattice)
    delta = _padded_single(case[2], 26, lambda x: _grid_delta_rounding(x, bp, 6, 1))
    _assert_bf16_grid_close(got + delta, _jax_sharded(case, tmp_path))


def test_sharded_session_turbo_layers(sharded):
    """The turbo layers on a mesh (2 bands of 24 rows, no padding): each
    layer's banded guided grid, accumulated and normalized, equals the
    single-device Session, which runs the fused guided kernel at d = 2."""
    got, case = sharded("turbo_layers")
    loaded = {p: imageio.load(p)[0] for p in (case[2],
                                              case[2].replace("frame_0001.png",
                                                              "RenderElements/albedo_0001.png"))}
    target, layer = (torch.from_numpy(x) for x in loaded.values())
    wc, nw = fast.cross_bilateral_layers_fast(target, layer, LayersParams(), 6, 2)
    np.testing.assert_array_equal(got, fast.normalize_layers_fast(wc, nw).numpy())


# ---------------------------------------------------------------------------
# gpu-denoise --mesh
# ---------------------------------------------------------------------------

CLI_PARAMS = ["--radius", "3", "--search-radius", "2", "--patch-radius", "1"]


def test_cli_mesh_writes_the_single_device_files(tmp_path, capsys):
    """--mesh 1x2 over gloo runs the six configs and writes the files the
    single-device run writes, byte for byte; rank 0 alone prints its six
    timing reports."""
    target = _make_anim(str(tmp_path / "anim"))
    argv = [target, "--device", "cpu", *CLI_PARAMS, "--configs", ",".join(cli.CONFIG_KEYS)]
    assert cli.main([*argv, "--output-dir", str(tmp_path / "single")]) == 0
    capsys.readouterr()
    rc, counts = cli.run([*argv, "--output-dir", str(tmp_path / "mesh"), "--mesh", "1x2",
                          "--dist-backend", "gloo"])
    out = capsys.readouterr().out
    assert rc == 0 and len(counts) == 2
    assert out.count("transfer time:") == 6
    names = sorted(os.listdir(tmp_path / "single"))
    assert len(names) == 6 and names == sorted(os.listdir(tmp_path / "mesh"))
    for name in names:
        assert filecmp.cmp(tmp_path / "single" / name, tmp_path / "mesh" / name, shallow=False)


def test_cli_mesh_turbo1_writes_the_d1_pipeline_files(tmp_path, capsys):
    """gpu-denoise --turbo 1 --mesh 1x2 runs bilateral and linear through the
    d = 1 grid kernels on both ranks: each file is the single-device
    grid_pipeline(..., 1) on the row-padded frame, cropped and saved, byte
    for byte."""
    target = _short_frame(str(tmp_path / "short"))
    out = tmp_path / "mesh"
    rc, counts = cli.run([target, "--device", "cpu", "--turbo", "1", "--mesh", "1x2",
                          "--dist-backend", "gloo", "--configs", "bilateral,linear",
                          "--output-dir", str(out)])
    assert rc == 0 and len(counts) == 2
    assert capsys.readouterr().out.count("execution time:") == 2
    want = _padded_single(target, 26, lambda x: fast.grid_pipeline(x, BilateralParams(), 6, 1))
    ref_dir = tmp_path / "want"
    ref_dir.mkdir()
    for cfg in (GPU_BATTERY[0], GPU_BATTERY[2]):
        name = cfg.output_name(False)
        imageio.save(str(ref_dir / name), want)
        assert filecmp.cmp(ref_dir / name, out / name, shallow=False), name
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref_dir))


@pytest.mark.parametrize("argv,message", [
    (["--mesh", "2x"], "error"),
    (["--mesh", "0x2"], "at least 1"),
    (["--mesh", "1x2", "--dist-backend", "nccl"], "--dist-backend nccl"),
])
def test_cli_refuses_a_bad_mesh_or_backend(tmp_path, capsys, argv, message):
    target = _odd_rows(str(tmp_path / "odd"))
    rc = cli.main([target, "--device", "cpu", "--configs", "bilateral", *argv,
                   "--output-dir", str(tmp_path / "out")])
    assert rc == 1
    assert message in capsys.readouterr().err


def test_cli_mesh_on_cuda_without_a_card_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    target = _odd_rows(str(tmp_path / "odd"))
    rc = cli.main([target, "--mesh", "1x2", "--configs", "bilateral", "--output-dir",
                   str(tmp_path / "out")])
    assert rc == 1
    assert "no CUDA device" in capsys.readouterr().err
