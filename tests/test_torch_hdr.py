"""The HDR path on the CPU against the JAX package: an EXR animation of
tools/make_dataset.render_frame(hdr=True) (RGB unclipped: noise below 0,
the emissive ceiling above 4) with fireflies (RGB times 50) in the target
frame and LDR PNG layers, through both packages' Sessions and CLIs and
through the kernels' plain versions; and the staged bilateral's range test,
the bound that picks ex2.approx.ftz for a tap row, in pure Python.

The port runs with device "cpu", so every wrapper takes its plain version;
the JAX side runs its Pallas kernels in interpret mode. Outputs are float32
EXR, compared as floats. Tolerances are the repo's contracts with every
absolute part times the content's scale, max(1, max |RGB|) of the target
(the values the absolute parts were set for are at most 1):

  * exact configs and kernels: rtol 1e-4 / atol 1e-5 (NLM: rtol 2e-4 /
    atol 1e-4); the bf16-tap bilateral with the port's colour distance given
    XLA's CPU rounding (tests/test_torch_stencils.py);
  * the turbo NLM configs (bf16 taps, stride 2, with and without half-row
    weights): the exact NLM's tolerance, with the port's squared difference
    given XLA's CPU rounding (tests/test_torch_turbo.py);
  * the bilateral grid (turbo bilateral and linear): the pipeline contract of
    tests/test_torch_fast.py against the JAX Pallas pipeline (tpu-denoise
    takes its XLA lattice on the CPU);
  * the guided grid (turbo layers): the same pipeline contract on the
    normalized output, against tpu-denoise's file.
"""

import functools
import importlib.util
import math
import os
import unittest.mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_filter_tpu import cli as jcli
from image_denoising_filter_tpu import ops as jops
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
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import imageio
from test_torch_config import jax_params
from test_torch_fast import _assert_turbo_close
from test_torch_stencils import xla_cpu_bilateral_sq_diff
from test_torch_turbo import _xla_cpu_sq_diff

torch.set_num_threads(2)

H, W = 40, 56
N_FRAMES, TARGET = 3, 1
N_FIREFLIES, FIREFLY_GAIN = 6, 50.0
BF16 = TilingConfig(compute_dtype="bfloat16")
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_NLM = dict(rtol=2e-4, atol=1e-4)
BP = BilateralParams(radius=3)
LP = LayersParams(radius=3)
NP_ = NlmParams(search_radius=2, patch_radius=1)
PARAMS = dict(bilateral_params=BP, layers_params=LP, nlm_params=NP_)
IDS = ["bilateral", "layers", "linear", "nlm", "multiframe", "overlap"]
BATTERY_CASES = [(cfg, None) for cfg in GPU_BATTERY] + [(GPU_BATTERY[0], BF16),
                                                        (GPU_BATTERY[1], BF16)]
# The CLI runs of the turbo modes, as chip_smoke.py's phase 10 makes them;
# the half-row weights take patch radius 3.
SMALL = ("--radius", "3", "--search-radius", "2", "--patch-radius", "3")
TURBO_RUNS = {
    "turbo2": (("--turbo", "2"), IDS),
    "turbo2_hrw": (("--turbo", "2", "--weights-halfres"), ["nlm", "multiframe", "overlap"]),
    "turbo8_s6": (("--turbo", "8", "--sigma-spatial", "6"), ["bilateral", "layers", "linear"]),
    "turbo1": (("--turbo", "1"), ["layers"]),
}
NAMES = {k: c.output_name(True) for k, c in zip(IDS, GPU_BATTERY)}


def _render_frame():
    spec = importlib.util.spec_from_file_location(
        "make_dataset", os.path.join(os.path.dirname(__file__), "..", "tools", "make_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render_frame


def _scale(img):
    return max(1.0, float(np.abs(img[..., :3]).max()))


def _scaled(tol, scale):
    return dict(rtol=tol["rtol"], atol=tol["atol"] * scale)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


@pytest.fixture(scope="module")
def anim(tmp_path_factory):
    """The EXR animation: N_FRAMES frames, fireflies in the target, PNG
    layers of every frame (make_dataset's layout). Returns the target's
    path."""
    root = tmp_path_factory.mktemp("hdranim")
    os.makedirs(root / "RenderElements")
    render = _render_frame()
    rng = np.random.default_rng(0)
    for i in range(N_FRAMES):
        noisy, layers = render(i / (N_FRAMES - 1), H, W, rng, noise=0.08, hdr=True)
        if i == TARGET:
            fire = np.random.default_rng(1).choice(H * W, N_FIREFLIES, replace=False)
            noisy.reshape(-1, 4)[fire, :3] *= np.float32(FIREFLY_GAIN)
        imageio.save(str(root / f"Animation01_HDR_{i:04d}.exr"), noisy)
        for name, img in layers.items():
            imageio.save(str(root / "RenderElements" / f"{name}_{i:04d}.png"), np.clip(img, 0, 1))
    return str(root / f"Animation01_HDR_{TARGET:04d}.exr")


@pytest.fixture(scope="module")
def target(anim):
    return imageio.load(anim)[0]


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """A CPU tensor takes the plain version: no wrapper launches a kernel."""
    stencils.reset_launches()
    yield
    assert all(n == 0 for n in stencils.launches.values()), stencils.launches


def test_content_is_hdr(target):
    """The target has what HDR brings: negative values, the emissive ceiling
    above 4, fireflies far above it; alpha 1."""
    rgb = target[..., :3]
    assert rgb.min() < 0.0 and (rgb > 4.0).any() and rgb.max() > 100.0
    assert (target[..., 3] == 1.0).all()


# ---------------------------------------------------------------------------
# Sessions: the exact battery and the bf16 taps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,tiling", BATTERY_CASES, ids=IDS + ["bilateral_bf16", "layers_bf16"])
def test_battery_config_matches_jax_session(anim, target, tmp_path, cfg, tiling, monkeypatch):
    """Every exact config and both bf16 tilings on the HDR target: the port's
    output equals the JAX Session's, and the float32 EXR it saves is that
    output, alpha included."""
    if tiling is not None:
        monkeypatch.setattr(stencils, "_bilateral_sq_diff_bf16", xla_cpu_bilateral_sq_diff)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = JaxSession(anim, output_dir=str(tmp_path / "jax"), warmup=False,
                      tiling=jax_params(tiling), **{k: jax_params(v) for k, v in PARAMS.items()}
                      ).run(jax_params(cfg))
    got = Session(anim, device="cpu", output_dir=str(tmp_path / "port"), tiling=tiling,
                  **PARAMS).run(cfg)
    assert got.output_path.endswith(cfg.output_name(True))
    saved, hdr = imageio.load(got.output_path)
    assert hdr
    np.testing.assert_array_equal(saved, got.image)
    tol = TOL_NLM if cfg.nlm else TOL
    np.testing.assert_allclose(got.image, want.image, **_scaled(tol, _scale(target)))


def test_exr_output_ignores_clamp(anim, tmp_path):
    """An EXR target saves float32 EXR: --clamp (Session(clamp_output=True))
    changes nothing, values below 0 and above 1 stay."""
    outs = []
    for clamp in (False, True):
        out_dir = tmp_path / f"clamp{int(clamp)}"
        out_dir.mkdir()
        res = Session(anim, device="cpu", output_dir=str(out_dir), clamp_output=clamp,
                      **PARAMS).run(GPU_BATTERY[0])
        with open(res.output_path, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    rgb = res.image[..., :3]
    assert rgb.min() < 0.0 and rgb.max() > 1.0


# ---------------------------------------------------------------------------
# The CLIs: the turbo modes and --all-frames
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _cli_run(package, anim, out_dir, argv):
    """One CLI run (the JAX package's tpu-denoise, or gpu-denoise --device
    cpu with its squared difference given XLA's CPU rounding); returns its
    output directory."""
    if package == "jax":
        assert jcli.main([anim, "--output-dir", out_dir, *argv]) == 0
    else:
        with unittest.mock.patch.object(eager, "_sq_diff_bf16", _xla_cpu_sq_diff):
            assert cli.main([anim, "--device", "cpu", "--output-dir", out_dir, *argv]) == 0
    return out_dir


def _turbo_outputs(anim, tmp_path_factory, run):
    """Both CLIs' output directories of one run; tpu-denoise runs the configs
    its files are read for (not the bilateral grid: _jax_grid)."""
    flags, keys = TURBO_RUNS[run]
    dirs = {}
    for package in ("jax", "port"):
        sel = [k for k in keys if package == "port" or k not in ("bilateral", "linear")]
        if sel:
            argv = (*flags, *SMALL, "--configs", ",".join(sel))
            out = str(tmp_path_factory.getbasetemp() / f"{package}_{run}")
            dirs[package] = _cli_run(package, anim, out, argv)
    return flags, dirs


@functools.lru_cache(maxsize=None)
def _jax_grid(anim, d, sigma_s):
    """The JAX Pallas pipeline of the bilateral grid on the target, as
    tpu-denoise runs it on its chip (K 5 at d = 2 and 4, 6 otherwise)."""
    planar = jnp.transpose(jnp.asarray(imageio.load(anim)[0]), (2, 0, 1))
    want = jfast._grid_pipeline_planar(planar, jax_params(BilateralParams(
        radius=3, sigma_spatial=sigma_s)), 5 if d in (2, 4) else 6, d)
    return np.transpose(np.asarray(want), (1, 2, 0))


TURBO_CASES = [(run, key) for run, (_, keys) in TURBO_RUNS.items() for key in keys]


@pytest.mark.parametrize("run,key", TURBO_CASES, ids=[f"{r}-{k}" for r, k in TURBO_CASES])
def test_cli_turbo_matches_jax(anim, target, tmp_path_factory, run, key):
    """gpu-denoise --device cpu against tpu-denoise on the HDR target, each
    output a float32 EXR within its turbo contract (module docstring)."""
    flags, dirs = _turbo_outputs(anim, tmp_path_factory, run)
    got, hdr = imageio.load(os.path.join(dirs["port"], NAMES[key]))
    assert hdr and got.shape == (H, W, 4) and np.isfinite(got).all()
    scale = _scale(target)
    if key in ("bilateral", "linear"):
        sigma_s = float(flags[-1]) if "--sigma-spatial" in flags else 2.0
        _assert_turbo_close(got, _jax_grid(anim, int(flags[1]), sigma_s), scale)
        return
    want = imageio.load(os.path.join(dirs["jax"], NAMES[key]))[0]
    if key == "layers":
        _assert_turbo_close(got, want, scale)
    else:
        np.testing.assert_allclose(got, want, **_scaled(TOL_NLM, scale))


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_cli_all_frames_matches_jax(anim, tmp_path_factory, frame):
    """--all-frames, the serving loop, over the EXR animation: one output
    directory per frame with the same files as tpu-denoise's, each within the
    exact tolerances of the frame's content."""
    argv = ("--all-frames", "--configs", "bilateral,nlm", "--radius", "3", "--search-radius", "2",
            "--patch-radius", "1")
    dirs = {p: _cli_run(p, anim, str(tmp_path_factory.getbasetemp() / f"{p}_all"), argv)
            for p in ("jax", "port")}
    stems = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == stems == [f"Animation01_HDR_{i:04d}"
                                                         for i in range(N_FRAMES)]
    stem = stems[frame]
    names = sorted(os.listdir(os.path.join(dirs["port"], stem)))
    assert names == sorted(os.listdir(os.path.join(dirs["jax"], stem))) == sorted(
        [NAMES["bilateral"], NAMES["nlm"]])
    scale = _scale(imageio.load(os.path.join(os.path.dirname(anim), stem + ".exr"))[0])
    for key, tol in (("bilateral", TOL), ("nlm", TOL_NLM)):
        got = imageio.load(os.path.join(dirs["port"], stem, NAMES[key]))[0]
        want = imageio.load(os.path.join(dirs["jax"], stem, NAMES[key]))[0]
        np.testing.assert_allclose(got, want, **_scaled(tol, scale))


# ---------------------------------------------------------------------------
# The kernels' plain versions on HDR content
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["float32", "bf16"])
@pytest.mark.parametrize("border", [BorderPolicy.CLAMP, BorderPolicy.ZERO])
def test_bilateral_plain_hdr_matches_jax(target, form, border, monkeypatch):
    """The bilateral (fused normalize) and one layer's guided partials, float32
    and bf16 taps, on the HDR target."""
    monkeypatch.setattr(stencils, "_bilateral_sq_diff_bf16", xla_cpu_bilateral_sq_diff)
    tiling = BF16 if form == "bf16" else None
    layer = np.clip(_render_frame()(0.5, H, W, np.random.default_rng(2), hdr=True)[1]["albedo"],
                    0, 1)
    tol = _scaled(TOL, _scale(target))
    bp = BilateralParams(radius=3, border=border)
    got = stencils.bilateral(_t(target), bp, tiling)
    want = jops.bilateral(target, jax_params(bp), jax_params(tiling))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    lp = LayersParams(radius=3, border=border)
    wc, nw = stencils.cross_bilateral_layers(_t(target), _t(layer), lp, tiling)
    jwc, jnw = jops.cross_bilateral_layers(target, layer, jax_params(lp), jax_params(tiling))
    np.testing.assert_allclose(wc.numpy(), np.asarray(jwc), **tol)
    np.testing.assert_allclose(nw.numpy(), np.asarray(jnw), **TOL)


NLM_CASES = {
    "f32": (NlmParams(search_radius=3, patch_radius=2), None),
    "bf16_stride2": (NlmParams(search_radius=3, patch_radius=2, search_stride=2), BF16),
    "hrw_f32": (NlmParams(search_radius=3, search_stride=2, weights_halfres=True), None),
    "hrw_bf16": (NlmParams(search_radius=3, search_stride=2, weights_halfres=True), BF16),
}


@pytest.mark.parametrize("name", NLM_CASES)
def test_nlm_plain_hdr_matches_jax(anim, target, name, monkeypatch):
    """The NLM (F = 2 with the target and a neighbour frame) at float32 and
    bf16 taps, with full and half-row weights, on the HDR frames; the
    half-row float32 form against the XLA oracle, as tests/test_torch_hrw.py
    holds it."""
    monkeypatch.setattr(eager, "_sq_diff_bf16", _xla_cpu_sq_diff)
    params, tiling = NLM_CASES[name]
    nbr = imageio.load(anim.replace(f"{TARGET:04d}.exr", "0000.exr"))[0]
    frames = np.stack([target, nbr])
    wc, nw = stencils.nlm_accumulate_frames(_t(target), _t(frames), params, tiling)
    if name == "hrw_f32":
        jwc = jnw = 0.0
        for f in frames:
            pwc, pnw = xla.nlm_xla(target, f, jax_params(params))
            jwc, jnw = jwc + np.asarray(pwc), jnw + np.asarray(pnw)
    else:
        jwc, jnw = jops.nlm_accumulate_frames(target, frames, jax_params(params),
                                              jax_params(tiling))
    tol = _scaled(TOL_NLM, _scale(target))
    np.testing.assert_allclose(wc.numpy(), np.asarray(jwc), **tol)
    np.testing.assert_allclose(nw.numpy(), np.asarray(jnw), **TOL_NLM)


@pytest.mark.parametrize("d,sigma_s", [(2, 2.0), (4, 2.0), (8, 6.0)])
def test_bilateral_grid_with_negative_values_matches_jax(anim, target, d, sigma_s):
    """The bilateral grid's range comes from the pooled data, negative values
    and fireflies included: the port's grid pipeline meets the JAX Pallas
    pipeline at the pipeline contract."""
    levels = 5 if d in (2, 4) else 6
    small = fast.pool(_t(target), d, BorderPolicy.CLAMP)
    lmin, _ = fast.grid_range(small, levels)
    assert (float(lmin.min()) < 0.0) == (d == 2)  # pooling at d = 4, 8 averages it above 0
    got = fast.bilateral_fast(_t(target), BilateralParams(sigma_spatial=sigma_s), levels, d)
    _assert_turbo_close(got.numpy(), _jax_grid(anim, d, sigma_s), _scale(target))


def test_fireflies_stretch_the_grid_range_in_both_packages(anim, target):
    """Found in the reference (ROADMAP.md queue C): the bilateral grid spreads
    its levels over the pooled image's min to max, so a few fireflies leave
    most pixels between levels whose range weights underflow, and the
    output's alpha (1 in the target) strays: in the JAX package's lattice as
    in the port. With the fireflies divided back by 50 it holds."""
    from image_denoising_filter_tpu.ops import bilateral_fast as jax_bilateral_fast

    calm = target.copy()
    calm[calm[..., :3].max(-1) > 20.0, :3] /= FIREFLY_GAIN
    for img, strays in ((target, True), (calm, False)):
        got = fast.bilateral_fast(_t(img), BilateralParams(), 5, 2).numpy()
        want = np.asarray(jax_bilateral_fast(img, jax_params(BilateralParams()), 5, 2))
        for out in (got, want):
            share = float((np.abs(out[..., 3] - 1.0) > 0.01).mean())
            assert (share > 0.5) if strays else (share < 0.01), share


@pytest.mark.parametrize("d", [2, 4])
def test_guided_grid_hdr_target_matches_jax(anim, target, d):
    """The guided grid with an HDR target (its values) and an LDR guide (the
    albedo layer), the fused kernel's dispatch: the normalized per-layer
    output meets the JAX package's at the pipeline contract (d = 1 and 8 run
    through the CLIs above)."""
    layer = imageio.load(os.path.join(os.path.dirname(anim), "RenderElements",
                                      f"albedo_{TARGET:04d}.png"))[0]
    lp = LayersParams(radius=3)
    wc, nw = fast.cross_bilateral_layers_fast(_t(target), _t(layer), lp, 5, d)
    got = fast.normalize_layers_fast(wc, nw).numpy()
    jwc, jnw = jfast.cross_bilateral_layers_fast(target, layer, jax_params(lp), 5, d)
    want = np.asarray(jfast.normalize_layers_fast(jwc, jnw))
    _assert_turbo_close(got, want, _scale(target))


# ---------------------------------------------------------------------------
# The staged bilateral's range test (stencils.cu: ssd_max, bil_exp2<true>)
# ---------------------------------------------------------------------------


def _block(lo, hi):
    return torch.tensor([lo] * 3, dtype=torch.float32), torch.tensor([hi] * 3,
                                                                     dtype=torch.float32)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_range_bound_fails_on_a_firefly_block_and_passes_on_an_ldr_block(bf16):
    """A block whose channels span [0, 1] keeps every tap row's farthest
    exponent at -126 or above (ssd_max 3, x = sp - 3 * 18.03 >= -126); a
    block holding a firefly (RGB 250 beside 0.3) drives every row below it,
    so every row takes exp2f."""
    bp = BilateralParams()
    n_rows = sum(n for _, n, _ in stencils._circle_runs(bp.effective_radius, bp.sigma_spatial,
                                                         bp.truncate_eps))
    ldr = stencils.bilateral_ssd_max(*_block(0.0, 1.0), False, bf16)
    assert float(ldr) == 3.0
    assert stencils.bilateral_row_walks(ldr, bp).tolist() == [True] * n_rows
    fire = stencils.bilateral_ssd_max(*_block(0.3, 250.0), False, bf16)
    assert float(fire) > 1e5
    assert stencils.bilateral_row_walks(fire, bp).tolist() == [False] * n_rows
    # blue_bug drops blue from the distance, and from its bound
    assert float(stencils.bilateral_ssd_max(*_block(0.0, 1.0), True, bf16)) == 2.0


def test_range_bound_is_the_kernels_test():
    """The bound in numbers: col_coef = 0.5 / sigma_c^2 * log2(e), the
    farthest tap's spatial term sp_coef * (dy^2 + hw^2), -126 the least
    exponent of ex2.approx.ftz; the threshold distance of each row splits
    pass from fail; an infinite or NaN distance fails; the constant reaches
    the kernel as a macro."""
    bp = BilateralParams()
    col = 0.5 / bp.sigma_color**2 * stencils.LOG2E
    sp = -0.5 / bp.sigma_spatial**2 * stencils.LOG2E
    assert col == pytest.approx(18.0337, abs=1e-4)
    rows = [(dy, hw) for dy0, n, hw in stencils._circle_runs(
        bp.effective_radius, bp.sigma_spatial, bp.truncate_eps) for dy in range(dy0, dy0 + n)]
    thresholds = torch.tensor([(sp * (dy * dy + hw * hw) + 126.0) / col for dy, hw in rows])
    inside = stencils.bilateral_row_walks(thresholds * (1 - 1e-4), bp)
    outside = stencils.bilateral_row_walks(thresholds * (1 + 1e-4), bp)
    assert inside.diagonal().all() and not outside.diagonal().any()
    bad = stencils.bilateral_row_walks(torch.tensor([math.inf, math.nan]), bp)
    assert not bad.any()
    assert f"-DIDF_BIL_EXP2_MIN={stencils.BIL_EXP2_MIN!r}f" in stencils.nvcc_defines()
    assert stencils.BIL_EXP2_MIN == -126.0


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_bilateral_walks_on_hdr_and_ldr_frames(target, bf16):
    """How the H100's tile (16 x 96, halo 12) walks the frames: no block of
    LDR content leaves the fast walk, under either border; the HDR target's
    emissive edge and fireflies send blocks to exp2f; an infinite pixel sends
    every block that stages it there, a NaN one (which fminf and fmaxf pass
    by) none."""
    tile = stencils.bilateral_tile(BilateralParams(), False, bf16, 232448)
    assert (tile.th, tile.tw, tile.hy, tile.hx) == (16, 96, 12, 12)
    ldr = np.clip(target, 0.0, 1.0)
    for border in (BorderPolicy.CLAMP, BorderPolicy.ZERO):
        walks = stencils.bilateral_walks(_t(ldr), BilateralParams(border=border), bf16, tile)
        assert walks["rows_exp2f"] == 0 and walks["blocks"] == 3
    walks = stencils.bilateral_walks(_t(target), BilateralParams(), bf16, tile)
    assert walks["blocks_exp2f"] == 3 and 0 < walks["rows_exp2f"] <= walks["rows"]
    img = ldr.copy()
    img[5, 5, 1] = np.nan
    assert stencils.bilateral_walks(_t(img), BilateralParams(), bf16, tile)["rows_exp2f"] == 0
    img[5, 5, 1] = np.inf
    walks = stencils.bilateral_walks(_t(img), BilateralParams(), bf16, tile)
    # row 5 lies in the staged rows of blocks 0 and 1 (the halo reaches 12 rows)
    assert walks["blocks_exp2f"] == 2 and walks["rows_exp2f"] == 2 * walks["rows"] // 3
    with pytest.raises(ValueError):
        stencils.bilateral_walks(_t(ldr), BilateralParams(), bf16,
                                 stencils.BilateralTile(0, 96, 12, 12, 0, 0, 0, 0, 0))
