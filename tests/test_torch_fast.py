"""The port's turbo bilateral grid on the CPU: the tables, each kernel's plain
version against the JAX Pallas kernel (interpret mode), the pipeline, the
eager lattice, Session.run_turbo and `gpu-denoise --turbo`.

The same numpy inputs go to both packages. A Pallas call in interpret mode
costs seconds, so the JAX side of each case (pool, build and the whole
`_grid_pipeline_planar`) runs once per test module and is shared by the
tests of the stages. Tolerances, each with its reason:

  * tables: exact;
  * pool: rtol 1e-6 -- both reproduce the two bf16 casts, and float32 sums
    of d bf16 values scaled by 1/d are exact;
  * build: the stored-grid bf16 contract of tests/test_sharding.py (at most
    2 bf16 ulps, at most 1% of cells off float32-tight bounds) -- the port
    blurs tap by tap in float32, the reference with banded matmuls, and a
    ~1 ulp regrouping occasionally flips a stored bf16 cell;
  * slice: the reference telescopes its tent sum over bf16-rounded level
    deltas (fast.py:641-683), the port sums the stored levels themselves.
    Adding that rounding back to the port's output gives the reference's to
    1e-5 times max(1, max|img|). The rounding is zero where neighbouring
    levels are close and reaches 2.5e-3 at ZERO borders, beyond the repo's
    2e-3 "delta floor" (tests/test_fast.py:562-585);
  * pipeline: every pixel within that floor plus one stored-grid bf16 ulp
    (2^-8; a build flip allowed by the grid contract reaches the output
    through the slice's convex weights), and at most 0.1% of pixels beyond
    the floor, all times max(1, max|img|);
  * eager lattice: rtol 1e-5 / atol 1e-5, the same float32 math in the same
    order.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_filter_tpu.ops import bilateral_fast as jax_bilateral_fast
from image_denoising_filter_tpu.ops import fast as jfast
from image_denoising_filter_tpu.ops import reference as ref
from image_denoising_filter_tpu_torch import cli
from image_denoising_filter_tpu_torch.config import GPU_BATTERY, BilateralParams, BorderPolicy, RunConfig
from image_denoising_filter_tpu_torch.ops import fast, stencils
from image_denoising_filter_tpu_torch.ops.eager import bilateral_fast_eager
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import imageio
from test_torch_config import jax_params

torch.set_num_threads(2)

CLAMP, ZERO = BorderPolicy.CLAMP, BorderPolicy.ZERO
K = 5  # the run_turbo default at d = 2 and 4
INV2SC = 0.5 / BilateralParams().sigma_color ** 2
DELTA_FLOOR = 2e-3

# (d, border, uniform_alpha, (h, w), sigma_s): every d with both borders and
# both odd shapes; uniform alpha on and off under each border; and d = 8 at
# sigma_s 6, the setting `--turbo 8` is meant for, whose blur has 7 taps
# (3 at sigma_s 2).
CASES = [
    (2, CLAMP, False, (97, 131), 2.0),
    (2, ZERO, True, (50, 300), 2.0),
    (4, CLAMP, False, (97, 131), 2.0),
    (4, ZERO, True, (50, 300), 2.0),
    (8, CLAMP, True, (50, 300), 2.0),
    (8, ZERO, False, (97, 131), 2.0),
    (8, CLAMP, False, (97, 131), 6.0),
]
# The sharded turbo's d = 1 (gpu-denoise --turbo 1 --mesh): the Pallas
# kernels at 17 taps (sigma_s 2) and 49 (sigma_s 6); one device runs the
# eager lattice at d = 1, so only the stages and grid_pipeline take these.
D1_CASES = [
    (1, CLAMP, False, (64, 48), 2.0),
    (1, ZERO, True, (40, 56), 6.0),
]


def _ids(cases):
    return [
        f"d{d}-{b}-{'ua' if ua else 'a'}-{h}x{w}" + (f"-s{s:g}" if s != 2.0 else "")
        for d, b, ua, (h, w), s in cases
    ]


IDS = _ids(CASES)
STAGE_CASES, STAGE_IDS = CASES + D1_CASES, IDS + _ids(D1_CASES)


def _image(shape, uniform_alpha, hdr=False):
    """Structured noisy RGBA content on the 8-bit lattice (so a PNG holds it
    exactly); alpha is constant under uniform alpha and varies otherwise;
    hdr scales RGB by 4."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.35 * np.sin(xx / 9.0),
            0.45 + 0.35 * np.cos(yy / 7.0),
            np.where((xx // 24 + yy // 16) % 2 == 0, 0.75, 0.25),
            0.6 + 0.3 * np.sin((xx + yy) / 13.0),
        ],
        -1,
    ).astype(np.float32)
    img[..., :3] += rng.normal(0, 0.06, (h, w, 3)).astype(np.float32)
    if uniform_alpha:
        img[..., 3] = 1.0
    img = imageio.to_float(imageio.quantize(np.clip(img, 0, 1), clamp=True))
    if hdr:
        img[..., :3] *= 4.0
    return img


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _bf16(x):
    """A bf16 JAX or ml_dtypes array as a torch bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)


def _hwc(planar):
    return np.transpose(np.asarray(planar, np.float32), (1, 2, 0))


def _scale(img):
    return max(1.0, float(np.abs(img).max()))


def _assert_turbo_close(got, want, scale):
    """The pipeline contract of the module docstring."""
    diff = np.abs(np.asarray(got) - want)
    assert diff.max() <= (DELTA_FLOOR + 2.0**-8) * scale, diff.max()
    assert (diff > DELTA_FLOOR * scale).mean() <= 1e-3, (diff > DELTA_FLOOR * scale).mean()


def _delta_rounding(img, grid, lmin, inv_step, d, ua):
    """What the reference's telescoped slice adds to the exact tent sum of
    the same grid: sum_k clip(t - k, 0, 1) * up(bf16(D_k) - D_k), with
    D_k = g_{k+1} - g_k (alpha under green's t; none under uniform alpha)."""
    levels = grid.shape[0]
    h, w, _ = img.shape
    t = ((img[..., :3] - lmin) * inv_step).clamp(0.0, levels - 1.0)
    t = torch.cat([t, t[..., 1:2]], -1)
    g = grid.float()
    out = torch.zeros_like(img)
    for k in range(levels - 1):
        delta = g[k + 1] - g[k]
        err = delta.to(torch.bfloat16).float() - delta
        out += (t - k).clamp(0.0, 1.0) * fast._bilinear_up(err, d, h, w)
    if ua:
        out[..., 3] = 0.0
    return out


def _jax_case(d, border, ua, shape, sigma_s=2.0, hdr=False):
    return _jax_case_cached(d, border, ua, shape, sigma_s, hdr)


@functools.lru_cache(maxsize=None)
def _jax_case_cached(d, border, ua, shape, sigma_s, hdr):
    """The JAX side of one case, stage by stage as
    fast.py:_grid_pipeline_planar(pad_free=False) runs it (same pad, tiles
    and options; test_stages_are_the_grid_pipeline holds the two equal):
    the pooled image, the grid range, the bf16 grid of the legacy layout,
    and the sliced output."""
    img = _image(shape, ua, hdr)
    h, w = shape
    planar = jnp.transpose(jnp.asarray(img), (2, 0, 1))
    mode = "edge" if border == CLAMP else "constant"
    hp, wp = -(-h // d) * d, -(-w // d) * d
    small = jfast._pool_pallas(jnp.pad(planar, ((0, 0), (0, hp - h), (0, wp - w)), mode=mode), d)
    lmin = jnp.min(small[:3], axis=(1, 2))
    step = jnp.maximum(jnp.max(small[:3], axis=(1, 2)) - lmin, 1e-6) / (K - 1)
    bth, btw = jfast._default_build_tile(d)
    grid = jfast._build_grid_pallas(
        small, lmin, step, K, jfast._grid_taps(sigma_s, d), border, INV2SC,
        tile_h=bth, tile_w=btw, uniform_alpha=ua, extend_to=None,
    )
    th, tw = jfast._default_slice_tile(d)  # clamped as in fast.py:390-391
    th = max(16 * d, min(th, jfast._round_up(h, 16 * d)))
    tw = max(128 * d, min(tw, jfast._round_up(w, 128 * d)))
    out = jfast._slice_grid_pallas(
        planar[:3], grid, lmin, 1.0 / step, K, d, th, tw, uniform_alpha=ua,
        alpha_val=planar[3, 0, 0] if ua else None, pad_edge=True,
        cull_mask=jfast._default_cull_mask(d),
    )
    return {
        "img": img,
        "small": _hwc(small),
        "lmin": np.array(lmin),
        "step": np.array(step),
        "grid": np.array(grid),  # (nc*K, hs, ws) bfloat16
        "out": _hwc(out),
    }


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """A CPU tensor takes the plain version: no wrapper launches a kernel."""
    stencils.reset_launches()
    yield
    assert all(n == 0 for n in stencils.launches.values()), stencils.launches


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma_s", [2.0, 6.0])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_grid_taps_equal_jax(d, sigma_s):
    got, want = fast._grid_taps(sigma_s, d), jfast._grid_taps(sigma_s, d)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_upsample_weights_equal_jax(d):
    """The half-pixel bilinear weights at a slice tile (fast.py:549-550 sizes)
    and at a ragged image width."""
    for n_out in (16 * d, 128 * d, 131):
        n_in = -(-n_out // d) + 2
        np.testing.assert_array_equal(
            fast._upsample_matrix(d, n_in, n_out), jfast._upsample_matrix(d, n_in, n_out)
        )


# ---------------------------------------------------------------------------
# Each kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def test_stages_are_the_grid_pipeline():
    """The staged JAX reference of these tests is _grid_pipeline_planar
    itself (interpret mode is exact float32, so bitwise)."""
    d, border, ua, shape, sigma_s = CASES[1]
    case = _jax_case(d, border, ua, shape, sigma_s)
    planar = jnp.transpose(jnp.asarray(case["img"]), (2, 0, 1))
    bp = BilateralParams(border=border, uniform_alpha=ua, sigma_spatial=sigma_s)
    np.testing.assert_array_equal(
        _hwc(jfast._grid_pipeline_planar(planar, jax_params(bp), K, d, pad_free=False)), case["out"]
    )


@pytest.mark.parametrize("d,border,ua,shape,sigma_s", STAGE_CASES, ids=STAGE_IDS)
def test_pool_plain_matches_pallas(d, border, ua, shape, sigma_s):
    case = _jax_case(d, border, ua, shape, sigma_s)
    got = fast.pool(_t(case["img"]), d, border)
    np.testing.assert_allclose(got.numpy(), case["small"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("d,border,ua,shape,sigma_s", STAGE_CASES, ids=STAGE_IDS)
def test_build_grid_plain_matches_pallas(d, border, ua, shape, sigma_s):
    """On the same pooled input, lmin and step; under ZERO the padded cells
    are zero pixels that keep their range weight."""
    from test_sharding import _assert_bf16_grid_close

    case = _jax_case(d, border, ua, shape, sigma_s)
    grid = fast.build_grid(
        _t(case["small"]), _t(case["lmin"]), _t(case["step"]), K,
        fast._grid_taps(sigma_s, d), border, INV2SC, ua, d=d,
    )
    assert grid.dtype == torch.bfloat16 and grid.shape == (K, *case["small"].shape)
    got = fast.grid_to_planes(grid, ua).float().numpy()
    _assert_bf16_grid_close(got, case["grid"].astype(np.float32))
    # and the layout converters are inverse
    planes = _bf16(case["grid"])
    assert torch.equal(fast.grid_to_planes(fast.grid_from_planes(planes, ua), ua), planes)


@pytest.mark.parametrize("d,border,ua,shape,sigma_s", STAGE_CASES, ids=STAGE_IDS)
def test_slice_grid_plain_matches_pallas(d, border, ua, shape, sigma_s):
    """On the same bf16 grid (the pipeline's output is _slice_grid_pallas,
    pad_edge=True, of exactly this grid): the port's tent sum plus the
    reference's delta rounding is the reference's output."""
    case = _jax_case(d, border, ua, shape, sigma_s)
    img = _t(case["img"])
    lmin, inv_step = _t(case["lmin"]), 1.0 / _t(case["step"])
    grid = fast.grid_from_planes(_bf16(case["grid"]), ua)
    got = fast.slice_grid(img, grid, lmin, inv_step, d, img[0, 0, 3] if ua else None)
    rounding = _delta_rounding(img, grid, lmin, inv_step, d, ua)
    np.testing.assert_allclose((got + rounding).numpy(), case["out"], rtol=0,
                               atol=1e-5 * _scale(case["img"]))
    if ua:
        np.testing.assert_array_equal(got[..., 3].numpy(), case["img"][0, 0, 3])


@pytest.mark.parametrize("d,border,ua,shape,sigma_s", CASES, ids=IDS)
def test_bilateral_fast_matches_grid_pipeline(d, border, ua, shape, sigma_s):
    case = _jax_case(d, border, ua, shape, sigma_s)
    bp = BilateralParams(border=border, uniform_alpha=ua, sigma_spatial=sigma_s)
    got = fast.bilateral_fast(_t(case["img"]), bp, K, d)
    assert got.shape == (*shape, 4) and bool(torch.isfinite(got).all())
    _assert_turbo_close(got.numpy(), case["out"], _scale(case["img"]))


@pytest.mark.parametrize("d,border,ua,shape,sigma_s", CASES, ids=IDS)
def test_fused_grid_matches_fused_pipeline(d, border, ua, shape, sigma_s):
    """grid_pipeline(fused=True) takes the fused kernel (its plain version on
    the CPU): bit for bit the build-and-slice pipeline, and within the
    pipeline contract of the JAX package's fused pipeline
    (_grid_pipeline_planar(fused=True)), which rebases its telescoped sum at
    floor(tmin) where the port sums the levels themselves."""
    img = _image(shape, ua)
    bp = BilateralParams(border=border, uniform_alpha=ua, sigma_spatial=sigma_s)
    got = fast.grid_pipeline(_t(img), bp, K, d, fused=True)
    assert torch.equal(got, fast.grid_pipeline(_t(img), bp, K, d, fused=False))
    assert torch.equal(got, fast.grid_pipeline_plain(_t(img), bp, K, d))
    planar = jnp.transpose(jnp.asarray(img), (2, 0, 1))
    want = _hwc(jfast._grid_pipeline_planar(planar, jax_params(bp), K, d, fused=True))
    _assert_turbo_close(got.numpy(), want, _scale(img))


def test_fused_grid_is_off_by_default():
    """As in the reference (fast.py:_default_fused), no d takes the fused
    kernel unless asked: bilateral_fast and grid_pipeline(fused=None) run
    the build and the slice."""
    for d in (2, 4, 8):
        assert fast.default_fused(d) is False and jfast._default_fused(d) is False


@pytest.mark.parametrize("d,border,ua,shape,sigma_s", D1_CASES, ids=_ids(D1_CASES))
def test_grid_pipeline_d1_matches_pallas_pipeline(d, border, ua, shape, sigma_s):
    """The two-kernel pipeline at d = 1 (the sharded turbo's on one device)
    against the JAX package's _grid_pipeline_planar(..., 1): with the
    reference's delta rounding added back, within 1e-6 at every pixel whose
    cell no level of the two grids stores differently, and within one
    stored-grid bf16 ulp (2^-8) where the grid contract let a cell flip (a
    pixel at d = 1 reads its own cell; the next one with weight 0)."""
    case = _jax_case(d, border, ua, shape, sigma_s)
    img = _t(case["img"])
    bp = BilateralParams(border=border, uniform_alpha=ua, sigma_spatial=sigma_s)
    got = fast.grid_pipeline(img, bp, K, 1)
    assert torch.equal(got, fast.grid_pipeline_plain(img, bp, K, 1))
    small = fast.pool(img, 1, border)
    lmin, step = fast.grid_range(small, K)
    grid = fast.build_grid(small, lmin, step, K, fast._grid_taps(sigma_s, 1), border, INV2SC, ua,
                           d=1)
    planar = jnp.transpose(jnp.asarray(case["img"]), (2, 0, 1))
    want = _hwc(jfast._grid_pipeline_planar(planar, jax_params(bp), K, 1))
    np.testing.assert_array_equal(want, case["out"])
    diff = np.abs((got + _delta_rounding(img, grid, lmin, 1.0 / step, 1, ua)).numpy() - want)
    planes = fast.grid_to_planes(grid, ua).float().numpy()
    flipped = (planes != case["grid"].astype(np.float32)).any(0)
    assert flipped.mean() <= 1e-2
    scale = _scale(case["img"])
    assert diff[~flipped].max() <= 1e-6 * scale, diff[~flipped].max()
    assert diff.max() <= 2.0**-8 * scale, diff.max()


def test_bilateral_fast_d1_stays_the_eager_lattice(monkeypatch):
    """One device at d = 1 runs the eager lattice, as the JAX package runs
    its XLA lattice there (fast.py:211-216): no grid wrapper is called, and
    the output is not the d = 1 grid pipeline's."""
    img = _t(_image((40, 56), False))
    bp = BilateralParams()
    for name in ("pool", "build_grid", "slice_grid", "fused_grid"):
        monkeypatch.setattr(fast, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} called"))
    got = fast.bilateral_fast(img, bp, K, 1)
    assert torch.equal(got, bilateral_fast_eager(img, bp, K, 1))
    monkeypatch.undo()
    assert not torch.equal(got, fast.grid_pipeline(img, bp, K, 1))


def test_bilateral_fast_hdr_matches_grid_pipeline():
    """HDR content (RGB up to 4), which the reference never sent through the
    grid: the two packages agree within the pipeline contract scaled by the
    range (the slice difference is the reference's delta rounding, as
    above)."""
    case = _jax_case(2, CLAMP, False, (97, 131), hdr=True)
    assert case["img"].max() > 3.0
    got = fast.bilateral_fast(_t(case["img"]), BilateralParams(), K, 2).numpy()
    _assert_turbo_close(got, case["out"], _scale(case["img"]))


def test_turbo_d2_within_40db_of_exact():
    """The quality gate of tests/test_fast.py:28-35 at d=2, for the port's
    default K=5, against the NumPy oracle of the exact bilateral."""
    rng = np.random.default_rng(1234)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    clean = np.stack(
        [
            0.5 + 0.35 * np.sin(xx / 25),
            0.45 + 0.35 * np.cos(yy / 20),
            np.where((xx // 48 + yy // 32) % 2 == 0, 0.75, 0.25).astype(np.float32),
            np.ones((h, w), np.float32),
        ],
        -1,
    )
    noisy = np.clip(clean + rng.normal(0, 0.06, clean.shape) * [1, 1, 1, 0], 0, 1)
    noisy = noisy.astype(np.float32)
    bp = BilateralParams()
    exact = ref.bilateral_reference(noisy, jax_params(bp))
    got = fast.bilateral_fast(_t(noisy), bp, K, 2).numpy()
    db = ref.psnr(got[..., :3], exact[..., :3])
    assert db >= 40.0, f"turbo d=2 vs exact: {db:.1f} dB"


# ---------------------------------------------------------------------------
# The eager lattice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("border", [CLAMP, ZERO])
@pytest.mark.parametrize("d", [1, 2])
def test_eager_lattice_matches_jax(d, border):
    """JAX's bilateral_fast takes its XLA lattice on the CPU at every d: the
    same math as bilateral_fast_eager. Under ZERO the padded blur fields
    carry no weight there (unlike the Pallas build)."""
    img = _image((50, 64), False)
    bp = BilateralParams(border=border)
    got = bilateral_fast_eager(_t(img), bp, K, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bilateral_fast(img, jax_params(bp), K, d)),
                               rtol=1e-5, atol=1e-5)
    if d == 1:  # the port's public entry takes the lattice at d = 1
        torch.testing.assert_close(fast.bilateral_fast(_t(img), bp, K, 1), got, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Wrapper checks
# ---------------------------------------------------------------------------


def test_grid_wrappers_check_inputs():
    img = _t(_image((24, 32), False))
    small = fast.pool(img, 2)
    lmin = small[..., :3].amin((0, 1))
    step = torch.full((3,), 0.25)
    taps = fast._grid_taps(2.0, 2)
    with pytest.raises(ValueError):  # the kernels take d in {1, 2, 4, 8}
        fast.pool(img, 3)
    with pytest.raises(TypeError):
        fast.pool(img.double(), 2)
    with pytest.raises(ValueError):  # more taps than the kernel's table
        fast.build_grid(small, lmin, step, K, np.ones(65, np.float32) / 65, CLAMP, INV2SC, d=2)
    with pytest.raises(ValueError):
        fast.build_grid(small, lmin, step, 1, taps, CLAMP, INV2SC, d=2)
    with pytest.raises(ValueError):
        fast.build_grid(small, lmin[:2], step, K, taps, CLAMP, INV2SC, d=2)
    grid = fast.build_grid(small, lmin, step, K, taps, CLAMP, INV2SC, d=2)
    with pytest.raises(TypeError):
        fast.slice_grid(img, grid.float(), lmin, 1.0 / step, 2)
    with pytest.raises(ValueError):  # grid of another image size
        fast.slice_grid(img[:-2], grid, lmin, 1.0 / step, 2)
    with pytest.raises(ValueError):  # uniform alpha is one constant
        fast.slice_grid(img, grid, lmin, 1.0 / step, 2, img[0, :2, 3])


def test_fused_grid_checks_inputs():
    img = _t(_image((24, 32), False))
    small = fast.pool(img, 2)
    lmin = small[..., :3].amin((0, 1))
    step = torch.full((3,), 0.25)
    taps = fast._grid_taps(2.0, 2)
    args = (small, img, lmin, step, 1.0 / step, K, taps, CLAMP, INV2SC)
    with pytest.raises(ValueError):  # pooled at another d
        fast.fused_grid(*args, 4)
    with pytest.raises(ValueError, match=r"\(2, 4, 8\)"):  # no fused kernel at d = 1
        fast.fused_grid(fast.pool(img, 1), img, lmin, step, 1.0 / step, K, taps, CLAMP, INV2SC, 1)
    with pytest.raises(ValueError):  # uniform alpha is one constant
        fast.fused_grid(*args, 2, img[0, :2, 3])
    with pytest.raises(ValueError):
        fast.fused_grid(small, img, lmin[:2], step, 1.0 / step, K, taps, CLAMP, INV2SC, 2)
    with pytest.raises(TypeError):
        fast.fused_grid(small, img.double(), lmin, step, 1.0 / step, K, taps, CLAMP, INV2SC, 2)


# ---------------------------------------------------------------------------
# Session.run_turbo and the CLI
# ---------------------------------------------------------------------------


def _write_target(root, img, name="frame_0001.png"):
    root.mkdir(parents=True, exist_ok=True)
    path = str(root / name)
    imageio.save(path, img, clamp=True)
    np.testing.assert_array_equal(imageio.load(path)[0], img)  # 8-bit lattice
    return path


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("cfg", [GPU_BATTERY[0], GPU_BATTERY[2]], ids=["bilateral", "linear"])
def test_run_turbo_matches_grid_pipeline(tmp_path, cfg, d):
    """The bilateral and linear configs run the same grid pipeline (K=5 at
    d = 2 and 4), which is what the JAX Session runs on the TPU, and save
    under the JAX file names."""
    case = _jax_case(d, CLAMP, False, (97, 131))
    target = _write_target(tmp_path / "anim", case["img"])
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    result = Session(target, device="cpu", output_dir=str(out_dir)).run_turbo(cfg, downsample=d)
    assert os.path.basename(result.output_path) == cfg.output_name(False)
    assert os.path.exists(result.output_path)
    _assert_turbo_close(result.image, case["out"], 1.0)
    assert result.report.exec_ns > 0 and result.report.transfer_ns > 0


@pytest.mark.parametrize("d,levels,want", [(1, None, 6), (2, None, 5), (4, None, 5),
                                           (8, None, 6), (2, 7, 7)])
def test_run_turbo_resolves_levels(tmp_path, monkeypatch, capsys, d, levels, want):
    seen = []
    real = fast.bilateral_fast

    def spy(img, params, k, downsample):
        seen.append((k, downsample))
        return real(img, params, k, downsample)

    monkeypatch.setattr(fast, "bilateral_fast", spy)
    target = _write_target(tmp_path / "anim", _image((24, 32), False))
    Session(target, device="cpu", output_dir=str(tmp_path), warmup=False).run_turbo(
        RunConfig(), levels=levels, downsample=d
    )
    assert seen == [(want, d)]
    note = "note: --turbo 8" in capsys.readouterr().out
    assert note == (d == 8)  # sigma_s = 2 < 5


def test_run_turbo_refuses_layers_and_nlm(tmp_path):
    """run_turbo takes the layers config now (the guided grid); the NLM
    configs have no grid mode and are still refused: their turbo form is
    Session.run with the strided search and bf16 taps (the JAX Session
    asserts)."""
    target = _write_target(tmp_path / "anim", _image((24, 32), False))
    session = Session(target, device="cpu", output_dir=str(tmp_path))
    for cfg in GPU_BATTERY[3:]:
        with pytest.raises(ValueError, match="no grid mode"):
            session.run_turbo(cfg)


@pytest.mark.parametrize("turbo", ["1", "2"])
def test_cli_turbo_bilateral_and_linear(tmp_path, capsys, turbo):
    target = _write_target(tmp_path / "anim", _image((50, 64), False))
    out = tmp_path / "out"
    rc = cli.main([target, "--device", "cpu", "--output-dir", str(out), "--clamp",
                   "--turbo", turbo, "--configs", "bilateral,linear"])
    assert rc == 0
    a, _ = imageio.load(str(out / GPU_BATTERY[0].output_name(False)))
    b, _ = imageio.load(str(out / GPU_BATTERY[2].output_name(False)))
    np.testing.assert_array_equal(a, b)
    assert capsys.readouterr().out.count("execution time:") == 2


def test_cli_turbo_rejects_other_downsamples(tmp_path):
    with pytest.raises(SystemExit) as exc:
        cli.main([str(tmp_path / "x.png"), "--device", "cpu", "--turbo", "3"])
    assert exc.value.code == 2


def test_builds_take_the_downsample_they_dispatch_by():
    """Both builds take d as a required keyword: on the card d = 1 launches
    the d = 1 body and every other d the 2-D one, so a call without d
    raises, as one outside DOWNSAMPLES does; on a CPU tensor every d runs
    the same plain version."""
    img = _t(_image((24, 40), False))
    small = fast.pool(img, 1)
    lmin, step = fast.grid_range(small, K)
    taps = fast._grid_taps(2.0, 1)
    with pytest.raises(TypeError, match="'d'"):
        fast.build_grid(small, lmin, step, K, taps, CLAMP, INV2SC)
    with pytest.raises(TypeError, match="'d'"):
        fast.build_guided_grid(small, small, lmin, step, K, taps, CLAMP, INV2SC)
    with pytest.raises(ValueError, match="downsample"):
        fast.build_grid(small, lmin, step, K, taps, CLAMP, INV2SC, d=3)
    with pytest.raises(ValueError, match="downsample"):
        fast.build_guided_grid(small, small, lmin, step, K, taps, CLAMP, INV2SC, d=3)
    for d in fast.DOWNSAMPLES:
        assert torch.equal(fast.build_grid(small, lmin, step, K, taps, CLAMP, INV2SC, d=d),
                           fast.build_grid_plain(small, lmin, step, K, taps, CLAMP, INV2SC))
        assert torch.equal(
            fast.build_guided_grid(small, small, lmin, step, K, taps, CLAMP, INV2SC, d=d),
            fast.build_guided_grid_plain(small, small, lmin, step, K, taps, CLAMP, INV2SC))


@pytest.mark.parametrize("d", fast.DOWNSAMPLES)
def test_pipelines_pass_their_downsample_to_the_builds(d, monkeypatch):
    """grid_pipeline (the build and slice kernels) and
    cross_bilateral_layers_fast (the two guided kernels) hand their own d
    to the builds, which pick the card's body by it."""
    from image_denoising_filter_tpu_torch.config import LayersParams

    seen = []
    build_grid, build_guided_grid = fast.build_grid, fast.build_guided_grid

    def spy(name, fn):
        def call(*args, d, **kwargs):
            seen.append((name, d))
            return fn(*args, d=d, **kwargs)
        return call

    monkeypatch.setattr(fast, "build_grid", spy("grid", build_grid))
    monkeypatch.setattr(fast, "build_guided_grid", spy("guided", build_guided_grid))
    img = _t(_image((24, 40), False))
    fast.grid_pipeline(img, BilateralParams(), K, d)
    fast.cross_bilateral_layers_fast(img, img, LayersParams(), K, d, fused=False)
    assert seen == [("grid", d), ("guided", d)]
