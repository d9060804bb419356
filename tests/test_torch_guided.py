"""The port's guided grid (turbo layers) on the CPU, stage by stage: each
kernel's plain version against the JAX Pallas kernel in interpret mode, on
the same numpy inputs.

A Pallas call in interpret mode costs seconds, so the JAX side of each case
(the two pools, `_build_guided_grid_pallas`, `_slice_guided_grid_pallas`
and, at d = 2 and 4, `_fused_guided_pipeline_planar`) runs once per module
and is shared by the tests of the stages. Tolerances, each with its reason:

  * pool: exact (rtol 1e-6 at d = 1 too, a bf16 round trip of every value);
  * build: the stored-grid bf16 contract of tests/test_sharding.py (at most
    2 bf16 ulps, at most 1% of cells off float32-tight bounds): the port
    blurs tap by tap, the reference with banded matmuls;
  * slice: the reference telescopes its tent sum over bf16-rounded level
    deltas, the port sums the stored levels directly; adding that rounding
    back to the port's partials gives the reference's to 1e-5 times
    max(1, max|partials|);
  * fused: the port's fused kernel computes the two kernels' sums (its plain
    version is their composition), so it equals the port's two-kernel path
    exactly. The reference's fused kernel meets its own two-kernel path at
    the stored-grid bf16 contract (tests/test_fast.py:632-677: it blurs
    other windows with banded matmuls, and rebases its telescoped sum at
    level floor(tmin) of each slice tile, 0 for every case here); so the
    port's fused partials plus the delta rounding meet the reference's
    fused partials at that same contract. Normalized, the delta rounding is
    divided by the partials' den: 6.4e-3 at the ZERO border of d2-zero,
    above the 4e-3 rebased floor of tests/test_fast.py:680-711, which holds
    CLAMP content (ROADMAP.md queue C).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_denoising_filter_tpu.ops import fast as jfast
from image_denoising_filter_tpu_torch.config import BorderPolicy, LayersParams
from image_denoising_filter_tpu_torch.ops import fast, stencils
from test_torch_config import jax_params

torch.set_num_threads(2)

CLAMP, ZERO = BorderPolicy.CLAMP, BorderPolicy.ZERO
K = 6
INV2SC = 0.5 / LayersParams().sigma_color ** 2

# (d, border, (h, w)): every d under both borders, the odd shapes of the JAX
# package's own guided tests.
CASES = [
    (1, CLAMP, (50, 300)),
    (1, ZERO, (40, 140)),
    (2, ZERO, (97, 131)),
    (2, CLAMP, (112, 384)),
    (4, CLAMP, (118, 410)),
    (4, ZERO, (97, 131)),
    (8, ZERO, (112, 384)),
    (8, CLAMP, (97, 131)),
]
IDS = [f"d{d}-{b}-{h}x{w}" for d, b, (h, w) in CASES]


def _image(shape, seed):
    """Structured noisy RGBA content with a varying alpha."""
    h, w = shape
    rng = np.random.default_rng(seed * 7919 + h * 1000 + w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.5 + 0.35 * np.sin(xx / (9.0 + seed)),
            0.45 + 0.35 * np.cos(yy / 7.0),
            np.where((xx // 24 + yy // 16) % 2 == seed % 2, 0.75, 0.25),
            0.6 + 0.3 * np.sin((xx + yy) / 13.0),
        ],
        -1,
    ).astype(np.float32)
    img[..., :3] += rng.normal(0, 0.06, (h, w, 3)).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _bf16(x):
    """A bf16 JAX array as a torch bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.array(x).view(np.uint16)).view(torch.bfloat16)


def _hwc(planar):
    return np.transpose(np.asarray(planar, np.float32), (1, 2, 0))


def _slice_tile(d, h, w):
    th, tw = jfast._default_slice_tile(d)  # clamped as in fast.py:1834-1836
    return max(16 * d, min(th, jfast._round_up(h, 16 * d))), max(
        128 * d, min(tw, jfast._round_up(w, 128 * d))
    )


@functools.lru_cache(maxsize=None)
def _jax_case(d, border, shape):
    """The JAX side of one case, stage by stage as cross_bilateral_layers_fast
    runs it (fast.py:1800-1843): the pooled target and layer, the grid range,
    the (7K, hs, ws) bf16 guided grid, the sliced (7, H, W) partials, and at
    d = 2 and 4 the fused kernel's partials."""
    target, layer = _image(shape, 1), _image(shape, 2)
    h, w = shape
    tp = jnp.transpose(jnp.asarray(target), (2, 0, 1))
    lp = jnp.transpose(jnp.asarray(layer), (2, 0, 1))
    mode = "edge" if border == CLAMP else "constant"
    hp, wp = -(-h // d) * d, -(-w // d) * d
    pad = ((0, 0), (0, hp - h), (0, wp - w))
    small_t = jfast._pool_pallas(jnp.pad(tp, pad, mode=mode), d)
    small_l = jfast._pool_pallas(jnp.pad(lp, pad, mode=mode), d)
    lmin = jnp.min(small_l[:3], axis=(1, 2))
    step = jnp.maximum(jnp.max(small_l[:3], axis=(1, 2)) - lmin, 1e-6) / (K - 1)
    bth, btw = jfast._default_build_tile(d)
    grid = jfast._build_guided_grid_pallas(
        small_t, small_l, lmin, step, K, jfast._grid_taps(2.0, d), border, INV2SC,
        tile_h=bth, tile_w=btw,
    )
    th, tw = _slice_tile(d, h, w)
    planes = jfast._slice_guided_grid_pallas(
        lp[:3], grid, lmin, 1.0 / step, K, d, th, tw, pad_edge=True
    )
    case = {
        "target": target,
        "layer": layer,
        "small_t": _hwc(small_t),
        "small_l": _hwc(small_l),
        "lmin": np.array(lmin),
        "step": np.array(step),
        "grid": np.array(grid),
        "out": _hwc(planes),
    }
    if d in (2, 4):
        params = jax_params(LayersParams(border=border))
        fused = jfast._fused_guided_pipeline_planar(tp, lp, params, K, d, th, tw)
        case["fused"] = _hwc(fused)
    return case


def _port_inputs(case):
    lmin, step = _t(case["lmin"]), _t(case["step"])
    return _t(case["small_t"]), _t(case["small_l"]), lmin, step


def _delta_rounding(layer, grid, lmin, inv_step, d):
    """What the reference's telescoped guided slice adds to the exact tent
    sum of the same grid: sum_k clip(t - k, 0, 1) * up(bf16(D_k) - D_k),
    D_k = g_{k+1} - g_k, per plane under its channel's t (alpha's numerator
    under green's)."""
    levels = grid.shape[0]
    h, w, _ = layer.shape
    t = ((layer[..., :3] - lmin) * inv_step).clamp(0.0, levels - 1.0)
    t = torch.cat([t, t[..., 1:2], t, t[..., :1]], -1)
    g = grid.float()
    out = torch.zeros((h, w, fast.GUIDED_PLANES))
    for k in range(levels - 1):
        delta = g[k + 1] - g[k]
        err = delta.to(torch.bfloat16).float() - delta
        out += (t - k).clamp(0.0, 1.0) * fast._bilinear_up(err, d, h, w)
    return out[..., :7]


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """A CPU tensor takes the plain version: no wrapper launches a kernel."""
    stencils.reset_launches()
    yield
    assert all(n == 0 for n in stencils.launches.values()), stencils.launches


@pytest.mark.parametrize("d,border,shape", CASES, ids=IDS)
def test_pool_matches_pallas_for_both_inputs(d, border, shape):
    case = _jax_case(d, border, shape)
    for name, small in (("target", "small_t"), ("layer", "small_l")):
        got = fast.pool(_t(case[name]), d, border)
        np.testing.assert_allclose(got.numpy(), case[small], rtol=1e-6, atol=0)
    lmin, step = fast.grid_range(_t(case["small_l"]), K)
    np.testing.assert_array_equal(lmin.numpy(), case["lmin"])
    np.testing.assert_array_equal(step.numpy(), case["step"])


@pytest.mark.parametrize("d,border,shape", CASES, ids=IDS)
def test_build_guided_grid_plain_matches_pallas(d, border, shape):
    from test_sharding import _assert_bf16_grid_close

    case = _jax_case(d, border, shape)
    grid = fast.build_guided_grid(
        *_port_inputs(case), K, fast._grid_taps(2.0, d), border, INV2SC, d=d
    )
    hs, ws = case["small_t"].shape[:2]
    assert grid.dtype == torch.bfloat16 and grid.shape == (K, hs, ws, fast.GUIDED_PLANES)
    assert not grid[..., 7].float().any()  # the pad plane
    got = fast.guided_grid_to_planes(grid).float().numpy()
    _assert_bf16_grid_close(got, case["grid"].astype(np.float32))
    planes = _bf16(case["grid"])
    assert torch.equal(fast.guided_grid_to_planes(fast.guided_grid_from_planes(planes)), planes)


@pytest.mark.parametrize("d,border,shape", CASES, ids=IDS)
def test_slice_guided_grid_plain_matches_pallas(d, border, shape):
    """On the same bf16 grid: the port's tent sum plus the reference's delta
    rounding is the reference's output."""
    case = _jax_case(d, border, shape)
    layer = _t(case["layer"])
    lmin, inv_step = _t(case["lmin"]), 1.0 / _t(case["step"])
    grid = fast.guided_grid_from_planes(_bf16(case["grid"]))
    wc, nw = fast.slice_guided_grid(layer, grid, lmin, inv_step, d)
    assert wc.shape == (*shape, 4) and nw.shape == (*shape, 3)
    got = torch.cat([wc, nw], -1) + _delta_rounding(layer, grid, lmin, inv_step, d)
    scale = max(1.0, float(np.abs(case["out"]).max()))
    np.testing.assert_allclose(got.numpy(), case["out"], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("d,border,shape", [c for c in CASES if c[0] in (2, 4)],
                         ids=[i for c, i in zip(CASES, IDS) if c[0] in (2, 4)])
def test_fused_guided_plain_matches_pallas(d, border, shape):
    """The port's fused kernel (plain version: build then slice) equals the
    port's two kernels, and with the reference's delta rounding added back
    meets the reference's fused kernel (module docstring)."""
    from test_sharding import _assert_bf16_grid_close

    case = _jax_case(d, border, shape)
    _assert_bf16_grid_close(case["fused"], case["out"])  # the reference's own contract
    small_t, small_l, lmin, step = _port_inputs(case)
    layer = _t(case["layer"])
    taps = fast._grid_taps(2.0, d)
    wc, nw = fast.fused_guided(small_t, small_l, layer, lmin, step, 1.0 / step, K, taps,
                               border, INV2SC, d)
    grid = fast.build_guided_grid(small_t, small_l, lmin, step, K, taps, border, INV2SC, d=d)
    two = fast.slice_guided_grid(layer, grid, lmin, 1.0 / step, d)
    assert torch.equal(wc, two[0]) and torch.equal(nw, two[1])
    got = torch.cat([wc, nw], -1) + _delta_rounding(layer, grid, lmin, 1.0 / step, d)
    _assert_bf16_grid_close(got.numpy(), case["fused"])


@pytest.mark.parametrize("d,border,shape", CASES, ids=IDS)
def test_cross_bilateral_layers_fast_matches_jax(d, border, shape):
    """The public per-layer entry from the full-resolution images, dispatched
    as the reference dispatches (fused at d = 2 and 4, the two guided kernels
    at d = 1 and 8): with the reference's delta rounding added back, the
    partials meet the JAX package's cross_bilateral_layers_fast (its stages
    as _jax_case runs them) at the stored-grid bf16 contract."""
    from test_sharding import _assert_bf16_grid_close

    case = _jax_case(d, border, shape)
    want = case["fused"] if d in (2, 4) else case["out"]
    target, layer = _t(case["target"]), _t(case["layer"])
    params = LayersParams(border=border)
    wc, nw = fast.cross_bilateral_layers_fast(target, layer, params, K, d)
    assert wc.shape == (*shape, 4) and nw.shape == (*shape, 3)
    small_t, small_l = fast.pool(target, d, border), fast.pool(layer, d, border)
    lmin, step = fast.grid_range(small_l, K)
    grid = fast.build_guided_grid(small_t, small_l, lmin, step, K, fast._grid_taps(2.0, d),
                                  border, INV2SC, d=d)
    got = torch.cat([wc, nw], -1) + _delta_rounding(layer, grid, lmin, 1.0 / step, d)
    _assert_bf16_grid_close(got.numpy(), want)


def test_normalize_layers_fast_matches_jax_with_sentinel():
    """Per-channel divide, alpha by green's norm; the magenta sentinel where
    green's norm is zero; a zero red or blue norm divides by one."""
    rng = np.random.default_rng(5)
    wc = rng.uniform(0, 5, (24, 32, 4)).astype(np.float32)
    nw = rng.uniform(0.5, 3, (24, 32, 3)).astype(np.float32)
    nw[3, 5, 1] = 0.0
    nw[7, 2, 0] = 0.0
    nw[10, :4] = 0.0
    got = fast.normalize_layers_fast(_t(wc), _t(nw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfast.normalize_layers_fast(wc, nw)))
    np.testing.assert_array_equal(got[3, 5].numpy(), [1.0, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(got[10, :4].numpy(), np.tile([1.0, 0.0, 1.0, 1.0], (4, 1)))
    assert got[7, 2, 0] == wc[7, 2, 0]


def test_guided_wrappers_check_inputs():
    target = _t(_image((24, 32), 1))
    layer = _t(_image((24, 32), 2))
    small_t, small_l = fast.pool(target, 2), fast.pool(layer, 2)
    lmin, step = fast.grid_range(small_l, K)
    taps = fast._grid_taps(2.0, 2)
    with pytest.raises(ValueError):  # the pools must match
        fast.build_guided_grid(small_t, small_l[:-1], lmin, step, K, taps, CLAMP, INV2SC, d=2)
    with pytest.raises(ValueError):
        fast.build_guided_grid(small_t, small_l, lmin, step, 1, taps, CLAMP, INV2SC, d=2)
    with pytest.raises(ValueError):  # more taps than the kernel's table
        fast.build_guided_grid(small_t, small_l, lmin, step, K, np.ones(65, np.float32) / 65,
                               CLAMP, INV2SC, d=2)
    grid = fast.build_guided_grid(small_t, small_l, lmin, step, K, taps, CLAMP, INV2SC, d=2)
    with pytest.raises(TypeError):
        fast.slice_guided_grid(layer, grid.float(), lmin, 1.0 / step, 2)
    with pytest.raises(ValueError):  # a bilateral grid is not a guided one
        fast.slice_guided_grid(layer, grid[..., :4].contiguous(), lmin, 1.0 / step, 2)
    with pytest.raises(ValueError):  # d outside {1, 2, 4, 8}
        fast.slice_guided_grid(layer, grid, lmin, 1.0 / step, 3)
    with pytest.raises(ValueError):  # pooled images of another size
        fast.fused_guided(small_t, small_l, layer[:-4], lmin, step, 1.0 / step, K, taps,
                          CLAMP, INV2SC, 2)
    # A window beyond a block's shared memory on the card (d = 1 at sigma_s
    # 2, tests/test_torch_cuda.py) is no limit of the plain version: on CPU
    # tensors the fused wrapper runs it.
    taps1 = fast._grid_taps(2.0, 1)
    got = fast.fused_guided(target, layer, layer, lmin, step, 1.0 / step, K, taps1, CLAMP,
                            INV2SC, 1)
    grid = fast.build_guided_grid(target, layer, lmin, step, K, taps1, CLAMP, INV2SC, d=1)
    want = fast.slice_guided_grid(layer, grid, lmin, 1.0 / step, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_default_guided_fused_is_the_references(d):
    assert fast.default_guided_fused(d) == jfast._default_guided_fused(d) == (d in (2, 4))


@pytest.mark.parametrize("border", [CLAMP, ZERO])
def test_cross_bilateral_layers_fast_at_wide_sigma_matches_jax(border):
    """At d = 2 and sigma_s 12 (49 blur taps) the fused kernel's window
    passes a block's shared memory on the card, where the entry takes the two
    guided kernels (tests/test_torch_cuda.py); the JAX package runs its fused
    kernel. On the CPU both choices give the same partials, which meet the
    reference's as test_cross_bilateral_layers_fast_matches_jax holds them."""
    from test_sharding import _assert_bf16_grid_close

    shape, d = (97, 131), 2
    target, layer = _image(shape, 1), _image(shape, 2)
    params = LayersParams(border=border, sigma_spatial=12.0)
    jwc, jnw = jfast.cross_bilateral_layers_fast(target, layer, jax_params(params), K, d)
    want = np.concatenate([np.asarray(jwc), np.asarray(jnw)], -1)
    target, layer = _t(target), _t(layer)
    for fused in (None, False):
        wc, nw = fast.cross_bilateral_layers_fast(target, layer, params, K, d, fused)
        small_t, small_l = fast.pool(target, d, border), fast.pool(layer, d, border)
        lmin, step = fast.grid_range(small_l, K)
        grid = fast.build_guided_grid(small_t, small_l, lmin, step, K, fast._grid_taps(12.0, d),
                                      border, INV2SC, d=d)
        got = torch.cat([wc, nw], -1) + _delta_rounding(layer, grid, lmin, 1.0 / step, d)
        _assert_bf16_grid_close(got.numpy(), want)
