"""The bilateral kernel's tile and staged halo (ops/stencils.py:bilateral_tile).

The CUDA kernel trusts this geometry: a block of th warps stages the tile
plus the disk's halo and reads every tap from it with the tile's offsets,
each thread walking its three pixels' tap rows through a ring of three
columns. These tests walk every block of small images with the kernel's
index arithmetic and check that every staged read, the ring's loads
included, falls inside the staged region and lands on the pixel the plain
version reads; that the layout's regions lie back to back; that the tile is
the tallest that fits and shrinks before the direct-load instance is taken;
and which radii take that instance on the H100. Rows and columns are
independent, so each axis is checked over all its offsets at once.
"""

import itertools

import numpy as np
import pytest

from image_denoising_filter_tpu_torch.config import BilateralParams
from image_denoising_filter_tpu_torch.ops import stencils

# The shared memory a block of the H100 may opt into
# (cudaDevAttrMaxSharedMemoryPerBlockOptin), and a block's without opting in.
H100_SHARED_OPTIN = 232448
DEFAULT_SHARED = 48 * 1024
FORMS = {  # kernel form: (guided, bf16)
    "bilateral": (False, False),
    "bilateral_guided": (True, False),
    "bilateral_bf16": (False, True),
    "bilateral_guided_bf16": (True, True),
}


def _runs(params):
    return stencils._circle_runs(params.effective_radius, params.sigma_spatial,
                                 params.truncate_eps)


def _check_rows(tile, runs, h):
    """Every block's rows: warp `row` of the block owns output row y0 + row;
    its tap row dy reads staged row row + hy + dy, image row y0 - hy + that."""
    dys = np.asarray([dy for dy0, n, _ in runs for dy in range(dy0, dy0 + n)])
    for y0 in range(0, h, tile.th):
        out = np.arange(tile.th)[:, None]
        staged = out + tile.hy + dys[None, :]
        assert staged.min() >= 0 and staged.max() < tile.th + 2 * tile.hy
        np.testing.assert_array_equal(y0 - tile.hy + staged, y0 + out + dys[None, :])


def _check_columns(tile, runs, w):
    """Every block's columns: lane l owns pixels x0 + 3l + i, i < 3. For a
    run of half width hw, step s (dx = s - hw) gives pixel i the ring column
    first + s + i, first = 3l + hx - hw; the ring preloads first, first + 1
    and step s loads first + s + 2."""
    n = stencils.BIL_PX
    sw = tile.tw + 2 * tile.hx
    lane = np.arange(32)[:, None, None]
    pixel = np.arange(n)[None, :, None]
    for x0 in range(0, w, tile.tw):
        for hw in sorted({hw for _, _, hw in runs}):
            steps = np.arange(2 * hw + 1)[None, None, :]
            first = n * lane + tile.hx - hw
            read = first + steps + pixel
            assert read.min() >= 0 and read.max() < sw
            np.testing.assert_array_equal(x0 - tile.hx + read,
                                          x0 + n * lane + pixel + steps - hw)
            loads = np.concatenate([first + np.arange(n - 1)[None, None, :],
                                    first + steps + n - 1], axis=-1)
            assert loads.min() >= 0 and loads.max() < sw


def _params(radius, truncate_eps, ua):
    return BilateralParams(radius=radius, truncate_eps=truncate_eps, uniform_alpha=ua)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("radius", range(1, 21))
def test_staged_tile_holds_every_tap(radius, form):
    """Radii 1-20 with the reference truncation and the full window
    (truncate_eps 0, up to 41 rows), uniform alpha on and off, the H100's
    limit: the tile is staged, fits, is the tallest of BIL_TILE_HS that
    fits, its halo is the disk's reach, and every read of every block of
    images below, at and above the tile falls inside it."""
    guided, bf16 = FORMS[form]
    for eps, ua in itertools.product((1e-8, 0.0), (False, True)):
        params = _params(radius, eps, ua)
        runs = _runs(params)
        tile = stencils.bilateral_tile(params, guided, bf16, H100_SHARED_OPTIN)
        assert tile.staged and tile.tw == stencils.BIL_TILE_W
        assert (tile.hy, tile.hx) == stencils.disk_halo(runs)
        assert tile.hy == max(abs(dy) for dy0, n, _ in runs for dy in (dy0, dy0 + n - 1))
        assert tile.shared_bytes <= H100_SHARED_OPTIN
        taller = [th for th in stencils.BIL_TILE_HS if th > tile.th]
        for th in taller:
            nbytes = stencils.bilateral_layout(th, tile.hy, tile.hx, guided, bf16, not ua)[-1]
            assert nbytes > H100_SHARED_OPTIN
        for h, w in itertools.product((max(1, tile.th - 3), tile.th, 2 * tile.th + 3),
                                      (5, tile.tw, 2 * tile.tw + 7)):
            _check_rows(tile, runs, h)
            _check_columns(tile, runs, w)


@pytest.mark.parametrize("ua", [False, True], ids=["alpha", "uniform_alpha"])
@pytest.mark.parametrize("form", list(FORMS))
def test_layout_regions_lie_back_to_back(form, ua):
    """The weight source's staged pixels at byte 0 (float4, or bf16 RGB in 8
    bytes), the target's when guided, the float32 alpha plane with bf16 taps
    unless alpha is uniform, the disk square's spatial terms, then th x 6
    floats of channel ranges: back to back, aligned for their loads; the
    launch ints in BilTile's order."""
    guided, bf16 = FORMS[form]
    for params in (_params(20, 1e-8, ua), _params(20, 0.0, ua), _params(3, 1e-8, ua)):
        tile = stencils.bilateral_tile(params, guided, bf16, H100_SHARED_OPTIN)
        n = tile.n_staged
        px = 8 if bf16 else 16
        regions = [("weight source", 0, px * n, px)]
        if guided:
            regions.append(("values", tile.vals_at, px * n, px))
        else:
            assert tile.vals_at == 0
        if bf16 and not ua:
            regions.append(("alpha", tile.alpha_at, 4 * n, 4))
        else:
            assert tile.alpha_at == 0
        regions.append(("spatial", tile.sp_at, 4 * (2 * tile.hy + 1) * (2 * tile.hx + 1), 4))
        regions.append(("ranges", tile.range_at, 24 * tile.th, 4))
        end = 0
        for name, at, size, align in regions:
            assert at == end and at % align == 0, name
            end = at + size
        assert tile.shared_bytes == end
        assert list(tile.launch_args()) == [tile.th, tile.hy, tile.hx, tile.vals_at,
                                            tile.alpha_at, tile.sp_at, tile.range_at,
                                            tile.shared_bytes]


def test_reference_tiles():
    """At the reference parameters (radius 20, disk radius 12) every form
    takes the 16 x 96 tile, a 40 x 120 staged region: 16 bytes a pixel for
    the float32 bilateral, 32 guided; 8 for the bf16 bilateral under
    uniform alpha, 12 with its alpha plane, 16 and 20 guided; the 25 x 25
    spatial terms (2,500 bytes) and 384 bytes of channel ranges."""
    want = {
        ("bilateral", True): 76800, ("bilateral", False): 76800,
        ("bilateral_guided", True): 153600, ("bilateral_guided", False): 153600,
        ("bilateral_bf16", True): 38400, ("bilateral_bf16", False): 57600,
        ("bilateral_guided_bf16", True): 76800, ("bilateral_guided_bf16", False): 96000,
    }
    want = {key: nbytes + 2500 + 16 * 24 for key, nbytes in want.items()}
    for (form, ua), nbytes in want.items():
        tile = stencils.bilateral_tile(BilateralParams(uniform_alpha=ua), *FORMS[form],
                                       H100_SHARED_OPTIN)
        assert (tile.th, tile.tw, tile.hy, tile.hx, tile.shared_bytes) == (16, 96, 12, 12, nbytes)


def test_tile_shrinks_before_the_direct_instance():
    """The float32 guided form, full window: 16 rows up to radius 18, then 8,
    4 and 2 rows as the halo grows, and the direct-load instance from
    radius 24, where not even one row fits."""
    ths = {}
    for radius in range(1, 30):
        tile = stencils.bilateral_tile(_params(radius, 0.0, False), True, False,
                                       H100_SHARED_OPTIN)
        ths[radius] = tile.th
    assert list(ths.values()) == sorted(ths.values(), reverse=True)
    assert {r for r, th in ths.items() if th == 16} == set(range(1, 19))
    assert {r for r, th in ths.items() if th == 8} == {19, 20, 21}
    assert {r for r, th in ths.items() if th == 4} == {22}
    assert {r for r, th in ths.items() if th == 2} == {23}
    assert {r for r, th in ths.items() if th == 0} == set(range(24, 30))


@pytest.mark.parametrize(
    "form,ua,widest",
    [("bilateral", False, 37), ("bilateral_guided", False, 23), ("bilateral_guided", True, 23),
     ("bilateral_bf16", False, 44), ("bilateral_bf16", True, 55),
     ("bilateral_guided_bf16", False, 32), ("bilateral_guided_bf16", True, 37)],
)
def test_direct_instance_takes_the_radii_no_tile_fits(form, ua, widest):
    """The widest full-window radius whose one-row tile fits the H100, by
    shape alone: (1 + 2R) x (96 + 2R) staged pixels at the form's bytes a
    pixel, the (2R + 1)^2 spatial terms and one row's channel ranges. Every wider radius up to the runs table's 63 takes the direct
    instance, which stages nothing (0 bytes)."""
    guided, bf16 = FORMS[form]
    for radius in range(1, 64):
        tile = stencils.bilateral_tile(_params(radius, 0.0, ua), guided, bf16, H100_SHARED_OPTIN)
        if radius <= widest:
            assert tile.staged, radius
        else:
            assert (tile.th, tile.vals_at, tile.alpha_at, tile.sp_at, tile.range_at,
                    tile.shared_bytes) == (0, 0, 0, 0, 0, 0)
            assert list(tile.launch_args()[:3]) == [0, radius, radius]


@pytest.mark.parametrize("form", list(FORMS))
def test_without_opt_in_the_tile_shrinks(form):
    """At 48 KB (no opt-in) the reference disk under uniform alpha stages
    only with bf16 taps and without a guide (16 rows, 8 bytes a staged
    pixel); the other forms take the direct-load instance."""
    guided, bf16 = FORMS[form]
    tile = stencils.bilateral_tile(BilateralParams(uniform_alpha=True), guided, bf16,
                                   DEFAULT_SHARED)
    assert tile.shared_bytes <= DEFAULT_SHARED
    assert tile.th == {"bilateral": 0, "bilateral_guided": 0, "bilateral_bf16": 16,
                       "bilateral_guided_bf16": 0}[form]
