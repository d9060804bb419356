"""chip_smoke.py's arithmetic and its turbo run list, without a card: the
work each kernel's bound counts, the runs turbo_battery makes, and the
trace reading of phase 8 (the union of device intervals, the config
spans)."""

import importlib.util
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

PIXELS = 1920 * 1080


@pytest.mark.parametrize("name", ["nlm", "nlm_bf16", "nlm_hrw", "nlm_hrw_bf16"])
def test_nlm_reads_an_aliased_target_once(name):
    """F = 1 on the target itself: the target and its one frame are one
    16-byte read a pixel, beside the 20-byte partials written."""
    alone = smoke.kernel_work(name, PIXELS, cands=49, aliased=True)
    apart = smoke.kernel_work(name, PIXELS, cands=49)
    assert alone[0] == 36 * PIXELS and apart[0] == 52 * PIXELS
    assert alone[1:] == apart[1:]


def test_nlm_bf16_bound_counts_its_squared_differences_at_the_bf16_rate():
    """8 of each candidate's 24 operations are bfloat16, at twice the float32
    rate: 1080p, F = 1, 49 candidates is 0.0303 ms, bound by operations."""
    nbytes, f32, bf16 = smoke.kernel_work("nlm_bf16", PIXELS, cands=49, aliased=True)
    assert (f32, bf16) == (16 * 49 * PIXELS, 8 * 49 * PIXELS)
    b = smoke.bound(nbytes, f32, bf16)
    assert b["bound_by"] == "operations"
    want = (f32 / 67e12 + bf16 / 133.8e12) * 1e3
    assert b["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert b["bound_ms"] == pytest.approx(0.0303, abs=5e-5)
    f32_only = smoke.bound(*smoke.kernel_work("nlm", PIXELS, cands=49, aliased=True))
    assert f32_only["bound_ms"] > b["bound_ms"]


@pytest.mark.parametrize("name", ["bilateral_bf16", "bilateral_guided_bf16"])
def test_bilateral_bf16_bound_counts_its_colour_distance_at_the_bf16_rate(name):
    """8 of a tap's 20 operations, the colour distance, are bfloat16 with
    bf16 taps, at twice the float32 rate; the bytes are the float32 form's
    (float32 images in and out). 1080p at the reference disk (499 taps):
    0.2473 ms for the bilateral against its float32 form's 0.3090, bound by
    operations."""
    from image_denoising_filter_tpu_torch.config import BilateralParams
    from image_denoising_filter_tpu_torch.ops import stencils

    disk = smoke.disk_taps(stencils, BilateralParams())
    assert disk == 499
    nbytes, f32, bf16 = smoke.kernel_work(name, PIXELS, disk=disk)
    full = smoke.kernel_work(name[: -len("_bf16")], PIXELS, disk=disk)
    normalize = 4 if name == "bilateral_bf16" else 0
    assert (f32, bf16) == (PIXELS * (12 * disk + normalize), PIXELS * 8 * disk)
    assert nbytes == full[0] and f32 + bf16 == full[1]
    b = smoke.bound(nbytes, f32, bf16)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx((f32 / 67e12 + bf16 / 133.8e12) * 1e3, rel=1e-12)
    assert b["bound_ms"] < smoke.bound(*full)["bound_ms"]
    if name == "bilateral_bf16":
        assert b["bound_ms"] == pytest.approx(0.2473, abs=5e-5)
        assert smoke.bound(*full)["bound_ms"] == pytest.approx(0.3090, abs=5e-5)


@pytest.mark.parametrize("nbytes,flops,by", [(3.35e9, 1, "bytes"), (1, 67e9, "operations")])
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, flops, by):
    b = smoke.bound(nbytes, flops)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == by


def test_nlm_hrw_bf16_bound_counts_its_half_rows():
    """The half-row NLM halves the 15 operations before the weighted colour
    and adds the 3 of the row upsample; its bf16 squared differences (4) run
    at the bf16 rate: 1080p, F = 1, 49 candidates is 0.0265 ms, bound by
    operations, where the bytes take 0.0223 ms."""
    nbytes, f32, bf16 = smoke.kernel_work("nlm_hrw_bf16", PIXELS, cands=49, aliased=True)
    assert (f32, bf16) == (31 * 49 * PIXELS // 2, 4 * 49 * PIXELS)
    b = smoke.bound(nbytes, f32, bf16)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(0.0265, abs=5e-5)
    assert nbytes / 3.35e12 * 1e3 == pytest.approx(0.0223, abs=5e-5)
    f32_only = smoke.kernel_work("nlm_hrw", PIXELS, cands=49, aliased=True)
    assert f32_only[1] == f32 + bf16


def test_slice_grid_d1_reads_each_pixels_own_cell():
    """At D = 1 the slice reads one cell a pixel (wy = wx = 0) at 2 of the K
    levels of each of its 4 bf16 planes: 16 B beside the image's 32, fewer
    than the whole grid's 8 K; and it drops the bilinear term (60
    operations a pixel against 132). 1080p, K = 6: 0.0297 ms by bytes,
    where reading the whole grid would take 0.0495."""
    d1 = smoke.kernel_work("slice_grid_d1", PIXELS, cells=PIXELS, levels=6)
    assert d1 == (48 * PIXELS, 60 * PIXELS)
    whole = smoke.kernel_work("slice_grid", PIXELS, cells=PIXELS, levels=6)
    assert whole == (80 * PIXELS, 132 * PIXELS)
    b = smoke.bound(*d1)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.0297, abs=5e-5)
    assert smoke.bound(*whole)["bound_ms"] == pytest.approx(0.0495, abs=5e-5)


@pytest.mark.parametrize("taps", [17, 49])
def test_build_grid_d1_is_the_build_at_full_resolution(taps):
    shape = dict(pixels=PIXELS, cells=PIXELS, levels=6, taps=taps)
    assert smoke.kernel_work("build_grid_d1", **shape) == smoke.kernel_work("build_grid", **shape)


@pytest.mark.parametrize("taps", [17, 49])
def test_build_guided_grid_d1_is_the_guided_build_at_full_resolution(taps):
    shape = dict(pixels=PIXELS, cells=PIXELS, levels=6, taps=taps)
    assert (smoke.kernel_work("build_guided_grid_d1", **shape)
            == smoke.kernel_work("build_guided_grid", **shape))


def test_d1_forms_are_launch_counters():
    """Each D = 1 form the kernels line lists is a counter the wrappers add
    to (ops/stencils.py:launches), and every D = 1 counter is one of them."""
    from image_denoising_filter_tpu_torch.ops import stencils

    d1 = {k for k in stencils.launches if k.endswith("_d1")}
    assert set(smoke.D1_FORMS.values()) == d1
    assert all(k in stencils.launches for k in smoke.D1_FORMS)


@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840)], ids=["1080p", "4K"])
def test_nonfinite_frame_holds_one_of_each(h, w):
    """One +inf, one -inf and two NaN values, at 1080p and 4K; the NaNs in
    bands 0 and 2 of a 1x4 mesh, the +inf in band 0, the -inf in band 1; a
    shifted copy (a neighbour frame's, a layer's) elsewhere."""
    import torch

    img = torch.zeros((h, w, 4))
    out = smoke.nonfinite_frame(img)
    assert int(torch.isposinf(out).sum()) == int(torch.isneginf(out).sum()) == 1
    assert int(torch.isnan(out).sum()) == 2
    assert bool((img == 0).all())  # the input stays as it was
    band = h // 4
    rows = {kind: sorted({int(y) // band for y in torch.nonzero(f(out))[:, 0]})
            for kind, f in (("nan", torch.isnan), ("+inf", torch.isposinf),
                            ("-inf", torch.isneginf))}
    assert rows == {"nan": [0, 2], "+inf": [0], "-inf": [1]}
    shifted = smoke.nonfinite_frame(img, shift=1)
    assert not bool((torch.isfinite(shifted) == torch.isfinite(out)).all())


def test_nonfinite_animation_puts_its_nans_in_bands_0_and_2():
    """Phase 12's target: a NaN in band 0 and one in band 2 of a 1x4 mesh at
    1080p, on different channels; a NaN in a neighbour frame; +inf in the
    albedo layer."""
    frames = smoke.NONFINITE_ANIMATION["frames"]
    target = frames[smoke.TARGET_FRAME]
    assert sorted(y // (smoke.H // 4) for y, *_ in target) == [0, 2]
    assert all(np.isnan(v) for *_, v in target) and len({c for _, _, c, _ in target}) == 2
    (other,) = set(frames) - {smoke.TARGET_FRAME}
    assert 0 <= other < smoke.N_FRAMES and all(np.isnan(v) for *_, v in frames[other])
    assert all(v == np.inf for *_, v in smoke.NONFINITE_ANIMATION["albedo"])


def test_nonfinite_readings_cover_every_run():
    """The JAX package's readings (tools/nonfinite_jax_reading.py) hold an
    entry for each output of phase 12's runs, in nonfinite_reading's shape:
    counts per channel [NaN, +inf, -inf], a 16-hex digest, dB against exact
    (None for the exact battery), and for the runs the JAX package's tiles
    spread over, boxes [channel, y0, y1, x0, x1] inside the frame."""
    names = {f"{run} {key}" for run, _, keys in smoke.NONFINITE_RUNS for key in keys}
    assert set(smoke.JAX_NONFINITE_READINGS) == names
    for name, r in smoke.JAX_NONFINITE_READINGS.items():
        assert np.asarray(r["counts"]).shape == (4, 3)
        assert len(r["digest"]) == 16 and int(r["digest"], 16) >= 0
        assert (r["db"] is None) == name.startswith("exact ")
        for c, y0, y1, x0, x1 in r.get("boxes", ()):
            assert 0 <= c < 4 and 0 <= y0 < y1 <= smoke.H and 0 <= x0 < x1 <= smoke.W
    spread = {n for n, r in smoke.JAX_NONFINITE_READINGS.items() if "boxes" in r}
    assert {n for n in names if n.startswith("mesh ") or n.endswith(" layers")
            and not n.startswith("exact") or "half-row" in n} == spread


def test_nonfinite_reading_counts_and_reads_finite_values():
    """nonfinite_reading on a small pair: the counts by channel and kind, a
    digest that moves with a position, and dB over the values finite in both
    and outside the boxes."""
    exact = np.full((4, 6, 4), 0.5, np.float32)
    out = exact.copy()
    out[0, 0, 0], out[1, 2, 1], out[2, 3, 2] = np.nan, np.inf, -np.inf
    out[3, 5, 0] = 0.75
    r = smoke.nonfinite_reading(out, exact)
    assert r["counts"] == [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]]
    moved = out.copy()
    moved[0, 0, 0], moved[0, 1, 0] = 0.5, np.nan
    assert smoke.nonfinite_reading(moved, exact)["digest"] != r["digest"]
    assert r["db"] == pytest.approx(10 * np.log10(0.25 / (0.0625 / (4 * 6 * 3 - 3))), abs=1e-4)
    assert smoke.nonfinite_reading(out, exact, [[0, 3, 4, 5, 6]])["db"] == np.inf
    assert smoke.nonfinite_reading(out, None)["db"] is None


def test_slice_guided_grid_d1_reads_each_pixels_own_cell():
    """At D = 1 the guided slice reads the layer (16 B), writes wc and nw (16
    + 12 B) and reads each pixel's own cell at 2 of the K levels of its 7
    planes (28 B): 72 B a pixel; 96 operations (the t 12, then 7 planes x 2
    levels x (tent 4, add 2)). 1080p, K = 6: 0.0446 ms by bytes."""
    d1 = smoke.kernel_work("slice_guided_grid_d1", PIXELS, cells=PIXELS, levels=6)
    assert d1 == (72 * PIXELS, 96 * PIXELS)
    b = smoke.bound(*d1)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(0.0446, abs=5e-5)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_turbo_kernels_name_the_d1_guided_slice(d):
    """A --turbo 1 grid run launches the guided build and slice under their
    D = 1 names (the bilateral grid is the eager lattice there), the other D
    under their own; the NLM runs launch no grid kernel."""
    got = smoke.turbo_kernels(d, False)
    assert ("slice_guided_grid_d1" in got) == ("build_guided_grid_d1" in got) == (d == 1)
    assert ("slice_guided_grid" in got) == ("build_guided_grid" in got) == (d == 8)
    assert set(smoke.D1_FORMS.values()) == {"build_grid_d1", "slice_grid_d1",
                                            "build_guided_grid_d1", "slice_guided_grid_d1"}
    assert not {n for n in got if n.endswith("_d1")} - {"build_guided_grid_d1",
                                                        "slice_guided_grid_d1"}
    assert not {n for n in smoke.turbo_kernels(d, True) if "grid" in n}


def test_turbo_battery_makes_the_smokes_runs():
    """Grid configs at every D of TURBO_RUNS, the NLM configs at D = 2 only,
    once more with --weights-halfres;
    each run's readings against clean and against exact (grid configs
    against the exact tiled bilateral)."""
    from image_denoising_filter_tpu_torch import cli
    from image_denoising_filter_tpu_torch import config as cfg

    names = smoke.output_names(cli, cfg)
    clean = np.full((2, 3, 4), 0.5, np.float32)
    outputs = {}

    class Io:
        @staticmethod
        def load(path):
            return outputs[path], None

    argvs = []

    def run(argv):
        argvs.append(argv)
        out_dir = argv[argv.index("--output-dir") + 1]
        for k in argv[argv.index("--configs") + 1].split(","):
            outputs[os.path.join(out_dir, names[k])] = clean + 0.01
        return 0, "", ""

    exact = {k: clean for k in ("bilateral", "layers") + smoke.NLM_CONFIGS}
    anim = {"target": "t.png", "clean": clean}
    runs = list(smoke.turbo_battery(cli, cfg, Io, anim, "root", exact, "cpu", run))
    got = [(d, s, keys, flags) for d, s, keys, flags, _, _ in runs]
    grid, nlm, hrw = cli.GRID_CONFIGS, smoke.NLM_CONFIGS, ("--weights-halfres",)
    assert got == [(1, 2.0, grid, ()), (2, 2.0, grid, ()), (2, 2.0, nlm, ()),
                   (2, 2.0, nlm, hrw), (4, 2.0, grid, ()), (8, 6.0, grid, ())]
    assert all(a[a.index("--device") + 1] == "cpu" for a in argvs)
    assert [("--weights-halfres" in a) for a in argvs] == [False] * 3 + [True] + [False] * 2
    for *_, readings in runs:
        for out, db_clean, db_exact, db_rgb in readings.values():
            assert db_clean == db_exact == db_rgb == pytest.approx(40.0)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0.0, 1000.0)], 1.0),
    ([(0.0, 1000.0), (500.0, 1500.0)], 1.5),  # overlapping
    ([(0.0, 1000.0), (2000.0, 2500.0)], 1.5),  # disjoint
    ([(100.0, 200.0), (0.0, 1000.0), (900.0, 900.0)], 1.0),  # nested, unsorted, empty
])
def test_busy_ms_is_the_union_of_the_intervals(intervals, want):
    assert smoke.busy_ms(intervals) == pytest.approx(want)


def test_read_trace_finds_the_config_spans(tmp_path):
    """The spans and device events phase 8 reads, from a trace gpu-denoise
    --profile writes on the CPU (no device events there)."""
    import json

    from image_denoising_filter_tpu_torch import cli
    from image_denoising_filter_tpu_torch.utils import imageio

    target = str(tmp_path / "frame_0000.png")
    imageio.save(target, np.random.default_rng(0).uniform(0, 1, (12, 16, 4)).astype(np.float32))
    prof = tmp_path / "prof"
    assert cli.main([target, "--device", "cpu", "--output-dir", str(tmp_path / "out"),
                     "--configs", "linear,cpu1", "--radius", "2", "--profile", str(prof)]) == 0
    spans, device = smoke.read_trace(str(prof / cli.TRACE_NAME), ("linear", "cpu1", "nlm"))
    assert sorted(spans) == ["cpu1", "linear"] and device == []
    (a0, a1), (b0, b1) = spans["linear"], spans["cpu1"]
    assert a0 < a1 <= b0 < b1  # cpu1 runs after the device configs
    with open(prof / cli.TRACE_NAME) as f:
        trace = json.load(f)
    trace["traceEvents"].append({"ph": "X", "cat": "kernel", "name": "void k()", "ts": a0,
                                 "dur": 1.0})
    (prof / "t.json").write_text(json.dumps(trace))
    assert [e["name"] for e in smoke.read_trace(str(prof / "t.json"), ())[1]] == ["void k()"]
