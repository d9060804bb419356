"""The layers config from disk (`gpu-denoise --all-frames --configs layers`)
on the CPU: a seeded RenderElements shot of three 48x64 targets, each with
its own albedo, normal and depth PNG, written as the benchmark's files feed
writes it (portbench/feeds/files_layers.py); each target through
Session.run with the layers config, the image it reads back and the PNG it
saves against the benchmark's plain reference
(portbench/reference/layer_guided.py) on the inputs decoded from the files.
And the feed's set-up check, which refuses a layout where the scan gives a
target a layer not its own, misses one, or finds them in another order."""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import LayersParams, RunConfig, TilingConfig
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from portbench import harness  # noqa: E402
from portbench.feeds import files_layers as feed  # noqa: E402
from portbench.reference import layer_guided as reference  # noqa: E402
from portbench.reference import png  # noqa: E402

torch.set_num_threads(1)

CELL = "xbf-1080p-files"
TARGETS = 3
LAYERS = RunConfig(use_layers=True)
# The port's plain guided bilateral and the reference sum the same float32
# terms in another order: their outputs differ by a few float32 steps of a
# value below 1 (read: 1.9e-6 to 2.5e-6 over seeds 26-28). 2e-5 leaves 8x
# room above that and sits ~80x under what bf16 taps give (1.6e-3 to
# 1.8e-3), which must fail.
TOL = 2e-5
# The saved PNG is the output cast as upstream casts it,
# (unsigned char)(255 x), truncated: a value within TOL of an integer step
# may land on either side of it, one byte off (read: 0 to 2 bytes of a
# 48x64 RGBA frame). A share of 1e-3 allows 12; bf16 taps change ~15%.
PNG_SHARE = 1e-3


def _cfg():
    cell = harness.find_cell(harness.ROOT, CELL)
    return dict(cell.config, height=48, width=64, shot_frames=TARGETS), cell.traffic


@pytest.fixture(scope="module")
def written_shot(tmp_path_factory):
    """One shot of TARGETS noisy targets and their layers from seed 26,
    written as the feed writes it under a root whose name holds a '.' and a
    frame ID (which the scan must never see), its layer scan checked. The
    root, the targets' paths relative to it and the configuration."""
    cfg, traffic = _cfg()
    family = harness.family(harness.ROOT, harness.find_cell(harness.ROOT, CELL))
    frames, layers = family.host_shots(cfg, 1, 26, "cpu")
    root = tmp_path_factory.mktemp("take.0002")
    targets, own = feed.write_shots(root, cfg, traffic, frames, layers)
    feed.check_layers(root, own)
    return root, [path for path, _, _ in targets], cfg


@pytest.fixture
def shot(written_shot, monkeypatch):
    """The written shot's targets and configuration, run from its root as
    the feed runs the Sessions."""
    root, targets, cfg = written_shot
    monkeypatch.chdir(root)
    return targets, cfg


def _decoded(path: str) -> torch.Tensor:
    with open(path, "rb") as f:
        return torch.from_numpy(png.to_float(png.decode(f.read())))


def _want(target: str, cfg: dict) -> np.ndarray:
    """The plain reference over the target and its layers as decoded from
    their files, the layers summed in the order the scan lists them."""
    found = dataset.discover(target, use_layers=True).layers
    layers = torch.stack([_decoded(p) for p in found])
    return reference.layer_guided(_decoded(target), layers, cfg["params"]).numpy()


def _run(target: str, cfg: dict, out_dir, tiling=None):
    return Session(target, device="cpu", layers_params=LayersParams(**cfg["params"]),
                   tiling=tiling, output_dir=str(out_dir), frame_cache={}).run(LAYERS)


def _png_share(result, want: np.ndarray) -> tuple[float, int]:
    """The share of the saved PNG's bytes that differ from the reference cast
    as upstream casts it, and the largest difference of a byte."""
    with open(result.output_path, "rb") as f:
        saved = png.decode(f.read()).astype(np.int64)
    diff = np.abs(saved - png.quantize(want).astype(np.int64))
    diff = np.minimum(diff, 256 - diff)  # the cast wraps modulo 256
    return float(np.count_nonzero(diff)) / diff.size, int(diff.max())


@pytest.mark.parametrize("k", range(TARGETS))
def test_each_target_matches_the_reference(shot, tmp_path, k):
    targets, cfg = shot
    result = _run(targets[k], cfg, tmp_path)
    want = _want(targets[k], cfg)
    assert result.image.shape == want.shape == (48, 64, 4)
    assert float(np.abs(result.image - want).max()) <= TOL
    share, most = _png_share(result, want)
    assert share <= PNG_SHARE and most <= 1


@pytest.mark.parametrize("k", range(TARGETS))
def test_bf16_taps_fail_the_tolerance(shot, tmp_path, k):
    """The program's own lower-precision path, bf16 taps, is outside both
    tolerances: they are tight enough to tell the precision apart."""
    targets, cfg = shot
    result = _run(targets[k], cfg, tmp_path, tiling=TilingConfig(compute_dtype="bfloat16"))
    want = _want(targets[k], cfg)
    assert float(np.abs(result.image - want).max()) > TOL
    assert _png_share(result, want)[0] > PNG_SHARE


def test_the_scan_finds_each_targets_own_layers_in_the_configs_order(shot):
    targets, cfg = shot
    for target in targets:
        fid = dataset.frame_id(target)
        found = dataset.discover(target, use_layers=True).layers
        assert [os.path.basename(p) for p in found] == [
            f"{j + 1}_{name}_{fid}.png" for j, name in enumerate(cfg["layers"])]


# Layouts the feed's set-up check refuses: each changes a good layout, written
# under `root`, and its map of each target's layers (paths relative to root).
def _moved(name: str):
    """The shots moved into the directory `name`, which the paths then hold."""
    def move(root: Path, layout: dict) -> None:
        os.rename(root / "in", root / name)
        moved = {str(Path(name, *Path(t).parts[1:])): [str(Path(name, *Path(p).parts[1:]))
                                                        for p in paths]
                 for t, paths in layout.items()}
        layout.clear()
        layout.update(moved)
    return move


def _missing(root: Path, layout: dict) -> None:
    os.remove(root / layout[sorted(layout)[0]][1])


def _extra(root: Path, layout: dict) -> None:
    """A file of target 0003's whose name also carries target 0001's frame
    ID."""
    first = layout[sorted(layout)[0]][0]
    shutil.copy(root / first, root / first.replace("_0001.png", "_0001_0003.png"))


def _unnumbered(root: Path, layout: dict) -> None:
    """The layers named without their place: the scan's name order (albedo,
    depth, normal) is not the configuration's."""
    for paths in layout.values():
        for i, p in enumerate(paths):
            paths[i] = os.path.join(os.path.dirname(p), os.path.basename(p).split("_", 1)[1])
            os.rename(root / p, root / paths[i])


FAULTS = {
    # A directory whose name holds target 0002's frame ID: the scan gives
    # that target every layer of the shot.
    "foreign_layers": _moved("take_0002"),
    # A '.' in the directory: the frame ID is read off the directory's name,
    # which every layer's path holds, so each target finds every layer.
    "dotted_directory": _moved("shots.v2"),
    "missing_layer": _missing,
    "another_targets_file": _extra,
    "name_order": _unnumbered,
}


def _small_layout(root: Path) -> dict:
    cfg, traffic = _cfg()
    frames = np.zeros((1, TARGETS, 4, 6, 4), np.uint8)
    layers = np.zeros((1, TARGETS, 3, 4, 6, 4), np.uint8)
    return feed.write_shots(root, cfg, traffic, frames, layers)[1]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_the_feeds_setup_check_refuses_a_wrong_layout(fault, tmp_path):
    own = _small_layout(tmp_path)
    feed.check_layers(tmp_path, own)
    FAULTS[fault](tmp_path, own)
    with pytest.raises(RuntimeError, match="layer scan finds"):
        feed.check_layers(tmp_path, own)


@pytest.mark.parametrize("name", ["tmp.AbC0001", "take_0002", "v1.2"])
def test_the_feeds_layout_holds_under_any_root(name, tmp_path):
    """The root's own name, a '.' or a frame ID in it, never reaches the
    scan: the check runs from the root, as the Sessions do."""
    root = tmp_path / name
    root.mkdir()
    feed.check_layers(root, _small_layout(root))
