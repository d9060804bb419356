"""The plain reference against the port's plain versions at tiny sizes on
the CPU, and the reference's independence of the program."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from image_denoising_filter_tpu_torch.config import LayersParams, NlmParams
from image_denoising_filter_tpu_torch.ops import stencils
from portbench.reference import layer_guided, temporal_nlm

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


def _frames(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, h, w, 4), generator=g)
    x[..., 3] = torch.rand((n, h, w), generator=g) * 0.5 + 0.5
    return x


@pytest.mark.parametrize("border", ["clamp", "zero"])
@pytest.mark.parametrize("s, p, shape", [(7, 3, (13, 17)), (2, 1, (5, 4)), (3, 2, (1, 9))])
def test_temporal_nlm_matches_the_ports_plain_version(border, s, p, shape):
    frames = _frames(3, *shape, seed=s * 10 + p)
    params = {"search_radius": s, "patch_radius": p, "h": 0.5, "norm_seed": 0.001,
              "border": border}
    want = stencils.normalize(*stencils.nlm_accumulate_frames(
        frames[0], frames, NlmParams(**params)))
    got = temporal_nlm.temporal_nlm(frames[0], frames, params)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _layers_want(target, layers, params):
    wc = torch.zeros_like(target)
    nw = torch.zeros(target.shape[:2])
    for layer in layers:
        pwc, pnw = stencils.cross_bilateral_layers(target, layer, params)
        wc, nw = wc + pwc, nw + pnw
    return stencils.normalize(wc, nw)


@pytest.mark.parametrize("border", ["clamp", "zero"])
@pytest.mark.parametrize("blue_bug", [False, True])
def test_layer_guided_matches_the_ports_plain_version_on_the_whole_window(border, blue_bug):
    x = _frames(4, 11, 14, seed=int(blue_bug))
    p = LayersParams(radius=4, sigma_spatial=2.0, sigma_color=0.2, truncate_eps=0.0,
                     blue_bug=blue_bug, border=border)
    got = layer_guided.layer_guided(x[0], x[1:], dataclasses.asdict(p))
    torch.testing.assert_close(got, _layers_want(x[0], x[1:], p), rtol=1e-5, atol=1e-6)


def test_layer_guided_truncation_disk_is_within_its_slack_of_the_ports():
    """The configuration's window: the reference takes the 465 taps of the
    truncation disk, the port's kernel 499 (its row runs add taps whose
    spatial weight is under 1e-8), so the two differ by less than 34e-8 of
    a weight sum that is at least 1."""
    x = _frames(4, 30, 30, seed=5)
    p = LayersParams()
    got = layer_guided.layer_guided(x[0], x[1:], dataclasses.asdict(p))
    torch.testing.assert_close(got, _layers_want(x[0], x[1:], p), rtol=0, atol=2e-6)
    assert len(layer_guided.taps(p.radius, p.sigma_spatial, p.truncate_eps)) == 465


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tree = ast.parse(path.read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and not n.level}
    tops = {n.split(".")[0] for n in names}
    assert tops <= {"__future__", "math", "struct", "zlib", "numpy", "torch"}, tops
