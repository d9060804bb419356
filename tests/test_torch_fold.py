"""The one fold of partial sums (models.denoiser.fold): every model and
Session loop that sums (weightColor, normWeight) partials over layers or
frames gives, bit for bit, the output of the same partials summed out of
place in the same order from the same first term (zeros, or the first
partial), and leaves its inputs as they were."""

import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import LayersParams, NlmParams, RunConfig
from image_denoising_filter_tpu_torch.models import (
    LINEAR,
    TILED,
    LayerGuidedDenoiser,
    TemporalNlmDenoiser,
)
from image_denoising_filter_tpu_torch.models.denoiser import fold
from image_denoising_filter_tpu_torch.ops import eager, fast, stencils
from image_denoising_filter_tpu_torch.runtime import Session
from image_denoising_filter_tpu_torch.utils import dataset as dataset_mod
from image_denoising_filter_tpu_torch.utils import imageio

torch.set_num_threads(1)

H, W = 14, 18
LP = LayersParams(radius=2)
NP_ = NlmParams(search_radius=1, patch_radius=1)
LAYOUTS = [TILED, LINEAR]


def _images(n, seed):
    """n frames with signed zeros, HDR values and a varying alpha."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-0.5, 2.0, (n, H, W, 4)).astype(np.float32)
    imgs[imgs < 0] = -0.0
    return torch.from_numpy(imgs)


def _summed(parts, first=None):
    """The partials summed out of place in order, from `first` (None: the
    first partial)."""
    wc, nw = (parts[0] if first is None else first)
    for pwc, pnw in parts[1:] if first is None else parts:
        wc, nw = wc + pwc, nw + pnw
    return wc, nw


def _zeros():
    return torch.zeros((H, W, 4)), torch.zeros((H, W))


def _layer_partials(layout, target, layer):
    if layout == TILED:
        return stencils.cross_bilateral_layers(target, layer, LP)
    return eager.cross_bilateral_layers_eager(target, layer, LP)


def _nlm_partials(layout, target, frame):
    if layout == TILED:
        return stencils.nlm_accumulate(target, frame, NP_)
    return eager.nlm_eager(target, frame, NP_)


def _normalize(layout, wc, nw):
    return stencils.normalize(wc, nw) if layout == TILED else eager.normalize_eager(wc, nw)


def _bits(got, want):
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.numpy().view(np.uint32))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_models_fold_as_the_out_of_place_sum(layout):
    target, *frames = _images(4, 1)
    layers = _images(3, 2)
    inputs = [t.clone() for t in (target, *frames, layers)]

    want = _normalize(layout, *_summed([_layer_partials(layout, target, x) for x in layers],
                                       _zeros()))
    _bits(LayerGuidedDenoiser(LP, layout=layout)(target, layers), want)

    model = TemporalNlmDenoiser(NP_, layout=layout)
    parts = [_nlm_partials(layout, target, f) for f in frames]
    stack = torch.stack(frames)
    got = model.accumulate(target, stack)
    if layout == LINEAR:
        for g, w in zip(got, _summed(parts, _zeros())):
            _bits(g, w)
    else:  # one frame-batched launch: no fold
        for g, w in zip(got, stencils.nlm_accumulate_frames(target, stack, NP_)):
            _bits(g, w)

    carry = None
    for f in frames:
        before = carry
        carry = model.accumulate_one(target, f, carry)
        if before is not None:  # folded into the carry's own memory
            assert [c.data_ptr() for c in carry] == [b.data_ptr() for b in before]
    for g, w in zip(carry, _summed(parts)):
        _bits(g, w)

    for t, was in zip((target, *frames, layers), inputs):
        _bits(t, was)


def test_a_view_starts_the_sums_as_a_copy():
    """A partial that is a view of another tensor (a cropped output) starts
    the sums as a copy: the next fold leaves its base as it was."""
    base = _images(2, 3)
    part = (base[0], base[1, ..., 0])
    acc = fold(None, part)
    acc = fold(acc, (torch.ones((H, W, 4)), torch.ones((H, W))))
    _bits(base, _images(2, 3))
    fresh = (torch.zeros((H, W, 4)), torch.zeros((H, W)))
    assert all(a is p for a, p in zip(fold(None, fresh), fresh))


@pytest.fixture(scope="module")
def shot(tmp_path_factory):
    """Four frames with varying alpha (the uniform-alpha rule never
    switches) and three layers of the target, frame 1."""
    root = tmp_path_factory.mktemp("fold")
    os.makedirs(root / "RenderElements")
    rng = np.random.default_rng(7)
    for i in range(4):
        imageio.save(str(root / f"frame_{i:04d}.png"),
                     rng.uniform(0, 1, (H, W, 4)).astype(np.float32))
    for name in ("albedo", "normal", "depth"):
        imageio.save(str(root / "RenderElements" / f"{name}_0001.png"),
                     rng.uniform(0, 1, (H, W, 4)).astype(np.float32))
    return str(root / "frame_0001.png")


def _decoded(paths):
    return [torch.from_numpy(imageio.load(p)[0]) for p in paths]


@pytest.mark.parametrize("loop", ["layers", "multiframe", "batched"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_session_loops_fold_as_the_out_of_place_sum(shot, tmp_path, layout, loop):
    """The layers config (zeros, then each layer), the per-frame
    multiframe loop (the first frame's partials, then each frame) and the
    batched loop (one chunk): each output equals the out-of-place sum's,
    and the cached decoded frames are unchanged."""
    cache: dict = {}
    session = Session(shot, device="cpu", output_dir=str(tmp_path), layers_params=LP,
                      nlm_params=NP_, frame_cache=cache, batch_frames=loop == "batched")
    linear = layout == LINEAR
    cfg = (RunConfig(use_layers=True, linear=linear) if loop == "layers"
           else RunConfig(nlm=True, multiframe=True, linear=linear))
    got = torch.from_numpy(session.run(cfg).image)
    ds = dataset_mod.discover(shot, multiframe=cfg.multiframe, use_layers=cfg.use_layers)
    target, = _decoded([ds.target])
    if loop == "layers":
        sums = _summed([_layer_partials(layout, target, x) for x in _decoded(ds.layers)],
                       _zeros())
    elif loop == "multiframe":
        sums = _summed([_nlm_partials(layout, target, f) for f in _decoded(ds.frames)])
    else:
        sums = TemporalNlmDenoiser(NP_, layout=layout).accumulate(
            target, torch.stack(_decoded(ds.frames)))
    _bits(got, _normalize(layout, *sums))
    for path, entry in cache.items():
        _bits(torch.from_numpy(entry.img), *_decoded([path]))


def test_the_turbo_layers_fold_as_the_out_of_place_sum(shot, tmp_path):
    """run_turbo's layers config: zeros, then each layer's guided-grid
    partials, then the per-channel divide."""
    got = Session(shot, device="cpu", output_dir=str(tmp_path), layers_params=LP).run_turbo(
        RunConfig(use_layers=True), levels=5, downsample=2)
    ds = dataset_mod.discover(shot, multiframe=False, use_layers=True)
    target, = _decoded([ds.target])
    layers = torch.stack(_decoded(ds.layers))
    parts = [fast.cross_bilateral_layers_fast(target, x, LP, 5, 2) for x in layers]
    zeros = torch.zeros((H, W, 4)), torch.zeros((H, W, 3))
    _bits(torch.from_numpy(got.image), fast.normalize_layers_fast(*_summed(parts, zeros)))
