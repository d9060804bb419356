"""The uniform-alpha rule of the port's Session: where every frame behind a
kernel's alpha taps has one constant alpha and the border is CLAMP, the
Session hands the kernels `uniform_alpha=True` (they rebuild alpha from the
norm, exactly); the overlap loop and run_turbo pass the parameters as given.
Each path's choice is recorded as every CPU kernel wrapper receives it, and
each frame's alpha is scanned at most once, with the decoded frame."""

import functools
import os

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import (
    BilateralParams,
    BorderPolicy,
    LayersParams,
    NlmParams,
    RunConfig,
)
from image_denoising_filter_tpu_torch.ops import fast, stencils
from image_denoising_filter_tpu_torch.runtime import Session, prefetch
from image_denoising_filter_tpu_torch.utils import imageio

torch.set_num_threads(1)

H, W = 12, 16
N_FRAMES = 4
VARYING = 2  # the frame whose alpha varies in the "varying_frame" shot
TARGET = 1   # frame_0001, which has the layers

SINGLE = RunConfig()
LAYERS = RunConfig(use_layers=True)
NLM = RunConfig(nlm=True)
MULTIFRAME = RunConfig(nlm=True, multiframe=True)
OVERLAP = RunConfig(nlm=True, multiframe=True, overlap=True)


def _write_shot(root, varying):
    """N_FRAMES frames with alpha 0.75 (one frame's alpha random where
    varying) and two layers of the target; the target's path."""
    os.makedirs(f"{root}/RenderElements")
    rng = np.random.default_rng(31)
    for i in range(N_FRAMES):
        img = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
        img[..., 3] = 0.75
        if varying and i == VARYING:
            img[..., 3] = rng.uniform(0, 1, (H, W))
        imageio.save(f"{root}/frame_{i:04d}.png", img)
    for name in ("albedo", "normal"):
        imageio.save(f"{root}/RenderElements/{name}_{TARGET:04d}.png",
                     rng.uniform(0, 1, (H, W, 4)).astype(np.float32))
    return f"{root}/frame_{TARGET:04d}.png"


@pytest.fixture(scope="module")
def shots(tmp_path_factory):
    root = tmp_path_factory.mktemp("ua")
    return {"uniform": _write_shot(root / "uniform", False),
            "varying": _write_shot(root / "varying", True)}


# shot -> (the shot's frames, the parameters' border, uniform_alpha given)
SHOTS = {
    "all_uniform": ("uniform", BorderPolicy.CLAMP, False),
    "varying_frame": ("varying", BorderPolicy.CLAMP, False),
    "zero_border": ("uniform", BorderPolicy.ZERO, False),
    "given": ("varying", BorderPolicy.CLAMP, True),
}

# path -> how the Session runs it
PATHS = {
    "bilateral": lambda s: s.run(SINGLE),
    "layers": lambda s: s.run(LAYERS),
    "nlm": lambda s: s.run(NLM),
    "multiframe": lambda s: s.run(MULTIFRAME),
    "batched": lambda s: s.run(MULTIFRAME),
    "overlap": lambda s: s.run(OVERLAP),
    "run_turbo": lambda s: s.run_turbo(SINGLE),
}

T, F = True, False
# The uniform_alpha each kernel call received, in order: the warm-up's
# calls, then the timed ones. The multiframe loop takes the target, then
# frames 0-3 (the target counted twice, as discovery lists them); the
# batched loop one stack of them; the overlap loop the first four.
WANT = {
    "all_uniform": {
        "bilateral": [T, T], "layers": [T] * 4, "nlm": [T, T], "multiframe": [T] * 7,
        "batched": [T, T], "overlap": [F] * 6, "run_turbo": [F, F],
    },
    "varying_frame": {
        "bilateral": [T, T], "layers": [T] * 4, "nlm": [T, T],
        "multiframe": [T, T, T, T, T, F, T], "batched": [F, F], "overlap": [F] * 6,
        "run_turbo": [F, F],
    },
    "zero_border": {
        "bilateral": [F, F], "layers": [F] * 4, "nlm": [F, F], "multiframe": [F] * 7,
        "batched": [F, F], "overlap": [F] * 6, "run_turbo": [F, F],
    },
    "given": {
        "bilateral": [T, T], "layers": [T] * 4, "nlm": [T, T], "multiframe": [T] * 7,
        "batched": [T, T], "overlap": [T] * 6, "run_turbo": [T, T],
    },
}


def _recording(monkeypatch):
    """Wrap the CPU kernel wrappers the Session's paths reach; the list of
    params.uniform_alpha as each call received it."""
    seen = []

    def record(module, name):
        fn = getattr(module, name)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            params = next(a for a in (*args, *kwargs.values())
                          if isinstance(a, (BilateralParams, LayersParams, NlmParams)))
            seen.append(params.uniform_alpha)
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    for name in ("bilateral", "cross_bilateral_layers", "nlm_accumulate_frames"):
        record(stencils, name)
    record(fast, "bilateral_fast")
    return seen


@pytest.mark.parametrize("shot", list(SHOTS))
@pytest.mark.parametrize("path", list(PATHS))
def test_each_path_hands_the_kernels_the_uniform_alpha_rule(shots, tmp_path, monkeypatch,
                                                           path, shot):
    frames, border, given = SHOTS[shot]
    kw = dict(border=border, uniform_alpha=given)
    session = Session(shots[frames], device="cpu", output_dir=str(tmp_path),
                      bilateral_params=BilateralParams(radius=2, **kw),
                      layers_params=LayersParams(radius=2, **kw),
                      nlm_params=NlmParams(search_radius=1, patch_radius=1, **kw),
                      batch_frames=path == "batched")
    seen = _recording(monkeypatch)
    PATHS[path](session)
    assert seen == WANT[shot][path]


def _counted_scans(monkeypatch):
    """Count DecodedFrame's alpha scans: the frames scanned, in order."""
    scanned = []
    scan = prefetch.DecodedFrame.uniform_alpha.func

    def counted(entry):
        scanned.append(entry.img)
        return scan(entry)

    prop = functools.cached_property(counted)
    prop.__set_name__(prefetch.DecodedFrame, "uniform_alpha")
    monkeypatch.setattr(prefetch.DecodedFrame, "uniform_alpha", prop)
    return scanned


@pytest.fixture
def decodes(monkeypatch):
    """The arrays decoded from here on by imageio.load, in order."""
    seen = []
    load = imageio.load

    def counted_load(path):
        img, hdr = load(path)
        seen.append(img)
        return img, hdr

    monkeypatch.setattr(imageio, "load", counted_load)
    return seen


@pytest.mark.parametrize("frames", ["uniform", "varying"])
def test_each_decoded_frame_is_scanned_once_across_sessions(shots, tmp_path, monkeypatch,
                                                           decodes, frames):
    """Every target of a shot through the multiframe loop, then the
    batched loop, on one shared cache: each decoded frame's alpha is
    scanned once, never again for a Session that finds it cached, and
    never a tensor read back from the device; the overlap loop and
    run_turbo scan nothing."""
    target = shots[frames]
    paths = [target.replace(f"{TARGET:04d}.png", f"{i:04d}.png") for i in range(N_FRAMES)]
    scanned = _counted_scans(monkeypatch)
    cache: dict = {}
    params = NlmParams(search_radius=1, patch_radius=1)
    for k, path in enumerate(paths * 2):
        Session(path, device="cpu", output_dir=str(tmp_path), nlm_params=params,
                frame_cache=cache, batch_frames=k >= N_FRAMES).run(MULTIFRAME)
    assert len(decodes) == N_FRAMES
    assert len(scanned) == N_FRAMES
    assert all(any(s is d for d in decodes) for s in scanned)
    assert len({id(s) for s in scanned}) == len(scanned)

    del scanned[:]
    for path in paths:
        session = Session(path, device="cpu", output_dir=str(tmp_path), nlm_params=params)
        session.run(OVERLAP)
        session.run_turbo(SINGLE)
        session.run_turbo(LAYERS)
    assert scanned == []


def test_without_a_cache_each_load_scans_once(shots, tmp_path, monkeypatch, decodes):
    """No shared cache: each decode of a frame is its own scan. A run
    decodes each of its files once, the target's included (taken by run and
    again among the frames, as the first and in its place), and the warm-up
    scans no second time."""
    scanned = _counted_scans(monkeypatch)
    Session(shots["uniform"], device="cpu", output_dir=str(tmp_path),
            nlm_params=NlmParams(search_radius=1, patch_radius=1)).run(MULTIFRAME)
    assert len(decodes) == N_FRAMES
    assert len(scanned) == len(decodes)
    assert all(s is d for s, d in zip(scanned, decodes))
