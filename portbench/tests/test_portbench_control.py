"""The comparison that decides `correct` fails where it should.

The control (the reference computed in the program's bf16 taps, the
program's own lower-precision path) comes out not correct, and so does a
run whose timed path is broken underneath, once for each fault the cells
can have: a step that returns its state (the noisy target) unchanged; half
of the batch (frames or layers) left out, the mean taken over the rest; an
answer altered where it is produced (one value of the normalized output by
one 8-bit step). The cells run on one card, so no exchange between cards
can be left out. These runs skip the harness's look for a card and run the
port's plain versions on the CPU at a tiny size; the card test runs the
control at the cells' own sizes.
"""

import dataclasses
import time

import pytest

from image_denoising_filter_tpu_torch.models import denoiser
from image_denoising_filter_tpu_torch.runtime import session as session_mod
from portbench import harness
from portbench.tests.conftest import CELLS, run_tiny


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    assert run_tiny(name)["correct"] is True


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    result = run_tiny(name, variant="control")
    assert result["correct"] is False
    assert result["checks"]["max_abs_err"]["value"] > result["checks"]["max_abs_err"]["limit"]


def _unchanged(monkeypatch):
    monkeypatch.setattr(denoiser.TemporalNlmDenoiser, "forward",
                        lambda self, target, frames: target.clone())
    monkeypatch.setattr(denoiser.LayerGuidedDenoiser, "forward",
                        lambda self, target, layers: target.clone())
    monkeypatch.setattr(session_mod.Session, "_run_multiframe",
                        lambda self, target_dev, *a: (target_dev.clone(), None))


def _half_batch(monkeypatch):
    nlm, guided = denoiser.TemporalNlmDenoiser.forward, denoiser.LayerGuidedDenoiser.forward
    monkeypatch.setattr(denoiser.TemporalNlmDenoiser, "forward",
                        lambda self, t, frames: nlm(self, t, frames[:len(frames) // 2]))
    monkeypatch.setattr(denoiser.LayerGuidedDenoiser, "forward",
                        lambda self, t, layers: guided(self, t, layers[:len(layers) // 2]))
    discover = session_mod.dataset_mod.discover

    def half(*args, **kwargs):
        ds = discover(*args, **kwargs)
        return dataclasses.replace(ds, frames=ds.frames[:len(ds.frames) // 2])

    monkeypatch.setattr(session_mod.dataset_mod, "discover", half)


def _altered(monkeypatch):
    normalize = denoiser._Normalizing._normalize

    def altered(self, wc, nw):
        out = normalize(self, wc, nw)
        out[0, 0, 0] += 1.0 / 255.0
        return out

    monkeypatch.setattr(denoiser._Normalizing, "_normalize", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    assert run_tiny(name)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(cuda_card, name):
    cell = harness.find_cell(harness.ROOT, name)
    for seed in (11, 2**31 + 12, 13):
        result = harness.run_cell(harness.ROOT, cell, seed, 2.0, False, "cuda",
                                  time.perf_counter(), log=lambda m: None, variant="control")
        assert result["correct"] is False
