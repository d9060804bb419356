"""The port's static kernel tables equal the JAX package's.

The CUDA kernels iterate exactly these tables (the bilateral truncation disk
runs and the NLM search candidates), so the kernels and the Pallas kernels
see the same tap and candidate sets.
"""

import numpy as np
import pytest
import torch

from image_denoising_filter_tpu_torch.config import BilateralParams, NlmParams
from image_denoising_filter_tpu.ops import stencils as jax_stencils
from image_denoising_filter_tpu_torch.ops import stencils

torch.set_num_threads(1)


@pytest.mark.parametrize("eps", [1e-8, 1e-4, 0.0])
@pytest.mark.parametrize("sigma_s", [0.8, 2.0, 10.0])
@pytest.mark.parametrize("radius", [1, 3, 6, 13, 20])
def test_circle_runs_match_jax(radius, sigma_s, eps):
    want = jax_stencils._circle_runs(radius, sigma_s, eps)
    got = stencils._circle_runs(radius, sigma_s, eps)
    assert [tuple(r) for r in got] == [tuple(r) for r in want]


def test_circle_runs_cover_effective_radius_at_defaults():
    """At the reference parameters (radius 20, sigma_s 2, eps 1e-8) the disk
    has radius floor(2 sqrt(2 ln 1e8)) = 12, and every row of [-12, 12] is
    covered exactly once."""
    p = BilateralParams()
    r = p.effective_radius
    assert r == 12
    runs = stencils._circle_runs(r, p.sigma_spatial, p.truncate_eps)
    rows = [dy for dy0, n, _ in runs for dy in range(dy0, dy0 + n)]
    assert rows == list(range(-r, r + 1))


def _jax_sdx_steps(s, stride, disk):
    """stencils.py:903-912, transcribed (a local of _nlm_planar_frames)."""
    sdx_all = tuple(range(s % stride, 2 * s, stride))
    return tuple(
        tuple(
            sdx
            for sdx in sdx_all
            if not disk or (sdy - s) ** 2 + (sdx - s) ** 2 <= s * s
        )
        for sdy in sdx_all
    )


@pytest.mark.parametrize("disk", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("s", [2, 6, 7])
def test_candidate_table_matches_jax(s, stride, disk):
    params = NlmParams(search_radius=s, search_stride=stride, search_disk=disk)
    assert stencils._sdx_steps(params) == _jax_sdx_steps(s, stride, disk)
    # The (dy, dx) list is the set and order the NumPy oracle loops over
    # (ops/reference.py:nlm_reference).
    want = [
        (dy, dx)
        for dy in range(s % stride - s, s, stride)
        for dx in range(s % stride - s, s, stride)
        if not disk or dy * dy + dx * dx <= s * s
    ]
    got = stencils.nlm_candidates(params)
    assert got == want
    assert (0, 0) in got  # the self match anchors the normalization


def test_candidate_counts_at_reference_params():
    assert len(stencils.nlm_candidates(NlmParams())) == 196
    assert len(stencils.nlm_candidates(NlmParams(search_stride=2, search_disk=True))) == 37
    assert np.asarray(stencils.nlm_candidates(NlmParams())).min() == -7
