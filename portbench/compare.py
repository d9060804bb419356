"""The numbers the comparison with the plain reference reads."""

from __future__ import annotations

import numpy as np
import torch


def max_abs_err(got, want) -> float:
    """The largest absolute difference of two arrays of one shape (numpy or
    torch, any device): inf where either holds a NaN, or where the shapes
    differ."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if got.shape != want.shape:
        return float("inf")
    diff = (got.to(want.device, torch.float64) - want.double()).abs()
    return float(torch.nan_to_num(diff, nan=float("inf")).max())


def mismatch_share(got: np.ndarray, want: np.ndarray) -> float:
    """The share of the values that differ (1.0 where the shapes differ)."""
    if got.shape != want.shape:
        return 1.0
    return float(np.count_nonzero(got != want)) / got.size
