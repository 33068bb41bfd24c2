"""Per-plane radar-map normalization (counterpart of
`hupr_tpu/ops/normalize.py`; reference datasets/base.py:13-24)."""

from __future__ import annotations

import torch


def _normalize_map(x: torch.Tensor) -> torch.Tensor:
    """x (..., R, A): min-max to [0, 1], then zero mean and unit unbiased
    std over the trailing two axes.

    A constant plane maps to zeros instead of NaN. The cube's Doppler-0
    chirp is mathematically zero after clutter removal; an FFT may compute
    it exactly zero (the TPU's does, cuFFT may) or leave rounding residue.
    The guards change nothing where max > 0 and var > 0."""
    mn = x.amin(dim=(-2, -1), keepdim=True)
    x0 = x - mn
    mx = x0.amax(dim=(-2, -1), keepdim=True)
    xn = x0 / torch.where(mx > 0, mx, torch.ones_like(mx))
    mean = xn.mean(dim=(-2, -1), keepdim=True)
    n = x.shape[-1] * x.shape[-2]
    var = ((xn - mean) ** 2).sum(dim=(-2, -1), keepdim=True) / (n - 1)
    return (xn - mean) / torch.sqrt(torch.where(var > 0, var,
                                                torch.ones_like(var)))


def normalize_radar_window(x: torch.Tensor) -> torch.Tensor:
    """Normalize each (R, A) slice of a (..., R, A, E) real window per
    elevation channel."""
    return _normalize_map(x.movedim(-1, -3)).movedim(-3, -1)
