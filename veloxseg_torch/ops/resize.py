"""Align-corners linear interpolation operator.

The reference upsamples PWA window tokens with ``F.interpolate(...,
mode='trilinear', align_corners=True)`` (``model/components/PWA.py:190``).
Separable per-axis interpolation with static sizes is a dense
``(n_out, n_in)`` matrix with at most two non-zeros per row; the PWA
scatter applies it along each token axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """Dense 1-D linear interpolation matrix, align_corners=True."""
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 or n_in == 1:
        # align_corners=True with a single sample maps to source index 0.
        w[:, 0] = 1.0
        return w
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


def interp_matrix(n_in: int, n_out: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """1-D align-corners linear interpolation operator ``(n_out, n_in)``."""
    return torch.as_tensor(_interp_matrix_np(int(n_in), int(n_out)),
                           dtype=dtype, device=device)
