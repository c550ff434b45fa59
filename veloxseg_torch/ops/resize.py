"""Align-corners linear interpolation.

The reference resizes with ``F.interpolate(..., mode='trilinear',
align_corners=True)`` in two places: the PWA window scatter
(``model/components/PWA.py:190``) and the deep-supervision heads
(``model/VeloxSeg.py:177-184``). Separable per-axis interpolation with
static sizes is a dense ``(n_out, n_in)`` matrix with at most two
non-zeros per row, applied along each axis as
``veloxseg_tpu/ops/resize.py`` applies it.
"""

from __future__ import annotations

import functools
from typing import Sequence

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


def resize_trilinear(x: torch.Tensor, out_size: Sequence[int]
                     ) -> torch.Tensor:
    """Resize the spatial axes of a channels-first ``(B, C, D, H, W)``
    tensor to ``out_size`` (align_corners=True)."""
    if len(out_size) != x.dim() - 2:
        raise ValueError(f"out_size {tuple(out_size)} does not match the "
                         f"{x.dim() - 2} spatial axes of {tuple(x.shape)}")
    for i, n_out in enumerate(out_size):
        axis = 2 + i
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        w = interp_matrix(n_in, n_out, dtype=x.dtype, device=x.device)
        x = torch.movedim(torch.tensordot(x, w, dims=([axis], [1])), -1, axis)
    return x
