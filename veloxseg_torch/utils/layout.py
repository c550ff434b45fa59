"""Channels-first ↔ channels-last converters.

The port computes channels-first ``(B, C, D, H, W)`` inside (the layout of
cuDNN and of its kernels) and keeps the JAX package's channels-last
``(B, D, H, W, C)`` at its public functions; these helpers sit at that
boundary.
"""

from __future__ import annotations

import torch


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """(B, C, *spatial) -> (B, *spatial, C)."""
    return torch.movedim(x, 1, -1)


def to_channels_first(x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, C) -> (B, C, *spatial)."""
    return torch.movedim(x, -1, 1)
