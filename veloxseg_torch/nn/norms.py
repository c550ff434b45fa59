"""Normalization layers (channels-first ``(B, C, *spatial)``).

- :class:`LayerNorm` normalizes the channel axis only, eps 1e-6, with a
  learnable ``weight``/``bias`` (the reference's channels-first LayerNorm,
  ``model/components/attention_utils.py:11-43``).
- :func:`instance_norm` normalizes per (sample, channel) over the spatial
  axes with no affine parameters, eps 1e-5 inside the rsqrt and
  ``max(var, 0)``, as ``veloxseg_tpu/nn/norms.py:49-62`` computes it.

Both compute in fp32 (the instance norm keeps a float64 input in float64)
and cast the result back to the input's dtype, as the
JAX package does for bf16 activations (``veloxseg_tpu/nn/norms.py:33-38``,
``57-63``): the LayerNorm rounds the normalized value, then applies its
weight and bias in the input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn


class LayerNorm(nn.Module):
    """Channel-axis LayerNorm with learnable weight/bias, eps 1e-6."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = (xf - mean).square().mean(dim=1, keepdim=True)
        y = ((xf - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * self.weight.view(shape) + self.bias.view(shape)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm over the spatial axes of ``(B, C, ...)``."""
    axes = tuple(range(2, x.dim()))
    count = 1
    for a in axes:
        count *= x.shape[a]
    xf = x if x.dtype == torch.float64 else x.float()
    mean = xf.sum(dim=axes, keepdim=True) / count
    var = xf.square().sum(dim=axes, keepdim=True) / count - mean.square()
    scale = torch.rsqrt(var.clamp_min(0.0) + eps)
    return (xf * scale - mean * scale).to(x.dtype)


class InstanceNorm(nn.Module):
    """Module form of :func:`instance_norm` (no parameters)."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.eps)
