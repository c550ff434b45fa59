"""Building blocks of the baseline zoo that U-RWKV needs
(``veloxseg_tpu/models/zoo/common.py``, and the JAX package's
``nn/norms.LayerNorm``). Its torch-style ``Conv3d`` (``k // 2`` padding,
groups) is :func:`..nn.basic.GroupedConv3d` and its ``max_pool3d`` is
``F.max_pool3d``; what is left is the batch norm and the last-axis layer
norm.

Both norms round as the JAX ones do in bf16: the statistics and the
normalized value in fp32, that value rounded to the input's dtype, then
the weight and the bias applied in that dtype (a product and a sum, each
rounded). ``torch.nn.LayerNorm`` in bf16 rounds once, after its affine.
"""

from __future__ import annotations

import torch
from torch import nn


def _normalize(x: torch.Tensor, axes, eps: float) -> torch.Tensor:
    """(x − mean) / sqrt(var + eps) over ``axes`` (biased variance), in
    fp32, rounded to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)


class BatchNormNoTrack(nn.Module):
    """Batch normalization with an affine, always over the statistics of the
    batch it is given (per channel over (batch, D, H, W), biased variance,
    eps 1e-5), in eval mode too, with no running statistics
    (``common.py:109-133``). So a tile's output depends on the other tiles
    of the same call: the JAX package's behaviour, kept."""

    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _normalize(x, (0,) + tuple(range(2, x.dim())), self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (y * self.weight.view(shape).to(x.dtype)
                + self.bias.view(shape).to(x.dtype))


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with a weight and a bias, eps 1e-6
    (``veloxseg_tpu/nn/norms.py:LayerNorm``, which U-RWKV uses)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _normalize(x, (-1,), self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)
