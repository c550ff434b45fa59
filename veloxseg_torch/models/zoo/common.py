"""Building blocks of the baseline zoo that U-RWKV needs
(``veloxseg_tpu/models/zoo/common.py``), channels-first. Its torch-style
``Conv3d`` (``k // 2`` padding, groups) is :func:`..nn.basic.GroupedConv3d`
and its ``max_pool3d`` is ``F.max_pool3d``; what is left is the batch norm.
"""

from __future__ import annotations

import torch
from torch import nn


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
        axes = (0,) + tuple(range(2, x.dim()))
        mean = x.mean(dim=axes, keepdim=True)
        var = (x - mean).square().mean(dim=axes, keepdim=True)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean) / torch.sqrt(var + self.eps)
                * self.weight.view(shape) + self.bias.view(shape))
