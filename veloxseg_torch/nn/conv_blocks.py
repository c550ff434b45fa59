"""JLC (Johnson-Lindenstrauss-guided Convolution) blocks and up/down sampling.

Reference semantics (``model/components/conv_blocks.py``), channels-first:

- ``DownConv``: conv(kernel 2p−1, stride p, pad p−1) + InstanceNorm.
- ``UpConv``: ConvTranspose(kernel 2, stride 2) + InstanceNorm, with the
  reference ``(I, O, 2, 2, 2)`` weight and its tied ``(O,)`` bias.
- ``JLC``: residual sum of parallel grouped convs (k ∈ kernel_sizes, each
  +IN+GELU), then a residual 1×1 channel MLP (IN → expand → GELU →
  project → dropout). Stage 1 always runs through the stage-1 kernels
  (K4f forward, K4b backward); stage 2 through K5f/K5b while its dropout
  is inactive (eval, or rate 0), else as library ops with the dropout
  before the residual, under the JAX package's gate
  (``veloxseg_tpu/nn/conv_blocks.py:246-247, 276-285``). The submodules
  only hold the parameters, under the reference's state-dict keys. The
  conv path always uses GELU, as the JAX package's encoder and decoders
  do. Every repo config has several branches; the reference's
  single-kernel form (a bare conv, no IN/GELU) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import fused_jlc
from .basic import (Conv1x1, ConvTranspose3d, GroupedConv3d, dropout,
                    get_act)
from .norms import InstanceNorm, instance_norm


class DownConv(nn.Module):
    """Strided overlapping patch downsample + InstanceNorm."""

    def __init__(self, in_ch: int, out_ch: int, patch_size: int = 2,
                 groups: int = 1):
        super().__init__()
        p = patch_size
        self.down = GroupedConv3d(in_ch, out_ch, 2 * p - 1, groups=groups,
                                  stride=p, padding=p - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(self.down(x))


class UpConv(nn.Module):
    """2× upsample: ConvTranspose3d(k = s = 2) + InstanceNorm."""

    def __init__(self, in_ch: int, out_ch: int, up_rate: int = 2):
        super().__init__()
        self.up = ConvTranspose3d(in_ch, out_ch, up_rate, stride=up_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(self.up(x))


class JLC(nn.Module):
    """One JLC block (multi-kernel grouped spatial mix + channel MLP), GELU.

    Keys: ``spatial_convs.{s}.0`` (Sequential(conv, IN, GELU)) and
    ``channel_conv.1`` / ``channel_conv.3`` (expand / project), as in the
    reference.
    """

    def __init__(self, channels: int, kernel_sizes: Sequence[int] = (1, 3, 5),
                 groups: int = 1, expansion_factor: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        if len(kernel_sizes) < 2:
            raise ValueError(f"JLC takes several kernel sizes; the "
                             f"single-kernel form {tuple(kernel_sizes)} is "
                             f"not ported")
        self.groups = groups
        self.spatial_convs = nn.ModuleList(
            nn.Sequential(GroupedConv3d(channels, channels, k, groups=groups),
                          InstanceNorm(), get_act("gelu"))
            for k in kernel_sizes)
        hidden = channels * expansion_factor
        self.channel_conv = nn.Sequential(
            InstanceNorm(), Conv1x1(channels, hidden), get_act("gelu"),
            Conv1x1(hidden, channels), nn.Dropout(dropout))
        self.dropout = dropout

    def _convs(self):
        return [m[0] for m in self.spatial_convs]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        convs = self._convs()
        out = fused_jlc.jlc_stage1(x, [c.weight for c in convs],
                                   [c.bias for c in convs], self.groups)
        expand, project = self.channel_conv[1], self.channel_conv[3]
        if not self.training or self.dropout == 0.0:
            return fused_jlc.jlc_stage2(out, expand.weight, expand.bias,
                                        project.weight, project.bias)
        z = F.gelu(expand(self.channel_conv[0](out)))
        return out + dropout(project(z), self.dropout, True, generator)


class JLCLayer(nn.Sequential):
    """``depth`` stacked JLC blocks (keys ``{j}.``)."""

    def __init__(self, channels: int, depth: int = 1,
                 kernel_sizes: Sequence[int] = (1, 3, 5), groups: int = 1,
                 expansion_factor: int = 4, dropout: float = 0.0):
        super().__init__(*[
            JLC(channels, kernel_sizes, groups, expansion_factor, dropout)
            for _ in range(depth)])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for blk in self:
            x = blk(x, generator)
        return x
