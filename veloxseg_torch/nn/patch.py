"""Patch embedding and patch merging (channels-first).

- :class:`PatchEmbed` mirrors MONAI's ``PatchEmbed`` as the reference
  transformer branch uses it (``model/Encoder.py:150-156``): a conv with
  kernel == stride == patch_size (``proj``), optional LayerNorm (``norm``).
- :class:`PatchMerging` mirrors ``model/components/attention_utils.py:127-168``:
  8-way stride-2 sampling → LayerNorm → bias-free 1×1 reduction to 2×
  channels.
"""

from __future__ import annotations

import torch
from torch import nn

from .basic import Conv1x1, Conv3d
from .norms import LayerNorm


class PatchEmbed(nn.Module):
    """(B, C, D, H, W) -> (B, E, D/p, H/p, W/p)."""

    def __init__(self, in_ch: int, embed_dim: int, patch_size: int = 4,
                 use_norm: bool = False):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv3d(in_ch, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        if any(s % p for s in x.shape[2:]):
            raise ValueError(f"spatial size {tuple(x.shape[2:])} not "
                             f"divisible by patch_size {p}")
        y = self.proj(x)
        return self.norm(y) if self.norm is not None else y


class PatchMerging(nn.Module):
    """(B, C, D, H, W) -> (B, 2C, D/2, H/2, W/2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = LayerNorm(8 * channels)
        self.reduction = Conv1x1(8 * channels, 2 * channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = [x[:, :, a::2, b::2, d::2]
                 for a in (0, 1) for b in (0, 1) for d in (0, 1)]
        return self.reduction(self.norm(torch.cat(parts, dim=1)))
