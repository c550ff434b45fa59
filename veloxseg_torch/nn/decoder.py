"""Student segmentation decoder, eval forward (``model/Decoder.py:97-179``).

U-Net-style up path with additive skips; head = 3³ conv to
``patch³·n_classes`` + 3-D pixel shuffle. The deep-supervision heads
``out_conv2..L`` exist as modules, so their state-dict keys do, but eval
does not compute them; nor does it compute the Gram statistic, which only
the training loss reads. The teachers' ``RCDecoder`` comes with training.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..core.config import VeloxSegConfig
from ..ops.pixel_shuffle import pixel_shuffle_3d
from .basic import Conv1x1, GroupedConv3d
from .conv_blocks import JLCLayer, UpConv


class SegDecoder(nn.Module):
    """Keys: ``layer_up{t}``, ``layer{t}`` (t = 1..L−1), ``out_conv1.0``
    and, with deep supervision, ``out_conv{t}`` (t = 2..L)."""

    def __init__(self, cfg: VeloxSegConfig):
        super().__init__()
        c = cfg.base_ch
        self.num_levels = n = cfg.num_levels
        self.patch_size = cfg.patch_size
        for t in range(n - 1, 0, -1):
            ct = c * 2 ** (t - 1)
            setattr(self, f"layer_up{t}", UpConv(c * 2 ** t, ct))
            setattr(self, f"layer{t}", JLCLayer(
                ct, cfg.conv_depths[t - 1], cfg.kernel_sizes,
                ct // cfg.min_dim_group[t - 1],
                cfg.conv_expansion_factor[t - 1]))
        self.out_conv1 = nn.Sequential(GroupedConv3d(
            c, cfg.patch_size ** 3 * cfg.n_classes, 3))
        if cfg.deep_supervision:
            for t in range(2, n + 1):
                setattr(self, f"out_conv{t}",
                        Conv1x1(c * 2 ** (t - 1), cfg.n_classes))

    def forward(self, encs: Sequence[torch.Tensor]) -> torch.Tensor:
        """``encs``: per-level features, finest first → eval logits."""
        h = encs[-1]
        for t in range(self.num_levels - 1, 0, -1):
            up = getattr(self, f"layer_up{t}")(h)
            h = getattr(self, f"layer{t}")(encs[t - 1] + up)
        return pixel_shuffle_3d(self.out_conv1(h), self.patch_size)
