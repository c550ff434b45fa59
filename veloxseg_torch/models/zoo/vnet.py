"""VNet, the reference's MONAI ``VNet`` baseline (``utils/load_model.py:
14-16``), as ``veloxseg_tpu/models/zoo/vnet.py`` builds it: 5³ conv
blocks with batch norm and ELU, stride-2 down convs (16 → 32 → 64 → 128 →
256 with 1/2/3/2 convs per stage), 2×2 transposed-conv up path (2/2/1/1
convs) with concatenated skips and residual adds, a 5³ conv + norm + 1×1
head. The batch norms are :class:`.common.BatchNormNoTrack` (the batch's
statistics in eval mode too). The two deepest stages drop whole channels
at 0.5 in training (:class:`.common.ChannelDropout`, ``vnet.py:56,
71-72``: after down 128 and 256, and on both inputs of up 256 and 128),
drawn from the generator passed to the forward.

Parameter names: the flax paths of the JAX module with ``/`` as ``.``
(``in_tr.conv.weight``, ``down_tr32.conv_0.bn.weight``,
``up_tr256.up_conv.weight``, ``out_proj.weight``); the stage names are
MONAI's, the inside of each stage the JAX module's (the JAX package holds
no MONAI key map). Channels-last in and out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (BatchNormNoTrack, ChannelDropout, ConvTranspose3d,
                     init_weights_)


class LUConv(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = GroupedConv3d(channels, channels, 5)
        self.bn = BatchNormNoTrack(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.bn(self.conv(x)))


class InputTransition(nn.Module):
    def __init__(self, in_ch: int, features: int = 16):
        super().__init__()
        self.conv = GroupedConv3d(in_ch, features, 5)
        self.bn = BatchNormNoTrack(features)
        self.repeat = features // in_ch if features % in_ch == 0 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(x))
        if self.repeat:
            y = y + x.repeat(1, self.repeat, 1, 1, 1)
        return F.elu(y)


class DownTransition(nn.Module):
    def __init__(self, in_ch: int, features: int, nconvs: int,
                 dropout: bool = False):
        super().__init__()
        self.down_conv = GroupedConv3d(in_ch, features, 2, stride=2,
                                       padding=0)
        self.bn = BatchNormNoTrack(features)
        self.drop = ChannelDropout(0.5 if dropout else 0.0)
        for i in range(nconvs):
            self.add_module(f"conv_{i}", LUConv(features))
        self.nconvs = nconvs

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        down = F.elu(self.bn(self.down_conv(x)))
        y = self.drop(down, generator)
        for i in range(self.nconvs):
            y = getattr(self, f"conv_{i}")(y)
        return F.elu(y + down)


class UpTransition(nn.Module):
    """``features`` is the width after the concatenation: the up conv
    gives half of it, the skip the other half."""

    def __init__(self, in_ch: int, features: int, nconvs: int,
                 dropout: bool = False):
        super().__init__()
        self.do_in = ChannelDropout(0.5 if dropout else 0.0)
        self.do_skip = ChannelDropout(0.5 if dropout else 0.0)
        self.up_conv = ConvTranspose3d(in_ch, features // 2)
        self.bn = BatchNormNoTrack(features // 2)
        for i in range(nconvs):
            self.add_module(f"conv_{i}", LUConv(features))
        self.nconvs = nconvs

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.do_in(x, generator)
        skip = self.do_skip(skip, generator)
        up = F.elu(self.bn(self.up_conv(x)))
        cat = torch.cat([up, skip], dim=1)
        y = cat
        for i in range(self.nconvs):
            y = getattr(self, f"conv_{i}")(y)
        return F.elu(y + cat)


class VNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 2):
        super().__init__()
        self.in_tr = InputTransition(in_channels, 16)
        self.down_tr32 = DownTransition(16, 32, 1)
        self.down_tr64 = DownTransition(32, 64, 2)
        self.down_tr128 = DownTransition(64, 128, 3, dropout=True)
        self.down_tr256 = DownTransition(128, 256, 2, dropout=True)
        self.up_tr256 = UpTransition(256, 256, 2, dropout=True)
        self.up_tr128 = UpTransition(256, 128, 2, dropout=True)
        self.up_tr64 = UpTransition(128, 64, 1)
        self.up_tr32 = UpTransition(64, 32, 1)
        self.out_conv = GroupedConv3d(32, out_channels, 5)
        self.out_bn = BatchNormNoTrack(out_channels)
        self.out_proj = Conv1x1(out_channels, out_channels)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the channel dropouts in training."""
        g = generator
        x16 = self.in_tr(to_channels_first(x))
        x32 = self.down_tr32(x16, g)
        x64 = self.down_tr64(x32, g)
        x128 = self.down_tr128(x64, g)
        x256 = self.down_tr256(x128, g)
        u = self.up_tr256(x256, x128, g)
        u = self.up_tr128(u, x64, g)
        u = self.up_tr64(u, x32, g)
        u = self.up_tr32(u, x16, g)
        y = F.elu(self.out_bn(self.out_conv(u)))
        return to_channels_last(self.out_proj(y))


@register_model("VNet")
def build_vnet(cfg: dict, device=None, seed: int = 0) -> VNet:
    """Eval-mode VNet from its model-config entry (``in_channels``,
    ``out_channels``), He-normal seeded convs."""
    dev = resolve_device(device)
    model = VNet(cfg.get("in_channels", 2), cfg.get("out_channels", 2))
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
