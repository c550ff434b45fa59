"""U-KAN, the reference's ``compared_model/UKAN/archs.py:239`` baseline, as
``veloxseg_tpu/models/zoo/ukan.py`` builds it: three double conv + batch
norm + ReLU stages, each max-pooled, then two tokenized KAN stages (an
overlapping 3³ stride-2 patch embedding + LayerNorm, a KAN block of three
:class:`.kan.KANLinear` layers each followed by a depthwise conv + batch
norm + ReLU, LayerNorm), and a decoder of double convs, align-corners
trilinear 2× upsamples with additive skips, and KAN blocks on its two
deepest levels; a 1×1 head. The batch norms are
:class:`.common.BatchNormNoTrack` (batch statistics in eval too).

Parameter names: the reference's state-dict keys (``encoder1.conv.0``,
``patch_embed3.proj``, ``block1.0.layer.fc1.base_weight``,
``block1.0.layer.dwconv_1.bn``, ``dnorm3``, ``final``), the inverse of
``veloxseg_tpu/interop/zoo_import.py:_map_ukan_key``; its batch-norm
statistics and KAN ``grid`` buffers are not held. Channels-last in and
out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...ops.resize import resize_trilinear
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import BatchNormNoTrack, LayerNorm, init_weights_
from .kan import KANLinear


class DoubleConv(nn.Module):
    """conv 3³ → BN → ReLU, twice (the reference's ``conv`` Sequential)."""

    def __init__(self, in_ch: int, mid: int, out: int):
        super().__init__()
        self.conv = nn.Sequential(
            GroupedConv3d(in_ch, mid, 3), BatchNormNoTrack(mid), nn.ReLU(),
            GroupedConv3d(mid, out, 3), BatchNormNoTrack(out), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DWBnRelu(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = GroupedConv3d(dim, dim, 3, groups=dim)
        self.bn = BatchNormNoTrack(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # an NCDHW copy of the KAN layer's channels-last view: PyTorch's
        # CPU bf16 depthwise conv3d gives a wrong weight gradient on a
        # channels-last input at 2³ (U-KAN's 1/32 level at 64³)
        return F.relu(self.bn(self.dwconv(x.contiguous())))


class KANLayer(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        for i in range(1, 4):
            self.add_module(f"fc{i}", KANLinear(dim, dim))
            self.add_module(f"dwconv_{i}", DWBnRelu(dim))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h: channels-last ``(B, D, H, W, C)``."""
        for i in range(1, 4):
            h = getattr(self, f"fc{i}")(h)
            h = to_channels_last(getattr(self, f"dwconv_{i}")(
                to_channels_first(h)))
        return h


class KANBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm2 = LayerNorm(dim)
        self.layer = KANLayer(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer(self.norm2(x))


class PatchEmbedOverlap(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int):
        super().__init__()
        self.proj = GroupedConv3d(in_ch, embed_dim, 3, stride=2)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """channels-first in, channels-last out."""
        return self.norm(to_channels_last(self.proj(x)))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return resize_trilinear(x, tuple(2 * s for s in x.shape[2:]))


class UKAN(nn.Module):
    def __init__(self, in_channels: int = 2, num_classes: int = 2,
                 embed_dims: Sequence[int] = (128, 160, 256)):
        super().__init__()
        e = tuple(embed_dims)
        c0 = e[0]
        self.encoder1 = DoubleConv(in_channels, c0 // 8, c0 // 8)
        self.encoder2 = DoubleConv(c0 // 8, c0 // 4, c0 // 4)
        self.encoder3 = DoubleConv(c0 // 4, c0, c0)
        self.patch_embed3 = PatchEmbedOverlap(c0, e[1])
        self.block1 = nn.ModuleList([KANBlock(e[1])])
        self.norm3 = LayerNorm(e[1])
        self.patch_embed4 = PatchEmbedOverlap(e[1], e[2])
        self.block2 = nn.ModuleList([KANBlock(e[2])])
        self.norm4 = LayerNorm(e[2])
        self.decoder1 = DoubleConv(e[2], e[2], e[1])
        self.dblock1 = nn.ModuleList([KANBlock(e[1])])
        self.dnorm3 = LayerNorm(e[1])
        self.decoder2 = DoubleConv(e[1], e[1], e[0])
        self.dblock2 = nn.ModuleList([KANBlock(e[0])])
        self.dnorm4 = LayerNorm(e[0])
        self.decoder3 = DoubleConv(e[0], e[0], e[0] // 4)
        self.decoder4 = DoubleConv(e[0] // 4, e[0] // 4, e[0] // 8)
        self.decoder5 = DoubleConv(e[0] // 8, e[0] // 8, e[0] // 8)
        self.final = Conv1x1(e[0] // 8, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_first(x)
        t1 = F.relu(F.max_pool3d(self.encoder1(x), 2))
        t2 = F.relu(F.max_pool3d(self.encoder2(t1), 2))
        t3 = F.relu(F.max_pool3d(self.encoder3(t2), 2))

        h = self.block1[0](self.patch_embed3(t3))
        t4 = self.norm3(h)                                 # channels-last
        h = self.block2[0](self.patch_embed4(to_channels_first(t4)))
        h = to_channels_first(self.norm4(h))

        h = F.relu(_up2(self.decoder1(h))) + to_channels_first(t4)
        h = self.dnorm3(self.dblock1[0](to_channels_last(h)))
        h = F.relu(_up2(self.decoder2(to_channels_first(h)))) + t3
        h = self.dnorm4(self.dblock2[0](to_channels_last(h)))
        h = F.relu(_up2(self.decoder3(to_channels_first(h)))) + t2
        h = F.relu(_up2(self.decoder4(h))) + t1
        h = F.relu(_up2(self.decoder5(h)))
        return to_channels_last(self.final(h))


@register_model("U-KAN")
def build_ukan(cfg: dict, device=None, seed: int = 0) -> UKAN:
    """Eval-mode U-KAN from its model-config entry (``input_channels``,
    ``num_classes``, ``embed_dims``), He-normal seeded convs and the KAN
    layers' own init."""
    dev = resolve_device(device)
    model = UKAN(cfg.get("input_channels", 2), cfg.get("num_classes", 2),
                 tuple(cfg.get("embed_dims", (128, 160, 256))))
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    for m in model.modules():
        if isinstance(m, KANLinear):
            m.reset_parameters_(gen)
    return model.to(dev).eval()
