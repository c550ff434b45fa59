"""A2FSeg, the reference's modality-adaptive fusion nnU-Net
(``compared_model/A2FSeg/.../generic_MAML3_channel.py:722``), as
``veloxseg_tpu/models/zoo/a2fseg.py`` builds it: one nnU-Net per modality
(conv 3³ + batch norm + LeakyReLU pairs, stride-2 convs down, 2×2
transposed convs up, widths 16·2^d capped at 320), a fusion decoder whose
skips are the means of the modality decoders' features at each level, and
a modality-adaptive head: per modality a conv block over (its feature,
the fusion feature), a softmax over the modalities, the weighted sum of
the modality features fused with the fusion feature, a 1×1 output conv.

The batch norms are :class:`.common.BatchNormNoTrack` (batch statistics in
eval too: ``num_pool`` 5 leaves a 3³ bottleneck at 96³ and a 1³ one at
32³). In eval the JAX module returns the fused logits alone
(``a2fseg.py:160-166``), so the deep-supervision heads (``seg_outputs``,
each a softmax) are not run here; they are parameters all the same, which
checkpoints hold.

Parameter names: the reference's state-dict keys
(``modality_specific_models.0.conv_blocks_context.0.blocks.0.conv``,
``...conv_blocks_context.5.0.blocks.0.instnorm``, ``...tu.0``,
``fusion_decoder.conv_blocks_localization.0.1.blocks.0.conv``,
``modality_aware_modules.0.3``, ``lastconv.0.1``, ``output``), the
inverse of ``veloxseg_tpu/interop/zoo_import.py:_map_a2fseg_key``; the
fusion decoder's unused ``conv_blocks_context`` and ``td`` modules and the
batch-norm statistics are not held. Channels-last in and out.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import BatchNormNoTrack, ConvTranspose3d, init_weights_


def _stage_channels(base: int, num_pool: int, cap: int = 320) -> List[int]:
    return [min(base * 2 ** d, cap) for d in range(num_pool + 1)]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class ConvBlock(nn.Module):
    """nnU-Net's ConvDropoutNormNonlin: conv 3³ → BN → LeakyReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv = GroupedConv3d(in_ch, out_ch, 3, stride=stride)
        self.instnorm = BatchNormNoTrack(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _lrelu(self.instnorm(self.conv(x)))


class Stacked(nn.Module):
    """nnU-Net's StackedConvLayers: its conv blocks as ``blocks``."""

    def __init__(self, *blocks: ConvBlock):
        super().__init__()
        self.blocks = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


def _localization(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(Stacked(ConvBlock(in_ch, out_ch)),
                         Stacked(ConvBlock(out_ch, out_ch)))


class Decoder(nn.Module):
    """The up path: per level a transposed conv (no bias), the skip
    concatenated, two conv blocks; the deep-supervision heads held."""

    def __init__(self, chs: List[int], num_classes: int):
        super().__init__()
        n = len(chs) - 1
        self.tu = nn.ModuleList()
        self.conv_blocks_localization = nn.ModuleList()
        self.seg_outputs = nn.ModuleList()
        for u in range(n):
            skip_ch = chs[n - 1 - u]
            self.tu.append(ConvTranspose3d(chs[n - u], skip_ch, bias=False))
            self.conv_blocks_localization.append(
                _localization(2 * skip_ch, skip_ch))
            self.seg_outputs.append(Conv1x1(skip_ch, num_classes,
                                            bias=False))

    def forward(self, x: torch.Tensor, skips: List[torch.Tensor]
                ) -> List[torch.Tensor]:
        """The features of every level, coarse to fine; ``skips`` fine to
        coarse."""
        feats = []
        for u, (tu, loc) in enumerate(zip(self.tu,
                                          self.conv_blocks_localization)):
            x = loc(torch.cat([tu(x), skips[-(u + 1)]], dim=1))
            feats.append(x)
        return feats


class ModalityUNet(Decoder):
    """One modality's nnU-Net: the encoder (``conv_blocks_context``) and
    the decoder."""

    def __init__(self, chs: List[int], num_classes: int):
        super().__init__(chs, num_classes)
        n = len(chs) - 1
        ctx = []
        for d in range(n):
            ctx.append(Stacked(ConvBlock(chs[d - 1] if d else 1, chs[d],
                                         1 if d == 0 else 2),
                               ConvBlock(chs[d], chs[d])))
        ctx.append(nn.Sequential(Stacked(ConvBlock(chs[n - 1], chs[n], 2)),
                                 Stacked(ConvBlock(chs[n], chs[n]))))
        self.conv_blocks_context = nn.ModuleList(ctx)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[bottleneck, decoder features coarse to fine]."""
        skips = []
        for block in self.conv_blocks_context[:-1]:
            x = block(x)
            skips.append(x)
        x = self.conv_blocks_context[-1](x)
        return [x] + super().forward(x, skips)


class A2FSeg(nn.Module):
    def __init__(self, modality_num: int = 2, base: int = 16,
                 num_classes: int = 2, num_pool: int = 5):
        super().__init__()
        chs = _stage_channels(base, num_pool)
        self.modality_specific_models = nn.ModuleList(
            ModalityUNet(chs, num_classes) for _ in range(modality_num))
        self.fusion_decoder = Decoder(chs, num_classes)
        self.modality_aware_modules = nn.ModuleList(
            nn.Sequential(GroupedConv3d(2 * base, base, 3),
                          BatchNormNoTrack(base), nn.LeakyReLU(0.01),
                          GroupedConv3d(base, base, 3), nn.LeakyReLU(0.01))
            for _ in range(modality_num))
        self.lastconv = nn.Sequential(nn.Sequential(
            GroupedConv3d(2 * base, base, 3), BatchNormNoTrack(base),
            nn.LeakyReLU(0.01)))
        self.output = Conv1x1(base, num_classes, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_first(x)
        levels = [unet(x[:, m:m + 1]) for m, unet
                  in enumerate(self.modality_specific_models)]
        modality_feats = [lv[-1] for lv in levels]
        means = [sum(f) / len(f) for f in zip(*levels)]
        fusion_feat = self.fusion_decoder(means[0], means[1:][::-1])[-1]
        attn = torch.softmax(torch.stack(
            [aware(torch.cat([f, fusion_feat], dim=1))
             for aware, f in zip(self.modality_aware_modules,
                                 modality_feats)], dim=1), dim=1)
        out = sum(attn[:, m] * f for m, f in enumerate(modality_feats))
        out = self.lastconv(torch.cat([out, fusion_feat], dim=1))
        return to_channels_last(self.output(out))


@register_model("A2FSeg")
def build_a2fseg(cfg: dict, device=None, seed: int = 0) -> A2FSeg:
    """Eval-mode A2FSeg from its model-config entry (``modality_num``,
    ``base_num_features``, ``num_classes``, ``num_pool``), He-normal
    seeded convs."""
    dev = resolve_device(device)
    model = A2FSeg(cfg.get("modality_num", 2),
                   cfg.get("base_num_features", 16),
                   cfg.get("num_classes", 2), cfg.get("num_pool", 5))
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
