"""Dual-branch encoder: the JLC conv pyramid and the per-modality PWA
pyramid, joined by the attn2conv 1×1+IN mixers (``model/Encoder.py``).
Channels-first throughout."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..core.config import VeloxSegConfig
from .basic import Conv1x1
from .conv_blocks import DownConv, JLCLayer
from .norms import InstanceNorm
from .patch import PatchEmbed
from .pwa import TransformerStage


class ConvEncoder(nn.Module):
    """4-level JLC pyramid (``model/Encoder.py:13-85``): ``down{k}`` and
    ``layer{k}``; the fused :class:`Encoder` interleaves them with the
    attention features."""

    def __init__(self, cfg: VeloxSegConfig):
        super().__init__()
        c = cfg.base_ch
        for i in range(cfg.num_levels):
            ci = c * 2 ** i
            cin = sum(cfg.in_ch) if i == 0 else c * 2 ** (i - 1)
            setattr(self, f"down{i + 1}", DownConv(
                cin, ci, patch_size=cfg.patch_size if i == 0 else 2))
            setattr(self, f"layer{i + 1}", JLCLayer(
                ci, cfg.conv_depths[i], cfg.kernel_sizes,
                ci // cfg.min_dim_group[i], cfg.conv_expansion_factor[i]))


class TransformerEncoder(nn.Module):
    """Per-modality PWA pyramid (``model/Encoder.py:88-204``)."""

    def __init__(self, cfg: VeloxSegConfig):
        super().__init__()
        m_count = cfg.num_modalities
        self.patch_embeds = nn.ModuleList(
            PatchEmbed(c, cfg.attn_base_ch, cfg.patch_size, cfg.patch_norm)
            for c in cfg.in_ch)
        size = tuple(s // cfg.patch_size for s in cfg.input_size)
        layers = []
        n = len(cfg.depths)
        for i in range(n):
            layers.append(TransformerStage(
                input_size=size,
                in_channels=(cfg.attn_base_ch * 2 ** i,) * m_count,
                depth=cfg.depths[i],
                min_big_window=cfg.min_big_window_sizes[i],
                min_small_window=cfg.min_small_window_sizes[i],
                scale_factor=cfg.scale_factors[i],
                num_heads=cfg.num_heads[i],
                min_dim_head=cfg.min_dim_head[i],
                ffn_expansion_ratio=cfg.ffn_expansion_ratio[i],
                act_layer=cfg.act_layer,
                qkv_bias=cfg.qkv_bias,
                do_downsample=i < n - 1))
            size = tuple(s // 2 for s in size)
        self.layers = nn.ModuleList(layers)

    def forward(self, xs: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
        """Per-level lists of per-modality features, finest first."""
        xs = [pe(x) for pe, x in zip(self.patch_embeds, xs)]
        feats = []
        for stage in self.layers:
            xs, down = stage(xs)
            feats.append(xs)
            if down is not None:
                xs = down
        return feats


class Encoder(nn.Module):
    """Fused dual-stream encoder (``model/Encoder.py:207-367``).

    Returns the fused conv features, finest first. The attention pyramid
    feeds the mixers; eval does not return it (the teachers that read it
    train only)."""

    def __init__(self, cfg: VeloxSegConfig):
        super().__init__()
        self.in_ch = tuple(cfg.in_ch)
        self.num_levels = cfg.num_levels
        self.encoder_attn = TransformerEncoder(cfg)
        self.encoder_conv = ConvEncoder(cfg)
        for i in range(cfg.num_levels):
            ca = cfg.attn_base_ch * 2 ** i
            ci = cfg.base_ch * 2 ** i
            setattr(self, f"attn2conv_{i + 1}", nn.Sequential(
                Conv1x1(cfg.num_modalities * ca, ci), InstanceNorm()))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        xs = list(torch.split(x, self.in_ch, dim=1))
        attn_feats = self.encoder_attn(xs)
        conv = self.encoder_conv
        encs = []
        h = x
        for i in range(self.num_levels):
            mixer = getattr(self, f"attn2conv_{i + 1}")
            mixed = mixer(torch.cat(attn_feats[i], dim=1))
            h = getattr(conv, f"down{i + 1}")(h) + mixed
            h = getattr(conv, f"layer{i + 1}")(h)
            encs.append(h)
        return encs
