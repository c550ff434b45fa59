"""SegFormer3D, the reference's ``compared_model/SegFormer/SegFormer.py``,
as ``veloxseg_tpu/models/zoo/segformer3d.py`` builds it: a
MixVisionTransformer encoder (overlapping patch embeddings k = 7/3/3/3,
s = 4/2/2/2; spatial-reduction attention whose scores are divided by
√num_heads, the reference's quirk; a mix-FFN with a depthwise 3³ conv and
a batch norm) and the all-MLP head (a linear embedding + LayerNorm per
level, half-pixel trilinear upsampling to the 1/4 scale, a 1×1 fuse +
batch norm + ReLU, a 1×1 prediction, 4× upsampling of the logits). The
batch norms are :class:`.common.BatchNormNoTrack`; LayerNorms use eps
1e-5.

The upsampling is ``F.interpolate(mode="trilinear",
align_corners=False)``: JAX's ``jax.image.resize(..., "trilinear")``
(``_resize_halfpixel``, 26-29) renormalizes its weights at the border
where torch clamps the source index, which is the same weight when
upsampling (the model only upsamples).

Parameter names: the reference's state-dict keys
(``segformer_encoder.tf_block1.0.attention.key_value``,
``segformer_decoder.linear_fuse.1``), the inverse of
``veloxseg_tpu/interop/zoo_import.py:_map_segformer_key``. Channels-last
in and out; the transformer runs on channels-last tokens.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (BatchNormNoTrack, LayerNorm, Linear, gelu, init_weights_,
                     wide)

_EPS = 1e-5


def resize_halfpixel(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Trilinear, align_corners=False upsampling of a channels-first
    ``(B, C, D, H, W)`` tensor to ``size``."""
    return F.interpolate(x, size=tuple(size), mode="trilinear",
                         align_corners=False)


class SRAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.query = Linear(dim, dim)
        self.key_value = Linear(dim, 2 * dim)
        if sr_ratio > 1:
            self.sr = GroupedConv3d(dim, dim, sr_ratio, stride=sr_ratio,
                                    padding=0)
            self.sr_norm = LayerNorm(dim, _EPS)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: channels-last (B, D, H, W, C)."""
        b, d, h, w, c = x.shape
        heads = self.num_heads
        hd = c // heads
        q = self.query(x).reshape(b, d * h * w, heads, hd).transpose(1, 2)
        src = x
        if self.sr_ratio > 1:
            src = self.sr_norm(to_channels_last(
                self.sr(to_channels_first(x))))
        kv = self.key_value(src).reshape(b, -1, 2, heads, hd)
        k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
        scores = (wide(q) @ wide(k).transpose(-1, -2)) \
            / math.sqrt(heads)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, d, h, w, c)
        return self.proj(out)


class DWConv(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = GroupedConv3d(dim, dim, 3, groups=dim)
        self.bn = BatchNormNoTrack(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_channels_last(self.bn(self.dwconv(to_channels_first(x))))


class MixFFN(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int = 4):
        super().__init__()
        self.fc1 = Linear(dim, dim * mlp_ratio)
        self.dwconv = DWConv(dim * mlp_ratio)
        self.fc2 = Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, _EPS)
        self.attention = SRAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim, _EPS)
        self.mlp = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbedding(nn.Module):
    def __init__(self, in_ch: int, dim: int, kernel: int, stride: int,
                 padding: int):
        super().__init__()
        self.patch_embeddings = GroupedConv3d(in_ch, dim, kernel,
                                              stride=stride,
                                              padding=padding)
        self.norm = LayerNorm(dim, _EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(to_channels_last(
            self.patch_embeddings(to_channels_first(x))))


class MixVisionTransformer(nn.Module):
    def __init__(self, in_channels, embed_dims, patch_kernel_size,
                 patch_stride, patch_padding, num_heads, sr_ratios,
                 mlp_ratios, depths):
        super().__init__()
        cin = in_channels
        for s in range(4):
            self.add_module(f"embed_{s + 1}", PatchEmbedding(
                cin, embed_dims[s], patch_kernel_size[s], patch_stride[s],
                patch_padding[s]))
            self.add_module(f"tf_block{s + 1}", nn.ModuleList(
                TransformerBlock(embed_dims[s], num_heads[s], sr_ratios[s],
                                 mlp_ratios[s]) for _ in range(depths[s])))
            self.add_module(f"norm{s + 1}", LayerNorm(embed_dims[s], _EPS))
            cin = embed_dims[s]

    def forward(self, x: torch.Tensor):
        """Channels-last in; the four stages' channels-last features."""
        feats = []
        for s in range(1, 5):
            x = getattr(self, f"embed_{s}")(x)
            for block in getattr(self, f"tf_block{s}"):
                x = block(x)
            x = getattr(self, f"norm{s}")(x)
            feats.append(x)
        return feats


class MLPEmbed(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.proj = Linear(dim, out_dim)
        self.bn = LayerNorm(out_dim, _EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.proj(x))


class SegFormerHead(nn.Module):
    def __init__(self, embed_dims, decoder_dim: int, num_classes: int):
        super().__init__()
        for i, dim in enumerate(embed_dims):
            self.add_module(f"linear_c{i + 1}", MLPEmbed(dim, decoder_dim))
        self.linear_fuse = nn.Sequential(
            Conv1x1(4 * decoder_dim, decoder_dim, bias=False),
            BatchNormNoTrack(decoder_dim), nn.ReLU())
        self.linear_pred = Conv1x1(decoder_dim, num_classes)

    def forward(self, feats) -> torch.Tensor:
        tgt = feats[0].shape[1:4]
        parts = []
        for i in (4, 3, 2, 1):
            y = to_channels_first(getattr(self, f"linear_c{i}")(
                feats[i - 1]))
            if tuple(y.shape[2:]) != tuple(tgt):
                y = resize_halfpixel(y, tgt)
            parts.append(y)
        logits = self.linear_pred(self.linear_fuse(torch.cat(parts, dim=1)))
        return resize_halfpixel(logits, [4 * t for t in tgt])


class SegFormer3D(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 3,
                 sr_ratios=(4, 2, 1, 1), embed_dims=(32, 64, 160, 256),
                 patch_kernel_size=(7, 3, 3, 3), patch_stride=(4, 2, 2, 2),
                 patch_padding=(3, 1, 1, 1), mlp_ratios=(4, 4, 4, 4),
                 num_heads=(1, 2, 5, 8), depths=(2, 2, 2, 2),
                 decoder_dim: int = 256):
        super().__init__()
        self.segformer_encoder = MixVisionTransformer(
            in_channels, embed_dims, patch_kernel_size, patch_stride,
            patch_padding, num_heads, sr_ratios, mlp_ratios, depths)
        self.segformer_decoder = SegFormerHead(embed_dims, decoder_dim,
                                               num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return to_channels_last(self.segformer_decoder(
            self.segformer_encoder(x)))


@register_model("SegFormer")
def build_segformer3d(cfg: dict, device=None, seed: int = 0) -> SegFormer3D:
    """Eval-mode SegFormer3D from its model-config entry (``in_channels``,
    ``num_classes``), He-normal seeded convs and linears."""
    dev = resolve_device(device)
    model = SegFormer3D(cfg.get("in_channels", 2), cfg.get("num_classes", 3))
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
