"""HDenseFormer, the reference's ``compared_model/HDense/HDenseFormer.py``
baseline (``HDenseFormer_16``), as ``veloxseg_tpu/models/zoo/hdense.py``
builds it: one dense-transformer branch per modality (a 16³ stride-16
patch embedding, a learned position embedding, ``transformer_depth // 4``
densely connected attention blocks of growth rate 32), their tokens
concatenated and upsampled 2× four times (conv 3³ + affine-free instance
norm + ReLU + half-pixel trilinear 2×) into the skips of a conv U-Net
(conv 3³ without bias + instance norm with an affine + ReLU, max pools,
3³ stride-2 transposed convs with output padding 1 up).

In each dense block the appended feature is a second pass of the same
pre-normed feed-forward over the layer's output (``hdense.py:93-95``, a
reference quirk kept). The upsample is ``jax.image.resize(...,
"trilinear")`` in the JAX module: for an exact 2× upsample that is
``F.interpolate(..., mode="trilinear", align_corners=False)``. The
position embeddings are sized by the token grid, so the model is built for
an ``image_size`` (default 96³). In eval the JAX module returns the full
resolution head alone (``hdense.py:213-218``): the three deep-supervision
heads are parameters here but are not run.

Parameter names: the reference's state-dict keys
(``attns.0.patch_embeddings``, ``attns.0.position_embeddings``,
``attns.0.blocks.0.0.layers.0.1.fn.to_qkv``, ``...layers.0.2.fn.net.3``,
``...out_layer.net.0``, ``deep_conv.double_conv.0``,
``block_1_1_left.norm``, ``upconv_3``, ``conv1x1_d1``), the inverse of
``veloxseg_tpu/interop/zoo_import.py:_map_hdense_key``. Channels-last in
and out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, ConvTranspose3d, GroupedConv3d
from ...nn.norms import InstanceNorm
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import GroupNorm, LayerNorm, Linear, gelu, init_weights_, wide


def resize_2x(x: torch.Tensor) -> torch.Tensor:
    """Half-pixel trilinear 2× upsampling of ``(B, C, D, H, W)``, as
    ``jax.image.resize(..., "trilinear")`` upsamples."""
    return F.interpolate(x, scale_factor=2, mode="trilinear",
                         align_corners=False)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.to_qkv = Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Sequential(Linear(dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.heads
        qkv = self.to_qkv(x).view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                   # (b, h, n, hd)
        scores = (wide(q) @ wide(k).transpose(-1, -2)) * (c // h) ** -0.5
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return self.to_out((attn @ v).transpose(1, 2).reshape(b, n, c))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, hidden), nn.Identity(),
                                 nn.Identity(), Linear(hidden, out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[3](gelu(self.net[0](x)))


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class DenseAttnBlock(nn.Module):
    """DensePreConv_AttentionBlock: per layer a reduce to the growth rate
    over all the features so far, attention and feed-forward with
    residuals, and the feed-forward once more as the appended feature."""

    def __init__(self, dim: int, growth_rate: int = 32, depth: int = 4,
                 heads: int = 8):
        super().__init__()
        g = growth_rate
        self.layers = nn.ModuleList(
            nn.ModuleList([Linear(dim + j * g, g),
                           PreNorm(g, Attention(g, heads)),
                           PreNorm(g, FeedForward(g, 2 * g, g))])
            for j in range(depth))
        self.out_layer = FeedForward(dim + depth * g, 2 * g, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        features = [x]
        for reduce, attn, ff in self.layers:
            h = reduce(torch.cat(features, dim=-1))
            h = attn(h) + h
            h = ff(h) + h
            features.append(ff(h))
        return self.out_layer(torch.cat(features, dim=-1))


class DenseTransformerBranch(nn.Module):
    def __init__(self, dim: int, image_size: Sequence[int], depth: int = 6,
                 patch: int = 16):
        super().__init__()
        self.grid = tuple(s // patch for s in image_size)
        self.patch_embeddings = GroupedConv3d(1, dim, patch, stride=patch,
                                              padding=0)
        n = self.grid[0] * self.grid[1] * self.grid[2]
        self.position_embeddings = nn.Parameter(torch.zeros(1, n, dim))
        self.blocks = nn.ModuleList(nn.ModuleList([DenseAttnBlock(dim)])
                                    for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, D, H, W) → channels-first tokens on the grid."""
        y = to_channels_last(self.patch_embeddings(x))
        b, grid, c = y.shape[0], y.shape[1:4], y.shape[-1]
        y = y.reshape(b, -1, c) + self.position_embeddings
        for block in self.blocks:
            y = block[0](y)
        return to_channels_first(y.reshape(b, *grid, c))


class UpConv(nn.Module):
    """conv 3³ → affine-free instance norm → ReLU → 2× upsample."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.double_conv = nn.Sequential(GroupedConv3d(in_ch, out_ch, 3),
                                         InstanceNorm(), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_2x(self.double_conv(x))


class BasicConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = GroupedConv3d(in_ch, out_ch, 3, bias=False)
        self.norm = GroupNorm(out_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x)))


class HDenseFormer(nn.Module):
    def __init__(self, in_channels: int = 2, n_cls: int = 2,
                 image_size: Sequence[int] = (96, 96, 96),
                 n_filters: int = 16, transformer_depth: int = 24):
        super().__init__()
        nf = n_filters
        self.attns = nn.ModuleList(
            DenseTransformerBranch(4 * nf, image_size,
                                   depth=transformer_depth // 4)
            for _ in range(in_channels))
        self.deep_conv = UpConv(4 * nf * in_channels, 8 * nf)
        self.up1 = UpConv(8 * nf, 4 * nf)
        self.up2 = UpConv(4 * nf, 2 * nf)
        self.up3 = UpConv(2 * nf, nf)
        widths = {1: nf, 2: 2 * nf, 3: 4 * nf, 4: 8 * nf}
        for level, ch in widths.items():
            below = in_channels if level == 1 else widths[level - 1]
            self.add_module(f"block_{level}_1_left", BasicConv(below, ch))
            self.add_module(f"block_{level}_2_left", BasicConv(ch, ch))
        for level in (3, 2, 1):
            ch = widths[level]
            self.add_module(f"upconv_{level}", ConvTranspose3d(
                2 * ch, ch, 3, stride=2, padding=1, output_padding=1))
            self.add_module(f"block_{level}_1_right", BasicConv(2 * ch, ch))
            self.add_module(f"block_{level}_2_right", BasicConv(ch, ch))
        self.conv1x1 = Conv1x1(nf, n_cls)
        for d, ch in ((1, 2 * nf), (2, 4 * nf), (3, 8 * nf)):
            self.add_module(f"conv1x1_d{d}", Conv1x1(ch, n_cls))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_first(x)
        attnall = torch.cat([branch(x[:, m:m + 1])
                             for m, branch in enumerate(self.attns)], dim=1)
        attnout = self.deep_conv(attnall)              # 1/8
        at1 = self.up1(attnout)                        # 1/4
        at2 = self.up2(at1)                            # 1/2
        at3 = self.up3(at2)                            # 1/1

        ds0 = self.block_1_2_left(self.block_1_1_left(x)) + at3
        ds1 = self.block_2_2_left(self.block_2_1_left(
            F.max_pool3d(ds0, 2))) + at2
        ds2 = self.block_3_2_left(self.block_3_1_left(
            F.max_pool3d(ds1, 2))) + at1
        h = self.block_4_2_left(self.block_4_1_left(
            F.max_pool3d(ds2, 2))) + attnout
        for level, skip in ((3, ds2), (2, ds1), (1, ds0)):
            h = torch.cat([getattr(self, f"upconv_{level}")(h), skip], dim=1)
            h = getattr(self, f"block_{level}_1_right")(h)
            h = getattr(self, f"block_{level}_2_right")(h)
        return to_channels_last(self.conv1x1(h))


@register_model("HDense", sized="image_size")
def build_hdense(cfg: dict, device=None, seed: int = 0) -> HDenseFormer:
    """Eval-mode HDenseFormer from its model-config entry (``in_channels``,
    ``n_cls``, ``transformer_depth``; ``image_size``, default 96³, sizes
    the position embeddings), He-normal seeded convs and linears, the
    position embeddings at 0 as the JAX module's."""
    dev = resolve_device(device)
    model = HDenseFormer(cfg.get("in_channels", 2), cfg.get("n_cls", 2),
                         tuple(cfg.get("image_size", (96, 96, 96))),
                         transformer_depth=cfg.get("transformer_depth", 24))
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
