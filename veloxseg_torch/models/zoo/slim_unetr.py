"""SlimUNETR, the reference's ``compared_model/SlimUNETR`` baseline, as
``veloxseg_tpu/models/zoo/slim_unetr.py`` builds it: a strided-conv
encoder (r = 4, 2, 2, 2, each conv followed by ``GroupNorm(1)``), Slim
blocks (a depthwise positional conv, a batch-norm + pointwise local
congregation, 1×1 MLPs, a global attention over every r-th voxel whose
scores are not scaled (the reference defines √head_dim and never applies
it), and a depthwise transposed-conv reverse diffusion + ``GroupNorm(1)``
+ pointwise conv), a learned position embedding at the bottleneck, a
mirrored decoder of transposed convs with additive skips, and a
transposed-conv head. Batch norms are :class:`.common.BatchNormNoTrack`.

The reference's bottleneck quirk is kept (``Decoder.py:58``, ``
slim_unetr.py:117-123``): the ``(B, N, C)`` tokens are reshaped straight
to ``(B, C, D, H, W)``, which scrambles tokens and channels.
``embedding_dim`` must equal the bottleneck's token count (27 at 96³, 32
at 128×128×64, 1 at 32³). In training the tokens pass a dropout at
``dropout`` (0.3 unless the config says otherwise, ``slim_unetr.py:122,
159``) after the position embedding, drawn from the generator passed to
the forward.

Parameter names: the reference's state-dict keys
(``Encoder.DWconv1.depth_wise``, ``Encoder.block1.0.GlobalST.qkv``,
``Decoder.TSconv1.transposed``, ``Decoder.SegHead.norm``), the inverse of
``veloxseg_tpu/interop/zoo_import.py:_make_slim_mapper``; ``GlobalST.qkv``
keeps the reference's row order, (head, q/k/v, channel). Channels-last in
and out.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (BatchNormNoTrack, ConvTranspose3d, Dropout, GroupNorm,
                     gelu, init_weights_, wide)


class _Positional(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.positional_encoding = GroupedConv3d(c, c, 3, groups=c,
                                                 bias=False)


class _LocalRC(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.bn1 = BatchNormNoTrack(c)
        self.pointwise_conv_0 = Conv1x1(c, c, bias=False)
        self.depthwise_conv = GroupedConv3d(c, c, 3, groups=c, bias=False)
        self.bn2 = BatchNormNoTrack(c)
        self.pointwise_conv_1 = Conv1x1(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pointwise_conv_0(self.bn1(x))
        return self.pointwise_conv_1(self.bn2(self.depthwise_conv(y)))


class _LineConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.line_conv_0 = Conv1x1(c, 4 * c, bias=False)
        self.line_conv_1 = Conv1x1(4 * c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.line_conv_1(gelu(self.line_conv_0(x)))


class _GlobalST(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.qkv = Conv1x1(c, 3 * c, bias=False)


class _LocalRD(nn.Module):
    def __init__(self, c: int, r: int):
        super().__init__()
        self.conv_trans = ConvTranspose3d(c, c, r, r, groups=c)
        self.norm = GroupNorm(1, c)
        self.pointwise_conv = Conv1x1(c, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_conv(self.norm(self.conv_trans(x)))


class SlimBlock(nn.Module):
    def __init__(self, c: int, r: int, heads: int):
        super().__init__()
        self.r, self.heads = r, heads
        self.patch1 = _Positional(c)
        self.LocalRC = _LocalRC(c)
        self.LineConv1 = _LineConv(c)
        self.patch2 = _Positional(c)
        self.GlobalST = _GlobalST(c)
        self.LocalRD = _LocalRD(c, r)
        self.LineConv2 = _LineConv(c)

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        s = x[:, :, ::self.r, ::self.r, ::self.r] if self.r > 1 else x
        b, c, d, h, w = s.shape
        hd = c // self.heads
        qkv = self.GlobalST.qkv(s).reshape(b, self.heads, 3, hd, d * h * w)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (b, h, hd, N)
        scores = wide(q).transpose(-1, -2) @ wide(k)    # (b, h, N, N)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = v @ attn.transpose(-1, -2)                    # (b, h, hd, N)
        return self.LocalRD(out.reshape(b, c, d, h, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch1.positional_encoding(x) + x
        x = self.LocalRC(x) + x
        x = self.LineConv1(x) + x
        x = self.patch2.positional_encoding(x) + x
        x = self._attention(x) + x
        return self.LineConv2(x) + x


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int, s: int):
        super().__init__()
        self.depth_wise = GroupedConv3d(cin, cout, s, stride=s, padding=0)
        self.norm = GroupNorm(1, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.depth_wise(x))


class _Up(nn.Module):
    def __init__(self, cin: int, cout: int, s: int):
        super().__init__()
        self.transposed = ConvTranspose3d(cin, cout, s, s)
        self.norm = GroupNorm(1, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.transposed(x))


def _blocks(c: int, n: int, heads: int, r: int) -> nn.Sequential:
    return nn.Sequential(*(SlimBlock(c, r, heads) for _ in range(n)))


class Encoder(nn.Module):
    def __init__(self, in_ch, ch, blocks, heads, r, embedding_dim,
                 dropout):
        super().__init__()
        strides = (4, 2, 2, 2)
        cin = in_ch
        for i in range(4):
            self.add_module(f"DWconv{i + 1}", _Down(cin, ch[i], strides[i]))
            self.add_module(f"block{i + 1}", _blocks(ch[i], blocks[i],
                                                     heads[i], r[i]))
            cin = ch[i]
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, embedding_dim, ch[3]))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        skips = []
        for i in range(1, 5):
            x = getattr(self, f"block{i}")(getattr(self, f"DWconv{i}")(x))
            skips.append(x)
        tokens = self.dropout(
            x.flatten(2).transpose(1, 2) + self.position_embeddings,
            generator)
        # the quirk: (B, N, C) read as (B, C, D, H, W)
        return tokens.contiguous().reshape(x.shape), skips[:3]


class Decoder(nn.Module):
    def __init__(self, out_ch, ch, blocks, heads, r):
        super().__init__()
        for i in range(4):
            self.add_module(f"block{i + 1}", _blocks(ch[i], blocks[i],
                                                     heads[i], r[i]))
        self.TSconv1 = _Up(ch[3], ch[2], 2)
        self.TSconv2 = _Up(ch[2], ch[1], 2)
        self.TSconv3 = _Up(ch[1], ch[0], 2)
        self.SegHead = _Up(ch[0], out_ch, 4)

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        x = self.block4(x)
        x = self.block3(self.TSconv1(x) + skips[2])
        x = self.block2(self.TSconv2(x) + skips[1])
        x = self.block1(self.TSconv3(x) + skips[0])
        return self.SegHead(x)


class SlimUNETR(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 2,
                 embed_dim: int = 96, embedding_dim: int = 27,
                 channels: Sequence[int] = (24, 48, 60),
                 blocks: Sequence[int] = (1, 2, 3, 2),
                 heads: Sequence[int] = (1, 2, 4, 4),
                 r: Sequence[int] = (4, 2, 2, 1), dropout: float = 0.3):
        super().__init__()
        ch = list(channels) + [embed_dim]
        self.Encoder = Encoder(in_channels, ch, blocks, heads, r,
                               embedding_dim, dropout)
        self.Decoder = Decoder(out_channels, ch, blocks, heads, r)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the bottleneck's dropout in training."""
        x, skips = self.Encoder(to_channels_first(x), generator)
        return to_channels_last(self.Decoder(x, skips))


@register_model("SlimUNETR")
def build_slim_unetr(cfg: dict, device=None, seed: int = 0) -> SlimUNETR:
    """Eval-mode SlimUNETR from its model-config entry (``in_channels``,
    ``out_channels``, ``embed_dim``, ``embedding_dim``, optional
    ``channels``, ``blocks``, ``heads``, ``r``, ``dropout``), He-normal
    seeded convs;
    the position embedding at 0, as the JAX module's init."""
    dev = resolve_device(device)
    model = SlimUNETR(
        cfg.get("in_channels", 2), cfg.get("out_channels", 2),
        cfg.get("embed_dim", 96), cfg.get("embedding_dim", 27),
        tuple(cfg.get("channels", (24, 48, 60))),
        tuple(cfg.get("blocks", (1, 2, 3, 2))),
        tuple(cfg.get("heads", (1, 2, 4, 4))),
        tuple(cfg.get("r", (4, 2, 2, 1))), cfg.get("dropout", 0.3))
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
