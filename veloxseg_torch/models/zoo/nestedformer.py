"""NestedFormer, the reference's ``compared_model/NestedFormer/medical/
model/nested_former.py`` baseline, as ``veloxseg_tpu/models/zoo/
nestedformer.py`` builds it: per modality a conv stem and four
global-poolformer stages (a 2³ stride-2 patch embedding, channel LayerNorm,
blocks that add the global mean token spread by a learned per-position map
and a 1×1 channel MLP); at the bottleneck a nested modality-aware fusion
(NMaFa: two blocks of tri-axial and 3-D window self-attention over the
concatenated modalities, then cross attention against a token learner's
32 tokens per modality); and a U-Net up path of 2× transposed convs over
conv-fused skips of every level.

The window attention adds a bias from a ``(m, m, m)`` table indexed by
the shifted relative offsets of the window's points
(:func:`_rel3d_indices`, a copy of the JAX package's); its default window
is (3, 3, 2) (``nestedformer.py:311``). The position maps and embeddings
are sized by the input, so the model is built for an ``image_size``
(default 96³). Its 1/16 bottleneck must be a multiple of the window: at
Hecktor's (128, 128, 64) it is (8, 8, 4), where the JAX module fails in
a reshape, so the builder raises :class:`..registry.CannotRunAtShape`
(a ``ValueError``) there. In training every attention of the fusion
(each block's two axial ones and the cross attention) drops its fp32
weights and its output at 0.1
(``nestedformer.py:122, 126``), drawn from the generator passed to the
forward.

Parameter names: the reference's state-dict keys
(``encoder.encoders.0.conv_0.conv_1.conv_1.0``, ``encoder.encoders.0.
down_1.block_list.0.attn.global_layer``, ``fusion.spatial_att.block_list.
0.attn.window_attention.pos_embedding``, ``fusion.modality_att.
token_mixer.token_conv``, ``fusion.modality_att.cross_attention.
attn_cross.query``, ``upcat_4.upsample``, ``final_conv``), the inverse of
``veloxseg_tpu/interop/zoo_import.py:_map_nestedformer_key``; the cross
attention's ``attention_norm``, which the reference's forward does not
use, is not held. Channels-last in and out.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...nn.norms import InstanceNorm
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import CannotRunAtShape, register_model
from .common import (ConvTranspose3d, Dropout, LayerNorm, Linear, gelu,
                     init_weights_, pointwise, wide)

Gen = Optional[torch.Generator]

FEA = (16, 16, 32, 64, 128, 16)


@functools.lru_cache(maxsize=None)
def _rel3d_indices(window: Tuple[int, int, int]) -> np.ndarray:
    """(l, l, 3): each pair's offset, shifted by the smallest of all."""
    pts = np.array([[x, y, z] for x in range(window[0])
                    for y in range(window[1]) for z in range(window[2])])
    rel = pts[None, :, :] - pts[:, None, :]
    return (rel - rel.min()).astype(np.int64)


class _ConvINReLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_1 = nn.Sequential(GroupedConv3d(in_ch, out_ch, 3),
                                    InstanceNorm(), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_1(x)


class TwoConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_1 = _ConvINReLU(in_ch, out_ch)
        self.conv_2 = _ConvINReLU(out_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_2(self.conv_1(x))


class _FFN(nn.Module):
    """fc1 → GELU → fc2, as 1×1 convs (``conv``) or linears."""

    def __init__(self, dim: int, hidden: int, conv: bool):
        super().__init__()
        make = Conv1x1 if conv else Linear
        self.fc1 = make(dim, hidden)
        self.fc2 = make(hidden, dim)
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv:
            return pointwise(self.fc2, gelu(pointwise(self.fc1, x)))
        return self.fc2(gelu(self.fc1(x)))


class _GlobalPool(nn.Module):
    def __init__(self, n_positions: int):
        super().__init__()
        self.global_layer = nn.Linear(1, n_positions)


class GlobalPoolBlock(nn.Module):
    """The mean token over all positions, times a learned weight plus a
    bias per position, added to the normalized input; then a 1×1 MLP."""

    def __init__(self, hidden: int, mlp_dim: int, n_positions: int):
        super().__init__()
        self.attention_norm = LayerNorm(hidden)
        self.attn = _GlobalPool(n_positions)
        self.ffn_norm = LayerNorm(hidden)
        self.ffn = _FFN(hidden, mlp_dim, conv=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """channels-last ``(B, D, H, W, C)``."""
        b, c = x.shape[0], x.shape[-1]
        y = self.attention_norm(x)
        mean = y.reshape(b, -1, c).mean(dim=1)
        layer = self.attn.global_layer
        g = mean[:, None, :] * layer.weight[:, 0][None, :, None] \
            + layer.bias[None, :, None]
        x = (g.reshape(x.shape) + y) + x
        return self.ffn(self.ffn_norm(x)) + x


class _Embeddings(nn.Module):
    def __init__(self, in_ch: int, hidden: int):
        super().__init__()
        self.patch_embeddings = GroupedConv3d(in_ch, hidden, 2, stride=2,
                                              padding=0)
        self.norm = LayerNorm(hidden, eps=1e-5)


class GlobalPoolformerStage(nn.Module):
    def __init__(self, in_ch: int, hidden: int, size: Sequence[int],
                 num_layers: int = 2):
        super().__init__()
        self.embeddings = _Embeddings(in_ch, hidden)
        n_pos = math.prod(s // 2 for s in size)
        self.block_list = nn.ModuleList(
            GlobalPoolBlock(hidden, 2 * hidden, n_pos)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """channels-first in and out."""
        y = to_channels_last(self.embeddings.patch_embeddings(x))
        y = self.embeddings.norm(y)
        for block in self.block_list:
            y = block(y)
        return to_channels_first(y)


class ModalityEncoder(nn.Module):
    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.conv_0 = TwoConv(1, FEA[0])
        for s in range(1, 5):
            self.add_module(f"down_{s}", GlobalPoolformerStage(
                FEA[s - 1], FEA[s], tuple(d // 2 ** (s - 1) for d in size)))

    def forward(self, x: torch.Tensor):
        feats = [self.conv_0(x)]
        for s in range(1, 5):
            feats.append(getattr(self, f"down_{s}")(feats[-1]))
        return feats


class MHA(nn.Module):
    """Attention with the weights (in fp32) and the output dropped at
    ``drop`` in training."""

    def __init__(self, hidden: int, heads: int = 8, drop: float = 0.1):
        super().__init__()
        self.heads = heads
        self.attn_drop = Dropout(drop)
        self.out_drop = Dropout(drop)
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        self.out = Linear(hidden, hidden)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                generator: Gen = None) -> torch.Tensor:
        b, nq, c = q_in.shape
        nk, h = kv_in.shape[1], self.heads
        q = self.query(q_in).view(b, nq, h, c // h).transpose(1, 2)
        k = self.key(kv_in).view(b, nk, h, c // h).transpose(1, 2)
        v = self.value(kv_in).view(b, nk, h, c // h).transpose(1, 2)
        s = (wide(q) @ wide(k).transpose(-1, -2)) / math.sqrt(c // h)
        a = self.attn_drop(torch.softmax(s, dim=-1), generator).to(v.dtype)
        o = self.out((a @ v).transpose(1, 2).reshape(b, nq, c))
        return self.out_drop(o, generator)


class Window3DAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, window: Sequence[int]):
        super().__init__()
        self.heads = heads
        self.window = tuple(window)
        self.to_qkv = Linear(hidden, 3 * hidden, bias=False)
        self.to_out = Linear(hidden, hidden)
        rel = _rel3d_indices(self.window)
        m = int(rel.max()) + 1
        self.pos_embedding = nn.Parameter(torch.zeros(m, m, m))
        self._rel = torch.from_numpy(rel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, hh, ww, c = x.shape
        wd, wh, w_ = self.window
        heads = self.heads
        hd = c // heads
        nd, nh, nw = d // wd, hh // wh, ww // w_
        l = wd * wh * w_
        qkv = self.to_qkv(x).reshape(b, nd, wd, nh, wh, nw, w_, 3, heads, hd)
        qkv = qkv.permute(7, 0, 8, 1, 3, 5, 2, 4, 6, 9).reshape(
            3, b, heads, nd * nh * nw, l, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        s = (wide(q) @ wide(k).transpose(-1, -2)) / math.sqrt(hd)
        rel = self._rel.to(x.device)
        s = s + wide(self.pos_embedding[rel[..., 0], rel[..., 1],
                                        rel[..., 2]])
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = (a @ v).reshape(b, heads, nd, nh, nw, wd, wh, w_, hd)
        o = o.permute(0, 2, 5, 3, 6, 4, 7, 1, 8).reshape(b, d, hh, ww, c)
        return self.to_out(o)


class _PositionEmbedding(nn.Module):
    def __init__(self, n: int, c: int):
        super().__init__()
        self.position_embeddings = nn.Parameter(torch.zeros(1, n, c))


class _MultiAtt(nn.Module):
    def __init__(self, hidden: int, window, size, is_position: bool):
        super().__init__()
        d, h, w = size
        self.v_attention = MHA(hidden)
        self.h_attention = MHA(hidden)
        self.window_attention = Window3DAttention(hidden, 8, window)
        self.is_position = is_position
        if is_position:
            self.pos_embedding_1 = _PositionEmbedding(h * w, hidden)
            self.pos_embedding_2 = _PositionEmbedding(d, hidden)


class MultiAttBlock(nn.Module):
    """Axial attention over each (H, W) plane and each D column, plus 3-D
    window attention, with a residual; then a linear MLP."""

    def __init__(self, hidden: int, mlp_dim: int, window, size,
                 is_position: bool):
        super().__init__()
        self.attention_norm = LayerNorm(hidden)
        self.attn = _MultiAtt(hidden, window, size, is_position)
        self.ffn_norm = LayerNorm(hidden)
        self.ffn = _FFN(hidden, mlp_dim, conv=False)

    def forward(self, x: torch.Tensor, generator: Gen = None
                ) -> torch.Tensor:
        b, d, h, w, c = x.shape
        y = self.attention_norm(x)
        x1 = y.reshape(b * d, h * w, c)
        x2 = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, d, c)
        a = self.attn
        if a.is_position:
            x1 = x1 + a.pos_embedding_1.position_embeddings
            x2 = x2 + a.pos_embedding_2.position_embeddings
        x1 = a.v_attention(x1, x1, generator).reshape(b, d, h, w, c)
        x2 = a.h_attention(x2, x2, generator).reshape(b, h, w, d, c).permute(
            0, 3, 1, 2, 4)
        x = (x1 + x2 + a.window_attention(y)) + x
        return self.ffn(self.ffn_norm(x)) + x


class _SpatialAtt(nn.Module):
    def __init__(self, in_ch: int, hidden: int, window, size,
                 num_layers: int):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.patch_embeddings = Conv1x1(in_ch, hidden)
        self.block_list = nn.ModuleList(
            MultiAttBlock(hidden, 2 * hidden, window, size, i == 0)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor, generator: Gen = None
                ) -> torch.Tensor:
        q = pointwise(self.embeddings.patch_embeddings, x)
        for block in self.block_list:
            q = block(q, generator)
        return q


class _CrossAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.attn_cross = MHA(hidden)
        self.attention_norm_cross = LayerNorm(hidden)
        self.ffn_norm = LayerNorm(hidden)
        self.ffn = _FFN(hidden, 2 * hidden, conv=False)

    def forward(self, q: torch.Tensor, kv: torch.Tensor,
                generator: Gen = None) -> torch.Tensor:
        y = self.attention_norm_cross(self.attn_cross(q, kv, generator) + q)
        return self.ffn_norm(self.ffn(y) + y)


class _ModalityAtt(nn.Module):
    def __init__(self, model_num: int, hidden: int, n: int, tokens: int):
        super().__init__()
        self.embeddings = nn.ModuleList()
        for _ in range(model_num):
            e = nn.Module()
            e.patch_embeddings = Conv1x1(hidden, hidden)
            e.position_embeddings = nn.Parameter(torch.zeros(1, n, hidden))
            self.embeddings.append(e)
        self.token_mixer = nn.Module()
        self.token_mixer.token_conv = GroupedConv3d(hidden, tokens, 3)
        self.cross_attention = _CrossAttention(hidden)

    def tokens(self, e: torch.Tensor) -> torch.Tensor:
        """TokenLearner: the sigmoid selection maps' weighted means of the
        positions, ``(B, tokens, C)``."""
        b, d, h, w, c = e.shape
        sel = to_channels_last(self.token_mixer.token_conv(
            to_channels_first(e)))
        sel = torch.sigmoid(sel.reshape(b, d * h * w, -1))
        return (sel.transpose(1, 2) @ e.reshape(b, d * h * w, c)) \
            / (d * h * w)

    def forward(self, q_seq: torch.Tensor, feats, generator: Gen = None
                ) -> torch.Tensor:
        kv = []
        for emb, f in zip(self.embeddings, feats):
            e = pointwise(emb.patch_embeddings, f)
            e = e.reshape(e.shape[0], -1, e.shape[-1]) \
                + emb.position_embeddings
            kv.append(self.tokens(e.reshape(f.shape[:-1] + (-1,))))
        return self.cross_attention(q_seq, torch.cat(kv, dim=1), generator)


class Fusion(nn.Module):
    def __init__(self, model_num: int, size, window, self_num_layer: int,
                 token_mixer_size: int):
        super().__init__()
        hidden = FEA[4]
        self.spatial_att = _SpatialAtt(model_num * hidden, hidden, window,
                                       size, self_num_layer)
        self.modality_att = _ModalityAtt(model_num, hidden, math.prod(size),
                                         token_mixer_size)

    def forward(self, feats, generator: Gen = None) -> torch.Tensor:
        """The modalities' channels-last bottlenecks → the fused one."""
        q = self.spatial_att(torch.cat(feats, dim=-1), generator)
        b, d, h, w, c = q.shape
        y = self.modality_att(q.reshape(b, d * h * w, c), feats, generator)
        return y.reshape(b, d, h, w, c)


class UpCat(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.upsample = ConvTranspose3d(in_ch, in_ch // 2)
        self.convs = TwoConv(skip_ch + in_ch // 2, out_ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.convs(torch.cat([skip, self.upsample(x)], dim=1))


class NestedFormer(nn.Module):
    def __init__(self, model_num: int = 2, out_channels: int = 2,
                 image_size: Sequence[int] = (96, 96, 96),
                 window: Sequence[int] = (3, 3, 2), self_num_layer: int = 2,
                 token_mixer_size: int = 32):
        super().__init__()
        bottleneck = tuple(s // 16 for s in image_size)
        if any(b % w for b, w in zip(bottleneck, window)):
            raise CannotRunAtShape(
                f"NestedFormer's window {tuple(window)} does not divide its "
                f"1/16 bottleneck {bottleneck} at image_size "
                f"{tuple(image_size)} (the JAX module cannot run there "
                f"either)")
        self.encoder = nn.Module()
        self.encoder.encoders = nn.ModuleList(
            ModalityEncoder(image_size) for _ in range(model_num))
        self.fusion = Fusion(model_num, bottleneck, window, self_num_layer,
                             token_mixer_size)
        for level in range(5):
            self.add_module(f"fusion_conv_{level + 1}",
                            TwoConv(model_num * FEA[level], FEA[level]))
        self.upcat_4 = UpCat(FEA[4], FEA[3], FEA[3])
        self.upcat_3 = UpCat(FEA[3], FEA[2], FEA[2])
        self.upcat_2 = UpCat(FEA[2], FEA[1], FEA[1])
        self.upcat_1 = UpCat(FEA[1], FEA[0], FEA[5])
        self.final_conv = Conv1x1(FEA[5], out_channels)

    def forward(self, x: torch.Tensor, generator: Gen = None
                ) -> torch.Tensor:
        """``generator`` draws the attentions' dropouts in training."""
        x = to_channels_first(x)
        per_mod = [enc(x[:, m:m + 1])
                   for m, enc in enumerate(self.encoder.encoders)]

        def fuse(level):
            return getattr(self, f"fusion_conv_{level + 1}")(
                torch.cat([f[level] for f in per_mod], dim=1))

        fusion = to_channels_first(self.fusion(
            [to_channels_last(f[4]) for f in per_mod], generator)) + fuse(4)
        u = self.upcat_4(fusion, fuse(3))
        u = self.upcat_3(u, fuse(2))
        u = self.upcat_2(u, fuse(1))
        u = self.upcat_1(u, fuse(0))
        return to_channels_last(self.final_conv(u))


@register_model("NestedFormer", sized="image_size")
def build_nestedformer(cfg: dict, device=None, seed: int = 0
                       ) -> NestedFormer:
    """Eval-mode NestedFormer from its model-config entry (``model_num``,
    ``out_channels``, ``image_size`` (default 96³), ``window_size``
    (default (3, 3, 2))), He-normal seeded convs and linears, the global
    maps N(0, 0.02²) and zero biases, the window table N(0, 1), the
    position embeddings at 0, as the JAX module's init."""
    dev = resolve_device(device)
    model = NestedFormer(cfg.get("model_num", 2), cfg.get("out_channels", 2),
                         tuple(cfg.get("image_size", (96, 96, 96))),
                         tuple(cfg.get("window_size", (3, 3, 2))))
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _GlobalPool):
                m.global_layer.weight.normal_(0.0, 0.02, generator=gen)
                m.global_layer.bias.zero_()
            elif isinstance(m, Window3DAttention):
                m.pos_embedding.normal_(0.0, 1.0, generator=gen)
    return model.to(dev).eval()
