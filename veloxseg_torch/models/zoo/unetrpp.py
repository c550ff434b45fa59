"""UNETR++, the reference's ``compared_model/unetr_pp/.../unetr_pp_tumor.py``
baseline, as ``veloxseg_tpu/models/zoo/unetrpp.py`` builds it: a conv
stem (k = 4, s = 4, ``GroupNorm(in_channels)``) and k = 2 downsamples
(``GroupNorm`` over the previous width), stages of Efficient Paired
Attention blocks (shared q/k; a channel attention with a learnable
per-head temperature over L2-normalized q and k, plus a spatial attention
through a learned sequence projection ``EF``, whose size is the stage's
token count from the configured ``patch_size``), each followed by a
batch-norm UnetResBlock and a 1×1 conv; a decoder of transposed convs with
additive skips and EPA blocks, the last stage conv-only. The reference's
spatial-path scramble (``transformerblock.py:131``) is kept. Batch norms
are :class:`.common.BatchNormNoTrack`; the "instance" blocks are
affine-free instance norms.

In eval the model returns the primary head alone (``unetrpp.py:201-212``);
the deep-supervision heads ``out2`` and ``out3`` are parameters the JAX
trainer's checkpoints hold, listed in ``TRAIN_ONLY`` so that the speed
CLI counts the eval model's parameters.

Parameter names: the reference's state-dict keys
(``unetr_pp_encoder.downsample_layers.0.0.conv``,
``unetr_pp_encoder.stages.0.0.epa_block.qkvv``,
``decoder5.decoder_block.0.1.conv51.conv1.conv``, ``out1.conv.conv``),
the inverse of ``veloxseg_tpu/interop/zoo_import.py:_map_unetrpp_key``.
Channels-last in and out.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...nn.norms import InstanceNorm
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (BatchNormNoTrack, ChannelDropout, ConvTranspose3d,
                     GroupNorm, LayerNorm, Linear, init_weights_, wide)


class _Conv(nn.Module):
    """MONAI's ``Convolution`` wrapper: the conv as its ``conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UnetResBlock(nn.Module):
    """conv 3³ → norm → LeakyReLU, conv 3³ → norm, plus the input or its
    1×1 projection + norm; convs without bias."""

    def __init__(self, in_ch: int, features: int, norm: str = "instance"):
        super().__init__()

        def make_norm():
            return (BatchNormNoTrack(features) if norm == "batch"
                    else InstanceNorm())
        self.conv1 = _Conv(GroupedConv3d(in_ch, features, 3, bias=False))
        self.norm1 = make_norm()
        self.conv2 = _Conv(GroupedConv3d(features, features, 3, bias=False))
        self.norm2 = make_norm()
        self.project = in_ch != features
        if self.project:
            self.conv3 = _Conv(GroupedConv3d(in_ch, features, 1, padding=0,
                                             bias=False))
            self.norm3 = make_norm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        y = self.norm2(self.conv2(y))
        res = self.norm3(self.conv3(x)) if self.project else x
        return F.leaky_relu(y + res, 0.01)


def _l2norm(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)


class EPA(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.qkvv = Linear(hidden_size, 4 * hidden_size, bias=False)
        self.EF = nn.Parameter(torch.zeros(input_size, proj_size))
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.temperature2 = nn.Parameter(torch.ones(num_heads, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkvv = self.qkvv(x).reshape(b, n, 4, h, c // h).permute(2, 0, 3, 4, 1)
        q, k, v_ca, v_sa = qkvv[0], qkvv[1], qkvv[2], qkvv[3]  # (b,h,hd,n)
        k_proj = k @ self.EF
        v_sa_proj = v_sa @ self.EF
        qn, kn = _l2norm(q), _l2norm(k)
        attn_ca = (wide(qn) @ wide(kn).transpose(-1, -2)) \
            * wide(self.temperature)
        attn_ca = torch.softmax(attn_ca, dim=-1).to(v_ca.dtype)
        x_ca = (attn_ca @ v_ca).permute(0, 3, 1, 2).reshape(b, n, c)
        attn_sa = (wide(qn).transpose(-1, -2) @ wide(k_proj)) \
            * wide(self.temperature2)
        attn_sa = torch.softmax(attn_sa, dim=-1).to(v_sa.dtype)
        x_sa = attn_sa @ v_sa_proj.transpose(-1, -2)         # (b, h, n, hd)
        # the reference's scramble: (b, h, n, hd) → (b, hd, h, n) → (b, n, c)
        x_sa = x_sa.permute(0, 3, 1, 2).reshape(b, n, c)
        return x_ca + x_sa


class TransformerBlock(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, proj_size: int,
                 num_heads: int):
        super().__init__()
        c = hidden_size
        self.norm = LayerNorm(c, 1e-5)
        self.gamma = nn.Parameter(1e-6 * torch.ones(c))
        self.epa_block = EPA(input_size, c, proj_size, num_heads)
        self.conv51 = UnetResBlock(c, c, norm="batch")
        self.conv8 = nn.Sequential(ChannelDropout(0.1), Conv1x1(c, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, input_size, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = x.flatten(2).transpose(1, 2) + self.pos_embed
        seq = seq + self.gamma * self.epa_block(self.norm(seq))
        vol = seq.transpose(1, 2).reshape(x.shape)
        return vol + self.conv8(self.conv51(vol))


class UnetrPPEncoder(nn.Module):
    def __init__(self, in_ch, dims, depths, input_sizes, proj_sizes,
                 num_heads):
        super().__init__()
        layers = [nn.Sequential(
            _Conv(GroupedConv3d(in_ch, dims[0], 4, stride=4, padding=0,
                                bias=False)),
            GroupNorm(in_ch, dims[0]))]
        for i in range(1, 4):
            layers.append(nn.Sequential(
                _Conv(GroupedConv3d(dims[i - 1], dims[i], 2, stride=2,
                                    padding=0, bias=False)),
                GroupNorm(dims[i - 1], dims[i])))
        self.downsample_layers = nn.ModuleList(layers)
        self.stages = nn.ModuleList(
            nn.Sequential(*(TransformerBlock(input_sizes[i], dims[i],
                                             proj_sizes[i], num_heads)
                            for _ in range(depths[i])))
            for i in range(4))

    def forward(self, x: torch.Tensor):
        hidden = []
        for down, stage in zip(self.downsample_layers, self.stages):
            x = stage(down(x))
            hidden.append(x)
        return hidden


class UnetrUpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, input_size: int,
                 num_heads: int, up_k: int = 2, conv_decoder: bool = False):
        super().__init__()
        self.transp_conv = _Conv(ConvTranspose3d(in_ch, out_ch, up_k, up_k,
                                                 bias=False))
        if conv_decoder:
            self.decoder_block = nn.ModuleList([UnetResBlock(out_ch, out_ch)])
        else:
            self.decoder_block = nn.ModuleList([nn.Sequential(
                *(TransformerBlock(input_size, out_ch, 64, num_heads)
                  for _ in range(3)))])

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.decoder_block[0](self.transp_conv(x) + skip)


class _OutBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = _Conv(Conv1x1(in_ch, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNETRPP(nn.Module):
    TRAIN_ONLY = ("out2", "out3")   # the deep-supervision heads

    def __init__(self, in_channels: int, out_channels: int = 2,
                 patch_size: Sequence[int] = (96, 96, 96),
                 feature_size: int = 16, num_heads: int = 4,
                 depths=(3, 3, 3, 3), dims=(32, 64, 128, 256),
                 proj_sizes=(64, 64, 64, 32)):
        super().__init__()
        sizes = [math.prod(s // 2 ** i for s in patch_size)
                 for i in range(2, 6)]
        f = feature_size
        self.unetr_pp_encoder = UnetrPPEncoder(
            in_channels, dims, depths, sizes, proj_sizes, num_heads)
        self.encoder1 = UnetResBlock(in_channels, f)
        self.decoder5 = UnetrUpBlock(dims[3], 8 * f, sizes[2], num_heads)
        self.decoder4 = UnetrUpBlock(8 * f, 4 * f, sizes[1], num_heads)
        self.decoder3 = UnetrUpBlock(4 * f, 2 * f, sizes[0], num_heads)
        self.decoder2 = UnetrUpBlock(2 * f, f, math.prod(patch_size),
                                     num_heads, up_k=4, conv_decoder=True)
        self.out1 = _OutBlock(f, out_channels)
        self.out2 = _OutBlock(2 * f, out_channels)
        self.out3 = _OutBlock(4 * f, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_first(x)
        conv_block = self.encoder1(x)
        enc1, enc2, enc3, enc4 = self.unetr_pp_encoder(x)
        dec3 = self.decoder5(enc4, enc3)
        dec2 = self.decoder4(dec3, enc2)
        dec1 = self.decoder3(dec2, enc1)
        out = self.decoder2(dec1, conv_block)
        return to_channels_last(self.out1(out))


@register_model("UNETRpp")
def build_unetrpp(cfg: dict, device=None, seed: int = 0) -> UNETRPP:
    """Eval-mode UNETR++ from its model-config entry (``in_channels``,
    ``out_channels``, ``patch_size``, ``feature_size``, ``num_heads``,
    ``depths``, ``dims``; ``unetrpp.py:215-225``), He-normal seeded convs
    and linears, ``EF`` U(−1/√proj, 1/√proj) as the reference's init."""
    dev = resolve_device(device)
    model = UNETRPP(cfg.get("in_channels", 2), cfg.get("out_channels", 2),
                    tuple(cfg.get("patch_size", (96, 96, 96))),
                    cfg.get("feature_size", 16), cfg.get("num_heads", 4),
                    tuple(cfg.get("depths", (3, 3, 3, 3))),
                    tuple(cfg.get("dims", (32, 64, 128, 256))))
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, EPA):
                bound = 1.0 / math.sqrt(m.EF.shape[1])
                m.EF.uniform_(-bound, bound, generator=gen)
    return model.to(dev).eval()
