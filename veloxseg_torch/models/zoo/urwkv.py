"""U-RWKV, the zoo baseline the reference runs on its own CUDA WKV kernel
(``compared_model/URWKV/URWKV.py``), as ``veloxseg_tpu/models/zoo/
urwkv.py`` builds it, on the port's WKV kernel K6 (:mod:`..ops.wkv`).

Conv stem → four shallow MultiSE stages and one deep (split) stage with
max-pool downsamples → an RWKV bottleneck that runs the WKV recurrence
over six directional flattenings of the volume (W, H, D forward and
reversed; shared weights; averaged) → nearest-upsample + conv decoder
with concatenated skips. Channels-last in and out, channels-first inside.
Parameter names are the reference's state-dict keys, without the
parameters its forward never reads (``zoo_import.py:_URWKV_DEAD``).

The JAX package's documented quirks, kept:
- ``q_shift`` is a fixed reshape permutation, not a spatial shift
  (:func:`_q_shift_scramble`);
- the bottleneck's "reverse" input is an identity round trip, so the
  block is ``2·forward(x)``;
- WKV takes ``w = spatial_decay / T`` and ``u = spatial_first / T``
  (decay neither negated nor exponentiated);
- batch norms normalize over the batch they are given, in eval mode too;
- GELU is exact (erf); LayerNorms use eps 1e-6, as the JAX package's, and
  round in bf16 as its own LayerNorm does (:mod:`.common`).

The train forward is the eval forward (no dropout; the batch norms take
batch statistics in every mode), as the JAX module's is. Under autograd
the WKV recurrence runs K6 forward and K6b backward (:func:`..ops.wkv.wkv`),
and the gradients reach ``spatial_decay`` and ``spatial_first`` through
their ``/ T``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import GroupedConv3d, he_init_
from ...ops.wkv import wkv
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import BatchNormNoTrack, LayerNorm

_LN_EPS = 1e-6


# --- directional scans: (B, D, H, W, C) -> (B, N, C) and inverse ---------

def _scan(x: torch.Tensor, axis_order: Tuple[int, int, int],
          flip_axis: Optional[int] = None) -> torch.Tensor:
    if flip_axis is not None:
        x = torch.flip(x, dims=(flip_axis,))
    x = x.permute((0,) + axis_order + (4,))
    return x.reshape(x.shape[0], -1, x.shape[-1])


def _scan_inv(seq: torch.Tensor, spatial: Sequence[int],
              axis_order: Tuple[int, int, int],
              flip_axis: Optional[int] = None) -> torch.Tensor:
    b, _, c = seq.shape
    x = seq.reshape(b, *(spatial[i - 1] for i in axis_order), c)
    inv = [0] * 3
    for pos, ax in enumerate(axis_order):
        inv[ax - 1] = pos + 1
    x = x.permute((0,) + tuple(inv) + (4,))
    if flip_axis is not None:
        x = torch.flip(x, dims=(flip_axis,))
    return x


_SCAN_SPECS = [
    ((1, 2, 3), None),   # left_to_right  (W fastest)
    ((1, 2, 3), 3),      # right_to_left  (W flipped)
    ((1, 3, 2), None),   # up_to_down     (H fastest)
    ((1, 3, 2), 2),      # down_to_up     (H flipped)
    ((2, 3, 1), None),   # front_to_back  (D fastest)
    ((2, 3, 1), 1),      # back_to_front  (D flipped)
]


def _q_shift_scramble(x_seq: torch.Tensor,
                      spatial: Sequence[int]) -> torch.Tensor:
    """(B, N, C) memory read as (B, C, D, H, W), then flattened
    channels-last: a fixed permutation (the reference's ``q_shift``)."""
    b, n, c = x_seq.shape
    d, h, w = spatial
    return x_seq.reshape(b, c, d, h, w).permute(0, 2, 3, 4, 1).reshape(b, n, c)


def _fancy_init(c: int, layer_id: int = 0, n_layer: int = 8):
    r01 = layer_id / (n_layer - 1)
    r10 = 1.0 - layer_id / n_layer
    decay = np.array([-5 + 8 * (h / (c - 1)) ** (0.7 + 1.3 * r01)
                      for h in range(c)], np.float32)
    zigzag = np.array([((i + 1) % 3 - 1) * 0.5 for i in range(c)],
                      np.float32)
    first = np.full(c, math.log(0.3), np.float32) + zigzag
    ramp = np.arange(c, dtype=np.float32) / c
    mix_k = ramp ** r10
    mix_v = ramp ** r10 + 0.3 * r01
    mix_r = ramp ** (0.5 * r10)
    return decay, first, mix_k, mix_v, mix_r


def _param(a: np.ndarray, shape=None) -> nn.Parameter:
    t = torch.from_numpy(np.asarray(a, np.float32).copy())
    return nn.Parameter(t.reshape(shape) if shape is not None else t)


def _mix(x: torch.Tensor, xx: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return x * m + xx * (1 - m)


class SpatialMix(nn.Module):
    """The reference's ``allinone_spa``: the RWKV spatial mixing of one
    scan sequence (``SpatialInteractionMix``) with the block's ``ln1`` and
    ``gamma1``, shared by the six scans."""

    def __init__(self, c: int):
        super().__init__()
        decay, first, mk, mv, mr = _fancy_init(c)
        self.spatial_decay = _param(decay)
        self.spatial_first = _param(first)
        self.spatial_mix_k = _param(mk, (1, 1, c))
        self.spatial_mix_v = _param(mv, (1, 1, c))
        self.spatial_mix_r = _param(mr, (1, 1, c))
        self.key = nn.Linear(c, c, bias=False)
        self.value = nn.Linear(c, c, bias=False)
        self.receptance = nn.Linear(c, c, bias=False)
        self.output = nn.Linear(c, c, bias=False)
        self.key_norm = LayerNorm(c, eps=_LN_EPS)
        self.ln1 = LayerNorm(c, eps=_LN_EPS)
        self.gamma1 = nn.Parameter(torch.ones(c))

    def forward(self, x_seq: torch.Tensor,
                spatial: Sequence[int]) -> torch.Tensor:
        xx = _q_shift_scramble(x_seq, spatial)
        k = self.key(_mix(x_seq, xx, self.spatial_mix_k))
        v = self.value(_mix(x_seq, xx, self.spatial_mix_v))
        r = self.receptance(_mix(x_seq, xx, self.spatial_mix_r))
        t = x_seq.shape[1]
        y = wkv((self.spatial_decay / t).contiguous(),
                (self.spatial_first / t).contiguous(), k.contiguous(),
                v.contiguous())
        y = torch.sigmoid(r) * self.key_norm(y)
        return self.output(y)


class SpectralMixer(nn.Module):
    """The block's channel mixing (``ffn``)."""

    def __init__(self, c: int, hidden_rate: int = 4):
        super().__init__()
        _, _, mk, _, mr = _fancy_init(c)
        self.spatial_mix_k = _param(mk, (1, 1, c))
        self.spatial_mix_r = _param(mr, (1, 1, c))
        self.key = nn.Linear(c, c * hidden_rate, bias=False)
        self.key_norm = LayerNorm(c * hidden_rate, eps=_LN_EPS)
        self.value = nn.Linear(c * hidden_rate, c, bias=False)
        self.receptance = nn.Linear(c, c, bias=False)

    def forward(self, x_seq: torch.Tensor,
                spatial: Sequence[int]) -> torch.Tensor:
        xx = _q_shift_scramble(x_seq, spatial)
        k = torch.square(F.relu(self.key(_mix(x_seq, xx,
                                              self.spatial_mix_k))))
        kv = self.value(self.key_norm(k))
        r = self.receptance(_mix(x_seq, xx, self.spatial_mix_r))
        return torch.sigmoid(r) * kv


class LoRABlock(nn.Module):
    """Six-directional RWKV mixing, then the spectral FFN; channels-last
    ``(B, D, H, W, C)`` in and out."""

    def __init__(self, c: int):
        super().__init__()
        self.allinone_spa = SpatialMix(c)
        self.ffn = SpectralMixer(c)
        self.ln2 = LayerNorm(c, eps=_LN_EPS)
        self.gamma2 = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        spatial = (d, h, w)
        spa = self.allinone_spa
        outs = []
        for order, flip in _SCAN_SPECS:
            seq = _scan(x, order, flip)
            seq = seq + spa.gamma1 * spa(spa.ln1(seq), spatial)
            outs.append(_scan_inv(seq, spatial, order, flip))
        y = sum(outs) / len(outs)
        seq = y.reshape(b, d * h * w, c)
        seq = seq + self.gamma2 * self.ffn(self.ln2(seq), spatial)
        return seq.reshape(b, d, h, w, c)


class _DW(nn.Module):
    """A grouped 3×3×3 conv kept under the reference's ``dwconv`` name."""

    def __init__(self, c: int):
        super().__init__()
        self.dwconv = GroupedConv3d(c, c, 3, groups=c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x)


class ConvBnAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1,
                 act: bool = False):
        super().__init__()
        layers = [GroupedConv3d(cin, cout, kernel), BatchNormNoTrack(cout)]
        if act:
            layers.append(nn.GELU())
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class MultiSEShallow(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.dwconv = _DW(cin)
        self.bn_in_c = BatchNormNoTrack(cin)
        self.pwconv_in_in4 = ConvBnAct(cin, cin * 4, act=True)
        self.pwconv_in4_out = ConvBnAct(cin * 4, features, act=True)
        self.residual = cin == features

    def forward(self, x: torch.Tensor):
        y = x + self.bn_in_c(F.gelu(self.dwconv(x)))
        y = self.pwconv_in4_out(self.pwconv_in_in4(y))
        if self.residual:
            y = x + y
        return y, F.max_pool3d(y, 2)


class MultiSEDeep(nn.Module):
    def __init__(self, cin: int, features: int, reduction: int = 8,
                 split: int = 2):
        super().__init__()
        red = features // reduction
        part = red // split
        self.pwconv1 = ConvBnAct(cin, red)
        self.m = nn.ModuleList(_DW(part) for _ in range(reduction - 1))
        self.pwconv2 = ConvBnAct(part * reduction, features)
        self.residual = cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv1(x)
        parts = [y[:, 0::2], y[:, 1::2]]
        for dw in self.m:
            parts.append(dw(parts[-1]))
        parts[0] = parts[0] + parts[1]
        parts.pop(1)
        y = self.pwconv2(torch.cat(parts, dim=1))
        return x + y if self.residual else y


class _Up(nn.Module):
    """``UpsampleConv``: nearest ×2 (the JAX package's ``repeat``), a
    3×3×3 conv, BN, GELU; held as the reference's ``up`` Sequential."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.up = nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                                GroupedConv3d(cin, features, 3),
                                BatchNormNoTrack(features), nn.GELU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class _Fusion(nn.Module):
    """``ChannelFusionConv``: grouped 3×3×3, then two 1×1 convs, each
    followed by GELU and BN; held as the reference's ``conv`` Sequential."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv = nn.Sequential(
            GroupedConv3d(cin, cin, 3, groups=2), nn.GELU(),
            BatchNormNoTrack(cin),
            GroupedConv3d(cin, features * 4, 1), nn.GELU(),
            BatchNormNoTrack(features * 4),
            GroupedConv3d(features * 4, features, 1), nn.GELU(),
            BatchNormNoTrack(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class URWKV(nn.Module):
    """``v_enc_256_fffse_dec_fusion_rwkv_with2x4_3d``; input sides must be
    multiples of 16 (four max-pools)."""

    def __init__(self, in_channels: int, num_classes: int = 2,
                 dims: Tuple[int, ...] = (8, 16, 64, 80, 128)):
        super().__init__()
        self.stem = nn.Sequential(GroupedConv3d(in_channels, dims[0], 3),
                                  BatchNormNoTrack(dims[0]), nn.GELU())
        self.e1 = MultiSEShallow(dims[0], dims[0])
        self.e2 = MultiSEShallow(dims[0], dims[1])
        self.e3 = MultiSEShallow(dims[1], dims[2])
        self.e4 = MultiSEShallow(dims[2], dims[3])
        self.e5 = MultiSEDeep(dims[3], dims[4])
        self.bx4rwkv = LoRABlock(dims[4])
        self.Up5 = _Up(dims[4], dims[3])
        self.Up_conv5 = _Fusion(2 * dims[3], dims[3])
        self.Up4 = _Up(dims[3], dims[2])
        self.Up_conv4 = _Fusion(2 * dims[2], dims[2])
        self.Up3 = _Up(dims[2], dims[1])
        self.Up_conv3 = _Fusion(2 * dims[1], dims[1])
        self.Up2 = _Up(dims[1], dims[0])
        self.Up_conv2 = _Fusion(2 * dims[0], dims[0])
        self.Conv_1x1 = GroupedConv3d(dims[0], num_classes, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Seeded init: He-normal convs and linears (zero conv biases);
        the RWKV parameters at ``_fancy_init``; norms at (1, 0)."""
        he_init_(self, generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.kaiming_normal_(m.weight, a=1e-2, mode="fan_in",
                                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_first(x).contiguous()
        p1 = self.stem(x)
        x1, p2 = self.e1(p1)
        x2, p3 = self.e2(p2)
        x3, p4 = self.e3(p3)
        x4, p5 = self.e4(p4)
        x5 = self.e5(p5)
        x5 = to_channels_first(2.0 * self.bx4rwkv(to_channels_last(x5)))
        d5 = self.Up_conv5(torch.cat([x4, self.Up5(x5)], dim=1))
        d4 = self.Up_conv4(torch.cat([x3, self.Up4(d5)], dim=1))
        d3 = self.Up_conv3(torch.cat([x2, self.Up3(d4)], dim=1))
        d2 = self.Up_conv2(torch.cat([x1, self.Up2(d3)], dim=1))
        return to_channels_last(self.Conv_1x1(d2))


@register_model("U-RWKV")
def build_urwkv(cfg: dict, device=None, seed: int = 0) -> URWKV:
    """Eval-mode U-RWKV from its model-config entry
    (``{"input_channel": .., "num_classes": ..}``), seeded weights."""
    dev = resolve_device(device)
    model = URWKV(cfg["input_channel"], cfg.get("num_classes", 2))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
