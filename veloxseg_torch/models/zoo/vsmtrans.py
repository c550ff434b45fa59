"""VSmTrans, the reference's ``compared_model/VSmTrans/VSmTrans.py``
baseline (``VSmixTUnet``), as ``veloxseg_tpu/models/zoo/vsmtrans.py``
builds it: a 2³ patch embedding, four stages of variable-shape mixed
blocks, each stage ended by a patch merging, an affine-free 12-group norm
on each of the five hidden states (``_group_norm_12``), and a UNETR-style
decoder of residual conv blocks with transposed-conv upsamples.

A block computes qkv once and splits it into four channel groups, each
attending over windows of another shape (w³; (s, H, s); (s, s, W);
(D, s, s), each clipped to the stage's size, :func:`vsa_window`), all with
the stage's full head count; the odd blocks roll by half the window where
it is smaller than the size and add the shifted-window mask
(:func:`_vsm_mask`, a copy of the JAX package's, with its slicing kept).
Per window group as ``vsmtrans.py:97-144``: pad to whole windows, roll,
split the channels with the head fastest (``(hd, heads)``), scale q by
``(4·feature // heads)^-0.5`` (a reference quirk: 4× the true head
width), scores and softmax in fp32 with the relative position bias, the
weights cast to V's dtype before ·V, then the inverse of each step. A
conv branch (GELU(qkv) → linear → LayerNorm → conv 3³ → batch norm →
LeakyReLU) is mixed in by two learned rates. The stages' windows and the
bias tables follow their sizes, so the model is built for an ``img_size``
(default 96³).

The residual blocks are UNETR++'s :class:`.unetrpp.UnetResBlock` with
instance norms, the function of SwinUNETR's ``ResBlock`` under the
reference's names. In eval the JAX module returns the logits alone
(``vsmtrans.py:314-323``): the deep-supervision heads ``out_0`` …
``out_3`` are parameters here, listed in ``TRAIN_ONLY``, and are not run.

Parameter names: the reference's state-dict keys
(``VSmViT.patch_embed.proj``, ``VSmViT.layers1.0.blocks.0.attn.qkv``,
``...attn.attns.0.relative_position_bias_table``, ``...attn.norm2``,
``VSmViT.layers1.1.reduction``, ``encoder1.layer.conv1.conv``,
``decoder5.transp_conv.conv``, ``out.conv.conv``, ``out_0``), the inverse
of ``veloxseg_tpu/interop/zoo_import.py:_map_vsmtrans_key``; the
relative position indices, the batch-norm statistics and the unused
``out_4`` are not held. Channels-last in and out.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...nn.pwa import RelativePositionBias
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (BatchNormNoTrack, ConvTranspose3d, LayerNorm, Linear,
                     gelu, init_weights_, wide)
from .unetrpp import UnetResBlock, _Conv


def vsa_window(idx: int, img: Sequence[int], split: int, window: int
               ) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """(window, shift) of window group ``idx`` over features of ``img``."""
    d, h, w = img
    if idx == 0:
        win = (min(window, d), min(window, h), min(window, w))
    elif idx == 1:
        win = (min(split, d), h, min(split, w))
    elif idx == 2:
        win = (min(split, d), min(split, h), w)
    else:
        win = (d, min(split, h), min(split, w))
    shift = tuple(ws // 2 if s > ws else 0 for ws, s in zip(win, img))
    return win, shift


@functools.lru_cache(maxsize=None)
def _vsm_mask(padded: Tuple[int, ...], window: Tuple[int, ...],
              shift: Tuple[int, ...]) -> np.ndarray:
    """compute_mask parity (``(num_windows, l, l)``: 0 within a region,
    −100 across), incl. its ``slice(-0)`` == whole-axis behavior."""
    img = np.zeros(padded, np.int32)
    cnt = 0

    def ranges(ws, sf):
        return (slice(None, -ws or None), slice(-ws, -sf if sf else None),
                slice(-sf, None) if sf else slice(0, None))

    for sd in ranges(window[0], shift[0]):
        for sh in ranges(window[1], shift[1]):
            for sw in ranges(window[2], shift[2]):
                img[sd, sh, sw] = cnt
                cnt += 1
    wd, wh, ww = window
    d, h, w = padded
    img = img.reshape(d // wd, wd, h // wh, wh, w // ww, ww)
    img = img.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


class VariableShapeAttention(RelativePositionBias):
    """One window shape's attention over a ``(…, 3·c)`` qkv group; its one
    parameter is its relative position bias table."""

    def __init__(self, feature: int, idx: int, split: int, window: int,
                 num_head: int, img_size: Sequence[int], shift: bool):
        win, shift_by = vsa_window(idx, tuple(img_size), split, window)
        super().__init__(win, num_head)
        self.win = win
        self.shift = shift_by if shift else (0, 0, 0)
        self.scale = (4 * feature // num_head) ** -0.5
        self._masks = {}    # (padded size, device) -> mask

    def _mask(self, padded, device) -> torch.Tensor:
        key = (padded, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_vsm_mask(
                padded, self.win, self.shift)).to(device)
        return self._masks[key]

    def forward(self, qkv: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c3 = qkv.shape
        c = c3 // 3
        win, shift = self.win, self.shift
        pads = [(ws - s % ws) % ws for s, ws in zip((d, h, w), win)]
        if any(pads):
            qkv = F.pad(qkv, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        pd, ph, pw = qkv.shape[1:4]
        if any(shift):
            qkv = torch.roll(qkv, tuple(-s for s in shift), dims=(1, 2, 3))
        heads = self.num_heads
        hd = c // heads
        l = win[0] * win[1] * win[2]
        nd, nh, nw_ = pd // win[0], ph // win[1], pw // win[2]
        nw = nd * nh * nw_
        y = qkv.reshape(b, nd, win[0], nh, win[1], nw_, win[2], 3, hd, heads)
        y = y.permute(7, 0, 1, 3, 5, 9, 2, 4, 6, 8).reshape(
            3, b * nw, heads, l, hd)
        q, k, v = y[0] * self.scale, y[1], y[2]
        s = wide(q) @ wide(k).transpose(-1, -2) + wide(super().forward())
        if any(shift):
            s = (s.view(b, nw, heads, l, l)
                 + self._mask((pd, ph, pw), s.device)[None, :, None]
                 ).view(b * nw, heads, l, l)
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = (a @ v).reshape(b, nd, nh, nw_, heads, win[0], win[1], win[2],
                            hd)
        o = o.permute(0, 1, 5, 2, 6, 3, 7, 8, 4).reshape(b, pd, ph, pw, c)
        if any(shift):
            o = torch.roll(o, shift, dims=(1, 2, 3))
        return o[:, :d, :h, :w, :]


class VSmixMSA(nn.Module):
    def __init__(self, feature: int, split: int, window: int, num_head: int,
                 img_size: Sequence[int], shift: bool):
        super().__init__()
        f = feature
        self.qkv = Linear(f, 3 * f)
        self.conv1 = Linear(3 * f, f)
        self.norm1 = LayerNorm(f)
        self.dep_conv = GroupedConv3d(f, f, 3)
        self.norm2 = BatchNormNoTrack(f)
        self.attns = nn.ModuleList(
            VariableShapeAttention(f // 4, i, split, window, num_head,
                                   img_size, shift) for i in range(4))
        self.proj = Linear(f, f)
        self.rate1 = nn.Parameter(torch.full((1,), 0.5))
        self.rate2 = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """channels-last ``(B, D, H, W, C)``."""
        qkv = self.qkv(x)
        cx = self.norm1(self.conv1(gelu(qkv)))
        cx = self.norm2(self.dep_conv(to_channels_first(cx)))
        cx = to_channels_last(F.leaky_relu(cx, 0.01))
        c4 = qkv.shape[-1] // 4
        ax = torch.cat([a(qkv[..., i * c4:(i + 1) * c4])
                        for i, a in enumerate(self.attns)], dim=-1)
        return self.rate1 * self.proj(ax) + self.rate2 * cx


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class VSmixedBlock(nn.Module):
    def __init__(self, feature: int, split: int, window: int, num_head: int,
                 img_size: Sequence[int], shift: bool,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(feature, eps=1e-5)
        self.attn = VSmixMSA(feature, split, window, num_head, img_size,
                             shift)
        self.norm2 = LayerNorm(feature, eps=1e-5)
        self.mlp = _Mlp(feature, int(feature * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VSPatchMerging(nn.Module):
    """The reference's merging, incl. its duplicated sample pattern."""

    OFFSETS = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1),
               (1, 0, 1), (0, 1, 0), (0, 0, 1), (1, 1, 1))

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim, eps=1e-5)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        parts = [x[:, i::2, j::2, k::2, :] for i, j, k in self.OFFSETS]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


def _group_norm_12(x: torch.Tensor) -> torch.Tensor:
    """``F.group_norm(x, 12)`` without an affine, in fp32, of a
    channels-last ``x``; returned channels-first."""
    b, c = x.shape[0], x.shape[-1]
    xf = wide(x).reshape(b, -1, 12, c // 12)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape).to(x.dtype)
    return to_channels_first(y)


class VSmViT(nn.Module):
    def __init__(self, in_channels: int, img_size: Sequence[int],
                 feature_size: int, split_size: Sequence[int], window: int,
                 depths: Sequence[int], num_heads: Sequence[int],
                 patch: int):
        super().__init__()
        f = feature_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = GroupedConv3d(in_channels, f, patch,
                                              stride=patch, padding=0)
        self.patch_embed.norm = LayerNorm(f, eps=1e-5)
        size = tuple(img_size)
        for i in range(4):
            size = tuple((s + 1) // 2 for s in size)
            fi = f * 2 ** i
            blocks = [VSmixedBlock(fi, split_size[i], window, num_heads[i],
                                   size, shift=j % 2 == 1)
                      for j in range(depths[i])]
            # the reference's ``layers{i}``: (a stage of blocks, merging)
            stage = nn.ModuleList([nn.Module(), VSPatchMerging(fi)])
            stage[0].blocks = nn.ModuleList(blocks)
            self.add_module(f"layers{i + 1}", stage)

    def forward(self, x: torch.Tensor):
        """channels-first input → the five normalized hidden states,
        channels-first."""
        h = to_channels_last(self.patch_embed.proj(x))
        h = self.patch_embed.norm(h)
        hiddens = []
        for i in range(4):
            stage = getattr(self, f"layers{i + 1}")
            for block in stage[0].blocks:
                h = block(h)
            hiddens.append(_group_norm_12(h))
            h = stage[1](h)
        hiddens.append(_group_norm_12(h))
        return hiddens


class _Encoder(nn.Module):
    """The reference's UnetrBasicBlock: the residual block as ``layer``."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.layer = UnetResBlock(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class _Decoder(nn.Module):
    """The reference's UnetrUpBlock: transposed conv (no bias), the skip
    concatenated, a residual block."""

    def __init__(self, in_ch: int, out_ch: int, k: int = 2):
        super().__init__()
        self.transp_conv = _Conv(ConvTranspose3d(in_ch, out_ch, k, k,
                                                 bias=False))
        self.conv_block = UnetResBlock(2 * out_ch, out_ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=1))


class VSmixTUnet(nn.Module):
    TRAIN_ONLY = ("out_0", "out_1", "out_2", "out_3")

    def __init__(self, in_channels: int = 2, out_channels: int = 2,
                 img_size: Sequence[int] = (96, 96, 96),
                 feature_size: int = 24, split_size=(1, 2, 3, 4),
                 window: int = 6, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), patch: int = 2):
        super().__init__()
        f = feature_size
        self.VSmViT = VSmViT(in_channels, img_size, f, split_size, window,
                             depths, num_heads, patch)
        self.encoder1 = _Encoder(in_channels, f)
        self.encoder2 = _Encoder(f, f)
        self.encoder3 = _Encoder(2 * f, 2 * f)
        self.encoder4 = _Encoder(4 * f, 4 * f)
        self.encoder5 = _Encoder(8 * f, 8 * f)
        self.decoder5 = _Decoder(16 * f, 8 * f)
        self.decoder4 = _Decoder(8 * f, 4 * f)
        self.decoder3 = _Decoder(4 * f, 2 * f)
        self.decoder2 = _Decoder(2 * f, f)
        self.decoder1 = _Decoder(f, f, patch)
        self.out = _Conv(_Conv(Conv1x1(f, out_channels)))
        for i, ch in enumerate((f, 2 * f, 4 * f, 8 * f)):
            self.add_module(f"out_{i}", Conv1x1(ch, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_channels_first(x)
        hs0, hs1, hs2, hs3, hs4 = self.VSmViT(x)
        enc0 = self.encoder1(x)
        dec3 = self.decoder5(hs4, self.encoder5(hs3))
        dec2 = self.decoder4(dec3, self.encoder4(hs2))
        dec1 = self.decoder3(dec2, self.encoder3(hs1))
        dec0 = self.decoder2(dec1, self.encoder2(hs0))
        out = self.decoder1(dec0, enc0)
        return to_channels_last(self.out(out))


def _patch(cfg: dict) -> int:
    p = cfg.get("patch_size", 2)
    return p[0] if isinstance(p, (list, tuple)) else p


@register_model("VSmTrans", sized=True)
def build_vsmtrans(cfg: dict, device=None, seed: int = 0) -> VSmixTUnet:
    """Eval-mode VSmTrans from its model-config entry (``in_channels``,
    ``out_channels``, ``img_size`` (default 96³; it sizes the windows and
    the bias tables), ``feature_size``, ``split_size``, ``window_size``,
    ``depths``, ``num_heads``, ``patch_size``), He-normal seeded convs and
    linears, the bias tables N(0, 0.02²), the rates 0.5."""
    dev = resolve_device(device)
    model = VSmixTUnet(cfg.get("in_channels", 2), cfg.get("out_channels", 2),
                       tuple(cfg.get("img_size", (96, 96, 96))),
                       cfg.get("feature_size", 24),
                       tuple(cfg.get("split_size", (1, 2, 3, 4))),
                       cfg.get("window_size", 6),
                       tuple(cfg.get("depths", (2, 2, 2, 2))),
                       tuple(cfg.get("num_heads", (3, 6, 12, 24))),
                       _patch(cfg))
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, RelativePositionBias):
                m.relative_position_bias_table.normal_(0.0, 0.02,
                                                       generator=gen)
    return model.to(dev).eval()
