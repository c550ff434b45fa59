"""SwinUNETR, the reference's MONAI ``SwinUNETR`` baseline
(``utils/load_model.py:22-24``), as ``veloxseg_tpu/models/zoo/
swin_unetr.py`` builds it: a 2×2×2 conv patch embedding (feature 24),
four Swin stages (depths 2/2/2/2, heads 3/6/12/24, window 7³) each ended by
MONAI's patch merging, a learnable LayerNorm on each of the five hidden
states, and a UNETR-style decoder of residual conv blocks (convs without
bias, affine-free instance norms) with 2×2 transposed-conv upsamples.

Per block, as ``swin_unetr.py:91-136``: the window is clipped to the
feature size and shifted (by half the window, on the odd blocks) only on
the axes where it is smaller than the size; the normalized features are
rolled, zero-padded at the end to whole windows (``_pad_to_windows``)
and split into windows; the attention adds the relative position bias
and, where shifted, the shifted-window mask (0 or −100, ``
_shift_attn_mask``), its scores and softmax in fp32 and the weights cast
to v's dtype before ·V. The bias tables are sized by the clipped
windows, which depend on the input size, so the model is built for an
``img_size`` (default 96³, the AutoPET-II and BraTS tiles; the published
configs name none, and ``load_model(..., input_size=)`` passes the
patch).

Parameter names: the flax paths of the JAX module with ``/`` as ``.``
(``stage0_block1.attn.qkv``, ``stage0_block1.attn.rpb.
relative_position_bias_table``, ``merge0.reduction``, ``hs_norm0``,
``encoder10.conv1``, ``decoder5_deconv``, ``out``): the JAX module's
hidden-state norms and biases are not MONAI's, and the JAX package holds
no MONAI key map. Channels-last in and out.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...nn.norms import instance_norm
from ...nn.pwa import RelativePositionBias
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (ConvTranspose3d, LayerNorm, Linear, gelu, init_weights_,
                     wide)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(padded: Tuple[int, ...], window: Tuple[int, ...],
                     shift: Tuple[int, ...]) -> np.ndarray:
    """The shifted-window mask ``(num_windows, l, l)``: 0 for pairs from
    one pre-shift region, −100 otherwise (``swin_unetr.py:33-50``, its
    slicing kept as it is, also on an axis with no shift)."""
    d, h, w = padded
    img = np.zeros((d, h, w), np.int32)
    cnt = 0

    def slices(s, ws):
        return (slice(0, -ws), slice(-ws, -s), slice(-s, None))
    for sd in slices(shift[0], window[0]):
        for sh in slices(shift[1], window[1]):
            for sw in slices(shift[2], window[2]):
                img[sd, sh, sw] = cnt
                cnt += 1
    wd, wh, ww = window
    img = img.reshape(d // wd, wd, h // wh, wh, w // ww, ww)
    img = img.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


def block_geometry(size: Sequence[int], window: Sequence[int],
                   shifted: bool) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(window, shift) of a block over features of ``size``: the window
    clipped to the size, the shift half the window where it is smaller
    than the size, on the shifted blocks."""
    win = tuple(min(ws, s) for ws, s in zip(window, size))
    shift = tuple(ws // 2 if (shifted and ws < s) else 0
                  for ws, s in zip(win, size))
    return win, shift


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: Sequence[int]):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.rpb = RelativePositionBias(window, num_heads)
        self.proj = Linear(dim, dim)

    def forward(self, xw: torch.Tensor, mask: Optional[torch.Tensor]
                ) -> torch.Tensor:
        """xw: (B·nW, l, C); mask: (nW, l, l) or None."""
        bn, l, c = xw.shape
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(xw).view(bn, l, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                   # (bn, h, l, hd)
        scores = (wide(q) @ wide(k).transpose(-1, -2)) * hd ** -0.5
        scores = scores + wide(self.rpb())
        if mask is not None:
            nw = mask.shape[0]
            scores = (scores.view(bn // nw, nw, h, l, l)
                      + mask[None, :, None]).view(bn, h, l, l)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(bn, l, c))


class SwinBlock(nn.Module):
    """One Swin block over channels-last features of spatial ``size``."""

    def __init__(self, dim: int, num_heads: int, size: Sequence[int],
                 window: Sequence[int] = (7, 7, 7), shifted: bool = False,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.win, self.shift = block_geometry(size, window, shifted)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, self.win)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Linear(dim, int(dim * mlp_ratio))
        self.fc2 = Linear(int(dim * mlp_ratio), dim)
        self._masks = {}   # (padded size, device) -> mask, built once

    def _mask(self, padded: Tuple[int, ...], device) -> torch.Tensor:
        key = (padded, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_attn_mask(
                padded, self.win, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        win, shift = self.win, self.shift
        y = self.norm1(x)
        if any(shift):
            y = torch.roll(y, tuple(-s for s in shift), dims=(1, 2, 3))
        pads = [(ws - s % ws) % ws for s, ws in zip((d, h, w), win)]
        if any(pads):
            y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        pd, ph, pw = y.shape[1:4]
        nd, nh, nw_ = pd // win[0], ph // win[1], pw // win[2]
        y = y.reshape(b, nd, win[0], nh, win[1], nw_, win[2], c)
        y = y.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
            b * nd * nh * nw_, win[0] * win[1] * win[2], c)
        mask = self._mask((pd, ph, pw), y.device) if any(shift) else None
        y = self.attn(y, mask)
        y = y.reshape(b, nd, nh, nw_, win[0], win[1], win[2], c)
        y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, pd, ph, pw, c)
        y = y[:, :d, :h, :w, :]
        if any(shift):
            y = torch.roll(y, shift, dims=(1, 2, 3))
        x = x + y
        z = self.fc2(gelu(self.fc1(self.norm2(x))))
        return x + z


class SwinPatchMerging(nn.Module):
    """MONAI's merging: the 8 stride-2 samples concatenated → LayerNorm →
    Linear(8C → 2C, no bias); odd sizes padded by one at the end."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, h, w = x.shape[1:4]
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        parts = [x[:, i::2, j::2, k::2, :]
                 for i, j, k in itertools.product((0, 1), repeat=3)]
        return self.reduction(self.norm(torch.cat(parts, dim=-1)))


class ResBlock(nn.Module):
    """UnetrBasicBlock: conv 3³ → IN → LeakyReLU, conv 3³ → IN, plus the
    input or its 1×1 projection + IN; convs without bias."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = GroupedConv3d(in_ch, features, 3, bias=False)
        self.conv2 = GroupedConv3d(features, features, 3, bias=False)
        self.project = in_ch != features
        if self.project:
            self.conv3 = GroupedConv3d(in_ch, features, 1, padding=0,
                                       bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(instance_norm(self.conv1(x)), 0.01)
        y = instance_norm(self.conv2(y))
        res = instance_norm(self.conv3(x)) if self.project else x
        return F.leaky_relu(y + res, 0.01)


class SwinUNETR(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 2,
                 img_size: Sequence[int] = (96, 96, 96),
                 feature_size: int = 24, depths=(2, 2, 2, 2),
                 num_heads=(3, 6, 12, 24), window=(7, 7, 7)):
        super().__init__()
        f = feature_size
        self.patch_embed = GroupedConv3d(in_channels, f, 2, stride=2,
                                         padding=0)
        self.stages = []
        size = tuple(s // 2 for s in img_size)
        dim = f
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            names = []
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", SwinBlock(
                    dim, heads, size, window, shifted=j % 2 == 1))
                names.append(f"stage{i}_block{j}")
            self.add_module(f"merge{i}", SwinPatchMerging(dim))
            self.stages.append((names, f"merge{i}"))
            size = tuple((s + 1) // 2 for s in size)
            dim *= 2
        for i in range(len(depths) + 1):
            self.add_module(f"hs_norm{i}", LayerNorm(f * 2 ** i))
        self.encoder1 = ResBlock(in_channels, f)
        self.encoder2 = ResBlock(f, f)
        self.encoder3 = ResBlock(2 * f, 2 * f)
        self.encoder4 = ResBlock(4 * f, 4 * f)
        self.encoder10 = ResBlock(16 * f, 16 * f)
        for name, cin, ch in (("decoder5", 16 * f, 8 * f),
                              ("decoder4", 8 * f, 4 * f),
                              ("decoder3", 4 * f, 2 * f),
                              ("decoder2", 2 * f, f),
                              ("decoder1", f, f)):
            self.add_module(f"{name}_deconv", ConvTranspose3d(cin, ch))
            self.add_module(f"{name}_conv", ResBlock(2 * ch, ch))
        self.out = Conv1x1(f, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_cf = to_channels_first(x)
        h = to_channels_last(self.patch_embed(x_cf))
        hiddens = [h]
        for names, merge in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            h = getattr(self, merge)(h)
            hiddens.append(h)
        hs = [to_channels_first(getattr(self, f"hs_norm{i}")(t))
              for i, t in enumerate(hiddens)]
        enc0 = self.encoder1(x_cf)
        enc1 = self.encoder2(hs[0])
        enc2 = self.encoder3(hs[1])
        enc3 = self.encoder4(hs[2])
        y = self.encoder10(hs[4])
        for name, skip in (("decoder5", hs[3]), ("decoder4", enc3),
                           ("decoder3", enc2), ("decoder2", enc1),
                           ("decoder1", enc0)):
            up = getattr(self, f"{name}_deconv")(y)
            y = getattr(self, f"{name}_conv")(torch.cat([up, skip], dim=1))
        return to_channels_last(self.out(y))


@register_model("SwinUNETR", sized=True)
def build_swin_unetr(cfg: dict, device=None, seed: int = 0) -> SwinUNETR:
    """Eval-mode SwinUNETR from its model-config entry (``in_channels``,
    ``out_channels``, optional ``feature_size``; ``img_size``, default
    96³, sizes the bias tables), He-normal seeded convs and linears, the
    bias tables N(0, 0.02²)."""
    dev = resolve_device(device)
    model = SwinUNETR(cfg.get("in_channels", 2), cfg.get("out_channels", 2),
                      tuple(cfg.get("img_size", (96, 96, 96))),
                      cfg.get("feature_size", 24))
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, RelativePositionBias):
                m.relative_position_bias_table.normal_(0.0, 0.02,
                                                       generator=gen)
    return model.to(dev).eval()
