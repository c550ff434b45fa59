"""UNETR, the reference's MONAI ``UNETR`` baseline (``utils/load_model.py:
18-20``), as ``veloxseg_tpu/models/zoo/unetr.py`` builds it: a ViT-B/16
encoder (hidden 768, 12 layers, 12 heads, MLP 3072, learned position
embeddings over the ``img_size / 16`` grid, a conv patch embedding) whose
layers 3, 6 and 9 and final norm feed a deconv + residual-conv decoder
(feature size 16, convs with bias, per-channel GroupNorm with an affine),
and a 1×1 head. The attention is flax's ``MultiHeadDotProductAttention``:
separate q, k and v projections with biases, q divided by √64, softmax,
an output projection. In training the tokens pass a dropout at
``dropout_rate`` after the position embedding (``unetr.py:102``) and the
attention weights one at flax's default rate (``unetr.py:110``); both
rates are 0.0, as the JAX builder leaves them (it reads no rate from the
config), so the published model draws nothing, but the sites take the
generator passed to the forward.

Parameter names: the flax paths of the JAX module with ``/`` as ``.``
(``patch_embed``, ``pos_embed``, ``l0_attn.query``, ``l0_fc1``,
``encoder2.up_0.conv.conv1``, ``decoder5_deconv``, ``out``); the JAX
module's q/k/v layout is not MONAI's fused ``qkv`` without bias, and the
JAX package holds no MONAI key map. Channels-last in and out; the input's
spatial size must be ``img_size``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (ConvTranspose3d, Dropout, GroupNorm, LayerNorm, Linear,
                     gelu, init_weights_)


class ResConvBlock(nn.Module):
    """UnetrBasicBlock: two conv 3³ + norm with a projected residual."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv1 = GroupedConv3d(in_ch, features, 3)
        self.norm1 = GroupNorm(features, features)
        self.conv2 = GroupedConv3d(features, features, 3)
        self.norm2 = GroupNorm(features, features)
        self.project = in_ch != features
        if self.project:
            self.res_conv = GroupedConv3d(in_ch, features, 1, padding=0)
            self.res_norm = GroupNorm(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        y = self.norm2(self.conv2(y))
        res = self.res_norm(self.res_conv(x)) if self.project else x
        return F.leaky_relu(y + res, 0.01)


class DeconvBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.deconv = ConvTranspose3d(features, features)
        self.conv = ResConvBlock(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.deconv(x))


class PrUpPath(nn.Module):
    """UnetrPrUpBlock: a bare deconv, then ``num_layer`` × (deconv + conv
    block)."""

    def __init__(self, in_ch: int, features: int, num_layer: int):
        super().__init__()
        self.deconv_init = ConvTranspose3d(in_ch, features)
        self.ups = [f"up_{i}" for i in range(num_layer)]
        for name in self.ups:
            self.add_module(name, DeconvBlock(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.deconv_init(x)
        for name in self.ups:
            y = getattr(self, name)(y)
        return y


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no mask):
    ``query``, ``key``, ``value`` and ``out`` projections, each a
    :class:`.common.Linear` with bias; a dropout of the attention weights
    at ``dropout_rate`` (flax's default 0.0)."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = Dropout(dropout_rate)
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim)
        self.value = Linear(dim, dim)
        self.out = Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        d = c // h
        q = self.query(x).view(b, n, h, d).transpose(1, 2) / math.sqrt(d)
        k = self.key(x).view(b, n, h, d).transpose(1, 2)
        v = self.value(x).view(b, n, h, d).transpose(1, 2)
        w = self.attn_drop(torch.softmax(q @ k.transpose(-1, -2), dim=-1),
                           generator)
        return self.out((w @ v).transpose(1, 2).reshape(b, n, c))


class UNETR(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 2,
                 img_size: Sequence[int] = (96, 96, 96),
                 feature_size: int = 16, hidden_size: int = 768,
                 mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12, patch_size: int = 16,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.grid = tuple(s // patch_size for s in img_size)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        n_tokens = math.prod(self.grid)
        self.patch_embed = GroupedConv3d(in_channels, hidden_size,
                                         patch_size, stride=patch_size,
                                         padding=0)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, hidden_size))
        self.pos_drop = Dropout(dropout_rate)
        for i in range(num_layers):
            self.add_module(f"l{i}_norm1", LayerNorm(hidden_size))
            self.add_module(f"l{i}_attn", MultiHeadAttention(hidden_size,
                                                             num_heads))
            self.add_module(f"l{i}_norm2", LayerNorm(hidden_size))
            self.add_module(f"l{i}_fc1", Linear(hidden_size, mlp_dim))
            self.add_module(f"l{i}_fc2", Linear(mlp_dim, hidden_size))
        self.final_norm = LayerNorm(hidden_size)
        f = feature_size
        self.encoder1 = ResConvBlock(in_channels, f)
        self.encoder2 = PrUpPath(hidden_size, 2 * f, 2)
        self.encoder3 = PrUpPath(hidden_size, 4 * f, 1)
        self.encoder4 = PrUpPath(hidden_size, 8 * f, 0)
        for name, cin, ch in (("decoder5", hidden_size, 8 * f),
                              ("decoder4", 8 * f, 4 * f),
                              ("decoder3", 4 * f, 2 * f),
                              ("decoder2", 2 * f, f)):
            self.add_module(f"{name}_deconv", ConvTranspose3d(cin, ch))
            self.add_module(f"{name}_conv", ResConvBlock(2 * ch, ch))
        self.out = Conv1x1(f, out_channels)

    def _vol(self, t: torch.Tensor) -> torch.Tensor:
        """Tokens (B, N, C) → channels-first volume on the patch grid."""
        return t.transpose(1, 2).reshape(t.shape[0], self.hidden_size,
                                         *self.grid)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """``generator`` draws the dropouts in training."""
        x = to_channels_first(x)
        tokens = self.patch_embed(x).flatten(2).transpose(1, 2)
        tokens = self.pos_drop(tokens + self.pos_embed, generator)
        hidden = []
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"l{i}_{name}")  # noqa: E731
            tokens = tokens + layer("attn")(layer("norm1")(tokens),
                                            generator)
            mlp = gelu(layer("fc1")(layer("norm2")(tokens)))
            tokens = tokens + layer("fc2")(mlp)
            hidden.append(tokens)
        z12 = self._vol(self.final_norm(tokens))
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(self._vol(hidden[2]))
        enc3 = self.encoder3(self._vol(hidden[5]))
        enc4 = self.encoder4(self._vol(hidden[8]))
        y = z12
        for name, skip in (("decoder5", enc4), ("decoder4", enc3),
                           ("decoder3", enc2), ("decoder2", enc1)):
            up = getattr(self, f"{name}_deconv")(y)
            y = getattr(self, f"{name}_conv")(torch.cat([up, skip], dim=1))
        return to_channels_last(self.out(y))


@register_model("UNETR")
def build_unetr(cfg: dict, device=None, seed: int = 0) -> UNETR:
    """Eval-mode UNETR from its model-config entry (``in_channels``,
    ``out_channels``, ``img_size``), He-normal seeded convs and linears,
    the position embeddings N(0, 0.02²)."""
    dev = resolve_device(device)
    model = UNETR(cfg.get("in_channels", 2), cfg.get("out_channels", 2),
                  tuple(cfg.get("img_size", (96, 96, 96))))
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        model.pos_embed.normal_(0.0, 0.02, generator=gen)
    return model.to(dev).eval()
