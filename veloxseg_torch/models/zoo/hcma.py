"""HCMA-UNet, the reference's ``compared_model/HCMA/HCMA.py:1299``
baseline, as ``veloxseg_tpu/models/zoo/hcma.py`` builds it (the default
flags: depth 4, channels (32, 64, 128, 256, 512), strides (2, 2, 2, 1),
DenseConv blocks, the channel split, the slice attention, no skip
branch): a DenseConv stem, four Down levels (average pool ⊕ a strided
ResNeXt conv, a triplane Mamba, a DenseConv), four Up levels (1×1 adapt +
instance norm + LeakyReLU, + the pre-extractor skip, a transposed conv of
kernel = stride) and a 1×1 head. In training the DenseConv blocks of the
Down levels drop their depthwise branch at r and their expansion at 2r,
r = (0.025, 0.05, 0.1, 0.1) by level (``hcma.py:75, 79-80``; the stem's
r is 0), and the head drops its input at 0.1 (``hcma.py:421``), drawn
from the generator passed to the forward; SS2D's dropout is at 0, so it
has no site (``hcma.py:214-216``).

The triplane Mamba splits the channels (C/2, C/4, C/4) over three
directional branches, one per axis D, H, W (``hcma.py:300-324``): each
runs a VSS block over the 2-D slices across its axis (SS2D: a depthwise
3² conv, the selective scan in four directions, row- and column-major and
their flips, summed back to row-major order, ``t_back``, then a LayerNorm
of eps 1e-5 gated by SiLU(z)), and an attention along its axis with a
learned position embedding, scores in fp32 and a sigmoid-gated residual
(``hcma.py:237-271``). The scan is :func:`..ops.selective_scan.
selective_scan`, torch ops (the JAX module's is ``jax.lax.
associative_scan``, XLA, not a Pallas kernel); its four directions run as
one call, where the JAX module ``vmap``\\ s over them. The axial position
tables are sized by ``patch_ini`` (at 96³ the levels are 48, 24, 12, 12).

The JAX module's Up is a Dense of width O·s³ and a pixel shuffle; here it
is the reference's ConvTranspose3d with kernel = stride, the same function
with the reference's O-length bias (``interop/zoo_params.py`` checks that
the JAX bias repeats it).

Computed channels-last as the JAX module; the 1×1 convs of the reference
run over the last axis (:func:`.common.pointwise`).

Parameter names: the reference's state-dict keys
(``encoders.0.conv_list.0.0``, ``encoders.1.downsample_resnext.
conv_list.1.1``, ``encoders.1.tmamba.mamba_x.mamba.self_attention.
A_logs``, ``...slice_attention.pos_embed``, ``encoders.1.tmamba.fusion.0``,
``decoders.0.extractor.0.1``, ``decoders.1.up_transpose``,
``out.3.conv1``), the inverse of ``veloxseg_tpu/interop/zoo_import.py:
_map_hcma_key``; the three heads the predict mode does not run
(``out.0``-``out.2``) are not held. Channels-last in and out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...nn.norms import instance_norm
from ...ops.selective_scan import selective_scan
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import (ConvTranspose3d, Dropout, LayerNorm, Linear, _normalize,
                     gelu, init_weights_, pointwise, wide)

Gen = Optional[torch.Generator]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


def _conv_cl(conv: nn.Module, x: torch.Tensor, ncdhw: bool = False
             ) -> torch.Tensor:
    """A channels-first conv on a channels-last ``x``: on its
    channels-first view, or with ``ncdhw`` on a contiguous copy."""
    x = to_channels_first(x)
    return to_channels_last(conv(x.contiguous() if ncdhw else x))


class InstanceNormAffine(nn.Module):
    """``GroupNorm(C, C)`` of a channels-last ``x``: per sample and channel
    over the spatial axes, eps 1e-5, then the affine in x's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _normalize(x, tuple(range(1, x.dim() - 1)), 1e-5)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class DenseConvBlock(nn.Module):
    """Depthwise 3³ + instance norm, then a dense 1×1 expand (GELU) and a
    dense 1×1 out over the concatenated features (+ x at equal width); in
    training the norm's output drops at ``dropout_rate`` and the expansion
    at twice it."""

    def __init__(self, in_ch: int, out_ch: int, expand_rate: int = 4,
                 dropout_rate: float = 0.0):
        super().__init__()
        c = in_ch
        self.drop1 = Dropout(dropout_rate)
        self.drop2 = Dropout(2 * dropout_rate)
        self.conv_list = nn.ModuleList([
            nn.Sequential(GroupedConv3d(c, c, 3, groups=c),
                          InstanceNormAffine(c)),
            nn.Sequential(Conv1x1(2 * c, c * expand_rate)),
            nn.Sequential(Conv1x1(2 * c + c * expand_rate, out_ch))])
        self.residual = in_ch == out_ch

    def forward(self, x: torch.Tensor, generator: Gen = None
                ) -> torch.Tensor:
        x1 = self.drop1(self.conv_list[0][1](_conv_cl(self.conv_list[0][0],
                                                      x)), generator)
        x2 = self.drop2(gelu(pointwise(self.conv_list[1][0],
                                       torch.cat([x, x1], dim=-1))),
                        generator)
        out = pointwise(self.conv_list[2][0], torch.cat([x, x1, x2], dim=-1))
        return out + x if self.residual else out


class ResNeXtConv(nn.Module):
    """1×1 expand → grouped 3³ (groups = in channels, the stride) → 1×1,
    each followed by instance norm + LeakyReLU; the downsampling one adds
    no residual (``hcma.py:84-88``).

    The grouped conv runs on a contiguous NCDHW copy. On the view, cuDNN
    takes a channels-last kernel whose rounding the model's ill-conditioned
    scan branches amplify: on an H100, the fp32 forward of a served
    case's padded tile lay 0.640 from its float64 logits (scale 42.4),
    against 0.182 on the copy and 0.124 on the CPU, and the copy's bf16
    batch-16 forward was no slower (601.1 against 614.9 ms;
    ``tools/fp32_drift.py --variants``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 expand_rate: int = 2):
        super().__init__()
        e = in_ch * expand_rate
        self.conv_list = nn.ModuleList([
            nn.Sequential(Conv1x1(in_ch, e), InstanceNormAffine(e)),
            nn.Sequential(GroupedConv3d(e, e, 3, groups=in_ch,
                                        stride=stride),
                          InstanceNormAffine(e)),
            nn.Sequential(Conv1x1(e, out_ch), InstanceNormAffine(out_ch))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _lrelu(self.conv_list[0][1](pointwise(self.conv_list[0][0], x)))
        y = _lrelu(self.conv_list[1][1](_conv_cl(self.conv_list[1][0], y,
                                                 ncdhw=True)))
        return _lrelu(self.conv_list[2][1](pointwise(self.conv_list[2][0], y)))


class SS2D(nn.Module):
    """The 2-D selective-scan block over channels-last slices ``(N, H, W,
    C)`` (``forward_corev0``), its parameters K-stacked as the
    reference's."""

    K = 4

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3,
                 expand: float = 0.5):
        super().__init__()
        d_inner = int(expand * d_model)
        self.d_inner = d_inner
        self.dt_rank = math.ceil(d_model / 16)
        self.d_state = d_state
        k = self.K
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = nn.Conv2d(d_inner, d_inner, d_conv,
                                padding=(d_conv - 1) // 2, groups=d_inner)
        self.x_proj_weight = nn.Parameter(torch.zeros(
            k, self.dt_rank + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.zeros(k, d_inner,
                                                        self.dt_rank))
        self.dt_projs_bias = nn.Parameter(torch.zeros(k, d_inner))
        self.A_logs = nn.Parameter(torch.zeros(k * d_inner, d_state))
        self.Ds = nn.Parameter(torch.ones(k * d_inner))
        self.out_norm = LayerNorm(d_inner, eps=1e-5)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The JAX module's init (``hcma.py:116-133, 183-195``)."""
        k, d, r, n = self.K, self.d_inner, self.dt_rank, self.d_state
        with torch.no_grad():
            self.x_proj_weight.uniform_(-d ** -0.5, d ** -0.5,
                                        generator=generator)
            self.dt_projs_weight.uniform_(-r ** -0.5, r ** -0.5,
                                          generator=generator)
            u = torch.rand(k, d, generator=generator)
            dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                           + math.log(0.001)).clamp_min(1e-4)
            self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            self.A_logs.copy_(torch.log(torch.arange(
                1, n + 1, dtype=torch.float32)).repeat(k * d, 1))
            self.Ds.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d, n, r, k = self.d_inner, self.d_state, self.dt_rank, self.K
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        conv = F.conv2d(xs.permute(0, 3, 1, 2), self.conv2d.weight, None,
                        padding=self.conv2d.padding, groups=d)
        xs = F.silu(conv.permute(0, 2, 3, 1) + self.conv2d.bias)
        b, h, w, _ = xs.shape
        length = h * w
        d0 = xs.reshape(b, length, d)
        d1 = xs.transpose(1, 2).reshape(b, length, d)
        dirs = torch.stack([d0, d1, d0.flip(1), d1.flip(1)])  # (K, b, L, d)
        x_dbl = dirs @ self.x_proj_weight.transpose(1, 2).unsqueeze(1)
        dts, bs, cs = x_dbl.split([r, n, n], dim=-1)
        dts = dts @ self.dt_projs_weight.transpose(1, 2).unsqueeze(1)
        a = -torch.exp(wide(self.A_logs)).reshape(k, 1, d, n)
        y = selective_scan(dirs, dts, a, bs, cs,
                           self.Ds.reshape(k, 1, d),
                           self.dt_projs_bias.reshape(k, 1, d))
        del dirs, dts, bs, cs, x_dbl

        def t_back(v):      # column-major sequence → row-major
            return v.reshape(b, w, h, d).transpose(1, 2).reshape(b, length,
                                                                 d)
        out = (y[0] + y[2].flip(1) + t_back(y[1]) + t_back(y[3].flip(1)))
        out = self.out_norm(out.reshape(b, h, w, d)) * F.silu(z)
        return self.out_proj(out)


class VSSBlock(nn.Module):
    """Down-project → LayerNorm → SS2D (+ residual) → up-project
    (+ x)."""

    def __init__(self, hidden_dim: int, d_state: int = 16):
        super().__init__()
        d_model = hidden_dim // 2
        self.down = Linear(hidden_dim, d_model)
        self.ln_1 = LayerNorm(d_model)
        self.self_attention = SS2D(d_model, d_state)
        self.up = Linear(d_model, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.down(x)
        h = h + self.self_attention(self.ln_1(h))
        return self.up(h) + x


class AxialAttention3D(nn.Module):
    """Single-head attention along ``axis`` ∈ {1, 2, 3} of ``(B, D, H, W,
    C)``: q, k, v from the processed features, the position embedding
    added to q and k, scores in fp32; a sigmoid-gated residual."""

    def __init__(self, channels: int, axis: int, axis_len: int):
        super().__init__()
        self.axis = axis
        shape = [1, channels, 1, 1, 1]
        shape[1 + axis] = axis_len
        self.pos_embed = nn.Parameter(torch.zeros(shape))
        self.query_conv = Conv1x1(channels, channels)
        self.key_conv = Conv1x1(channels, channels)
        self.value_conv = Conv1x1(channels, channels)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, processed: torch.Tensor
                ) -> torch.Tensor:
        c = x.shape[-1]
        shape = [1, 1, 1, 1, c]
        shape[self.axis] = -1
        pos = self.pos_embed.reshape(c, -1).t().reshape(shape)
        q = pointwise(self.query_conv, processed) + pos
        k = pointwise(self.key_conv, processed) + pos
        v = pointwise(self.value_conv, processed)
        qm, km, vm = (torch.movedim(t, self.axis, -2) for t in (q, k, v))
        scores = (wide(qm) @ wide(km).transpose(-1, -2)) / math.sqrt(c)
        wts = torch.softmax(scores, dim=-1).to(vm.dtype)
        out = torch.movedim(wts @ vm, -2, self.axis)
        gamma = torch.sigmoid(self.gamma)
        return gamma * out + (1.0 - gamma) * x


def _avg_pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """``s``³ average pool of a channels-last ``x`` (floor sizes), as a
    mean over a reshape: the sum in fp32 in every dtype, on every device
    (``F.avg_pool3d`` has no bf16 CPU form)."""
    if s == 1:
        return x
    b, d, h, w, c = x.shape
    x = x[:, :d - d % s, :h - h % s, :w - w % s]
    return x.reshape(b, d // s, s, h // s, s, w // s, s, c).mean((2, 4, 6))


# (B, D, H, W, C) → the slices across each axis, and back
_PERM = {1: (0, 1, 2, 3, 4), 2: (0, 2, 1, 3, 4), 3: (0, 3, 1, 2, 4)}


class DirectionalMamba(nn.Module):
    def __init__(self, channels: int, axis: int, axis_len: int,
                 d_state: int = 32):
        super().__init__()
        self.axis = axis
        self.mamba = VSSBlock(channels, d_state)
        self.slice_attention = AxialAttention3D(channels, axis, axis_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        perm = _PERM[self.axis]
        xp = x.permute(perm)
        lead = xp.shape[:2]
        processed = self.mamba(xp.reshape(-1, *xp.shape[2:]))
        inv = tuple(perm.index(i) for i in range(5))
        processed = processed.reshape(*lead, *processed.shape[1:]) \
            .permute(inv)
        return self.slice_attention(x, processed)


class TriplaneMamba(nn.Module):
    def __init__(self, channels: int, feature_size: Sequence[int],
                 d_state: int = 32):
        super().__init__()
        q = channels // 4
        for ax, width in zip((1, 2, 3), (2 * q, q, channels - 3 * q)):
            self.add_module(f"mamba_{'xyz'[ax - 1]}", DirectionalMamba(
                width, ax, feature_size[ax - 1], d_state))
        self.fusion = nn.Sequential(Conv1x1(channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = x.shape[-1] // 4
        parts = (x[..., :2 * q], x[..., 2 * q:3 * q], x[..., 3 * q:])
        y = torch.cat([self.mamba_x(parts[0]), self.mamba_y(parts[1]),
                       self.mamba_z(parts[2])], dim=-1)
        y = _lrelu(pointwise(self.fusion[0], y))
        return to_channels_last(instance_norm(to_channels_first(y))) + x


class Down(nn.Module):
    """(average pool ⊕ strided ResNeXt) → triplane Mamba → DenseConv;
    returns (pre-extractor, post-extractor)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 feature_size: Sequence[int], expand_rate: int = 4,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.stride = stride
        self.downsample_resnext = ResNeXtConv(in_ch, in_ch, stride)
        self.tmamba = TriplaneMamba(in_ch, feature_size)
        self.extractor = nn.ModuleList([DenseConvBlock(
            in_ch, out_ch, expand_rate, dropout_rate)])

    def forward(self, x: torch.Tensor, generator: Gen = None):
        x = self.tmamba(_avg_pool(x, self.stride)
                        + self.downsample_resnext(x))
        return x, self.extractor[0](x, generator)


class Up(nn.Module):
    """1×1 adapt + instance norm + LeakyReLU, + the skip, a transposed conv
    of kernel = stride."""

    def __init__(self, low_ch: int, high_ch: int, stride: int):
        super().__init__()
        self.extractor = nn.ModuleList([nn.Sequential(
            Conv1x1(low_ch, high_ch), InstanceNormAffine(high_ch))])
        self.up_transpose = ConvTranspose3d(high_ch, high_ch, stride, stride)

    def forward(self, x_low: torch.Tensor, x_high: torch.Tensor
                ) -> torch.Tensor:
        adapt, norm = self.extractor[0]
        y = _lrelu(norm(pointwise(adapt, x_low))) + x_high
        return _conv_cl(self.up_transpose, y)


class HCMA(nn.Module):
    def __init__(self, in_channels: int, n_classes: int,
                 patch_ini: Sequence[int] = (128, 128, 128),
                 channels: Sequence[int] = (32, 64, 128, 256, 512),
                 strides: Sequence[int] = (2, 2, 2, 1),
                 encoder_expand_rate: Sequence[int] = (4, 4, 4, 4),
                 dropout_rate_list: Sequence[float] = (0.025, 0.05, 0.1,
                                                       0.1)):
        super().__init__()
        depth = len(strides)
        sizes = [tuple(patch_ini)]
        for s in strides:
            sizes.append(tuple(d // s for d in sizes[-1]))
        self.encoders = nn.ModuleList([DenseConvBlock(in_channels,
                                                      channels[0])])
        for i in range(depth):
            self.encoders.append(Down(channels[i], channels[i + 1],
                                      strides[i], sizes[i + 1],
                                      encoder_expand_rate[i],
                                      dropout_rate_list[i]))
        self.decoders = nn.ModuleList(
            Up(channels[depth - i], channels[depth - i - 1],
               strides[depth - i - 1]) for i in range(depth))
        # the predict mode's head, out[depth - 1], alone
        self.out = nn.ModuleDict({str(depth - 1): nn.Module()})
        self.out[str(depth - 1)].conv1 = Conv1x1(channels[0], n_classes)
        self.out_drop = Dropout(0.1)

    def forward(self, x: torch.Tensor, generator: Gen = None
                ) -> torch.Tensor:
        """``generator`` draws the dropouts in training."""
        h = self.encoders[0](x, generator)
        skips = []
        for down in self.encoders[1:]:
            x_down, h = down(h, generator)
            skips.append(x_down)
        for up, skip in zip(self.decoders, reversed(skips)):
            h = up(h, skip)
        return pointwise(self.out[str(len(self.decoders) - 1)].conv1,
                         self.out_drop(h, generator))


@register_model("HCMA-UNet", sized="patch_ini")
def build_hcma(cfg: dict, device=None, seed: int = 0) -> HCMA:
    """Eval-mode HCMA-UNet from its model-config entry (``in_channels``,
    ``n_classes``, ``patch_ini`` (default 128³; it sizes the axial
    position tables)), He-normal seeded convs and linears, the SS2D
    parameters as the JAX module initializes them, the position tables
    Xavier-uniform, the gates at 0."""
    dev = resolve_device(device)
    model = HCMA(int(cfg["in_channels"]), int(cfg["n_classes"]),
                 tuple(cfg.get("patch_ini", (128, 128, 128))))
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SS2D):
                nn.init.kaiming_normal_(m.conv2d.weight, a=1e-2,
                                        mode="fan_in", generator=gen)
                m.conv2d.bias.zero_()
                m.reset_parameters_(gen)
            elif isinstance(m, AxialAttention3D):
                length, c = m.pos_embed.numel() // m.pos_embed.shape[1], \
                    m.pos_embed.shape[1]
                bound = math.sqrt(6.0 / (length + c))
                m.pos_embed.uniform_(-bound, bound, generator=gen)
    return model.to(dev).eval()
