"""Building blocks of the baseline zoo (``veloxseg_tpu/models/zoo/
common.py``, and the JAX package's ``nn/norms.LayerNorm``). Channels-first
``(B, C, D, H, W)`` except :class:`LayerNorm` and :class:`Linear`, which
act on the last axis.

- the torch-style ``Conv3d`` (``k // 2`` padding, stride, groups) is
  :func:`..nn.basic.GroupedConv3d`;
- :func:`ConvTranspose3d` keeps ``nn.ConvTranspose3d``'s weight
  ``(I, O/g, k, k, k)``; the JAX module keeps a DHWIO kernel and runs it
  flipped over the input dilated by the stride, which is the same
  function, so the weights carry across by a transpose alone
  (:mod:`..interop.zoo_params`);
- ``max_pool3d`` and ``avg_pool3d`` are ``F.max_pool3d`` and
  ``F.avg_pool3d`` (no padding, floor sizes, as flax's VALID pools);
- :func:`dropout` is the zoo's one dropout, elementwise (flax's
  ``nn.Dropout``, :class:`Dropout`) or per sample and channel
  (``common.py:144-157``, :class:`ChannelDropout`); every site of the zoo
  draws through it, from the ``torch.Generator`` its model's forward is
  handed.

The norms round as the JAX ones do in bf16: the statistics and the
normalized value in fp32, that value rounded to the input's dtype, then
the weight and the bias applied in that dtype (a product and a sum, each
rounded). ``torch.nn.LayerNorm`` and ``torch.nn.GroupNorm`` in bf16 round
once, after their affine. :class:`Linear` adds its bias to the product
already rounded, as flax's ``Dense`` (a dot, then ``+ bias``) does, and
:func:`gelu` rounds where ``jax.nn.gelu`` does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import ConvTranspose3d as _ConvTranspose3d
from ...nn.basic import he_init_


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in fp32, or as it is in float64: the attention scores' and
    the norms' compute type (``preferred_element_type=jnp.float32``)."""
    return t if t.dtype == torch.float64 else t.float()


def _normalize(x: torch.Tensor, axes, eps: float) -> torch.Tensor:
    """(x − mean) / sqrt(var + eps) over ``axes`` (biased variance), in
    fp32 (float64 stays float64), rounded to x's dtype."""
    xf = wide(x)
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)


def _affine(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
            ) -> torch.Tensor:
    """``y * weight + bias`` per channel (axis 1), in y's dtype."""
    shape = (1, -1) + (1,) * (y.dim() - 2)
    return (y * weight.view(shape).to(y.dtype)
            + bias.view(shape).to(y.dtype))


class BatchNormNoTrack(nn.Module):
    """Batch normalization with an affine, always over the statistics of the
    batch it is given (per channel over (batch, D, H, W), biased variance,
    eps 1e-5), in eval mode too, with no running statistics
    (``common.py:109-133``). So a tile's output depends on the other tiles
    of the same call: the JAX package's behaviour, kept."""

    eps = 1e-5

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _normalize(x, (0,) + tuple(range(2, x.dim())), self.eps)
        return _affine(y, self.weight, self.bias)


class GroupNorm(nn.Module):
    """GroupNorm with an affine over ``(B, C, ...)``: per sample, over each
    group's channels and the spatial axes, eps 1e-5 (``common.py:87-107``).
    ``GroupNorm(C, C)`` is an instance norm with an affine,
    ``GroupNorm(1, C)`` a layer norm over everything but the batch."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels in {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(x.shape[0], self.num_groups, -1)
        y = _normalize(g, (2,), self.eps).reshape(x.shape)
        return _affine(y, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with a weight and a bias, eps 1e-6 by
    default (``veloxseg_tpu/nn/norms.py:LayerNorm``)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _normalize(x, (-1,), self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. In fp32 (or float64) ``F.gelu``; in bf16 op by op as
    ``jax.nn.gelu(approximate=False)`` computes it,
    ``(0.5·x)·erfc(−x·√½)``, with √½ in that dtype and each product and
    the erfc rounded (``F.gelu`` rounds once)."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return F.gelu(x)
    t = -x * x.new_tensor(0.5 ** 0.5)
    return (0.5 * x) * torch.erfc(t.float()).to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` over the last axis that, on a tensor narrower than
    fp32 (bf16), adds its bias to the product already rounded to that
    dtype, as flax's ``Dense`` does; in fp32 it is ``nn.Linear``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.bias is None:
            return super().forward(x)
        return F.linear(x, self.weight) + self.bias


def pointwise(conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
    """A 1×1 conv's weights (the reference's ``(O, I, 1, 1, 1)``) applied
    over the last axis of a channels-last ``x``, its bias added to the
    rounded product below fp32, as flax's ``Dense`` adds it."""
    w = conv.weight.flatten(1)
    if conv.bias is None:
        return F.linear(x, w)
    if x.dtype == torch.float32:
        return F.linear(x, w, conv.bias)
    return F.linear(x, w) + conv.bias


def ConvTranspose3d(in_ch: int, out_ch: int, kernel_size: int = 2,
                    stride: int = 2, padding: int = 0, groups: int = 1,
                    bias: bool = True) -> _ConvTranspose3d:
    """Torch-style transposed convolution (``common.py:48-85``): output
    size ``(i − 1)·s − 2p + k``; its bias is added to the rounded product
    in bf16 (:class:`..nn.basic.ConvTranspose3d`)."""
    return _ConvTranspose3d(in_ch, out_ch, kernel_size, stride=stride,
                            padding=padding, groups=groups, bias=bias)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator],
            channel: bool = False) -> torch.Tensor:
    """The JAX zoo's dropout, ``where(mask, x / keep, 0)`` with ``keep =
    1 − rate`` and ``x / keep`` rounded in x's dtype (keep too, as JAX's
    weakly typed scalar is: in bf16 the quotient rounds as the JAX bf16
    step's does). The mask is ``rand < keep`` drawn from ``generator`` on
    x's device: over every element, or with ``channel`` per sample and
    channel of a channels-first ``x``, ``(B, C, 1, …)`` broadcast over the
    spatial axes. The identity in eval mode or at rate 0, drawing nothing;
    in training at a non-zero rate without a generator it raises (it
    never draws from the global generator)."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError(f"a train-mode dropout at rate {rate} needs a "
                         "torch.Generator")
    keep = 1.0 - rate
    shape = (x.shape[:2] + (1,) * (x.dim() - 2)) if channel else x.shape
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / x.new_tensor(keep), x.new_zeros(()))


class Dropout(nn.Module):
    """flax's ``nn.Dropout(rate)``: :func:`dropout` over every element."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator)


class ChannelDropout(Dropout):
    """``Dropout3d`` (``common.py:144-157``): :func:`dropout` of whole
    channels per sample of a channels-first ``(B, C, D, H, W)``."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator, channel=True)


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of a zoo model: He-normal weights (fan-in, leaky-relu
    slope 1e-2, as the JAX package's ``he_normal``) and zero biases for
    every convolution, transposed convolution and :class:`Linear`; the
    norms stay at (1, 0). Other parameters are each model's own."""
    he_init_(module, generator)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.kaiming_normal_(m.weight, a=1e-2, mode="fan_in",
                                    generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
