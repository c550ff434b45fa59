"""Basic building blocks: seeded init, activations, dropout, DropPath, FFN,
convolutions.

All modules take channels-first tensors ``(B, C, D, H, W)``. Dropout and
DropPath draw their masks from an explicit ``torch.Generator`` (on the
tensor's device) that the caller passes down through the forward, as the
JAX package draws them from its ``dropout`` rng stream; no global RNG is
read. They are the identity in eval mode or at rate 0.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# He (kaiming-normal) init with leaky-relu negative slope 1e-2, fan_in: the
# reference's InitWeights_He (``model/components/initialization.py:3-14``).
_HE_NEG_SLOPE = 1e-2


def he_init_(module: nn.Module, generator: Optional[torch.Generator]
             ) -> None:
    """He-normal weights and zero biases for every conv in ``module``."""
    for m in module.modules():
        if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
            nn.init.kaiming_normal_(m.weight, a=_HE_NEG_SLOPE,
                                    mode="fan_in", generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def get_act(name: str) -> nn.Module:
    """Activation factory mirroring ``common_function.get_act``."""
    name = name.lower()
    table = {
        "relu": lambda: nn.ReLU(),
        "relu6": lambda: nn.ReLU6(),
        "leakyrelu": lambda: nn.LeakyReLU(0.2),
        "gelu": lambda: nn.GELU(approximate="none"),
        "hswish": lambda: nn.Hardswish(),
    }
    if name not in table:
        raise NotImplementedError(f"activation layer [{name}] is not found")
    return table[name]()


def _need_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("training with a non-zero dropout rate needs a "
                         "torch.Generator passed down through the forward")
    return generator


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout: keep with prob 1 − rate, scale by 1/keep
    (``flax.linen.Dropout``)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=_need_generator(generator),
                      device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (``veloxseg_tpu/nn/basic.py:38-51``)."""
    if rate == 0.0 or not training:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=_need_generator(generator),
                      device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` that, on a tensor narrower than fp32 (bf16), adds its
    bias to the product already rounded to that dtype, as the JAX package's
    convolution or einsum and then ``+ bias`` do
    (``veloxseg_tpu/nn/basic.py:80-88``, ``nn/pwa.py:304-316``); in fp32
    it is ``nn.Conv3d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.bias is None:
            return super().forward(x)
        return (self._conv_forward(x, self.weight, None)
                + self.bias.view(-1, 1, 1, 1))


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` whose bias is added as :class:`Conv3d`'s
    (the UpConv's matmul, pixel shuffle, then ``+ bias``:
    ``veloxseg_tpu/nn/conv_blocks.py:155-177``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32 or self.bias is None:
            return super().forward(x)
        return (F.conv_transpose3d(x, self.weight, None, self.stride,
                                   self.padding, self.output_padding,
                                   self.groups, self.dilation)
                + self.bias.view(-1, 1, 1, 1))


def GroupedConv3d(in_ch: int, out_ch: int, kernel_size: int, groups: int = 1,
                  stride: int = 1, padding: Optional[int] = None,
                  bias: bool = True) -> Conv3d:
    """Grouped 3-D convolution, "same" padding by default (the reference's
    ``nn.Conv3d(..., groups=g)`` inside JLC blocks,
    ``model/components/conv_blocks.py:50-62``)."""
    if in_ch % groups or out_ch % groups:
        raise ValueError(f"channels ({in_ch}->{out_ch}) not divisible by "
                         f"groups {groups}")
    if padding is None:
        padding = kernel_size // 2
    return Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                  padding=padding, groups=groups, bias=bias)


def Conv1x1(in_ch: int, out_ch: int, bias: bool = True) -> Conv3d:
    """1×1×1 projection, stored as the reference's Conv3d ``(O, I, 1, 1, 1)``."""
    return Conv3d(in_ch, out_ch, 1, bias=bias)


class FFN(nn.Module):
    """1×1-conv feed-forward: expand → act → dropout → project → dropout
    (``model/components/attention_utils.py:45-71``; the PWA block's FFN,
    ``veloxseg_tpu/nn/pwa.py:513-519``)."""

    def __init__(self, channels: int, expansion_ratio: int = 4,
                 act: str = "GELU", dropout: float = 0.0):
        super().__init__()
        self.linear1 = Conv1x1(channels, channels * expansion_ratio)
        self.act = get_act(act)
        self.linear2 = Conv1x1(channels * expansion_ratio, channels)
        self.dropout = dropout

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        z = dropout(self.act(self.linear1(x)), self.dropout, self.training,
                    generator)
        return dropout(self.linear2(z), self.dropout, self.training,
                       generator)
