"""Basic building blocks: seeded init, activations, FFN, convolutions.

All modules take channels-first tensors ``(B, C, D, H, W)``.
"""

from __future__ import annotations

from typing import Optional

import torch
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


def GroupedConv3d(in_ch: int, out_ch: int, kernel_size: int, groups: int = 1,
                  stride: int = 1, padding: Optional[int] = None,
                  bias: bool = True) -> nn.Conv3d:
    """Grouped 3-D convolution, "same" padding by default (the reference's
    ``nn.Conv3d(..., groups=g)`` inside JLC blocks,
    ``model/components/conv_blocks.py:50-62``)."""
    if in_ch % groups or out_ch % groups:
        raise ValueError(f"channels ({in_ch}->{out_ch}) not divisible by "
                         f"groups {groups}")
    if padding is None:
        padding = kernel_size // 2
    return nn.Conv3d(in_ch, out_ch, kernel_size, stride=stride,
                     padding=padding, groups=groups, bias=bias)


def Conv1x1(in_ch: int, out_ch: int, bias: bool = True) -> nn.Conv3d:
    """1×1×1 projection, stored as the reference's Conv3d ``(O, I, 1, 1, 1)``."""
    return nn.Conv3d(in_ch, out_ch, 1, bias=bias)


class FFN(nn.Module):
    """1×1-conv feed-forward: expand → act → project; dropout is the
    identity in eval (``model/components/attention_utils.py:45-71``)."""

    def __init__(self, channels: int, expansion_ratio: int = 4,
                 act: str = "GELU"):
        super().__init__()
        self.linear1 = Conv1x1(channels, channels * expansion_ratio)
        self.act = get_act(act)
        self.linear2 = Conv1x1(channels * expansion_ratio, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(self.act(self.linear1(x)))
