"""MedNeXt-S, the reference's ConvNeXt-style baseline
(``compared_model/MedNeXt``, ``create_mednextv1_small``), as
``veloxseg_tpu/models/zoo/mednext.py`` builds it: 32 channels, expansion
2, kernel 3, two blocks per stage, residual down and up blocks, no deep
supervision. A block is a depthwise k³ conv → per-channel GroupNorm → 1×1
expand → exact GELU → 1×1 compress (+ the input). Down blocks run the
depthwise conv at stride 2 with a stride-2 1×1 residual; up blocks a
depthwise 3³ transposed conv (stride 2, padding 1: 2i − 1 voxels) and a
1×1 stride-2 transposed residual, each padded by one voxel in front on
every axis *after* the block (``blocks.py:186-197``), so the norm and the
compress conv never see the padded zeros.

Parameter names: the reference's state-dict keys (``stem``,
``enc_block_0.1.conv2``, ``down_0.res_conv``, ``up_3.conv1``,
``out_0.conv_out``), the inverse of ``veloxseg_tpu/interop/zoo_import.py:
_map_mednext_key``. Channels-last in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import ConvTranspose3d, GroupNorm, gelu, init_weights_

_FRONT = (1, 0, 1, 0, 1, 0)   # one voxel in front of W, H and D


class MedNeXtBlock(nn.Module):
    """``kind`` "block" (same width, + x), "down" (stride 2, + 1×1 stride-2
    residual) or "up" (transposed, + transposed 1×1 residual, padded)."""

    def __init__(self, in_ch: int, out_ch: int, exp_r: int = 2,
                 kernel_size: int = 3, kind: str = "block"):
        super().__init__()
        self.kind = kind
        if kind == "up":
            self.conv1 = ConvTranspose3d(in_ch, in_ch, kernel_size, 2,
                                         padding=kernel_size // 2,
                                         groups=in_ch)
        else:
            self.conv1 = GroupedConv3d(in_ch, in_ch, kernel_size,
                                       groups=in_ch,
                                       stride=2 if kind == "down" else 1)
        self.norm = GroupNorm(in_ch, in_ch)
        self.conv2 = Conv1x1(in_ch, exp_r * in_ch)
        self.conv3 = Conv1x1(exp_r * in_ch, out_ch)
        if kind == "down":
            self.res_conv = GroupedConv3d(in_ch, out_ch, 1, stride=2,
                                          padding=0)
        elif kind == "up":
            self.res_conv = ConvTranspose3d(in_ch, out_ch, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv1(x))
        y = self.conv3(gelu(self.conv2(y)))
        if self.kind == "block":
            return y + x
        res = self.res_conv(x)
        if self.kind == "up":
            y, res = F.pad(y, _FRONT), F.pad(res, _FRONT)
        return y + res


class OutBlock(nn.Module):
    """The head, a 1×1 transposed conv in the reference."""

    def __init__(self, in_ch: int, n_classes: int):
        super().__init__()
        self.conv_out = ConvTranspose3d(in_ch, n_classes, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(x)


class MedNeXt(nn.Module):
    def __init__(self, in_channels: int, n_classes: int = 2,
                 n_channels: int = 32, exp_r: int = 2, kernel_size: int = 3,
                 block_counts=(2,) * 9):
        super().__init__()
        n, k, e = n_channels, kernel_size, exp_r

        def stage(ch, count):
            return nn.Sequential(*(MedNeXtBlock(ch, ch, e, k)
                                   for _ in range(count)))

        self.stem = Conv1x1(in_channels, n)
        for i in range(4):
            self.add_module(f"enc_block_{i}", stage(n * 2 ** i,
                                                    block_counts[i]))
            self.add_module(f"down_{i}", MedNeXtBlock(
                n * 2 ** i, n * 2 ** (i + 1), e, k, kind="down"))
        self.bottleneck = stage(16 * n, block_counts[4])
        for i in (3, 2, 1, 0):
            self.add_module(f"up_{i}", MedNeXtBlock(
                n * 2 ** (i + 1), n * 2 ** i, e, k, kind="up"))
            self.add_module(f"dec_block_{i}", stage(n * 2 ** i,
                                                    block_counts[8 - i]))
        self.out_0 = OutBlock(n, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(to_channels_first(x))
        skips = []
        for i in range(4):
            x = getattr(self, f"enc_block_{i}")(x)
            skips.append(x)
            x = getattr(self, f"down_{i}")(x)
        x = self.bottleneck(x)
        for i in (3, 2, 1, 0):
            x = skips[i] + getattr(self, f"up_{i}")(x)
            x = getattr(self, f"dec_block_{i}")(x)
        return to_channels_last(self.out_0(x))


@register_model("MedNeXt")
def build_mednext(cfg: dict, device=None, seed: int = 0) -> MedNeXt:
    """Eval-mode MedNeXt-S from its model-config entry
    (``num_input_channels``, ``num_classes``), He-normal seeded convs."""
    dev = resolve_device(device)
    model = MedNeXt(cfg.get("num_input_channels", 2),
                    cfg.get("num_classes", 2))
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
