"""BasicUNet, the reference's "UNet" baseline (MONAI ``BasicUNet``,
``utils/load_model.py:10-12``), as ``veloxseg_tpu/models/zoo/
basic_unet.py`` builds it: features (32, 32, 64, 128, 256, 32), a TwoConv
stem, 4 × (max-pool + TwoConv) down, 4 × (2×2 transposed conv, skip
concatenated first, TwoConv) up, a 1×1 head. TwoConv is 2 × (conv 3³ with
bias → instance norm with an affine (``GroupNorm(C, C)``) → LeakyReLU 0.1).

Parameter names: the flax paths of the JAX module with ``/`` as ``.``
(``conv_0.conv_0.weight``, ``upcat_4_deconv.weight``, ``final_conv``); its
top-level names are MONAI's attribute names, but the JAX package holds no
MONAI key map for this model (``tests/test_monai_param_counts.py``), so
a MONAI ``.pth`` is not read as it is. Channels-last in and out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import ConvTranspose3d, GroupNorm, init_weights_


class TwoConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv_0 = GroupedConv3d(in_ch, out_ch, 3)
        self.norm_0 = GroupNorm(out_ch, out_ch)
        self.conv_1 = GroupedConv3d(out_ch, out_ch, 3)
        self.norm_1 = GroupNorm(out_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.norm_0(self.conv_0(x)), 0.1)
        return F.leaky_relu(self.norm_1(self.conv_1(x)), 0.1)


class BasicUNet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 2,
                 features: Sequence[int] = (32, 32, 64, 128, 256, 32)):
        super().__init__()
        f = tuple(features)
        self.conv_0 = TwoConv(in_channels, f[0])
        self.down_1 = TwoConv(f[0], f[1])
        self.down_2 = TwoConv(f[1], f[2])
        self.down_3 = TwoConv(f[2], f[3])
        self.down_4 = TwoConv(f[3], f[4])
        self.upcat_4_deconv = ConvTranspose3d(f[4], f[4] // 2)
        self.upcat_4_convs = TwoConv(f[3] + f[4] // 2, f[3])
        self.upcat_3_deconv = ConvTranspose3d(f[3], f[3] // 2)
        self.upcat_3_convs = TwoConv(f[2] + f[3] // 2, f[2])
        self.upcat_2_deconv = ConvTranspose3d(f[2], f[2] // 2)
        self.upcat_2_convs = TwoConv(f[1] + f[2] // 2, f[1])
        # the last UpCat keeps its channels (MONAI's halves=False)
        self.upcat_1_deconv = ConvTranspose3d(f[1], f[1])
        self.upcat_1_convs = TwoConv(f[0] + f[1], f[5])
        self.final_conv = Conv1x1(f[5], out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.conv_0(to_channels_first(x))
        x1 = self.down_1(F.max_pool3d(x0, 2))
        x2 = self.down_2(F.max_pool3d(x1, 2))
        x3 = self.down_3(F.max_pool3d(x2, 2))
        x4 = self.down_4(F.max_pool3d(x3, 2))
        u = x4
        for name, skip in (("upcat_4", x3), ("upcat_3", x2),
                           ("upcat_2", x1), ("upcat_1", x0)):
            up = getattr(self, f"{name}_deconv")(u)
            u = getattr(self, f"{name}_convs")(torch.cat([skip, up], dim=1))
        return to_channels_last(self.final_conv(u))


@register_model("UNet")
def build_unet(cfg: dict, device=None, seed: int = 0) -> BasicUNet:
    """Eval-mode UNet from its model-config entry (``in_channels``,
    ``out_channels``, optional ``features``), He-normal seeded convs."""
    dev = resolve_device(device)
    model = BasicUNet(cfg.get("in_channels", 2), cfg.get("out_channels", 2),
                      cfg.get("features", (32, 32, 64, 128, 256, 32)))
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
