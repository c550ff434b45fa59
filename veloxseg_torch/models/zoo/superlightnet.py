"""SuperLightNet, the reference's ``compared_model/SuperLightNet/
superlightnet.py`` baseline (``NormalU_Net``), as ``veloxseg_tpu/models/
zoo/superlightnet.py`` builds it: a 1×1 stem, four stages of THPA blocks
each ended by an instance norm and a 2³ stride-2 conv, THPA blocks at the
bottleneck, and a decoder of learnable-skip upsample blocks (1×1 → half-
pixel trilinear 2× → + skip·scale → instance norm → grouped conv 3³ →
GELU → 1×1, + the residual·scale), a GroupNorm and a two-layer 1×1 head.

A THPA block normalizes half of its channels and runs GHPA (EGE-UNet's
grouped multi-axis Hadamard-product attention, 2-D) on the slices across
one folded axis, bidirectionally; it concatenates the other half, then
instance norm and a 1×1 MLP. The reverse pass is the flip of the forward
one along the folded axis (``superlightnet.py:121-147``). In eval every
block folds axis 2 (H) of the channels-last ``(B, D, H, W, C)``; in
training each block takes a direction d ∈ {0, 1, 2} drawn per step
(:func:`fold_directions`) and folds axis 2, 1 or 3 for d = 0, 1, 2, the
JAX module's branches in its order (``superlightnet.py:139-144``).
GHPA's learned maps are resized to the slice with
``align_corners=True`` (:func:`..ops.resize.interp_matrix`), and its 2-D
and 1-D depthwise convs pad ``SAME``.

Parameter names: the reference's state-dict keys
(``ParallelU_Net_enc_m.stem``, ``ParallelU_Net_enc_m.repr_block_0.0.
GHPA_dim.params_xy``, ``...GHPA_dim.conv_zx.0``, ``...mlp.fc1``,
``ParallelU_Net_enc_m.dwn_block_0.proj``, ``ParallelU_Net_dec_m.
repr_block_up_0.group_skip_scale``, ``norm``, ``proj.fc2``), the inverse
of ``veloxseg_tpu/interop/zoo_import.py:_map_superlightnet_key``, in the
reference's layouts (GHPA's 2-D convs ``(O, I/g, k, k)``, its 1-D convs
``(O, I/g, k)``). Channels-last in and out.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import torch
from torch import nn

from ...nn.basic import Conv1x1, GroupedConv3d
from ...nn.norms import instance_norm
from ...ops.resize import interp_matrix
from ...utils.device import resolve_device
from ...utils.layout import to_channels_first, to_channels_last
from ..registry import register_model
from .common import GroupNorm, LayerNorm, gelu, init_weights_
from .hdense import resize_2x
from .unetrpp import _Conv

DEPTHS = {"small": (1, 1, 2, 2, 2), "medium": (3, 4, 4, 4, 4),
          "large": (3, 4, 8, 8, 8)}


def _resize_axis(p: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """Align-corners linear resize of one axis of a (small) parameter."""
    n_in = p.shape[axis]
    if n_in == n_out:
        return p
    w = interp_matrix(n_in, n_out, dtype=p.dtype, device=p.device)
    return torch.movedim(torch.tensordot(w, p, dims=([1], [axis])), 0, axis)


def _dw2d(c: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, padding=1, groups=c)


def _dw1d(c: int) -> nn.Conv1d:
    return nn.Conv1d(c, c, 3, padding=1, groups=c)


class GHPA(nn.Module):
    """GHPA over channels-last 2-D slices ``(N, H, W, C)``: C in four
    groups, multiplied by learned maps over (H, W), (H, C) and (W, C), and
    a depthwise path; then LayerNorm, a depthwise 3² conv, GELU, 1×1."""

    def __init__(self, dim: int, x_init: int, y_init: int = 8):
        super().__init__()
        c4 = dim // 4
        self.params_xy = nn.Parameter(torch.ones(1, c4, x_init, y_init))
        self.conv_xy = nn.Sequential(_dw2d(c4), nn.GELU(),
                                     nn.Conv2d(c4, c4, 1))
        self.params_zx = nn.Parameter(torch.ones(1, 1, c4, x_init))
        self.conv_zx = nn.Sequential(_dw1d(c4), nn.GELU(),
                                     nn.Conv1d(c4, c4, 1))
        self.params_zy = nn.Parameter(torch.ones(1, 1, c4, y_init))
        self.conv_zy = nn.Sequential(_dw1d(c4), nn.GELU(),
                                     nn.Conv1d(c4, c4, 1))
        self.dw = nn.Sequential(nn.Conv2d(c4, c4, 1), nn.GELU(), _dw2d(c4))
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.ldw = nn.Sequential(_dw2d(dim), nn.GELU(),
                                 nn.Conv2d(dim, dim, 1))

    @staticmethod
    def _map(conv: nn.Sequential, p: torch.Tensor) -> torch.Tensor:
        """conv → GELU → conv, as functions: a map that needs no resize
        is a view of a parameter, which a module's pre-hooks (the FLOP
        counter's tracker) cannot take under ``inference_mode``."""
        first, last = conv[0], conv[2]
        y = first._conv_forward(p, first.weight, first.bias)
        return last._conv_forward(gelu(y), last.weight, last.bias)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        hh, ww = t.shape[1:3]
        t1, t2, t3, t4 = self.norm1(t).chunk(4, dim=-1)
        pxy = _resize_axis(_resize_axis(self.params_xy, 2, hh), 3, ww)
        t1 = t1 * self._map(self.conv_xy, pxy).permute(0, 2, 3, 1)
        pzx = _resize_axis(self.params_zx[0], 2, hh)           # (1, c4, H)
        t2 = t2 * self._map(self.conv_zx, pzx).permute(0, 2, 1)[:, :, None]
        pzy = _resize_axis(self.params_zy[0], 2, ww)           # (1, c4, W)
        t3 = t3 * self._map(self.conv_zy, pzy).permute(0, 2, 1)[:, None]
        t4 = self._map(self.dw, t4.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        y = self.norm2(torch.cat([t1, t2, t3, t4], dim=-1))
        return self._map(self.ldw, y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    def __init__(self, channels: int, expr: int, out: int = 0):
        super().__init__()
        self.fc1 = Conv1x1(channels, channels * expr)
        self.fc2 = Conv1x1(channels * expr, out or channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


# direction → the channels-last axis folded (``superlightnet.py:139-144``)
FOLD_AXES = (2, 1, 3)


def fold_directions(n: int, generator: torch.Generator) -> List[int]:
    """One training step's fold directions in {0, 1, 2}, one per THPA
    block, without a device sync: they are drawn on the host from a CPU
    generator seeded by ``generator``'s state (a CUDA generator's seed and
    Philox offset live on the host, so reading them launches nothing and
    waits for nothing, where a draw on the card read by ``.item()`` would
    wait for the card), and ``generator`` then advances by one draw on its
    own device, so that the next step draws other directions."""
    digest = hashlib.sha256(generator.get_state().numpy().tobytes())
    host = torch.Generator().manual_seed(
        int.from_bytes(digest.digest()[:8], "little"))
    torch.empty((), device=generator.device).random_(generator=generator)
    return torch.randint(0, 3, (n,), generator=host).tolist()


class THPABlock(nn.Module):
    def __init__(self, channels: int, expr: int = 2):
        super().__init__()
        half = channels // 2
        self.GHPA_dim = GHPA(half, half)
        self.mlp = Mlp(channels, expr)

    def forward(self, x: torch.Tensor, direction: int = 0) -> torch.Tensor:
        """x: ``(B, C, D, H, W)``; GHPA over the slices across the
        channels-last axis ``FOLD_AXES[direction]`` (direction 0: the (D,
        W) slices of each H)."""
        half = x.shape[1] // 2
        axis = FOLD_AXES[direction]
        a = instance_norm(x[:, :half]).permute(0, 2, 3, 4, 1)
        folded = torch.movedim(a, axis, 1)
        b, n = folded.shape[:2]
        y = self.GHPA_dim(folded.reshape(b * n, *folded.shape[2:]))
        y = torch.movedim(y.reshape(b, n, *y.shape[1:]), 1, axis)
        y = (y + torch.flip(y, dims=(axis,))).permute(0, 4, 1, 2, 3)
        return self.mlp(instance_norm(torch.cat([y, x[:, half:]], dim=1)))


class Encoder(nn.Module):
    def __init__(self, in_channels: int, n: int, expr: int,
                 depths: Sequence[int]):
        super().__init__()
        self.stem = Conv1x1(in_channels, n)
        for s in range(4):
            ch = n * 2 ** s
            self.add_module(f"repr_block_{s}", nn.ModuleList(
                THPABlock(ch, expr) for _ in range(depths[s])))
            self.add_module(f"dwn_block_{s}", nn.Module())
            getattr(self, f"dwn_block_{s}").proj = GroupedConv3d(
                ch, 2 * ch, 2, stride=2, padding=0)
        self.emb_block = nn.ModuleList(THPABlock(n * 16, expr)
                                       for _ in range(depths[4]))

    def forward(self, x: torch.Tensor, directions: Sequence[int]):
        """``directions``: each THPA block's, in the order they run."""
        directions = iter(directions)
        x = self.stem(x)
        skips = []
        for s in range(4):
            for block in getattr(self, f"repr_block_{s}"):
                x = block(x, next(directions))
            skips.append(x)
            x = getattr(self, f"dwn_block_{s}").proj(instance_norm(x))
        for block in self.emb_block:
            x = block(x, next(directions))
        return x, skips


class UpRepr(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.upc = _Conv(Conv1x1(2 * features, features, bias=False))
        self.group_skip_scale = nn.Parameter(torch.ones(1, features, 1, 1, 1))
        self.repr_mldw = nn.Sequential(
            _Conv(GroupedConv3d(features, features, 3,
                                groups=max(features // 12, 1), bias=False)),
            nn.GELU(), _Conv(Conv1x1(features, features, bias=False)))
        self.group_res_scale = nn.Parameter(torch.ones(1))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = resize_2x(self.upc(x)) + skip * self.group_skip_scale
        z = self.repr_mldw[0](instance_norm(y))
        return self.repr_mldw[2](gelu(z)) + y * self.group_res_scale


class Decoder(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        for s in range(4):
            self.add_module(f"repr_block_up_{s}", UpRepr(n * 2 ** s))

    def forward(self, x: torch.Tensor, skips) -> torch.Tensor:
        for s in reversed(range(4)):
            x = getattr(self, f"repr_block_up_{s}")(x, skips[s])
        return x


class SuperLightNet(nn.Module):
    def __init__(self, in_channels: int = 4, class_nums: int = 4,
                 n_channels: int = 24, expr: int = 2,
                 depths: Sequence[int] = DEPTHS["small"]):
        super().__init__()
        n = n_channels
        self.ParallelU_Net_enc_m = Encoder(in_channels, n, expr, depths)
        self.ParallelU_Net_dec_m = Decoder(n)
        self.norm = GroupNorm(n, n)
        self.proj = Mlp(n, expr, class_nums)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """In training ``generator`` draws the blocks' fold directions
        (:func:`fold_directions`); eval folds axis 2 in every block."""
        enc = self.ParallelU_Net_enc_m
        n = sum(isinstance(m, THPABlock) for m in enc.modules())
        if not self.training:
            directions = [0] * n
        elif generator is None:
            raise ValueError("SuperLightNet in training draws its fold "
                             "directions from a torch.Generator")
        else:
            directions = fold_directions(n, generator)
        x, skips = enc(to_channels_first(x), directions)
        x = self.ParallelU_Net_dec_m(x, skips)
        return to_channels_last(self.proj(self.norm(x)))


@register_model("SuperLightNet")
def build_superlightnet(cfg: dict, device=None,
                        seed: int = 0) -> SuperLightNet:
    """Eval-mode SuperLightNet from its model-config entry
    (``init_channels``, ``class_nums``, ``n_channels``,
    ``depths_unidirectional``), He-normal seeded convs, GHPA's maps and the
    scales at 1 as the JAX module's."""
    dev = resolve_device(device)
    model = SuperLightNet(cfg.get("init_channels", 4),
                          cfg.get("class_nums", 4),
                          cfg.get("n_channels", 24),
                          depths=DEPTHS[cfg.get("depths_unidirectional",
                                                "small")])
    gen = torch.Generator().manual_seed(seed)
    init_weights_(model, gen)
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            nn.init.kaiming_normal_(m.weight, a=1e-2, mode="fan_in",
                                    generator=gen)
            nn.init.zeros_(m.bias)
    return model.to(dev).eval()
