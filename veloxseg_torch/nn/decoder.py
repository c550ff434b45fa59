"""Student segmentation decoder and teacher reconstruction decoders
(``model/Decoder.py``; ``veloxseg_tpu/nn/decoder.py:36-230``).

Both run a U-Net-style up path with additive skips and a 3³ conv head
followed by a 3-D pixel shuffle. In train mode the student also emits the
deep-supervision heads ``out_conv2..L`` (1×1 convs on the coarser decoded
features) and the Gram matrix of its finest feature (the SDKT student
statistic); each teacher reconstructs its modality and emits its own
Gram. Eval computes the student's segmentation logits only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..core.config import VeloxSegConfig
from ..ops.gram import gram_matrix
from ..ops.pixel_shuffle import pixel_shuffle_3d
from .basic import Conv1x1, GroupedConv3d
from .conv_blocks import JLCLayer, UpConv
from .norms import InstanceNorm


def _up_path(dec: nn.Module, encs: Sequence[torch.Tensor], num_levels: int,
             generator: Optional[torch.Generator], feats: Optional[dict]
             ) -> torch.Tensor:
    """Level L−1 → level 1 through ``layer_up{t}`` and ``layer{t}``;
    ``feats[t]`` (when given) receives the decoded feature of level t."""
    h = encs[-1]
    for t in range(num_levels - 1, 0, -1):
        up = getattr(dec, f"layer_up{t}")(h)
        h = getattr(dec, f"layer{t}")(encs[t - 1] + up, generator)
        if feats is not None:
            feats[t] = h
    return h


class SegDecoder(nn.Module):
    """Keys: ``layer_up{t}``, ``layer{t}`` (t = 1..L−1), ``out_conv1.0``
    and, with deep supervision, ``out_conv{t}`` (t = 2..L)."""

    def __init__(self, cfg: VeloxSegConfig):
        super().__init__()
        c = cfg.base_ch
        self.num_levels = n = cfg.num_levels
        self.patch_size = cfg.patch_size
        self.deep_supervision = cfg.deep_supervision
        for t in range(n - 1, 0, -1):
            ct = c * 2 ** (t - 1)
            setattr(self, f"layer_up{t}", UpConv(c * 2 ** t, ct))
            setattr(self, f"layer{t}", JLCLayer(
                ct, cfg.conv_depths[t - 1], cfg.kernel_sizes,
                ct // cfg.min_dim_group[t - 1],
                cfg.conv_expansion_factor[t - 1], cfg.conv_drop))
        self.out_conv1 = nn.Sequential(GroupedConv3d(
            c, cfg.patch_size ** 3 * cfg.n_classes, 3))
        if cfg.deep_supervision:
            for t in range(2, n + 1):
                setattr(self, f"out_conv{t}",
                        Conv1x1(c * 2 ** (t - 1), cfg.n_classes))

    def forward(self, encs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, Tuple[List[torch.Tensor],
                                               torch.Tensor]]:
        """``encs``: per-level features, finest first. Eval: the logits.
        Train: ``(preds, gram)``, preds finest first (the deep heads at
        their own scale)."""
        n = self.num_levels
        deep = self.training and self.deep_supervision
        # feats[L] is the raw deepest encoder output (model/Decoder.py:158)
        feats = {n: encs[-1]} if deep else None
        h = _up_path(self, encs, n, generator, feats)
        out = pixel_shuffle_3d(self.out_conv1(h), self.patch_size)
        if not self.training:
            return out
        preds = [out]
        if deep:
            preds += [getattr(self, f"out_conv{t}")(feats[t])
                      for t in range(2, n + 1)]
        return preds, gram_matrix(h)


class RCDecoder(nn.Module):
    """Reconstruction (teacher) decoder of one modality
    (``model/Decoder.py:11-94``). Keys, under ``rc_decoders.{m}.``:
    ``enc2rc_{k}.0`` (1×1 + IN over concat(attn_m, enc) at level k),
    ``layer_up{t}``, ``layer{t}``, ``out_conv.0``."""

    def __init__(self, cfg: VeloxSegConfig, in_channel: int):
        super().__init__()
        c = cfg.base_ch
        self.num_levels = n = cfg.num_levels
        self.patch_size = cfg.patch_size
        for i in range(n):
            cin = cfg.attn_base_ch * 2 ** i + c * 2 ** i
            setattr(self, f"enc2rc_{i + 1}", nn.Sequential(
                Conv1x1(cin, c * 2 ** i), InstanceNorm()))
        for t in range(n - 1, 0, -1):
            ct = c * 2 ** (t - 1)
            setattr(self, f"layer_up{t}", UpConv(c * 2 ** t, ct))
            setattr(self, f"layer{t}", JLCLayer(
                ct, cfg.conv_depths[t - 1], cfg.kernel_sizes,
                ct // cfg.min_dim_group[t - 1],
                cfg.conv_expansion_factor[t - 1], cfg.conv_drop))
        self.out_conv = nn.Sequential(GroupedConv3d(
            c, cfg.patch_size ** 3 * in_channel, 3))

    def forward(self, encs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``encs``: per-level concat(attn_m, fused enc), finest first →
        ``(reconstruction, gram)``."""
        encs = [getattr(self, f"enc2rc_{i + 1}")(e)
                for i, e in enumerate(encs)]
        h = _up_path(self, encs, self.num_levels, generator, None)
        rec = pixel_shuffle_3d(self.out_conv(h), self.patch_size)
        return rec, gram_matrix(h)
