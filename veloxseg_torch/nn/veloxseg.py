"""VeloxSeg top-level model (``model/VeloxSeg.py``).

:class:`VeloxSeg` takes and returns channels-last tensors, as the JAX
package does: ``(B, D, H, W, sum(in_ch))`` in. Inside it runs
channels-first, permuted once at the boundary. Parameter names and shapes
are the reference's state-dict keys.

- eval: ``(B, D, H, W, n_classes)`` seg logits;
- train (``veloxseg_tpu/nn/veloxseg.py:94-145``): the list
  ``[*seg_preds, recons, student_gram, *teacher_grams]``: the seg heads,
  finest first, the coarse ones resized (trilinear, align_corners) to
  ``cfg.input_size``; the concat of the per-modality reconstructions; the
  student's and each teacher's ``(B, C, C)`` Gram. Dropout masks come
  from the ``generator`` passed to the forward.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from ..core.config import VeloxSegConfig
from ..ops.resize import resize_trilinear
from ..utils.device import resolve_device
from ..utils.layout import to_channels_first, to_channels_last
from .basic import he_init_
from .decoder import RCDecoder, SegDecoder
from .encoder import Encoder
from .pwa import RelativePositionBias


class VeloxSeg(nn.Module):
    # submodules only training runs: the JAX model's eval init holds no
    # parameters of theirs (the speed CLI counts as it does)
    TRAIN_ONLY = ("rc_decoders",)

    def __init__(self, cfg: VeloxSegConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = SegDecoder(cfg)
        self.rc_decoders = nn.ModuleList(
            RCDecoder(cfg, c) for c in cfg.in_ch)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Seeded init: He-normal convs with zero biases (the reference's
        InitWeights_He), truncated-normal(0.02) position-bias tables,
        LayerNorms at (1, 0)."""
        he_init_(self, generator)
        for m in self.modules():
            if isinstance(m, RelativePositionBias):
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=0.02, generator=generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        attn_feats, encs = self.encoder(to_channels_first(x).contiguous(),
                                        generator)
        if not self.training:
            return to_channels_last(self.decoder(encs))
        preds, gram = self.decoder(encs, generator)
        size = self.cfg.input_size
        preds = [preds[0]] + [resize_trilinear(p, size) for p in preds[1:]]
        recs, grams = [], []
        for m, rc in enumerate(self.rc_decoders):
            # teachers see both branches: concat(attn_m, fused enc) per
            # level (model/VeloxSeg.py:211-212)
            rec, g = rc([torch.cat([a[m], e], dim=1)
                         for a, e in zip(attn_feats, encs)], generator)
            recs.append(rec)
            grams.append(g)
        return ([to_channels_last(p) for p in preds]
                + [to_channels_last(torch.cat(recs, dim=1)), gram] + grams)


def build_veloxseg(model_config: Union[dict, VeloxSegConfig],
                   device: Optional[Union[str, torch.device]] = None,
                   seed: int = 0) -> Tuple[VeloxSeg, VeloxSegConfig]:
    """Build an eval-mode VeloxSeg from a reference-format model-config dict
    (``models_config_*.json`` key ``VeloxSeg``) with weights seeded from
    ``seed``, on ``device`` (default ``"cuda"``; raises without CUDA unless
    ``device="cpu"``). The weights are made on the CPU and then moved, so
    one seed gives the same weights on every device."""
    dev = resolve_device(device)
    cfg = (model_config if isinstance(model_config, VeloxSegConfig)
           else VeloxSegConfig.from_dict(model_config))
    model = VeloxSeg(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval(), cfg
