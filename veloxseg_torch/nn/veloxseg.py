"""VeloxSeg top-level model, eval forward (``model/VeloxSeg.py``).

:class:`VeloxSeg` takes and returns channels-last tensors, as the JAX
package does: ``(B, D, H, W, sum(in_ch))`` in, ``(B, D, H, W, n_classes)``
seg logits out. Inside it runs channels-first, permuted once at the
boundary. Parameter names and shapes are the reference's state-dict keys
(the teachers' ``rc_decoders`` come with the training slice).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..core.config import VeloxSegConfig
from ..utils.device import resolve_device
from ..utils.layout import to_channels_first, to_channels_last
from .basic import he_init_
from .decoder import SegDecoder
from .encoder import Encoder
from .pwa import RelativePositionBias


class VeloxSeg(nn.Module):
    def __init__(self, cfg: VeloxSegConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = SegDecoder(cfg)

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "veloxseg_torch runs the eval forward only; call .eval()")
        encs = self.encoder(to_channels_first(x).contiguous())
        return to_channels_last(self.decoder(encs))


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
