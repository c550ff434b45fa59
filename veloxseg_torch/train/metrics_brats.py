"""BraTS region metrics (ET / TC / WT dice).

``veloxseg_tpu/train/metrics_brats.py:1-33`` as torch functions (reference
``utils/metric/metrics_brats.py:21-46``): region masks ET = (label == 3),
TC = (label ∈ {1, 3}), WT = (label ≠ 0); per-sample dice with eps 1e-6,
then the batch mean; float32 sums on the tensors' device.
"""

from __future__ import annotations

from typing import Dict

import torch

_EPS = 1e-6


def _region_dice(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, pred.ndim))
    inter = torch.sum(pred * target, dim=dims) + _EPS
    union = (torch.sum(pred, dim=dims) + torch.sum(target, dim=dims)
             + 2 * _EPS)
    return torch.mean(2.0 * inter / union)


def brats_dice(pred: torch.Tensor, target: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """pred/target are int label maps (B, *spatial) with classes {0,1,2,3}."""
    et = _region_dice((pred == 3).float(), (target == 3).float())
    tc = _region_dice(((pred == 1) | (pred == 3)).float(),
                      ((target == 1) | (target == 3)).float())
    wt = _region_dice((pred != 0).float(), (target != 0).float())
    return {"avg": (et + tc + wt) / 3.0, "et": et, "tc": tc, "wt": wt}
