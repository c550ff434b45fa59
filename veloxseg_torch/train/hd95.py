"""95th-percentile Hausdorff distance (host side, numpy and scipy).

The port's own copy of ``veloxseg_tpu/train/hd95.py:1-63``, with the
behaviour of ``medpy.metric.binary.hd95`` as the reference uses it
(``utils/metric/metrics.py:27-39``, ``metrics_brats.py:28-39``): surface
voxels by binary erosion with a connectivity-1 cross, symmetric
95th-percentile surface distances by the euclidean distance transform
with voxel spacing, and NaN for an empty mask.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage


def _surface_distances(result: np.ndarray, reference: np.ndarray,
                       spacing: Sequence[float]) -> np.ndarray:
    footprint = ndimage.generate_binary_structure(result.ndim, 1)
    result = result.astype(bool)
    reference = reference.astype(bool)
    result_border = result ^ ndimage.binary_erosion(
        result, structure=footprint, iterations=1)
    reference_border = reference ^ ndimage.binary_erosion(
        reference, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~reference_border,
                                        sampling=list(spacing))
    return dt[result_border]


def hd95(result: np.ndarray, reference: np.ndarray,
         voxelspacing: Sequence[float] = (1.0, 1.0, 1.0)) -> float:
    """Symmetric 95th-percentile Hausdorff distance (medpy semantics)."""
    result = np.asarray(result)
    reference = np.asarray(reference)
    if result.max() == 0 or reference.max() == 0:
        return float("nan")
    d1 = _surface_distances(result, reference, voxelspacing)
    d2 = _surface_distances(reference, result, voxelspacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def get_hausdorff(gt: np.ndarray, pred: np.ndarray,
                  spacing: Sequence[float] = (1, 1, 1)) -> float:
    """Reference ``get_hausdorff`` parity: empty-mask → NaN, else hd95."""
    if gt.max() == 0 or pred.max() == 0:
        return float("nan")
    return hd95(pred, gt, voxelspacing=spacing)


def brats_hd95(pred: np.ndarray, target: np.ndarray,
               spacing: Sequence[float] = (1, 1, 1)):
    """Per-region HD95 (ET/TC/WT) — ``metrics_brats.py:48-57`` parity."""
    def _h(p, t):
        if t.max() == 0 or p.max() == 0:
            return float("nan")
        return hd95(p, t, voxelspacing=spacing)

    et = _h(pred == 3, target == 3)
    tc = _h((pred == 1) | (pred == 3), (target == 1) | (target == 3))
    wt = _h(pred != 0, target != 0)
    return {"avg": (et + tc + wt) / 3.0, "et": et, "tc": tc, "wt": wt}
