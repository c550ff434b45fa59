"""Sliding-window whole-volume inference.

Behaviour of MONAI ``sliding_window_inference`` as the reference uses it
(``utils/inference_runtime.py:4-19``) and as
``veloxseg_tpu/infer/sliding_window.py`` implements it: overlap 0.25,
constant blending by default (gaussian on request), symmetric zero padding
of volumes smaller than the ROI. Tiles run through the predictor in
batches of ``sw_batch_size`` on the device, and the weighted sums
accumulate on the same device.

A ragged last batch is filled up with copies of the first tile, whose
outputs are dropped, as the JAX package does (MONAI runs a smaller last
batch instead). A predictor whose output for one tile depends on the
other tiles of its call, as U-RWKV's batch norms do, then gives what the
JAX package gives.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device


def compute_tile_origins(image_size: Sequence[int], roi_size: Sequence[int],
                         overlap: float) -> List[Tuple[int, ...]]:
    """Tile-origin grid (MONAI ``dense_patch_slices``).

    Per axis: scan interval = int(roi · (1−overlap)); starts are
    ``i·interval`` clamped so the last tile ends exactly at the volume edge.
    """
    per_axis: List[List[int]] = []
    for size, roi in zip(image_size, roi_size):
        size, roi = int(size), int(roi)
        if size <= roi:
            per_axis.append([0])
            continue
        interval = int(roi * (1.0 - overlap)) or 1
        n = int(math.ceil((size - roi) / interval)) + 1
        per_axis.append(sorted({min(i * interval, size - roi)
                                for i in range(n)}))
    origins: List[Tuple[int, ...]] = [()]
    for axis_starts in per_axis:
        origins = [o + (s,) for o in origins for s in axis_starts]
    return origins


@functools.lru_cache(maxsize=8)
def _importance_np(mode: str, roi: Tuple[int, ...]) -> np.ndarray:
    """Blend weights over one ROI: ones, or the separable gaussian
    (MONAI GaussianFilter, sigma = roi / 8) clipped at 1e-3 of its peak."""
    if mode == "constant":
        return np.ones(roi, dtype=np.float32)
    if mode != "gaussian":
        raise ValueError(f"unknown blend mode {mode!r}")
    g = None
    for r in roi:
        center = (r - 1) / 2.0
        sigma = max(r * 0.125, 1e-3)
        x = np.arange(r, dtype=np.float64)
        m = np.exp(-0.5 * ((x - center) / sigma) ** 2)
        g = m if g is None else np.multiply.outer(g, m)
    g = np.clip(g, np.max(g) * 1e-3, None)
    return g.astype(np.float32)


@torch.no_grad()
def sliding_window_inference(
    inputs: Union[np.ndarray, torch.Tensor],
    roi_size: Sequence[int],
    predictor: Callable[[torch.Tensor], torch.Tensor],
    sw_batch_size: int = 4,
    overlap: float = 0.25,
    mode: str = "constant",
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Tile, predict, blend.

    Args:
      inputs: ``(B, D, H, W, C)`` volume (channels-last), a numpy array or a
        tensor; it is moved to ``device``.
      roi_size: tile size (D, H, W).
      predictor: ``(n, *roi, C) -> (n, *roi, K)`` logits, channels-last, for
        example an eval-mode :class:`~veloxseg_torch.nn.veloxseg.VeloxSeg`.
      sw_batch_size: tiles per predictor call (4, as the JAX package's
        whole-volume evaluation runs it).
      mode: ``'constant'`` (reference default) or ``'gaussian'`` blending.
      device: where tiles run and sums accumulate; default ``"cuda"``
        (raises without CUDA unless ``"cpu"`` is asked for).

    Returns ``(B, D, H, W, K)`` blended float32 logits on ``device``.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(inputs).to(dev, torch.float32)
    b, *spatial, c = x.shape
    roi = tuple(int(r) for r in roi_size)

    # pad volumes smaller than the ROI (symmetric zeros, MONAI parity)
    pads = [(max(r - s, 0) // 2, max(r - s, 0) - max(r - s, 0) // 2)
            for s, r in zip(spatial, roi)]
    padded = any(p != (0, 0) for p in pads)
    if padded:
        flat = [0, 0]                     # channel axis last: no pad
        for lo, hi in reversed(pads):
            flat += [lo, hi]
        x = F.pad(x, flat)
    padded_spatial = tuple(x.shape[1:-1])

    imp = torch.as_tensor(_importance_np(mode, roi), device=dev)[..., None]
    origins = compute_tile_origins(padded_spatial, roi, overlap)
    n_real = len(origins)
    origins += [origins[0]] * ((-n_real) % sw_batch_size)
    out_sum = None
    cnt = torch.zeros((*padded_spatial, 1), device=dev)
    for i in range(0, len(origins), sw_batch_size):
        batch = origins[i:i + sw_batch_size]
        sls = [tuple(slice(o, o + r) for o, r in zip(org, roi))
               for org in batch]
        tiles = torch.cat([x[(slice(None),) + sl] for sl in sls])
        logits = predictor(tiles).float()
        if out_sum is None:
            out_sum = torch.zeros((b, *padded_spatial, logits.shape[-1]),
                                  device=dev)
        for j, sl in enumerate(sls[:n_real - i]):
            out_sum[(slice(None),) + sl] += logits[j * b:(j + 1) * b] * imp
            cnt[sl] += imp
    blended = out_sum / cnt

    if padded:
        crop = tuple(slice(lo, lo + s) for (lo, _), s in zip(pads, spatial))
        blended = blended[(slice(None),) + crop]
    return blended
