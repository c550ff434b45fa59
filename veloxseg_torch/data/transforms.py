"""Host-side (numpy and scipy) data transforms: the port's copy of
``veloxseg_tpu/data/transforms.py``, which draws the same numbers from the
same ``np.random.Generator`` and so gives the same arrays.

The MONAI transform semantics the reference pipelines rely on
(``utils/train_autopet.py:132-170``) and the offline normalisations
(``preprocess/normalization_CT_PET.py``, ``preprocess/normalization_MRI.py``):

- ``crop_foreground``: CropForegroundd(source_key=img, select_fn=x>x.min());
- ``rand_crop_by_pos_neg_label``: RandCropByPosNegLabeld(pos=1, neg=1,
  num_samples=N): each sample centres on a random foreground voxel with
  probability pos/(pos+neg), else on a random background voxel; centres
  are clamped so the patch fits;
- ``rand_rotate_z``: RandRotated(range_z=±θ, p, bilinear/nearest,
  keep_size, border padding), through the native rotation
  (:mod:`.native_ops`) or scipy;
- the normalisations, with the reference's quirk: its ``zscore(image,
  seg)`` masks with ``seg >= 0`` on a boolean array, which is always true,
  so PET and MRI normalisation are global per-volume z-scores
  (``normalization_CT_PET.py:6-11``).

Arrays are (X, Y, Z) volumes (one channel) or (X, Y, Z, C); every
transform runs on the host, in the loader's threads.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


# ---------------------------------------------------------------------------
# Cropping
# ---------------------------------------------------------------------------

def foreground_bbox(source: np.ndarray, margin: int = 0
                    ) -> Tuple[Tuple[int, int], ...]:
    """Bounding box (start, end) per axis of voxels where x > x.min()."""
    mask = source > source.min()
    if not mask.any():
        return tuple((0, s) for s in source.shape)
    out = []
    for ax in range(source.ndim):
        other = tuple(i for i in range(source.ndim) if i != ax)
        proj = mask.any(axis=other)
        idx = np.where(proj)[0]
        lo = max(int(idx[0]) - margin, 0)
        hi = min(int(idx[-1]) + 1 + margin, source.shape[ax])
        out.append((lo, hi))
    return tuple(out)


def crop_foreground(volumes: Sequence[np.ndarray], source: np.ndarray,
                    margin: int = 0) -> List[np.ndarray]:
    """Crop every volume to the foreground bbox of ``source``."""
    bbox = foreground_bbox(source, margin)
    slicer = tuple(slice(lo, hi) for lo, hi in bbox)
    return [v[slicer] for v in volumes]


def _pad_to_at_least(vol: np.ndarray, size: Sequence[int]) -> np.ndarray:
    pads = []
    for s, want in zip(vol.shape, size):
        extra = max(want - s, 0)
        pads.append((extra // 2, extra - extra // 2))
    if any(p != (0, 0) for p in pads):
        vol = np.pad(vol, pads)
    return vol


def fg_flat_indices(label: np.ndarray) -> np.ndarray:
    """Flat indices of foreground (label > 0) voxels.

    Precomputable per item once the label is padded — the MONAI
    ``FgBgToIndicesd`` analogue for the positive branch of
    :func:`rand_crop_by_pos_neg_label` (the loader caches this alongside
    the decoded volumes so repeat epochs skip the full-volume scan).
    """
    return np.flatnonzero(label > 0)


def _draw_bg_flat(label: np.ndarray, rng: np.random.Generator
                  ) -> Optional[int]:
    """Uniform draw over background (label == 0) voxels.

    Rejection sampling: a uniform flat index conditioned on label == 0 is
    exactly uniform over background voxels — same distribution as indexing
    a materialized ``argwhere(label == 0)`` list, without building (or
    caching) the huge per-volume index array. Falls back to the exact scan
    when the volume is nearly all foreground; returns None if there is no
    background at all.
    """
    flat = label.reshape(-1)
    n = flat.size
    for _ in range(8):
        cand = rng.integers(0, n, size=64)
        hits = cand[flat[cand] == 0]
        if hits.size:
            return int(hits[0])
    bg = np.flatnonzero(flat == 0)
    if bg.size == 0:
        return None
    return int(bg[rng.integers(bg.size)])


def rand_crop_by_pos_neg_label(
    volumes: Sequence[np.ndarray],
    label: np.ndarray,
    spatial_size: Sequence[int],
    num_samples: int = 2,
    pos: float = 1.0,
    neg: float = 1.0,
    rng: Optional[np.random.Generator] = None,
    fg_flat: Optional[np.ndarray] = None,
    assume_padded: bool = False,
) -> List[List[np.ndarray]]:
    """Draw ``num_samples`` patches balanced between pos/neg centers.

    ``fg_flat``: precomputed :func:`fg_flat_indices` of the (padded)
    label — pass it when the caller caches per-item state across epochs.
    ``assume_padded``: skip the pad-to-patch-size step (the caller
    already padded, e.g. from a cached deterministic transform head).

    Returns a list of samples; each sample is [*cropped_volumes,
    cropped_label].
    """
    rng = rng or np.random.default_rng()
    size = [int(s) for s in spatial_size]
    if not assume_padded:
        volumes = [_pad_to_at_least(v, size) for v in volumes]
        label = _pad_to_at_least(label, size)
    shape = label.shape

    if fg_flat is None:
        fg_flat = fg_flat_indices(label)
    no_bg = fg_flat.size == label.size
    p_pos = pos / (pos + neg)

    samples = []
    for _ in range(num_samples):
        use_fg = (rng.random() < p_pos and fg_flat.size > 0) or no_bg
        if use_fg:
            center_flat = int(fg_flat[rng.integers(fg_flat.size)])
        else:
            drawn = _draw_bg_flat(label, rng)
            if drawn is None:  # no background voxel exists
                center_flat = int(fg_flat[rng.integers(fg_flat.size)])
            else:
                center_flat = drawn
        center = np.unravel_index(center_flat, shape)
        starts = []
        for ax in range(3):
            half = size[ax] // 2
            start = int(center[ax]) - half
            start = min(max(start, 0), shape[ax] - size[ax])
            starts.append(start)
        slicer = tuple(slice(s, s + size[i]) for i, s in enumerate(starts))
        samples.append([v[slicer] for v in volumes] + [label[slicer]])
    return samples


# ---------------------------------------------------------------------------
# Rotation
# ---------------------------------------------------------------------------

def rand_rotate_z(
    volumes: Sequence[np.ndarray],
    label: np.ndarray,
    range_z: float,
    prob: float = 0.5,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Rotate about the z axis by U(−range_z, range_z) with probability
    ``prob``; images bilinear, label nearest, keep_size, border padding."""
    rng = rng or np.random.default_rng()
    if rng.random() >= prob:
        return list(volumes), label
    rad = rng.uniform(-range_z, range_z)
    angle = math.degrees(rad)

    def rot(v, order):
        from .native_ops import rotate_axes01
        out = rotate_axes01(v, rad, order)  # native row-streaming kernel
        if out is not None:
            return out
        return ndimage.rotate(v, angle, axes=(0, 1), reshape=False,
                              order=order, mode="nearest")

    return [rot(v, 1) for v in volumes], rot(label, 0)


# ---------------------------------------------------------------------------
# Normalization (offline preprocess ports)
# ---------------------------------------------------------------------------

def normalize_pet_zscore(image: np.ndarray) -> np.ndarray:
    """Global per-volume z-score (reference quirk preserved — see module
    docstring)."""
    mean = image.mean()
    std = image.std()
    return (image - mean) / max(float(std), 1e-8)


normalize_mri_volume = normalize_pet_zscore


def ct_global_statistics(foreground_voxels: np.ndarray) -> dict:
    """nnUNet-style pooled CT foreground stats
    (``normalization_CT_PET.py:72-88``)."""
    return {
        "mean": float(np.mean(foreground_voxels)),
        "median": float(np.median(foreground_voxels)),
        "std": float(np.std(foreground_voxels)),
        "min": float(np.min(foreground_voxels)),
        "max": float(np.max(foreground_voxels)),
        "percentile_99_5": float(np.percentile(foreground_voxels, 99.5)),
        "percentile_00_5": float(np.percentile(foreground_voxels, 0.5)),
    }


def normalize_ct_global(image: np.ndarray, stats: dict) -> np.ndarray:
    """Clip to [p0.5, p99.5] then z-score with pooled stats
    (``normalization_CT_PET.py:23-30``)."""
    image = np.clip(image, stats["percentile_00_5"],
                    stats["percentile_99_5"])
    return (image - stats["mean"]) / max(stats["std"], 1e-8)


def remap_brats_label(label: np.ndarray) -> np.ndarray:
    """BraTS label 4 → 3 (``normalization_MRI.py:66``)."""
    out = label.copy()
    out[out == 4] = 3
    return out
