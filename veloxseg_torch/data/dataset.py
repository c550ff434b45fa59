"""Dataset pairing and the threaded patch loader: the port's copy of
``veloxseg_tpu/data/dataset.py``, numpy only (the loader threads never touch
torch), so the same seed gives the same batches bit for bit.

It replaces the reference's MONAI ``Dataset``/``DataLoader`` stack
(``utils/train_autopet.py:193-211``): file-glob pairing with the
sorted-order 60/20/20 split (``:174-189``, list order, not randomised), the
per-item transform pipeline on host threads (gzip inflate and numpy
resampling release the GIL), ``num_samples`` crops per item collated as
MONAI ``list_data_collate`` collates them (so ``batch_size=2`` yields 4
patches per step, the reference's effective batch), and ready host arrays
for :func:`.prefetch.prefetch_to_device`.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import os
import threading
from glob import glob
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..utils.runtime import validate_file_groups
from .nifti_fast import load_nifti_fast as load_nifti
from .transforms import (_pad_to_at_least, crop_foreground, fg_flat_indices,
                         rand_crop_by_pos_neg_label, rand_rotate_z)


class SegmentationDataset:
    """Paired multimodal volumes + label with reference split semantics."""

    def __init__(self, file_groups: Dict[str, List[str]], dataset_name: str):
        """``file_groups``: ordered dict of modality name → sorted paths,
        with 'label' last."""
        self.length = validate_file_groups(dataset_name, file_groups)
        self.names = [k for k in file_groups if k != "label"]
        self.files = [
            {**{k: file_groups[k][i] for k in self.names},
             "label": file_groups["label"][i]}
            for i in range(self.length)
        ]

    @classmethod
    def from_globs(cls, patterns: Dict[str, str], dataset_name: str):
        groups = {k: sorted(glob(p)) for k, p in patterns.items()}
        return cls(groups, dataset_name)

    def split(self, train_rate: float, val_rate: float):
        """Sorted-order split (reference ``utils/train_autopet.py:174-189``)."""
        n = self.length
        a = int(train_rate * n)
        b = int((train_rate + val_rate) * n)
        return self.files[:a], self.files[a:b], self.files[b:]


class PatchTransform:
    """Crop→sample→(rotate)→stack pipeline, split into a deterministic
    head and a random tail.

    The split mirrors MONAI ``CacheDataset`` semantics: everything before
    the first random transform (foreground crop, pad-to-patch-size, and
    the foreground-index scan) is ``deterministic`` and cacheable per
    item; ``random`` (pos/neg patch sampling, z-rotation, channel stack)
    re-runs every epoch. ``__call__`` composes both, so the object is a
    drop-in for the old closure API.
    """

    def __init__(self, patch_size, num_samples=2, rotate_prob=0.0,
                 range_z=0.0, use_foreground_crop=True):
        self.size = tuple(int(s) for s in patch_size)
        self.num_samples = num_samples
        self.rotate_prob = rotate_prob
        self.range_z = range_z
        self.use_foreground_crop = use_foreground_crop

    def deterministic(self, volumes: List[np.ndarray], label: np.ndarray):
        """Foreground-crop, pad, and index the item (cacheable)."""
        if self.use_foreground_crop:
            cropped = crop_foreground(list(volumes) + [label],
                                      source=volumes[0])
            volumes, label = cropped[:-1], cropped[-1]
        volumes = [_pad_to_at_least(v, self.size) for v in volumes]
        label = _pad_to_at_least(label, self.size)
        return list(volumes), label, fg_flat_indices(label)

    def random(self, det, rng: np.random.Generator):
        """Sample patches from a deterministic-head result."""
        volumes, label, fg_flat = det
        samples = rand_crop_by_pos_neg_label(
            volumes, label, self.size, num_samples=self.num_samples,
            rng=rng, fg_flat=fg_flat, assume_padded=True)
        out = []
        for s in samples:
            vols, lab = s[:-1], s[-1]
            if self.rotate_prob > 0:
                vols, lab = rand_rotate_z(vols, lab, self.range_z,
                                          prob=self.rotate_prob, rng=rng)
            out.append((np.stack(vols, axis=-1), lab))
        return out

    def __call__(self, volumes, label, rng):
        return self.random(self.deterministic(volumes, label), rng)


def default_train_transform(patch_size, num_samples=2, rotate_prob=0.5,
                            range_z=math.radians(15.0),
                            use_foreground_crop=True):
    """The AutoPET/Hecktor train pipeline
    (``utils/train_autopet.py:132-152``; Hecktor skips CropForegroundd)."""
    return PatchTransform(patch_size, num_samples=num_samples,
                          rotate_prob=rotate_prob, range_z=range_z,
                          use_foreground_crop=use_foreground_crop)


def default_val_transform(patch_size, num_samples=2,
                          use_foreground_crop=True):
    """Validation pipeline (``utils/train_autopet.py:154-170``) — same
    pos/neg crop, no rotation."""
    return PatchTransform(patch_size, num_samples=num_samples,
                          use_foreground_crop=use_foreground_crop)


class PatchLoader:
    """Threaded, shuffling patch loader with one-batch lookahead."""

    def __init__(self, files: List[dict], modality_keys: Sequence[str],
                 transform: Callable, batch_size: int = 2,
                 num_samples: int = 2, num_workers: int = 4,
                 shuffle: bool = True, seed: int = 12345,
                 modal_index: Optional[Sequence[int]] = None,
                 binary_label: bool = True, drop_last: bool = False,
                 cache: bool = False,
                 cache_max_bytes: Optional[int] = None):
        """``drop_last`` skips a final ragged batch (the JAX package needs
        it under its data-parallel mesh). Default ``False`` matches the
        reference's DataLoader behavior.

        ``cache`` keeps each item's decoded volumes — after the
        transform's deterministic head (foreground crop, pad, fg-index
        scan) when the transform exposes one (:class:`PatchTransform`) —
        in host RAM, so epochs ≥ 2 skip NIfTI decode entirely (MONAI
        ``CacheDataset`` analogue; the reference's plain ``Dataset``
        re-decodes every epoch). Capped at ``cache_max_bytes`` (default
        40% of physical RAM); items beyond the budget fall back to
        re-decoding, so whole-body datasets degrade gracefully instead
        of OOMing the host.
        """
        self.files = files
        self.keys = list(modality_keys)
        self.transform = transform
        self.batch_size = batch_size
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.binary_label = binary_label
        self.drop_last = drop_last
        self.modal_index = (list(modal_index) if modal_index is not None
                            else [1] * len(self.keys))
        self._rng = np.random.default_rng(seed)
        self._workers = num_workers
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self._lock = threading.Lock()
        self._cache: Optional[dict] = {} if cache else None
        self._cache_bytes = 0
        if cache_max_bytes is None:
            try:
                total = (os.sysconf("SC_PAGE_SIZE") *
                         os.sysconf("SC_PHYS_PAGES"))
            except (ValueError, OSError):  # pragma: no cover
                total = 8 << 30
            cache_max_bytes = int(0.4 * total)
        self._cache_budget = cache_max_bytes

    @staticmethod
    def _nbytes(det) -> int:
        n = 0
        for part in det:
            if isinstance(part, np.ndarray):
                n += part.nbytes
            else:
                n += sum(a.nbytes for a in part)
        return n

    def _load_item(self, item: dict, seed: int, index: int):
        rng = np.random.default_rng(seed)
        det = self._cache.get(index) if self._cache is not None else None
        if det is None:
            vols = [load_nifti(item[k]).data.astype(np.float32)
                    for k, on in zip(self.keys, self.modal_index) if on]
            label = load_nifti(item["label"]).data.astype(np.int32)
            if hasattr(self.transform, "deterministic"):
                det = self.transform.deterministic(vols, label)
            else:
                det = (vols, label)
            if self._cache is not None:
                nb = self._nbytes(det)
                with self._lock:
                    if (index not in self._cache
                            and self._cache_bytes + nb
                            <= self._cache_budget):
                        self._cache[index] = det
                        self._cache_bytes += nb
        if hasattr(self.transform, "random"):
            return self.transform.random(det, rng)
        vols, label = det
        return self.transform(vols, label, rng)

    def __len__(self):
        if self.drop_last:
            return len(self.files) // self.batch_size
        return math.ceil(len(self.files) / self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.files))
        if self.shuffle:
            self._rng.shuffle(order)
        seeds = self._rng.integers(0, 2 ** 31, size=len(order))
        work = [(self.files[i], int(s), int(i))
                for i, s in zip(order, seeds)]

        # Bounded lookahead: keep at most ~2× the worker count in flight.
        # Submitting the whole epoch at once lets workers run arbitrarily
        # far ahead of the consumer — decoded volumes pile up in host RAM
        # in proportion to dataset size on whole-body datasets.
        lookahead = max(2 * self._workers, self.batch_size)
        futures: List[cf.Future] = []
        next_i = 0
        for next_i in range(min(lookahead, len(work))):
            futures.append(self._pool.submit(self._load_item, *work[next_i]))
        next_i += 1

        # list_data_collate parity: every item contributes num_samples
        # patches; a "batch" is batch_size items' worth of patches.
        per_batch = self.batch_size * self.num_samples
        batch_x, batch_y = [], []
        for done in range(len(work)):
            fut = futures[done]
            if next_i < len(work):
                futures.append(
                    self._pool.submit(self._load_item, *work[next_i]))
                next_i += 1
            for x, y in fut.result():
                batch_x.append(x)
                batch_y.append(y)
            while len(batch_x) >= per_batch:
                yield self._emit(batch_x[:per_batch], batch_y[:per_batch])
                del batch_x[:per_batch], batch_y[:per_batch]
        if batch_x and not self.drop_last:
            yield self._emit(batch_x, batch_y)

    def close(self) -> None:
        """Stop the worker threads."""
        self._pool.shutdown(wait=True, cancel_futures=True)

    def _emit(self, xs, ys):
        x = np.stack(xs)
        y = np.stack(ys)
        if self.binary_label:
            y = (y != 0).astype(np.int32)
        return x, y
