"""The native in-plane rotation: the port's ctypes binding of
``vs_rotate_axes01_f32`` (``veloxseg_tpu/data/native_ops.py``,
``native/rotate_native.cpp``), from the library :mod:`.nifti_fast` builds.

:func:`rotate_axes01` matches ``scipy.ndimage.rotate(v, deg, axes=(0, 1),
reshape=False, order=order, mode="nearest")`` on 3-D volumes, streaming
axis-2 rows instead of scipy's per-voxel spline path. It returns ``None``
where the library is unavailable or cannot take the input, and the caller
runs scipy (``veloxseg_tpu/data/native_ops.py:43-84``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .nifti_fast import native_lib


def rotate_axes01(vol: np.ndarray, angle_rad: float, order: int
                  ) -> Optional[np.ndarray]:
    """Rotate a 3-D volume in the (0, 1) plane about its centre with spline
    ``order`` 0 or 1. Float32 in any C or Fortran layout; integers only at
    order 0 and below 2**24, where the float32 round trip is exact."""
    lib = native_lib()
    if lib is None or vol.ndim != 3 or order not in (0, 1):
        return None
    cast_back = None
    if vol.dtype != np.float32:
        # bilinear on other dtypes would change numerics; nearest is a
        # pure gather, exact through float32 for integers below 2**24
        if order != 0 or not np.issubdtype(vol.dtype, np.integer):
            return None
        if vol.dtype.itemsize > 2 and (vol.size == 0 or max(
                abs(int(vol.min())), abs(int(vol.max()))) >= 2 ** 24):
            return None
        cast_back = vol.dtype
        vol = vol.astype(np.float32)
    if 0 in vol.strides:  # broadcast views: scipy takes them
        return None
    src = vol if (vol.flags.c_contiguous or vol.flags.f_contiguous) \
        else np.ascontiguousarray(vol)
    out = np.empty_like(src)
    strides = [s // src.itemsize for s in src.strides]
    rc = lib.vs_rotate_axes01_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[0], src.shape[1], src.shape[2],
        strides[0], strides[1], strides[2], float(angle_rad), int(order),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out.astype(cast_back) if cast_back is not None else out
