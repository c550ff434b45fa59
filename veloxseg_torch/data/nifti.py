"""NIfTI-1 reader and writer (numpy, gzip and struct; no nibabel).

The port's own copy of ``veloxseg_tpu/data/nifti.py:1-139``: a 348-byte
header, a single ``.nii`` or gzipped ``.nii.gz`` file, the dtypes the
segmentation workloads need, ``scl_slope``/``scl_inter`` scaling, voxel
spacing (pixdim) and the sform affine. Arrays keep NIfTI's Fortran order
and axis order (X, Y, Z), which the port uses as (D, H, W).
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray                 # (X, Y, Z[, T]) array, scaled
    spacing: Tuple[float, ...]       # voxel spacing per spatial axis
    affine: np.ndarray               # 4×4 voxel→world transform

    @property
    def shape(self):
        return self.data.shape


def _read_header(raw: bytes):
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file (bad sizeof_hdr)")
        endian = ">"
    magic = raw[344:348]
    if magic[:2] not in (b"n+", b"ni"):
        raise ValueError(f"bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    datatype = struct.unpack_from(endian + "h", raw, 70)[0]
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    vox_offset = struct.unpack_from(endian + "f", raw, 108)[0]
    scl_slope = struct.unpack_from(endian + "f", raw, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", raw, 116)[0]
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]
    srow = np.array(struct.unpack_from(endian + "12f", raw, 280),
                    dtype=np.float64).reshape(3, 4)
    return (endian, dim, datatype, pixdim, int(vox_offset), scl_slope,
            scl_inter, sform_code, srow)


def load_nifti(path: str, dtype=np.float32) -> NiftiImage:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    (endian, dim, datatype, pixdim, vox_offset, scl_slope, scl_inter,
     sform_code, srow) = _read_header(raw)

    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    if datatype not in _DTYPES:
        raise ValueError(f"unsupported NIfTI datatype {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count,
                         offset=vox_offset)
    # NIfTI stores Fortran (x fastest) order.
    data = data.reshape(shape, order="F")
    data = np.asarray(data, dtype=dtype)
    if scl_slope not in (0.0, 1.0) and np.isfinite(scl_slope):
        data = data * scl_slope + scl_inter
    elif scl_inter not in (0.0,) and scl_slope == 1.0:
        data = data + scl_inter

    spacing = tuple(float(abs(p)) for p in pixdim[1:1 + min(ndim, 3)])
    if sform_code > 0:
        affine = np.vstack([srow, [0, 0, 0, 1]])
    else:
        affine = np.diag(list(spacing[:3]) + [1.0])
    return NiftiImage(data=data, spacing=spacing, affine=affine)


def save_nifti(path: str, data: np.ndarray,
               spacing: Tuple[float, ...] = (1.0, 1.0, 1.0),
               affine: Optional[np.ndarray] = None) -> None:
    data = np.asarray(data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    dt_code = _DTYPE_CODES[np.dtype(data.dtype)]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    ndim = data.ndim
    dims = [ndim] + list(data.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, dt_code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    pix = [1.0] + [float(s) for s in spacing[:ndim]] + \
        [1.0] * (7 - min(ndim, len(spacing)))
    struct.pack_into("<8f", hdr, 76, *pix[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    # sform
    if affine is None:
        affine = np.diag(list(spacing[:3]) + [1.0]) if ndim >= 3 else \
            np.eye(4)
    struct.pack_into("<h", hdr, 254, 1)      # sform_code = scanner
    struct.pack_into("<12f", hdr, 280,
                     *np.asarray(affine[:3], dtype=np.float32).ravel())
    hdr[344:348] = b"n+1\x00"

    body = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(body)
