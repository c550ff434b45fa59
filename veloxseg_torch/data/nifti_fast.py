"""The native NIfTI reader: the port's ctypes binding of ``vs_nifti_read_*``
(``veloxseg_tpu/data/nifti_fast.py``, ``native/nifti_native.cpp``).

The library is built from the repository's sources, ``native/
nifti_native.cpp`` and ``native/rotate_native.cpp`` (``vs_rotate_axes01_f32``,
bound in :mod:`.native_ops`), with ``native/build.sh``'s flags, at first use,
into ``veloxseg_torch/_build/`` as the CUDA kernels are built
(``ops/_cuda.py``). The file name carries a hash of the sources and flags,
so an edited source is never served by a stale build; the committed
``native/libvsnative.so`` is not loaded. Where the library cannot be built
(no ``g++`` or no zlib), :func:`load_nifti_fast` falls back to the Python
reader, :func:`..data.nifti.load_nifti`, as the JAX package does when its
library is absent (``nifti_fast.py:58-77``); :func:`native_status` says
which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .nifti import NiftiImage, load_nifti

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("nifti_native.cpp", "rotate_native.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LINK_FLAGS = ("-lz",)

_LOCK = threading.Lock()
_STATE: dict = {}          # "lib": the CDLL or None, "why": the build's log


class _Header(ctypes.Structure):
    _fields_ = [
        ("ndim", ctypes.c_int32),
        ("shape", ctypes.c_int32 * 7),
        ("spacing", ctypes.c_float * 7),
        ("datatype", ctypes.c_int32),
        ("voxels", ctypes.c_int64),
    ]


def _lib_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libvsnative_{h.hexdigest()[:16]}.so"


def _build() -> Tuple[Optional[ctypes.CDLL], str]:
    if not all((NATIVE_DIR / n).is_file() for n in SOURCES):
        return None, f"no native sources under {NATIVE_DIR}"
    out = _lib_path()
    if not out.is_file():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            return None, "no C++ compiler (g++) found"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, *(str(NATIVE_DIR / n) for n in SOURCES),
               *LINK_FLAGS, "-o", str(tmp)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode != 0:
            if tmp.exists():
                tmp.unlink()
            return None, f"build failed: {p.stderr.strip()[-500:]}"
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.vs_nifti_read_header.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(_Header)]
    lib.vs_nifti_read_header.restype = ctypes.c_int
    lib.vs_nifti_read_f32.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int64]
    lib.vs_nifti_read_f32.restype = ctypes.c_int
    lib.vs_rotate_axes01_f32.argtypes = (
        [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int64] * 6
        + [ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_float)])
    lib.vs_rotate_axes01_f32.restype = ctypes.c_int
    return lib, str(out.relative_to(_PKG.parent))


def native_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; ``None`` where it cannot
    be built."""
    with _LOCK:
        if "lib" not in _STATE:
            _STATE["lib"], _STATE["why"] = _build()
        return _STATE["lib"]


def native_status() -> str:
    """Which NIfTI reader and rotation run, and why: one line for a log."""
    lib = native_lib()
    if lib is None:
        return (f"NIfTI reader: Python (data/nifti.py); rotation: scipy "
                f"(the native library is unavailable: {_STATE['why']})")
    return (f"NIfTI reader: native; rotation: native "
            f"({_STATE['why']}, built from native/"
            f"{{{','.join(SOURCES)}}})")


def load_nifti_fast(path: str) -> NiftiImage:
    """:func:`..data.nifti.load_nifti` through the native library: data
    as float32 in Fortran order, spacing; the Python reader where the
    library is unavailable or refuses the file."""
    lib = native_lib()
    if lib is None:
        return load_nifti(path)
    hdr = _Header()
    if lib.vs_nifti_read_header(path.encode(), ctypes.byref(hdr)) != 0:
        return load_nifti(path)
    shape = tuple(int(hdr.shape[i]) for i in range(hdr.ndim))
    out = np.empty(int(hdr.voxels), dtype=np.float32)
    rc = lib.vs_nifti_read_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size)
    if rc != 0:
        return load_nifti(path)
    data = out.reshape(shape, order="F")
    spacing = tuple(abs(float(hdr.spacing[i]))
                    for i in range(min(hdr.ndim, 3)))
    affine = np.diag(list(spacing[:3]) + [1.0])
    return NiftiImage(data=data, spacing=spacing, affine=affine)
