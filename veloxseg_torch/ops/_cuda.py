"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds). The sources of the bf16
forms (``BF16_SOURCES``) are compiled once more with ``-DVS_BF16`` into
``<name>_bf16``: the same kernels for bf16 elements
(``csrc/common.cuh:Elem``). The bf16 forms written for the tensor cores
(``BF16_ONLY``: K3f's and K5f's) are built for bf16 alone, and the bf16
builds of the sources they replace leave those entry points out. All
libraries build in parallel, one ``nvcc``
process each, at first use, into ``_build/`` beside this package's
sources. A library's file name carries a hash of its sources and flags, so
an edited source is never served by a stale build.

Every exported function returns the ``cudaError_t`` of its launches
(``cudaGetLastError()`` after each); :func:`check` raises on a non-zero.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("pwa_attention_train", "pwa_attention_bwd", "pwa_attention_long",
           "jlc_stage1", "jlc_stage2", "wkv")
BF16_SOURCES = ("pwa_attention_train", "pwa_attention_bwd",
                "pwa_attention_long", "jlc_stage1", "jlc_stage2")
BF16_ONLY = ("pwa_attention_long_mma", "jlc_stage2_mma")
# library name -> (source, extra nvcc flags)
LIBRARIES = {**{n: (n, ()) for n in SOURCES},
             **{f"{n}_bf16": (n, ("-DVS_BF16",))
                for n in BF16_SOURCES + BF16_ONLY}}
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# argtypes of each exported function (pointers, ints, floats, stream last)
SIGNATURES = {
    "pwa_attention_train": {
        "vs_pwa_attention": [_P] * 5 + [_I] * 11 + [_F, _P],
        "vs_pwa_attention_train": [_P] * 8 + [_I] * 10 + [_F, _U, _F, _P],
        "vs_pwa_attention_long_train": [_P] * 8 + [_I] * 10
        + [_F, _U, _F, _P]},
    "pwa_attention_bwd": {
        "vs_pwa_attention_train_bwd": [_P] * 15 + [_I] * 9
        + [_F, _U, _F, _P]},
    "pwa_attention_long": {
        "vs_pwa_attention_long_train_bwd": [_P] * 14 + [_I] * 6
        + [_F, _U, _F, _P]},
    "jlc_stage1": {"vs_jlc_stage1": [_P] * 9 + [_I] * 12 + [_P],
                   "vs_jlc_stage1_bwd": [_P] * 14 + [_I] * 14 + [_P],
                   "vs_jlc_branch_wgrad": [_P] * 6 + [_I] * 11 + [_P]},
    "jlc_stage2": {"vs_jlc_stage2": [_P] * 9 + [_I] * 8 + [_P],
                   "vs_jlc_stage2_bwd": [_P] * 15 + [_I] * 10 + [_P]},
    "wkv": {"vs_wkv": [_P] * 5 + [_I] * 5 + [_P],
            "vs_wkv_bwd": [_P] * 9 + [_I] * 4 + [_P]},
}
# the bf16 builds export the same entry points, but K3f's and K5f's, whose
# bf16 forms are the BF16_ONLY kernels
SIGNATURES.update({f"{n}_bf16": dict(SIGNATURES[n]) for n in BF16_SOURCES})
del SIGNATURES["pwa_attention_train_bf16"]["vs_pwa_attention_long_train"]
del SIGNATURES["jlc_stage2_bf16"]["vs_jlc_stage2"]
SIGNATURES.update({
    "pwa_attention_long_mma_bf16": {
        "vs_pwa_attention_long_train_mma": [_P] * 8 + [_I] * 8
        + [_F, _U, _F, _P]},
    "jlc_stage2_mma_bf16": {"vs_jlc_stage2_mma": [_P] * 8 + [_I] * 8 + [_P]},
})

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    source, flags = LIBRARIES[name]
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{source}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, all in parallel.

    Returns the wall seconds this call spent building (0 when all were
    already built)."""
    with _LOCK:
        todo = [n for n in LIBRARIES if not _lib_path(n).is_file()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for name in todo:
            out = _lib_path(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            source, flags = LIBRARIES[name]
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp),
                   str(CSRC / f"{source}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for name, out, tmp, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                failed.append(f"--- {name} ---\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def lib(name: str, dtype: torch.dtype = torch.float32) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` built for ``dtype``
    elements (float32, or bfloat16 for ``BF16_SOURCES`` and ``BF16_ONLY``),
    built on first use."""
    if dtype == torch.bfloat16 and name in BF16_SOURCES + BF16_ONLY:
        name = f"{name}_bf16"
    elif dtype != torch.float32 or name in BF16_ONLY:
        raise ValueError(f"{name}: no kernel library for {dtype}")
    handle = _LIBS.get(name)
    if handle is None:
        build_all()
        handle = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(handle, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        handle.vs_error_string.argtypes = [ctypes.c_int]
        handle.vs_error_string.restype = ctypes.c_char_p
        _LIBS[name] = handle
    return handle


def check(handle: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel function returned a CUDA error."""
    if err != 0:
        text = handle.vs_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card (132 on an H100 SXM): the
    backward kernels size their grids of deterministic partial sums by
    it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def count_launch(fn, dtype: torch.dtype) -> None:
    """Count one launch of the kernel behind the wrapper ``fn``: its fp32
    form on ``fn.launches``, its bf16 form on ``fn.launches_bf16``."""
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as a pointer for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream
