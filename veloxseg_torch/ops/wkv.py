"""The RWKV-4 WKV recurrence: kernel K6 and its plain version.

Replaces ``veloxseg_tpu/ops/wkv.py``: ``wkv_pallas`` (the Pallas
``_wkv_kernel``, K6) and ``wkv_scan``, its reference. Per (batch,
channel), sequential in T, with a running log-max so that no exponent is
positive (``wkv.py:7-11``); ``w`` is passed as the caller computes it
(U-RWKV passes ``decay / T``, not negated). The CUDA kernel is
``csrc/wkv.cu``.

The JAX package has no backward kernel (its VJP differentiates the scan),
and serving needs none: on a CUDA tensor :func:`wkv` runs the kernel and
refuses inputs that require a gradient; on a CPU tensor it runs the plain
version, which autograd can differentiate.

The kernel cuts each chain into chunks and runs them as a two-pass scan
(``csrc/wkv.cu``); :func:`wkv_chunked_plain` is that decomposition in torch
ops, which the tests hold against the JAX package, and :func:`wkv_launch`
its geometry.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _cuda

_NEG = -1e38
_SMEM_BYTES = 232448  # the most a block may hold


def wkv_plain(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``wkv_scan``'s recurrence as a loop over T. w, u: (C,); k, v:
    (B, T, C); returns (B, T, C), float32 (float64 for float64 inputs)."""
    b, t, c = k.shape
    dt = torch.promote_types(k.dtype, torch.float32)
    kf, vf = k.to(dt), v.to(dt)
    wf, uf = w.to(dt)[None], u.to(dt)[None]
    aa = torch.zeros((b, c), dtype=dt, device=k.device)
    bb = torch.zeros((b, c), dtype=dt, device=k.device)
    pp = torch.full((b, c), _NEG, dtype=dt, device=k.device)
    ys = []
    for i in range(t):
        kt, vt = kf[:, i], vf[:, i]
        ww = uf + kt
        q = torch.maximum(pp, ww)
        e1, e2 = torch.exp(pp - q), torch.exp(ww - q)
        ys.append((e1 * aa + e2 * vt) / (e1 * bb + e2))
        ww2 = pp + wf
        q2 = torch.maximum(ww2, kt)
        e1b, e2b = torch.exp(ww2 - q2), torch.exp(kt - q2)
        aa = e1b * aa + e2b * vt
        bb = e1b * bb + e2b
        pp = q2
    return torch.stack(ys, dim=1)


def wkv_chunked_plain(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, chunks: int) -> torch.Tensor:
    """K6's decomposition in torch ops: each chain cut into ``chunks``
    chunks of n = ⌈T/chunks⌉ steps (chunks past T empty); pass 1 runs each
    chunk from the zero state (0, 0, −1e38); chunk j's incoming state folds
    chunks 0 .. j − 1 in order, n steps each: p = max(p_in + n·w, p_i),
    a = e^(p_in + n·w − p)·a_in + e^(p_i − p)·a_i (b likewise); pass 2
    re-runs the chunk from it and writes y. (B, T, C), float32 (float64
    for float64 inputs)."""
    b, t, c = k.shape
    n = -(-t // chunks)
    dt = torch.promote_types(k.dtype, torch.float32)
    kf, vf = k.to(dt), v.to(dt)
    wf, uf = w.to(dt)[None], u.to(dt)[None]

    def zero():
        return (torch.full((b, c), _NEG, dtype=dt, device=k.device),
                torch.zeros((b, c), dtype=dt, device=k.device),
                torch.zeros((b, c), dtype=dt, device=k.device))

    local = []
    for j in range(chunks):
        pp, aa, bb = zero()
        for i in range(j * n, min(t, (j + 1) * n)):
            ww = pp + wf
            q = torch.maximum(ww, kf[:, i])
            e1, e2 = torch.exp(ww - q), torch.exp(kf[:, i] - q)
            aa, bb, pp = e1 * aa + e2 * vf[:, i], e1 * bb + e2, q
        local.append((pp, aa, bb))
    decay = wf * float(n)
    pin, ain, bin_ = zero()
    ys = []
    for j in range(chunks):
        if j * n >= t:
            break
        if j:
            pi, ai, bi = local[j - 1]
            pd = pin + decay
            m = torch.maximum(pd, pi)
            f1, f2 = torch.exp(pd - m), torch.exp(pi - m)
            ain, bin_, pin = f1 * ain + f2 * ai, f1 * bin_ + f2 * bi, m
        pp, aa, bb = pin, ain, bin_
        for i in range(j * n, min(t, (j + 1) * n)):
            kt, vt = kf[:, i], vf[:, i]
            ww = uf + kt
            q = torch.maximum(pp, ww)
            e1, e2 = torch.exp(pp - q), torch.exp(ww - q)
            ys.append((e1 * aa + e2 * vt) / (e1 * bb + e2))
            ww2 = pp + wf
            q2 = torch.maximum(ww2, kt)
            e1b, e2b = torch.exp(ww2 - q2), torch.exp(kt - q2)
            aa, bb, pp = e1b * aa + e2b * vt, e1b * bb + e2b, q2
    return torch.stack(ys, dim=1)


class WkvLaunch(NamedTuple):
    """K6's geometry (``csrc/wkv.cu`` checks it): a block owns
    ``channels`` channels (a multiple of 4) of one sample, one thread a
    (chunk, channel), ``chunks`` chunks a chain."""
    channels: int
    chunks: int


def wkv_smem_bytes(t: int, lw: WkvLaunch) -> int:
    """Shared memory of a K6 block: its k and v tiles and the chunks'
    states."""
    return 4 * (2 * t * lw.channels + 3 * lw.chunks * lw.channels)


@functools.lru_cache(maxsize=None)
def wkv_launch(t: int) -> WkvLaunch:
    """K6's geometry for chains of ``t`` steps: 8 channels a block (one
    32-byte sector of a row) and 16 chunks, the best of a sweep on the
    card at U-RWKV's (4, 216, 128) within its noise
    (``tools/bench_serving_kernels.py --sweep``, ``PERF.md`` §6); 4
    channels where the tiles would not fit a block's shared memory, fewer
    chunks where a chain is short."""
    chunks = max(1, min(16, t // 4))
    for channels in (8, 4):
        lw = WkvLaunch(channels, chunks)
        if wkv_smem_bytes(t, lw) <= _SMEM_BYTES:
            return lw
    raise ValueError(f"T={t}: a chain's k and v tiles do not fit a block's "
                     f"shared memory")


def wkv(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor, launch: Optional[WkvLaunch] = None) -> torch.Tensor:
    """K6 on CUDA tensors, the plain version on CPU tensors; (B, T, C).
    ``launch``: a :class:`WkvLaunch` in place of :func:`wkv_launch`'s (the
    card tests and the bench's sweep)."""
    if k.device.type == "cpu":
        return wkv_plain(w, u, k, v)
    if k.device.type != "cuda":
        raise ValueError(f"unsupported device {k.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (w, u, k, v)):
        raise RuntimeError("the WKV kernel has no backward: run it under "
                           "torch.no_grad() or on the CPU")
    b, t, c = k.shape
    for x, shape in ((w, (c,)), (u, (c,)), (k, (b, t, c)), (v, (b, t, c))):
        if x.device != k.device or x.dtype != torch.float32 \
                or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"expected a contiguous float32 {shape} on "
                             f"{k.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    y = torch.empty_like(k)
    if y.numel() == 0:
        return y
    lw = launch or wkv_launch(t)
    lib = _cuda.lib("wkv")
    with torch.cuda.device(k.device):
        err = lib.vs_wkv(w.data_ptr(), u.data_ptr(), k.data_ptr(),
                         v.data_ptr(), y.data_ptr(), b, t, c, lw.channels,
                         lw.chunks, _cuda.stream_ptr(k.device))
    _cuda.check(lib, err, "wkv")
    wkv.launches += 1
    return y


wkv.launches = 0
