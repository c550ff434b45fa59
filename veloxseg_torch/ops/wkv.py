"""The RWKV-4 WKV recurrence: kernel K6, its backward K6b, and their
plain versions.

Replaces ``veloxseg_tpu/ops/wkv.py``: ``wkv_pallas`` (the Pallas
``_wkv_kernel``, K6), ``wkv_scan``, its reference, and the ``custom_vjp``
of ``wkv`` (``wkv.py:142-167``), whose backward is ``jax.vjp(wkv_scan)``.
Per (batch, channel), sequential in T, with a running log-max so that no
exponent is positive (``wkv.py:7-11``); ``w`` is passed as the caller
computes it (U-RWKV passes ``decay / T``, not negated). The CUDA kernels
are ``csrc/wkv.cu``.

bf16 inputs run as ``wkv_pallas`` runs them (``wkv.py:108-144``): w, u, k
and v cast to fp32, the kernel (or the plain version) in fp32, the output
cast back to v's dtype; under autograd the casts' backward hands the
gradients back in the operands' dtypes, as the ``custom_vjp`` does. The
Pallas kernel has no bf16 form to port.

Under autograd :func:`wkv` is a ``torch.autograd.Function``: on CUDA
tensors its forward is K6 and its backward K6b (``vs_wkv_bwd``: the
RWKV-4 backward on the stabilised state, :func:`wkv_bwd`); on CPU tensors
they are :func:`wkv_plain` and :func:`wkv_bwd_plain`, the same two sweeps
in torch ops.

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
from .portable import runs_plain

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


def wkv_bwd_plain(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, gy: torch.Tensor):
    """K6b's two sweeps as loops over T: the forward sweep rebuilds the
    state (a, b, p) before each step; the reverse sweep carries the
    adjoints of A = a·e^p and B = b·e^p scaled by e^p, so that no exponent
    is positive (``csrc/wkv.cu`` derives it). Returns (gw, gu, gk, gv):
    (C,), (C,), (B, T, C), (B, T, C), float32 (float64 for float64
    inputs); gw and gu summed over the batch."""
    b, t, c = k.shape
    dt = torch.promote_types(k.dtype, torch.float32)
    kf, vf, gf = k.to(dt), v.to(dt), gy.to(dt)
    wf, uf = w.to(dt)[None], u.to(dt)[None]
    aa = torch.zeros((b, c), dtype=dt, device=k.device)
    bb = torch.zeros((b, c), dtype=dt, device=k.device)
    pp = torch.full((b, c), _NEG, dtype=dt, device=k.device)
    states = []
    for i in range(t):
        states.append((aa, bb, pp))
        kt, vt = kf[:, i], vf[:, i]
        ww = pp + wf
        q = torch.maximum(ww, kt)
        e1, e2 = torch.exp(ww - q), torch.exp(kt - q)
        aa, bb, pp = e1 * aa + e2 * vt, e1 * bb + e2, q
    ga, gb = torch.zeros_like(aa), torch.zeros_like(aa)
    gw, gu = torch.zeros_like(aa), torch.zeros_like(aa)
    gk, gv = [None] * t, [None] * t
    pn = pp
    for i in reversed(range(t)):
        at, bt, pt = states[i]
        kt, vt, g = kf[:, i], vf[:, i], gf[:, i]
        ww = uf + kt
        q = torch.maximum(pt, ww)
        e1, e2 = torch.exp(pt - q), torch.exp(ww - q)
        d = e1 * bt + e2
        r, y = g / d, (e1 * at + e2 * vt) / d
        f1, f2 = torch.exp(pt + wf - pn), torch.exp(kt - pn)
        gdir = r * e2 * (vt - y)
        gv[i] = r * e2 + f2 * ga
        gk[i] = gdir + f2 * (vt * ga + gb)
        gu = gu + gdir
        gw = gw + f1 * (ga * at + gb * bt)
        ga, gb = r * e1 + f1 * ga, f1 * gb - r * y * e1
        pn = pt
    return (gw.sum(0), gu.sum(0), torch.stack(gk, dim=1),
            torch.stack(gv, dim=1))


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


def _block_channels(t: int, smem_bytes) -> int:
    """The channels a block of K6 or K6b takes for chains of ``t`` steps:
    8 (one 32-byte sector of a row), or 4 where the block's tiles at 8
    would not fit its shared memory (``smem_bytes(channels)``)."""
    for channels in (8, 4):
        if smem_bytes(channels) <= _SMEM_BYTES:
            return channels
    raise ValueError(f"T={t}: a chain's tiles do not fit a block's shared "
                     f"memory")


@functools.lru_cache(maxsize=None)
def wkv_launch(t: int) -> WkvLaunch:
    """K6's geometry for chains of ``t`` steps: 8 channels a block and 16
    chunks, the best of a sweep on the card at U-RWKV's (4, 216, 128)
    within its noise (``tools/bench_serving_kernels.py --sweep``,
    ``PERF.md`` §6); 4 channels where the tiles would not fit a block's
    shared memory (:func:`_block_channels`), fewer chunks where a chain is
    short."""
    chunks = max(1, min(16, t // 4))
    return WkvLaunch(_block_channels(
        t, lambda g: wkv_smem_bytes(t, WkvLaunch(g, chunks))), chunks)


def _check_operands(w, u, k, v, *more) -> None:
    b, t, c = k.shape
    for x, shape in ((w, (c,)), (u, (c,)), (k, (b, t, c)), (v, (b, t, c)),
                     *((m, (b, t, c)) for m in more)):
        if x.device != k.device or x.dtype != torch.float32 \
                or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"expected a contiguous float32 {shape} on "
                             f"{k.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")


def _wkv_fwd(w, u, k, v, launch: Optional[WkvLaunch]) -> torch.Tensor:
    """The forward on fp32 operands: K6 on CUDA tensors, the plain version
    on CPU tensors or in a portable scope."""
    if runs_plain(k):  # a CPU tensor, or inside a portable scope
        return wkv_plain(w, u, k, v)
    if k.device.type != "cuda":
        raise ValueError(f"unsupported device {k.device}")
    _check_operands(w, u, k, v)
    b, t, c = k.shape
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


def wkv_bwd_smem_bytes(t: int, channels: int) -> int:
    """Shared memory of a K6b block: its k, v and gy tiles and the state
    before each step."""
    return 4 * 6 * t * channels


@functools.lru_cache(maxsize=None)
def wkv_bwd_channels(t: int) -> int:
    """K6b's channels a block for chains of ``t`` steps, as K6's
    (:func:`_block_channels`): 8, or 4 where the tiles would not fit."""
    return _block_channels(t, lambda g: wkv_bwd_smem_bytes(t, g))


def wkv_bwd(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, gy: torch.Tensor):
    """The WKV backward on fp32 operands: K6b on CUDA tensors, the plain
    version on CPU tensors (or in a portable scope). Returns (gw, gu, gk,
    gv); gw and gu summed over the batch in a fixed order, so a repeat is
    bit for bit the same."""
    if runs_plain(k):
        return wkv_bwd_plain(w, u, k, v, gy)
    if k.device.type != "cuda":
        raise ValueError(f"unsupported device {k.device}")
    _check_operands(w, u, k, v, gy)
    b, t, c = k.shape
    gk, gv = torch.empty_like(k), torch.empty_like(k)
    gwu = torch.zeros((2, c), dtype=torch.float32, device=k.device)
    if k.numel() == 0:
        return gwu[0], gwu[1], gk, gv
    part = torch.empty((2, b, c), dtype=torch.float32, device=k.device)
    lib = _cuda.lib("wkv")
    with torch.cuda.device(k.device):
        err = lib.vs_wkv_bwd(w.data_ptr(), u.data_ptr(), k.data_ptr(),
                             v.data_ptr(), gy.data_ptr(), gk.data_ptr(),
                             gv.data_ptr(), part.data_ptr(), gwu.data_ptr(),
                             b, t, c, wkv_bwd_channels(t),
                             _cuda.stream_ptr(k.device))
    _cuda.check(lib, err, "wkv_bwd")
    wkv_bwd.launches += 1
    return gwu[0], gwu[1], gk, gv


wkv_bwd.launches = 0


class _Wkv(torch.autograd.Function):
    """K6 forward, K6b backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, w, u, k, v, launch):
        ctx.save_for_backward(w, u, k, v)
        return _wkv_fwd(w, u, k, v, launch)

    @staticmethod
    def backward(ctx, gy):
        gw, gu, gk, gv = wkv_bwd(*ctx.saved_tensors, gy.contiguous())
        return gw, gu, gk, gv, None


def wkv(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor, launch: Optional[WkvLaunch] = None) -> torch.Tensor:
    """K6 on CUDA tensors, the plain version on CPU tensors; (B, T, C).
    Under autograd, K6b (or :func:`wkv_bwd_plain`) is its backward. bf16
    operands are cast to fp32 and the output back to bf16, as
    ``wkv_pallas`` casts them. ``launch``: a :class:`WkvLaunch` in place
    of :func:`wkv_launch`'s (the card tests and the bench's sweep)."""
    if v.dtype == torch.bfloat16:
        return wkv(*(t.float() for t in (w, u, k, v)),
                   launch=launch).to(v.dtype)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (w, u, k, v))):
        return _wkv_fwd(w, u, k, v, launch)
    return _Wkv.apply(w, u, k, v, launch)


wkv.launches = 0
