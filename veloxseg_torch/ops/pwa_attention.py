"""Paired-window attention: the eval kernel K1 and the train kernels K2f,
K2b, each with its plain version.

Replaces ``veloxseg_tpu/ops/pwa_attention.py``: ``window_attention_pallas``
(the Pallas ``_attn_kernel``, K1) and ``window_attention_train`` (the
custom VJP over ``_train_fwd_kernel`` and ``_train_bwd_kernel``, K2).
Token layout ``(B, h, N, C, L)``: per (batch, head, window), q/k are
``(Cqk, L)`` and v ``(Cv, L)``; the bias is ``(h, L, L)``. The CUDA
kernels are ``csrc/pwa_attention.cu`` (K1, K2f) and
``csrc/pwa_attention_bwd.cu`` (K2b).

Train attention drops attention weights with a counter-based mask: a
lowbias32 hash of the global (window, row, column) id and a per-call seed
(:func:`keep_mask`, bit for bit ``_keep_mask``). Windows are numbered
batch-major over (b, h, n) with the TRUE window count N, as ``_train_xla``
numbers them (the Pallas kernel numbers them over its padded count, so at
a ragged N its mask differs from its own oracle; the port follows the
oracle). The seed is an int32 tensor ``[seed, batch_offset]``.

Every wrapper runs the plain version for a CPU tensor and the kernel for
a CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import _cuda

# (Cqk, Cv) pairs the kernels are instantiated for (csrc/pwa_attention*.cu).
KERNEL_WIDTHS = {(cq, cv) for cq in (4, 8, 16) for cv in (4, 8, 16, 32)}

_M32 = 0xFFFFFFFF


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """einsum → +bias → softmax → einsum, as ``window_attention_xla``."""
    scores = torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
    scores = scores + bias[None, :, None]
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhnlm,bhncm->bhncl", weights, v)


def _check(q, k, v, bias, *more, seed=None):
    """Device, type, contiguity and shape checks of a kernel call."""
    b, h, n, c_qk, l = q.shape
    c_v = v.shape[3]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if seed is not None and (seed.device != q.device
                             or seed.dtype != torch.int32
                             or seed.shape != (2,)):
        raise ValueError(f"seed must be int32 [seed, batch_offset] on "
                         f"{q.device}, got {seed.dtype} {tuple(seed.shape)} "
                         f"on {seed.device}")
    for t in (q, k, v, bias) + more:
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 tensors on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if k.shape != q.shape or v.shape != (b, h, n, c_v, l) \
            or bias.shape != (h, l, l):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} bias "
                         f"{tuple(bias.shape)}")
    if (c_qk, c_v) not in KERNEL_WIDTHS:
        raise ValueError(f"no kernel instance for Cqk={c_qk}, Cv={c_v}")
    return b, h, n, c_qk, c_v, l


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Eval window attention (K1); (B, h, N, Cv, L) out."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale)
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias)
    out = torch.empty_like(v)
    lib = _cuda.lib("pwa_attention")
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, n, c_qk, c_v, l, float(scale),
            _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0


# ---------------------------------------------------------------------------
# The counter-hash dropout mask.
# ---------------------------------------------------------------------------

def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a · m) mod 2³² for int64 ``a`` in [0, 2³²) and a 32-bit constant,
    split in 16-bit halves so no int64 product overflows."""
    lo = (a & 0xFFFF) * m
    hi = ((a >> 16) * m) & _M32
    return (lo + (hi << 16)) & _M32


def drop_threshold(p: float) -> int:
    """uint32 threshold of ``_keep_mask``: keep where hash >= it."""
    return min((1 << 32) - 1, int(p * float(1 << 32)))


def keep_mask(gid: torch.Tensor, p: float, seed: int) -> torch.Tensor:
    """Keep-mask (prob 1 − p) of global element ids ``gid`` (int64 holding
    uint32 values): the lowbias32 avalanche of
    ``veloxseg_tpu/ops/pwa_attention.py:_keep_mask``, in int64 with every
    product reduced mod 2³² (the CPU has no uint32 multiply)."""
    gid = gid.to(torch.int64) & _M32
    x = (_mul32(gid, 0x9E3779B9) + ((int(seed) & _M32) * 0x85EBCA6B)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= drop_threshold(p)


def window_ids(b: int, h: int, n: int, l: int, offset: int = 0,
               device=None) -> torch.Tensor:
    """Global (window, row, column) ids of a ``(B, h, N, L, L)`` score
    grid, int64 mod 2³²: ``((wid·L + i)·L + j)`` with
    ``wid = ((offset + b)·h + hh)·N + n`` (``_train_xla``, 666-673)."""
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=device)  # noqa
    wid = (((offset + ar(b))[:, None, None] * h + ar(h)[None, :, None]) * n
           + ar(n)) & _M32
    i = ar(l)
    return (((wid[..., None, None] * l + i[:, None]) & _M32) * l
            + i[None, :]) & _M32


def _seed_pair(seed: torch.Tensor):
    s, off = (int(t) for t in seed.reshape(-1)[:2].tolist())
    return s, off


# ---------------------------------------------------------------------------
# Train attention (K2f forward, K2b backward).
# ---------------------------------------------------------------------------

def _train_probs(q, k, bias, scale):
    scores = torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
    return torch.softmax(scores + bias[None, :, None], dim=-1)


def window_attention_train_fwd_plain(q, k, v, bias, seed, scale: float,
                                     p: float) -> torch.Tensor:
    """``_train_xla``: softmax, the hash mask with weights / (1 − p), ·V."""
    weights = _train_probs(q, k, bias, scale)
    if p > 0.0:
        s, off = _seed_pair(seed)
        b, h, n, _, l = q.shape
        keep = keep_mask(window_ids(b, h, n, l, off, q.device), p, s)
        weights = torch.where(keep, weights / (1.0 - p), 0.0)
    return torch.einsum("bhnlm,bhncm->bhncl", weights, v)


def window_attention_train_bwd_plain(q, k, v, bias, seed, do, scale: float,
                                     p: float):
    """dq, dk, dv and dbias (summed over batch and windows) of the train
    attention, recomputing the softmax from q, k and bias (``_wat_bwd``)."""
    prob = _train_probs(q, k, bias, scale)
    if p > 0.0:
        s, off = _seed_pair(seed)
        b, h, n, _, l = q.shape
        keep = keep_mask(window_ids(b, h, n, l, off, q.device), p, s)
        inv = 1.0 / (1.0 - p)
        weights = torch.where(keep, prob * inv, 0.0)
    else:
        weights = prob
    dv = torch.einsum("bhnlm,bhncl->bhncm", weights, do)
    dw = torch.einsum("bhncl,bhncm->bhnlm", do, v)
    dprob = torch.where(keep, dw * inv, 0.0) if p > 0.0 else dw
    t = prob * dprob
    ds = t - prob * t.sum(dim=-1, keepdim=True)
    dq = torch.einsum("bhncm,bhnlm->bhncl", k, ds) * scale
    dk = torch.einsum("bhncl,bhnlm->bhncm", q, ds) * scale
    return dq, dk, dv, ds.sum(dim=(0, 2))


def window_attention_train_fwd(q, k, v, bias, seed, scale: float,
                               p: float) -> torch.Tensor:
    """K2f: train attention forward; (B, h, N, Cv, L) out."""
    if q.device.type == "cpu":
        return window_attention_train_fwd_plain(q, k, v, bias, seed, scale, p)
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, seed=seed)
    out = torch.empty_like(v)
    lib = _cuda.lib("pwa_attention")
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention_train(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), out.data_ptr(), b, h, n, c_qk, c_v, l,
            float(scale), drop_threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention_train")
    window_attention_train_fwd.launches += 1
    return out


window_attention_train_fwd.launches = 0

def bwd_chunks(b: int, h: int, n: int, sms: int) -> int:
    """Window chunks per head of K2b: about two blocks per SM in all, none
    of them empty."""
    bn = b * n
    per = -(-bn // max(1, min(bn, -(-2 * sms // h))))
    return -(-bn // per)


def window_attention_train_bwd(q, k, v, bias, seed, do, scale: float,
                               p: float):
    """K2b: (dq, dk, dv, dbias) of the train attention."""
    if q.device.type == "cpu":
        return window_attention_train_bwd_plain(q, k, v, bias, seed, do,
                                                scale, p)
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, do, seed=seed)
    if do.shape != v.shape:
        raise ValueError(f"do {tuple(do.shape)} differs from v "
                         f"{tuple(v.shape)}")
    chunks = bwd_chunks(b, h, n, _cuda.sm_count(q.device))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    part = torch.empty((h, chunks, l, l), device=q.device)
    lib = _cuda.lib("pwa_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), part.data_ptr(), dbias.data_ptr(), b, h, n, c_qk,
            c_v, l, chunks, float(scale),
            drop_threshold(p) if p > 0.0 else 0, 1.0 / (1.0 - p),
            _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention_train_bwd")
    window_attention_train_bwd.launches += 1
    return dq, dk, dv, dbias


window_attention_train_bwd.launches = 0


class _TrainAttention(torch.autograd.Function):
    """Saves only the inputs; the backward recomputes the softmax and the
    mask (``_wat_fwd`` / ``_wat_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, p):
        ctx.save_for_backward(q, k, v, bias, seed)
        ctx.scale, ctx.p = scale, p
        return window_attention_train_fwd(q, k, v, bias, seed, scale, p)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_train_bwd(
            q, k, v, bias, seed, do.contiguous(), ctx.scale, ctx.p)
        return dq, dk, dv, dbias, None, None, None


def window_attention_train(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor,
                           seed: torch.Tensor, scale: float,
                           p: float) -> torch.Tensor:
    """Train attention with weight dropout at rate ``p``, differentiable in
    q, k, v and bias. ``seed``: int32 ``[step_seed, batch_offset]`` on the
    tensors' device (the offset is 0 on one device)."""
    return _TrainAttention.apply(q, k, v, bias, seed, scale, p)
