"""Paired-window attention: the eval kernel K1, the train kernels K2f,
K2b and, for long windows, K3f, K3b, each with its plain version.

Replaces ``veloxseg_tpu/ops/pwa_attention.py``: ``window_attention_pallas``
(the Pallas ``_attn_kernel``, K1) and ``window_attention_train`` (the
custom VJP over ``_train_fwd_kernel`` and ``_train_bwd_kernel``, K2, and
their row-blocked forms ``_train_fwd_rb_kernel`` and
``_train_bwd_rb_kernel``, K3). Token layout ``(B, h, N, C, L)``: per
(batch, head, window), q/k are ``(Cqk, L)`` and v ``(Cv, L)``; the bias
is ``(h, L, L)``. The CUDA kernels are ``csrc/pwa_attention_train.cu``
(K1, K2f and K3f: one forward for every window length, K1 its instance
without dropout and lse), ``csrc/pwa_attention_bwd.cu`` (K2b) and
``csrc/pwa_attention_long.cu`` (K3b); :func:`uses_long_kernel` picks K2
or K3.

Train attention drops attention weights with a counter-based mask: a
lowbias32 hash of the global (window, row, column) id and a per-call seed
(:func:`keep_mask`, bit for bit ``_keep_mask``). Windows are numbered
batch-major over (b, h, n) with the TRUE window count N, as ``_train_xla``
numbers them (the Pallas kernel numbers them over its padded count, so at
a ragged N its mask differs from its own oracle; the port follows the
oracle). The seed is an int32 tensor ``[seed, batch_offset]``.

Every wrapper runs the plain version for a CPU tensor and the kernel for
a CUDA tensor; there is no fallback between the two. K1 also runs its
plain version inside :func:`.portable.portable_scope` (the export).

K2f and K2b also take bf16 q, k, v (and dO), as the JAX trainer passes them
to the Pallas kernels: scores, softmax and every product in fp32, the
outputs rounded once to the operands' dtype; the bias, the lse and dbias
stay fp32 (``veloxseg_tpu/ops/pwa_attention.py:572-649``). Their bf16 forms
are the same kernels built for bf16 elements (``_cuda.lib(...,
torch.bfloat16)``); the plain versions compute in fp32 and round where the
kernels round. K1 takes bf16 q, k, v as well (the bf16 eval forward of
``speed_main``): its bf16 form computes in fp32 and rounds the output once
(``_attn_kernel``, 56-74). K3f and K3b take bf16 q, k, v (and dO) too, as
the JAX trainer passes them to the row-blocked Pallas kernels at the 128³
flagship's level 1, and round where those kernels round
(``_train_fwd_rb_kernel``, 434-447; ``_train_bwd_rb_kernel``, 499-527): the
kept weights before ·V and before the dV product, dS before the dq and dk
products; their plain versions are K2's with those roundings
(``row_blocked=True``).
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..utils.flops import add_kernel_flops
from . import _cuda
from .portable import runs_plain

# (Cqk, Cv) pairs K1 and K2 are instantiated for (csrc/pwa_attention_train.cu,
# csrc/pwa_attention_bwd.cu).
KERNEL_WIDTHS = {(cq, cv) for cq in (4, 8, 16) for cv in (4, 8, 16, 32)}

_M32 = 0xFFFFFFFF


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """einsum → +bias → softmax → einsum, as ``window_attention_xla``, in
    fp32 (float64 stays float64), the output in v's dtype: for bf16
    operands the function of ``_attn_kernel`` (``pwa_attention.py:56-74``),
    the weights not rounded before ·V and the output rounded once."""
    dtype = v.dtype
    dt = torch.promote_types(dtype, torch.float32)
    q, k, v, bias = (t.to(dt) for t in (q, k, v, bias))
    scores = torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
    scores = scores + bias[None, :, None]
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhnlm,bhncm->bhncl", weights, v).to(dtype)


def window_attention_flops(b: int, h: int, n: int, c_qk: int, c_v: int,
                           l: int) -> int:
    """K1's operations as ``FlopCounterMode`` counts its plain version: the
    two batched products (QᵀK and the weights' ·V), 2·L·L·C each per
    window; the softmax is not counted."""
    return 2 * b * h * n * l * l * (c_qk + c_v)


def _check(q, k, v, bias, *more, seed=None, widths=KERNEL_WIDTHS,
           tokens=(), dtypes=(torch.float32,)):
    """Device, type, contiguity and shape checks of a kernel call: q, k, v
    and ``tokens`` (dO) of one dtype of ``dtypes``; bias and ``more`` (the
    forward's fp32 out and lse) float32."""
    b, h, n, c_qk, l = q.shape
    c_v = v.shape[3]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in dtypes:
        raise ValueError(f"no kernel instance for {q.dtype}")
    if seed is not None and (seed.device != q.device
                             or seed.dtype != torch.int32
                             or seed.shape != (2,)):
        raise ValueError(f"seed must be int32 [seed, batch_offset] on "
                         f"{q.device}, got {seed.dtype} {tuple(seed.shape)} "
                         f"on {seed.device}")
    for t, want in [(t, q.dtype) for t in (q, k, v) + tuple(tokens)] \
            + [(t, torch.float32) for t in (bias,) + more]:
        if t.device != q.device or t.dtype != want \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous {want} tensors on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if k.shape != q.shape or v.shape != (b, h, n, c_v, l) \
            or bias.shape != (h, l, l):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} bias "
                         f"{tuple(bias.shape)}")
    if (c_qk, c_v) not in widths:
        raise ValueError(f"no kernel instance for Cqk={c_qk}, Cv={c_v}")
    return b, h, n, c_qk, c_v, l


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float,
                     launch: Optional["TrainFwdLaunch"] = None
                     ) -> torch.Tensor:
    """Eval window attention (K1): the train forward's kernel without
    dropout and lse; q, k, v fp32 or bf16, bias fp32; (B, h, N, Cv, L) out
    in v's dtype. ``launch``: a :class:`TrainFwdLaunch` in place of
    :func:`eval_fwd_launch`'s (the card tests and the bench's sweep). Its
    decomposition in torch ops is
    :func:`window_attention_train_fwd_tiled_plain` at p = 0. The plain
    version runs for a CPU tensor or inside a portable scope."""
    if runs_plain(q):
        return window_attention_plain(q, k, v, bias, scale)
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias,
                                   dtypes=(torch.float32, torch.bfloat16))
    out = torch.empty_like(v)
    if out.numel() == 0:
        return out
    lw = launch or eval_fwd_launch(b, h, n, l, c_qk, c_v,
                                   _cuda.sm_count(q.device))
    lib = _cuda.lib("pwa_attention_train", q.dtype)
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, n, c_qk, c_v, l, lw.slabs, lw.windows,
            lw.chunks, lw.per, int(lw.ldg), float(scale),
            _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention")
    _cuda.count_launch(window_attention, q.dtype)
    add_kernel_flops(window_attention_flops(b, h, n, c_qk, c_v, l))
    return out


window_attention.launches = 0
window_attention.launches_bf16 = 0


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


def _fp32(*ts):
    return tuple(t.float() for t in ts)


def _train_weights(q, k, bias, seed, scale: float, p: float):
    """The kept weights M·softmax/(1 − p) in fp32 on fp32 copies of the
    operands."""
    q, k, bias = _fp32(q, k, bias)
    weights = _train_probs(q, k, bias, scale)
    if p > 0.0:
        s, off = _seed_pair(seed)
        b, h, n, _, l = q.shape
        keep = keep_mask(window_ids(b, h, n, l, off, q.device), p, s)
        weights = torch.where(keep, weights / (1.0 - p), 0.0)
    return weights


def _train_fwd_plain32(q, k, v, bias, seed, scale: float, p: float):
    """The train forward in fp32 on fp32 copies of the operands."""
    return torch.einsum("bhnlm,bhncm->bhncl",
                        _train_weights(q, k, bias, seed, scale, p), v.float())


def window_attention_train_fwd_plain(q, k, v, bias, seed, scale: float,
                                     p: float) -> torch.Tensor:
    """``_train_xla``: softmax, the hash mask with weights / (1 − p), ·V,
    in fp32 (the probabilities are not rounded), the output rounded once
    to v's dtype (``_train_fwd_kernel``, ``pwa_attention.py:322-341``)."""
    return _train_fwd_plain32(q, k, v, bias, seed, scale, p).to(v.dtype)


def window_attention_train_bwd_plain(q, k, v, bias, seed, do, scale: float,
                                     p: float, row_blocked: bool = False):
    """dq, dk, dv and dbias (summed over batch and windows) of the train
    attention, recomputing the softmax from q, k and bias (``_wat_bwd``),
    in fp32; dq, dk, dv rounded once to the operands' dtype, dbias fp32
    (``_train_bwd_kernel``, ``pwa_attention.py:344-404``). ``row_blocked``:
    K3b's function, ``_train_bwd_rb_kernel`` (499-527): the kept weights
    rounded to k's dtype before the dV product and dS before the dq and dk
    products, dbias from the unrounded dS (the identity in fp32)."""
    dtypes = (q.dtype, k.dtype, v.dtype)
    rnd = (lambda t: t.to(dtypes[1]).float()) if row_blocked \
        else (lambda t: t)
    q, k, v, bias, do = _fp32(q, k, v, bias, do)
    prob = _train_probs(q, k, bias, scale)
    if p > 0.0:
        s, off = _seed_pair(seed)
        b, h, n, _, l = q.shape
        keep = keep_mask(window_ids(b, h, n, l, off, q.device), p, s)
        inv = 1.0 / (1.0 - p)
        weights = torch.where(keep, prob * inv, 0.0)
    else:
        weights = prob
    dv = torch.einsum("bhnlm,bhncl->bhncm", rnd(weights), do)
    dw = torch.einsum("bhncl,bhncm->bhnlm", do, v)
    dprob = torch.where(keep, dw * inv, 0.0) if p > 0.0 else dw
    t = prob * dprob
    ds = t - prob * t.sum(dim=-1, keepdim=True)
    dq = torch.einsum("bhncm,bhnlm->bhncl", k, rnd(ds)) * scale
    dk = torch.einsum("bhncl,bhnlm->bhncm", q, rnd(ds)) * scale
    return (*(g.to(dt) for g, dt in zip((dq, dk, dv), dtypes)),
            ds.sum(dim=(0, 2)))


def _train_fwd_kernel(fn, name: str, widths, q, k, v, bias, seed,
                      scale: float, p: float, launch=None,
                      dtypes=(torch.float32,)):
    """Launch the train forward (``csrc/pwa_attention_train.cu``) through
    its entry point ``name`` on CUDA tensors; ``fn`` is the wrapper whose
    launches are counted. ``launch``: a :class:`TrainFwdLaunch` in place
    of :func:`train_fwd_launch`'s (the card tests and the bench's sweep).
    Returns (out, lse, out32): a bf16 form also writes the output in fp32
    before its rounding, for K2b; in fp32 out32 is out."""
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, seed=seed, widths=widths,
                                   dtypes=dtypes)
    if b * n == 0:
        raise ValueError("no windows")
    lw = launch or train_fwd_launch(b, h, n, l, c_qk, c_v,
                                    _cuda.sm_count(q.device))
    out = torch.empty_like(v)
    out32 = out if v.dtype == torch.float32 \
        else torch.empty_like(v, dtype=torch.float32)
    lse = torch.empty((b, h, n, l), device=q.device)
    lib = _cuda.lib("pwa_attention_train", q.dtype)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), out.data_ptr(), out32.data_ptr(),
            lse.data_ptr(), b, h, n, c_qk, c_v, l, lw.slabs, lw.windows,
            lw.chunks, lw.per, float(scale),
            drop_threshold(p) if p > 0.0 else 0, 1.0 / (1.0 - p),
            _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, name)
    _cuda.count_launch(fn, q.dtype)
    return out, lse, out32


def window_attention_train_fwd(q, k, v, bias, seed, scale: float,
                               p: float):
    """K2f: train attention forward on fp32 or bf16 q, k, v (bias fp32);
    (out, lse, out32): the (B, h, N, Cv, L) output in v's dtype, each row's
    log-sum-exp (B, h, N, L) and the output in fp32 before its rounding
    (``out`` itself for fp32), the two K2b takes. Its plain version is
    :func:`window_attention_train_fwd_plain` with :func:`train_lse_plain`;
    :func:`window_attention_train_fwd_tiled_plain` mirrors the kernel's
    decomposition."""
    if q.device.type == "cpu":
        out32 = _train_fwd_plain32(q, k, v, bias, seed, scale, p)
        return (out32.to(v.dtype), train_lse_plain(q, k, bias, scale),
                out32)
    return _train_fwd_kernel(window_attention_train_fwd,
                             "vs_pwa_attention_train", KERNEL_WIDTHS, q, k, v,
                             bias, seed, scale, p,
                             dtypes=(torch.float32, torch.bfloat16))


window_attention_train_fwd.launches = 0
window_attention_train_fwd.launches_bf16 = 0


def train_lse_plain(q, k, bias, scale: float) -> torch.Tensor:
    """Each row's log-sum-exp of its logits, (B, h, N, L), in fp32: what
    K2f and K3f write beside their output for K2b and K3b."""
    q, k, bias = _fp32(q, k, bias)
    scores = torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
    return torch.logsumexp(scores + bias[None, :, None], dim=-1)


_SMEM_FLOATS = 232448 // 4  # the most a block may hold


def _chunk_ranges(bn: int, chunks: int, per: int) -> List[Tuple[int, int]]:
    """The windows ``[lo, hi)`` of each of ``chunks`` chunks of ``per`` of a
    head's ``bn`` windows (window ``j`` is sample ``j // N``, window
    ``j % N``)."""
    return [(i * per, min(bn, (i + 1) * per)) for i in range(chunks)]


# csrc/pwa_attention_train.cu: columns of a stage (kTile) and of an online
# softmax step (kStep), column lanes and row groups of a warp (kTX, kTY),
# the most warps a block has
_FWD_TILE, _FWD_STEP, _FWD_TX, _FWD_TY, _FWD_MAX_WARPS = 64, 32, 4, 8, 16
# train_fwd_launch's model, fitted to the device times of a sweep of
# geometries (tools/bench_train_bwd.py --sweep): the warps an SM needs to
# issue at its full rate, the bytes a clock one SM loads from L2, and the
# issue slots of one 16-byte copy of a tile's K or V
_FWD_FULL_RATE_WARPS = 10
_FWD_L2_BYTES_PER_CLOCK = 24
_FWD_COPY_SLOTS = 40
# the slabs and window slots a block may have (the grid the model was
# fitted on)
_FWD_SLABS, _FWD_WINDOWS = (1, 2, 3, 4, 6, 8), (1, 2, 4, 8)


def _fwd_rows_per_lane(c_qk: int, c_v: int) -> int:
    """Rows a lane of K2f/K3f owns (``rows_per_lane``): 4 at Cqk + Cv <= 8,
    2 up to 24, else 1 (its registers hold RM·(Cqk + Cv + 8) floats)."""
    return 4 if c_qk + c_v <= 8 else 2 if c_qk + c_v <= 24 else 1


class TrainFwdLaunch(NamedTuple):
    """K2f's and K3f's launch geometry for one shape
    (``csrc/pwa_attention_train.cu`` checks it). A block owns ``rows`` =
    ``slabs``·8·RM query rows of one head (RM: :func:`_fwd_rows_per_lane`)
    and walks a chunk of ``per`` of that head's windows (``chunks``
    chunks), ``windows`` at a time; warp (slab, window slot) takes one slab
    of rows of one window, all its columns. ``ldg`` (K1 only): the block
    reads the bias through L1 instead of staging its rows."""
    slabs: int
    windows: int
    chunks: int
    per: int
    rows: int
    ldg: bool = False

    def window_ranges(self, bn: int) -> List[Tuple[int, int]]:
        return _chunk_ranges(bn, self.chunks, self.per)


def _k2f_smem_floats(slabs: int, windows: int, l: int, c_qk: int,
                     c_v: int, ldg: bool = False) -> int:
    """Shared memory of a K1/K2f/K3f block (``fwd_smem_floats``): the bias
    rows (stride ⌈L/64⌉·64 + 16/RM; none with ``ldg``) and two stages of
    ``windows`` windows, each a tile of K and V and the block's q rows."""
    rm = _fwd_rows_per_lane(c_qk, c_v)
    rows = slabs * _FWD_TY * rm
    stride = 0 if ldg else -(-l // _FWD_TILE) * _FWD_TILE + 16 // rm
    return rows * stride + 2 * windows * (_FWD_TILE * (c_qk + c_v)
                                          + c_qk * rows)


def _fwd_fits(slabs: int, windows: int, l: int, c_qk: int, c_v: int,
              ldg: bool = False) -> bool:
    """Whether the kernel takes this (slabs, windows) at window length l:
    at most 16 warps, no slab wholly past L, and a block's shared
    memory."""
    rows_slab = _FWD_TY * _fwd_rows_per_lane(c_qk, c_v)
    return (slabs * windows <= _FWD_MAX_WARPS
            and (slabs - 1) * rows_slab < l
            and _k2f_smem_floats(slabs, windows, l, c_qk, c_v, ldg)
            <= _SMEM_FLOATS)


def _fwd_cost(b: int, h: int, n: int, l: int, c_qk: int, c_v: int,
              sms: int, lw: "TrainFwdLaunch", hashed: bool = True) -> float:
    """Modelled clocks of one launch (:func:`train_fwd_launch`); ``hashed``
    False: K1, the instance without the hash."""
    rm = _fwd_rows_per_lane(c_qk, c_v)
    warps = lw.slabs * lw.windows
    floats = _k2f_smem_floats(lw.slabs, lw.windows, l, c_qk, c_v, lw.ldg)
    regs = min(128, 44 + rm * (c_qk + c_v + 11))
    fit = min(_SMEM_FLOATS // floats, 32 // warps,
              65536 // (32 * regs * warps))
    blocks = h * -(-l // lw.rows) * lw.chunks
    per_sm = min(fit, -(-blocks // sms))
    rounds = -(-blocks // (sms * per_sm))
    rate = 4 * min(1.0, per_sm * warps / _FWD_FULL_RATE_WARPS)
    tiles = -(-l // _FWD_TILE)
    # a lane's issue slots per window: per step its 8·RM scores at
    # Cqk + Cv FMAs and ~25 more (bias, max, exp2, the hash's ~11, the
    # select, the sum), per tile its share of the copies (its window
    # slot's S warps share them); the lanes' merge
    steps = _FWD_TILE // _FWD_STEP
    copies = _FWD_COPY_SLOTS * (c_qk + c_v) * _FWD_TILE / (4 * 32 * lw.slabs)
    extra = 25 if hashed else 14
    lane_window = (tiles * (steps * 8 * rm * (c_qk + c_v + extra) + copies)
                   + rm * (4 * c_v + 12))
    batches = -(-lw.per // lw.windows)
    issue = per_sm * warps * batches * lane_window / rate
    # an SM's loads: each block's bias rows before it starts (none through
    # L1), then per window its K, V and q rows under the compute
    bias = 0 if lw.ldg else per_sm * 4 * lw.rows * l / _FWD_L2_BYTES_PER_CLOCK
    tokens = (per_sm * lw.per * 4 * ((c_qk + c_v) * l + lw.rows * c_qk)
              / _FWD_L2_BYTES_PER_CLOCK)
    return rounds * (bias + max(issue, tokens))


def train_fwd_candidates(b: int, h: int, n: int, l: int, c_qk: int,
                         c_v: int, sms: int, ldg: bool = False,
                         hashed: bool = True):
    """(modelled clocks, :class:`TrainFwdLaunch`) of each (slabs, windows)
    of the grid that the kernel takes, each with its best windows per chunk
    (ties to fewer chunks). ``ldg``, ``hashed``: K1's options (the bias
    through L1; no hash)."""
    bn = b * n
    rows_slab = _FWD_TY * _fwd_rows_per_lane(c_qk, c_v)
    pers = sorted({-(-bn // c) for c in range(1, bn + 1)})
    out = []
    for slabs in _FWD_SLABS:
        for windows in _FWD_WINDOWS:
            if windows > bn or not _fwd_fits(slabs, windows, l, c_qk, c_v,
                                              ldg):
                continue
            out.append(min(
                ((_fwd_cost(b, h, n, l, c_qk, c_v, sms, lw, hashed),
                  lw.chunks), lw)
                for lw in (TrainFwdLaunch(slabs, windows, -(-bn // per), per,
                                          slabs * rows_slab, ldg)
                           for per in pers)))
    return [(cost, lw) for (cost, _), lw in out]


@functools.lru_cache(maxsize=None)
def train_fwd_launch(b: int, h: int, n: int, l: int, c_qk: int, c_v: int,
                     sms: int) -> TrainFwdLaunch:
    """K2f's and K3f's geometry: the (slabs, windows at a time, windows
    per chunk) of least modelled time. The model (:func:`_fwd_cost`): a
    lane spends issue slots on each tile of each window of its chunk; an
    SM holds as many blocks as its shared memory, 32 warps and its
    registers allow, and issues 4 warp instructions a clock when it holds
    ``_FWD_FULL_RATE_WARPS`` warps or more, proportionally fewer below;
    each block loads its bias rows from L2 before it starts; blocks run in
    rounds over the ``sms`` SMs. Ties go to fewer chunks (less bias staged
    again)."""
    return min(train_fwd_candidates(b, h, n, l, c_qk, c_v, sms),
               key=lambda c: (c[0], c[1].chunks))[1]


@functools.lru_cache(maxsize=None)
def eval_fwd_launch(b: int, h: int, n: int, l: int, c_qk: int, c_v: int,
                    sms: int) -> TrainFwdLaunch:
    """K1's geometry: of the train forward's grid, the geometry of least
    modelled time without the hash. A window of one tile (L <= 64) reads
    the bias through L1, and there ties go to more chunks (nothing is
    staged again, more SMs run); longer windows stage it, ties to fewer
    chunks."""
    ldg = l <= _FWD_TILE
    return min(train_fwd_candidates(b, h, n, l, c_qk, c_v, sms, ldg, False),
               key=lambda c: (c[0], -c[1].chunks if ldg else c[1].chunks))[1]


def window_attention_train_fwd_tiled_plain(q, k, v, bias, seed, scale: float,
                                           p: float, rows: int, cols: int,
                                           chunk: int):
    """K2f's and K3f's decomposition in torch ops, returning (out, lse):
    blocks of ``rows`` query rows of a head walk chunks of ``chunk`` of the
    head's windows (window ``b·N + n``) in tiles of ``cols`` columns (the
    kernel's 64), each in steps of 32; each row's columns are taken by 4
    column lanes, lane x taking columns [4x, 4x + 4) and [16 + 4x,
    16 + 4x + 4) of every step, with an online softmax in base 2
    per lane (logit = (q·scale·log2e)·k + bias·log2e; per tile the running
    max, the sum and the kept-weight accumulator rescaled once a step, then
    exp2
    weights added); the lanes' partials merged as the kernel's xor
    shuffles add them ((0 + 1) + (2 + 3)); out = acc·(1/(1 − p))/sum and
    lse = (max + log2 sum)·ln 2."""
    b, h, n, c_qk, l = q.shape
    c_v = v.shape[3]
    log2e = 1.4426950408889634
    keep_scale = 1.0 / (1.0 - p) if p > 0.0 else 1.0
    if p > 0.0:
        s, off = _seed_pair(seed)
        keep = keep_mask(window_ids(b, h, n, l, off, q.device), p, s)
    # (h, B·N, ...): the windows of a head in the order the blocks walk them
    heads = lambda t: t.transpose(0, 1).reshape(h, b * n, *t.shape[3:])  # noqa
    qh, kh, vh = heads(q), heads(k), heads(v)
    kp = heads(keep) if p > 0.0 else None
    bias2 = bias * log2e
    out = torch.empty_like(vh)
    lse = torch.empty(h, b * n, l, device=q.device)
    half = _FWD_STEP // 2
    for lo, hi in _chunk_ranges(b * n, -(-(b * n) // chunk), chunk):
        for r0 in range(0, l, rows):
            r1 = min(l, r0 + rows)
            logit = (torch.einsum("hwcl,hwcm->hwlm",
                                  qh[:, lo:hi, :, r0:r1] * (scale * log2e),
                                  kh[:, lo:hi]) + bias2[:, None, r0:r1])
            parts = []
            for x in range(_FWD_TX):
                mx = logit.new_full(logit.shape[:-1], -1e30)
                tot = logit.new_zeros(logit.shape[:-1])
                acc = logit.new_zeros(*logit.shape[:-1], c_v)
                steps = [u0 for t0 in range(0, l, cols)
                         for u0 in range(t0, min(l, t0 + cols), _FWD_STEP)]
                for u0 in steps:
                    idx = [c for a in (u0 + 4 * x, u0 + half + 4 * x)
                           for c in range(a, min(a + 4, l))]
                    if not idx:
                        continue
                    sl = logit[..., idx]
                    mn = torch.maximum(mx, sl.amax(dim=-1))
                    f = torch.exp2(mx - mn)
                    tot, acc, mx = tot * f, acc * f[..., None], mn
                    e = torch.exp2(sl - mx[..., None])
                    tot = tot + e.sum(dim=-1)
                    if p > 0.0:
                        e = torch.where(kp[:, lo:hi, r0:r1][..., idx], e,
                                        0.0)
                    acc = acc + torch.einsum("hwlm,hwcm->hwlc", e,
                                             vh[:, lo:hi][..., idx])
                parts.append((mx, tot, acc))
            m = parts[0][0]
            for mx, _, _ in parts[1:]:
                m = torch.maximum(m, mx)
            scaled = [(t * torch.exp2(mx - m),
                       a * torch.exp2(mx - m)[..., None])
                      for mx, t, a in parts]
            tot = (scaled[0][0] + scaled[1][0]) + (scaled[2][0]
                                                   + scaled[3][0])
            acc = (scaled[0][1] + scaled[1][1]) + (scaled[2][1]
                                                   + scaled[3][1])
            out[:, lo:hi, :, r0:r1] = (acc * (keep_scale / tot)[..., None]
                                       ).transpose(-1, -2)
            lse[:, lo:hi, r0:r1] = (m + torch.log2(tot)) * math.log(2.0)
    return tuple(t.reshape(h, b, n, *t.shape[2:]).transpose(0, 1)
                 .contiguous() for t in (out, lse))


class TrainBwdLaunch(NamedTuple):
    """K2b's launch geometry for one shape (``csrc/pwa_attention_bwd.cu``
    checks it): the tile edge and the tiles along each edge of a window's
    (L, L) scores, and the chunks of ``per`` windows of each head that its
    blocks walk (window ``j`` of a head is sample ``j // N``, window
    ``j % N``)."""
    tile: int
    tiles: int
    chunks: int
    per: int

    def window_ranges(self, bn: int) -> List[Tuple[int, int]]:
        return _chunk_ranges(bn, self.chunks, self.per)


_PASS_ROW = 64 + 4          # row stride of K2b's dS and W tiles


def _k2b_smem_floats(tile: int, c_qk: int, c_v: int) -> int:
    """Shared memory of a K2b tiles block (``tiles_smem``): the bias tile,
    two stages of a window's tokens and statistics, the dS and W tiles."""
    stage = (2 * c_qk + 2 * c_v) * (tile + 4) + 2 * tile
    return tile * (tile + 4) + 2 * stage + 2 * tile * _PASS_ROW


@functools.lru_cache(maxsize=None)
def train_bwd_launch(b: int, h: int, n: int, l: int, c_qk: int, c_v: int,
                     sms: int) -> TrainBwdLaunch:
    """K2b's tiling. The tile edge is 64 up to L = 64 (one tile a window)
    and 128 beyond (64 where a 128 block's shared memory would not fit:
    Cqk 16 with Cv 32); blocks of 128-tiles take a whole SM, two 64-tile
    blocks share one. The windows of each head are split into the chunks
    that fill those slots in the fewest rounds of the longest chunk, and of
    those the fewest chunks (fewer dbias partials)."""
    tile = 64 if l <= 64 or _k2b_smem_floats(128, c_qk, c_v) > _SMEM_FLOATS \
        else 128
    tiles = -(-l // tile)
    slots = sms * (1 if tile == 128 else 2)
    bn = b * n
    best = None
    for per in range(1, bn + 1):
        chunks = -(-bn // per)
        cost = -(-chunks * tiles * tiles * h // slots) * per
        if best is None or cost <= best[0]:
            best = (cost, per)
    per = best[1]
    return TrainBwdLaunch(tile, tiles, -(-bn // per), per)


def window_attention_train_bwd_tiled_plain(q, k, v, bias, seed, do, out, lse,
                                           scale: float, p: float,
                                           tile: int, per: int):
    """K2b's and K3b's decomposition in torch ops: P from the forward's
    ``lse``, D = rowsum(dO ⊙ out), each (row tile I, column tile J) of
    edge ``tile`` forming dS once; dq summed over the J partials, dk and dv
    over the I partials, in tile order; dbias per chunk of ``per`` windows
    of a head (windows numbered ``b·N + n``), the chunks added in order."""
    b, h, n, _, l = q.shape
    prob = torch.exp(torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
                     + bias[None, :, None] - lse[..., None])
    if p > 0.0:
        s, off = _seed_pair(seed)
        keep = keep_mask(window_ids(b, h, n, l, off, q.device), p, s)
        inv = 1.0 / (1.0 - p)
    d = (do * out).sum(dim=3)                                   # (b,h,n,L)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    dbias = torch.zeros_like(bias)
    bn = b * n
    for i0 in range(0, l, tile):
        for j0 in range(0, l, tile):
            pr = prob[..., i0:i0 + tile, j0:j0 + tile]
            dw = torch.einsum("bhncl,bhncm->bhnlm", do[..., i0:i0 + tile],
                              v[..., j0:j0 + tile])
            if p > 0.0:
                kp = keep[..., i0:i0 + tile, j0:j0 + tile]
                dw = torch.where(kp, dw * inv, 0.0)
                wt = torch.where(kp, pr * inv, 0.0)
            else:
                wt = pr
            ds = pr * (dw - d[..., i0:i0 + tile, None])
            dq[..., i0:i0 + tile] += torch.einsum("bhncm,bhnlm->bhncl",
                                                  k[..., j0:j0 + tile], ds)
            dk[..., j0:j0 + tile] += torch.einsum("bhncl,bhnlm->bhncm",
                                                  q[..., i0:i0 + tile], ds)
            dv[..., j0:j0 + tile] += torch.einsum("bhnlm,bhncl->bhncm", wt,
                                                  do[..., i0:i0 + tile])
            # (h, windows, tile, tile), the windows of a head in order
            ds_w = ds.transpose(0, 1).reshape(h, bn, *ds.shape[-2:])
            for lo in range(0, bn, per):
                dbias[:, i0:i0 + tile, j0:j0 + tile] += \
                    ds_w[:, lo:lo + per].sum(dim=1)
    return dq * scale, dk * scale, dv, dbias


def window_attention_train_bwd(q, k, v, bias, seed, do, scale: float,
                               p: float, out, lse):
    """K2b: (dq, dk, dv, dbias) of the train attention, every sum in a fixed
    order, from K2f's fp32 ``out`` (its ``out32``) and ``lse`` of the same
    inputs; q, k, v and do fp32 or bf16, dq, dk, dv in their dtype, dbias
    fp32. Its plain version recomputes the softmax and takes neither."""
    if q.device.type == "cpu":
        return window_attention_train_bwd_plain(q, k, v, bias, seed, do,
                                                scale, p)
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, out, lse, seed=seed,
                                   tokens=(do,),
                                   dtypes=(torch.float32, torch.bfloat16))
    if do.shape != v.shape or out.shape != v.shape \
            or lse.shape != (b, h, n, l):
        raise ValueError(f"do {tuple(do.shape)}, out {tuple(out.shape)} or "
                         f"lse {tuple(lse.shape)} does not match v "
                         f"{tuple(v.shape)}")
    if b * n == 0:
        raise ValueError("no windows")
    lw = train_bwd_launch(b, h, n, l, c_qk, c_v, _cuda.sm_count(q.device))
    dev = q.device
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    stats = torch.empty((b, h, n, 2, l), device=dev)
    part = torch.empty((lw.tiles * (2 * q.numel() + v.numel())
                        if lw.tiles > 1 else 1,), device=dev)
    partb = torch.empty((lw.chunks * bias.numel() if lw.chunks > 1 else 1,),
                        device=dev)
    lib = _cuda.lib("pwa_attention_bwd", q.dtype)
    with torch.cuda.device(dev):
        err = lib.vs_pwa_attention_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dbias.data_ptr(),
            stats.data_ptr(), part.data_ptr(), partb.data_ptr(), b, h, n,
            c_qk, c_v, l, lw.tile, lw.chunks, lw.per, float(scale),
            drop_threshold(p) if p > 0.0 else 0, 1.0 / (1.0 - p),
            _cuda.stream_ptr(dev))
    _cuda.check(lib, err, "pwa_attention_train_bwd")
    _cuda.count_launch(window_attention_train_bwd, q.dtype)
    return dq, dk, dv, dbias


window_attention_train_bwd.launches = 0
window_attention_train_bwd.launches_bf16 = 0


# ---------------------------------------------------------------------------
# Train attention for long windows (K3f forward, K3b backward).
# ---------------------------------------------------------------------------

# (Cqk, Cv) pairs K3 is instantiated for (csrc/pwa_attention_long.cu): the
# only long window of any config is bench.py's 128³ level 1.
LONG_KERNEL_WIDTHS = {(8, 8)}
_K2_MAX_L = 512


def uses_long_kernel(l: int) -> bool:
    """Whether train attention at window length ``l`` takes K3 (True) or
    K2 (False): K3 for L > 512, where the JAX package too leaves its
    whole-window kernels for the row-blocked ones. Every window of the
    dataset configs (L <= 512, Hecktor's largest) takes K2; bench.py's 128³
    level 1 (L = 1024) takes K3."""
    return l > _K2_MAX_L


def window_attention_train_fwd_long_plain(q, k, v, bias, seed, scale: float,
                                          p: float):
    """K3f's function, ``_train_fwd_rb_kernel`` (434-447): the kept weights
    of :func:`window_attention_train_fwd_plain` rounded to v's dtype before
    ·V, the product in fp32, the output rounded once. Returns (out, out32)
    with out32 the product of the unrounded weights, from which K3b forms
    D as the Pallas backward forms Σ P·dP (the rounded output would miss
    it by the weights' rounding). In fp32 both are K2's output."""
    weights = _train_weights(q, k, bias, seed, scale, p)
    v32 = v.float()
    out32 = torch.einsum("bhnlm,bhncm->bhncl", weights, v32)
    if v.dtype == torch.float32:
        return out32, out32
    out = torch.einsum("bhnlm,bhncm->bhncl", weights.to(v.dtype).float(), v32)
    return out.to(v.dtype), out32


def window_attention_train_fwd_long(q, k, v, bias, seed, scale: float,
                                    p: float):
    """K3f: train attention forward for windows longer than 512 tokens, at
    the widths K3b is built for; the same kernel as K2f, whose on-chip
    memory grows with L only by its bias rows (32 rows of L at L = 1024).
    q, k, v fp32 or bf16 (bias fp32); (out, lse, out32) as K2f returns them,
    which K3b takes. Its bf16 form rounds the kept weights before ·V (two
    passes over each window) and its out32 is the product of the unrounded
    weights. Its plain version is :func:`window_attention_train_fwd_long_plain`
    with :func:`train_lse_plain`."""
    if q.device.type == "cpu":
        out, out32 = window_attention_train_fwd_long_plain(q, k, v, bias, seed,
                                                           scale, p)
        return out, train_lse_plain(q, k, bias, scale), out32
    return _train_fwd_kernel(window_attention_train_fwd_long,
                             "vs_pwa_attention_long_train",
                             LONG_KERNEL_WIDTHS, q, k, v, bias, seed, scale, p,
                             dtypes=(torch.float32, torch.bfloat16))


window_attention_train_fwd_long.launches = 0
window_attention_train_fwd_long.launches_bf16 = 0

_LONG_TILE = 128  # dbias tile edge of K3b (csrc/pwa_attention_long.cu:kBT)


def long_bwd_tiles(l: int) -> int:
    """K3b's row (and column) tiles of 128: its grid is tiles × tiles ×
    heads, each block walking all the head's windows, and dq, dk, dv have
    this many partials each (its plain form is
    :func:`window_attention_train_bwd_tiled_plain` at tile 128, one chunk)."""
    return -(-l // _LONG_TILE)


def window_attention_train_bwd_long(q, k, v, bias, seed, do, scale: float,
                                    p: float, out, lse):
    """K3b: (dq, dk, dv, dbias) of the train attention, dbias summed over
    the windows in a fixed order, from K3f's fp32 ``out`` (its ``out32``)
    and ``lse`` of the same inputs; q, k, v and do fp32 or bf16, dq, dk, dv
    in their dtype, dbias fp32. Its bf16 form rounds the kept weights
    before the dV product and dS before the dq and dk products. Its plain
    version is K2's with those roundings
    (:func:`window_attention_train_bwd_plain` with ``row_blocked``), which
    recomputes the softmax and takes neither out nor lse."""
    if q.device.type == "cpu":
        return window_attention_train_bwd_plain(q, k, v, bias, seed, do,
                                                scale, p, row_blocked=True)
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, out, lse, seed=seed,
                                   tokens=(do,), widths=LONG_KERNEL_WIDTHS,
                                   dtypes=(torch.float32, torch.bfloat16))
    if do.shape != v.shape or out.shape != v.shape \
            or lse.shape != (b, h, n, l):
        raise ValueError(f"do {tuple(do.shape)}, out {tuple(out.shape)} or "
                         f"lse {tuple(lse.shape)} does not match v "
                         f"{tuple(v.shape)}")
    if b * n == 0:
        raise ValueError("no windows")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    stats = torch.empty((b, h, n, 2, l), device=q.device)
    part = torch.empty((3, long_bwd_tiles(l)) + tuple(q.shape),
                       device=q.device)
    lib = _cuda.lib("pwa_attention_long", q.dtype)
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention_long_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            part.data_ptr(), dbias.data_ptr(), b, h, n, c_qk, c_v, l,
            float(scale), drop_threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention_long_train_bwd")
    _cuda.count_launch(window_attention_train_bwd_long, q.dtype)
    return dq, dk, dv, dbias


window_attention_train_bwd_long.launches = 0
window_attention_train_bwd_long.launches_bf16 = 0


class _TrainAttention(torch.autograd.Function):
    """Saves the inputs with the forward's fp32 output and log-sum-exp,
    which the backward kernel takes (``_wat_fwd`` / ``_wat_bwd``; the plain
    backward on the CPU recomputes the softmax and takes neither). K2 or K3
    by :func:`uses_long_kernel` of the window length."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, p):
        ctx.scale, ctx.p = scale, p
        ctx.long = uses_long_kernel(q.shape[-1])
        fwd = window_attention_train_fwd_long if ctx.long \
            else window_attention_train_fwd
        out, lse, out32 = fwd(q, k, v, bias, seed, scale, p)
        ctx.save_for_backward(q, k, v, bias, seed, out32, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        bwd = window_attention_train_bwd_long if ctx.long \
            else window_attention_train_bwd
        q, k, v, bias, seed, out, lse = ctx.saved_tensors
        grads = bwd(q, k, v, bias, seed, do.contiguous(), ctx.scale, ctx.p,
                    out, lse)
        return (*grads, None, None, None)


def window_attention_train(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor,
                           seed: torch.Tensor, scale: float,
                           p: float) -> torch.Tensor:
    """Train attention with weight dropout at rate ``p``, differentiable in
    q, k, v and bias. q, k, v fp32 or bf16, bias fp32. ``seed``: int32
    ``[step_seed, batch_offset]`` on the tensors' device (the offset is 0
    on one device)."""
    return _TrainAttention.apply(q, k, v, bias, seed, scale, p)
