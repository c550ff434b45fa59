"""Paired-window attention: the eval kernel K1, the train kernels K2f,
K2b and, for long windows, K3f, K3b, each with its plain version.

Replaces ``veloxseg_tpu/ops/pwa_attention.py``: ``window_attention_pallas``
(the Pallas ``_attn_kernel``, K1) and ``window_attention_train`` (the
custom VJP over ``_train_fwd_kernel`` and ``_train_bwd_kernel``, K2, and
their row-blocked forms ``_train_fwd_rb_kernel`` and
``_train_bwd_rb_kernel``, K3). Token layout ``(B, h, N, C, L)``: per
(batch, head, window), q/k are ``(Cqk, L)`` and v ``(Cv, L)``; the bias
is ``(h, L, L)``. The CUDA kernels are ``csrc/pwa_attention.cu`` (K1,
K2f), ``csrc/pwa_attention_bwd.cu`` (K2b) and
``csrc/pwa_attention_long.cu`` (K3f, K3b); :func:`uses_long_kernel`
picks K2 or K3.

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

import functools
from typing import List, NamedTuple, Tuple

import torch

from . import _cuda

# (Cqk, Cv) pairs K1 and K2 are instantiated for (csrc/pwa_attention.cu,
# csrc/pwa_attention_bwd.cu).
KERNEL_WIDTHS = {(cq, cv) for cq in (4, 8, 16) for cv in (4, 8, 16, 32)}

_M32 = 0xFFFFFFFF


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """einsum → +bias → softmax → einsum, as ``window_attention_xla``."""
    scores = torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
    scores = scores + bias[None, :, None]
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhnlm,bhncm->bhncl", weights, v)


def _check(q, k, v, bias, *more, seed=None, widths=KERNEL_WIDTHS):
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
    if (c_qk, c_v) not in widths:
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
                               p: float):
    """K2f: train attention forward; (B, h, N, Cv, L) out and each row's
    log-sum-exp (B, h, N, L), which K2b takes. Its plain version is
    :func:`window_attention_train_fwd_plain` with :func:`train_lse_plain`."""
    if q.device.type == "cpu":
        return (window_attention_train_fwd_plain(q, k, v, bias, seed, scale,
                                                 p),
                train_lse_plain(q, k, bias, scale))
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, seed=seed)
    out = torch.empty_like(v)
    lse = torch.empty((b, h, n, l), device=q.device)
    lib = _cuda.lib("pwa_attention")
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention_train(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, n, c_qk,
            c_v, l, float(scale), drop_threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention_train")
    window_attention_train_fwd.launches += 1
    return out, lse


window_attention_train_fwd.launches = 0


def train_lse_plain(q, k, bias, scale: float) -> torch.Tensor:
    """Each row's log-sum-exp of its logits, (B, h, N, L): what K2f and K3f
    write beside their output for K2b and K3b."""
    scores = torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
    return torch.logsumexp(scores + bias[None, :, None], dim=-1)


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
        """The windows ``[lo, hi)`` of each chunk of a head's ``bn``."""
        return [(i * self.per, min(bn, (i + 1) * self.per))
                for i in range(self.chunks)]


_SMEM_FLOATS = 232448 // 4  # the most a block may hold
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
    order, from K2f's ``out`` and ``lse`` of the same inputs. Its plain
    version recomputes the softmax and takes neither."""
    if q.device.type == "cpu":
        return window_attention_train_bwd_plain(q, k, v, bias, seed, do,
                                                scale, p)
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, do, out, lse, seed=seed)
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
    lib = _cuda.lib("pwa_attention_bwd")
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
    window_attention_train_bwd.launches += 1
    return dq, dk, dv, dbias


window_attention_train_bwd.launches = 0


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


def window_attention_train_fwd_long(q, k, v, bias, seed, scale: float,
                                    p: float):
    """K3f: train attention forward with on-chip memory bounded in L;
    (B, h, N, Cv, L) out and each row's log-sum-exp (B, h, N, L), which
    K3b takes. Its plain version is K2's (the same function) with
    :func:`train_lse_plain`."""
    if q.device.type == "cpu":
        return (window_attention_train_fwd_plain(q, k, v, bias, seed, scale,
                                                 p),
                train_lse_plain(q, k, bias, scale))
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, seed=seed,
                                   widths=LONG_KERNEL_WIDTHS)
    out = torch.empty_like(v)
    lse = torch.empty((b, h, n, l), device=q.device)
    lib = _cuda.lib("pwa_attention_long")
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention_long_train(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, n, c_qk,
            c_v, l, float(scale), drop_threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention_long_train")
    window_attention_train_fwd_long.launches += 1
    return out, lse


window_attention_train_fwd_long.launches = 0

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
    the windows in a fixed order, from K3f's ``out`` and ``lse`` of the
    same inputs. Its plain version is K2's, which recomputes the softmax
    and takes neither."""
    if q.device.type == "cpu":
        return window_attention_train_bwd_plain(q, k, v, bias, seed, do,
                                                scale, p)
    seed = seed.reshape(-1).contiguous()
    b, h, n, c_qk, c_v, l = _check(q, k, v, bias, do, out, lse, seed=seed,
                                   widths=LONG_KERNEL_WIDTHS)
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
    lib = _cuda.lib("pwa_attention_long")
    with torch.cuda.device(q.device):
        err = lib.vs_pwa_attention_long_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            seed.data_ptr(), do.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            part.data_ptr(), dbias.data_ptr(), b, h, n, c_qk, c_v, l,
            float(scale), drop_threshold(p) if p > 0.0 else 0,
            1.0 / (1.0 - p), _cuda.stream_ptr(q.device))
    _cuda.check(lib, err, "pwa_attention_long_train_bwd")
    window_attention_train_bwd_long.launches += 1
    return dq, dk, dv, dbias


window_attention_train_bwd_long.launches = 0


class _TrainAttention(torch.autograd.Function):
    """Saves the inputs with the forward's output and log-sum-exp, which
    the backward kernel takes (``_wat_fwd`` / ``_wat_bwd``; the plain
    backward on the CPU recomputes the softmax and takes neither). K2 or K3
    by :func:`uses_long_kernel` of the window length."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, p):
        ctx.scale, ctx.p = scale, p
        ctx.long = uses_long_kernel(q.shape[-1])
        fwd = window_attention_train_fwd_long if ctx.long \
            else window_attention_train_fwd
        out, lse = fwd(q, k, v, bias, seed, scale, p)
        ctx.save_for_backward(q, k, v, bias, seed, out, lse)
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
    q, k, v and bias. ``seed``: int32 ``[step_seed, batch_offset]`` on the
    tensors' device (the offset is 0 on one device)."""
    return _TrainAttention.apply(q, k, v, bias, seed, scale, p)
