"""JLC block: kernels K4f/K4b (stage 1) and K5f/K5b (stage 2).

Replaces the Pallas kernels of ``veloxseg_tpu/ops/fused_jlc.py``:
``_k1_kernel`` and ``_k1_bwd_kernel`` (stage 1), ``_k2_kernel`` and
``_k2_bwd_kernel`` (stage 2), tied together there by the custom VJP
``_fused_core``. The port runs them on plain channels-first tensors
``(B, C, D, H, W)``; the 2×2×2 packed parity stream of the TPU layout is
not carried over.

- stage 1: ``out1 = x + Σ_k GELU(IN(gconv_k(x)))`` (``csrc/jlc_stage1.cu``)
- stage 2: ``out = out1 + W2·GELU(W1·IN(out1) + b1) + b2``
  (``csrc/jlc_stage2.cu``)

IN is the affine-free InstanceNorm (eps 1e-5, ``max(var, 0)``); GELU is
exact (erf). Each stage is a ``torch.autograd.Function`` that saves only
its inputs and weights and recomputes the rest in its backward:

- stage 1: K4b recomputes the branch convs and their IN statistics and
  emits the cotangent at each branch's conv output; the convs' input and
  weight gradients then run on cuDNN, as the JAX package runs them on XLA
  (``fused_jlc.py:369-374``).
- stage 2: K5b recomputes the IN and the MLP and emits dx and the weight
  and bias gradients, summed over batch and voxels in a fixed order.

The kernels do not read the branch conv biases: they cancel inside the
branch InstanceNorm, so their gradient is an exact 0
(``fused_jlc.py:29-32``). The plain versions add them, and the tests show
that the two agree. Each wrapper runs the plain version for a CPU tensor
and the kernel for a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..nn.norms import instance_norm
from . import _cuda

_MAX_BRANCHES = 3
_OCH = 4  # output channels per conv thread (csrc/jlc_stage1.cu)
_TILE = 32  # voxels per K5b tile (csrc/jlc_stage2.cu)


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx GELU(x) = Φ(x) + x·φ(x) (``fused_jlc.py:80-84``)."""
    cdf = 0.5 * (1.0 + torch.erf(x * math.sqrt(0.5)))
    pdf = torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
    return cdf + x * pdf


def _plane_stats(y: torch.Tensor):
    """Per-(b, c) mean and rstd over the spatial axes, as
    :func:`instance_norm` computes them."""
    axes = tuple(range(2, y.dim()))
    count = math.prod(y.shape[2:])
    mean = y.sum(dim=axes, keepdim=True) / count
    var = y.square().sum(dim=axes, keepdim=True) / count - mean.square()
    return mean, torch.rsqrt(var.clamp_min(0.0) + 1e-5)


def _in_backward(d: torch.Tensor, yhat: torch.Tensor,
                 rstd: torch.Tensor) -> torch.Tensor:
    """InstanceNorm backward: r·(d − mean(d) − ŷ·mean(d·ŷ))."""
    axes = tuple(range(2, d.dim()))
    return rstd * (d - d.mean(dim=axes, keepdim=True)
                   - yhat * (d * yhat).mean(dim=axes, keepdim=True))


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def jlc_stage1_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], groups: int
                     ) -> torch.Tensor:
    """Stage 1 with torch ops: grouped conv per branch (+bias) → IN → GELU,
    summed onto the residual."""
    branches = 0
    for w, b in zip(weights, biases):
        y = F.conv3d(x, w, b, padding=w.shape[-1] // 2, groups=groups)
        branches = branches + F.gelu(instance_norm(y))
    return x + branches


def jlc_stage1_bwd_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         g: torch.Tensor, groups: int) -> torch.Tensor:
    """K4b's function: the cotangent at each branch's conv output,
    ``(nb, B, C, D, H, W)``, given the cotangent ``g`` of stage 1's
    output (``_k1_bwd_kernel``)."""
    out = []
    for w in weights:
        y = F.conv3d(x, w, None, padding=w.shape[-1] // 2, groups=groups)
        mean, rstd = _plane_stats(y)
        yhat = (y - mean) * rstd
        out.append(_in_backward(g * _gelu_grad(yhat), yhat, rstd))
    return torch.stack(out)


def jlc_stage2_plain(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Stage 2 with torch ops; ``w1`` (E·C, C, 1, 1, 1), ``w2`` (C, E·C,
    1, 1, 1) as the reference's 1×1 convs store them."""
    z = F.conv3d(instance_norm(out1), w1, b1)
    z = F.conv3d(F.gelu(z), w2, b2)
    return out1 + z


def jlc_stage2_bwd_plain(out1: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor):
    """K5b's function (``_k2_bwd_kernel``): ``(dx, dw1, db1, dw2, db2)``
    given the cotangent ``g`` of stage 2's output, the weight gradients
    in the port's weight shapes."""
    b, c = out1.shape[:2]
    hid = w1.shape[0]
    mean, rstd = _plane_stats(out1)
    yhat = ((out1 - mean) * rstd).reshape(b, c, -1)
    g3 = g.reshape(b, c, -1)
    w1m, w2m = w1.reshape(hid, c), w2.reshape(c, hid)
    z1p = torch.einsum("ec,bcs->bes", w1m, yhat) + b1[:, None]
    db2 = g3.sum(dim=(0, 2))
    dw2 = torch.einsum("bcs,bes->ce", g3, F.gelu(z1p))
    dz1 = torch.einsum("ce,bcs->bes", w2m, g3) * _gelu_grad(z1p)
    db1 = dz1.sum(dim=(0, 2))
    dw1 = torch.einsum("bes,bcs->ec", dz1, yhat)
    dz = torch.einsum("ec,bes->bcs", w1m, dz1)
    dx = g3 + _in_backward(dz, yhat, rstd.reshape(b, c, 1))
    return (dx.reshape(out1.shape), dw1.reshape(w1.shape), db1,
            dw2.reshape(w2.shape), db2)


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check_cuda(x: torch.Tensor, *tensors: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t in (x,) + tensors:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 tensors on "
                             f"{x.device}, got {t.dtype} on {t.device}")


def _stage1_args(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 groups: int):
    """Checked kernel arguments shared by K4f and K4b."""
    weights = [w.contiguous() for w in weights]
    _check_cuda(x, *weights)
    c = x.shape[1]
    nb = len(weights)
    ks = [int(wt.shape[-1]) for wt in weights]
    cg = c // groups
    if not 1 <= nb <= _MAX_BRANCHES or cg * groups != c or cg % _OCH \
            or any(k % 2 == 0 for k in ks) \
            or any(tuple(wt.shape) != (c, cg, k, k, k)
                   for wt, k in zip(weights, ks)):
        raise ValueError(f"K4 takes 1-{_MAX_BRANCHES} odd cubic branches "
                         f"with C/groups a multiple of {_OCH}; got C={c}, "
                         f"groups={groups}, kernels {ks}")
    ptrs = [wt.data_ptr() for wt in weights] + [None] * (_MAX_BRANCHES - nb)
    return weights, nb, ptrs, ks + [0] * (_MAX_BRANCHES - nb)


def _jlc_stage1_fwd(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], groups: int
                    ) -> torch.Tensor:
    """K4f (or the plain version for a CPU tensor)."""
    if x.device.type == "cpu":
        return jlc_stage1_plain(x, weights, biases, groups)
    weights, nb, ptrs, ks = _stage1_args(x, weights, groups)
    b, c, d, h, w = x.shape
    scratch = torch.empty((nb, b, c, d, h, w), device=x.device)
    mean = torch.empty((nb * b * c,), device=x.device)
    rstd = torch.empty_like(mean)
    out = torch.empty_like(x)
    lib = _cuda.lib("jlc_stage1")
    with torch.cuda.device(x.device):
        err = lib.vs_jlc_stage1(
            x.data_ptr(), *ptrs, scratch.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), out.data_ptr(), b, c, d, h, w, groups, nb, *ks,
            _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "jlc_stage1")
    jlc_stage1.launches += 1
    return out


def jlc_stage1_bwd(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   g: torch.Tensor, groups: int) -> torch.Tensor:
    """K4b: the cotangent at each branch's conv output, (nb, B, C, D, H, W)."""
    if x.device.type == "cpu":
        return jlc_stage1_bwd_plain(x, weights, g, groups)
    weights, nb, ptrs, ks = _stage1_args(x, weights, groups)
    _check_cuda(x, g)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} differs from x {tuple(x.shape)}")
    b, c, d, h, w = x.shape
    dy = torch.empty((nb, b, c, d, h, w), device=x.device)
    mean = torch.empty((nb * b * c,), device=x.device)
    rstd = torch.empty_like(mean)
    lib = _cuda.lib("jlc_stage1")
    with torch.cuda.device(x.device):
        err = lib.vs_jlc_stage1_bwd(
            x.data_ptr(), *ptrs, g.data_ptr(), dy.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), b, c, d, h, w, groups, nb, *ks,
            _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "jlc_stage1_bwd")
    jlc_stage1_bwd.launches += 1
    return dy


jlc_stage1_bwd.launches = 0


def _stage2_mats(out1, w1, w2):
    c = out1.shape[1]
    hid = w1.shape[0]
    w1m = w1.reshape(hid, -1).contiguous()
    w2m = w2.reshape(w2.shape[0], -1).contiguous()
    if w1m.shape != (hid, c) or w2m.shape != (c, hid):
        raise ValueError(f"K5 weight shapes do not match C={c}: "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    return w1m, w2m, hid


def _jlc_stage2_fwd(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K5f (or the plain version for a CPU tensor)."""
    if out1.device.type == "cpu":
        return jlc_stage2_plain(out1, w1, b1, w2, b2)
    b, c, d, h, w = out1.shape
    w1m, w2m, hid = _stage2_mats(out1, w1, w2)
    _check_cuda(out1, w1m, b1, w2m, b2)
    if b1.shape != (hid,) or b2.shape != (c,):
        raise ValueError(f"K5f bias shapes {tuple(b1.shape)}, "
                         f"{tuple(b2.shape)} do not match C={c}")
    mean = torch.empty((b * c,), device=out1.device)
    rstd = torch.empty_like(mean)
    out = torch.empty_like(out1)
    lib = _cuda.lib("jlc_stage2")
    with torch.cuda.device(out1.device):
        err = lib.vs_jlc_stage2(
            out1.data_ptr(), w1m.data_ptr(), b1.data_ptr(), w2m.data_ptr(),
            b2.data_ptr(), mean.data_ptr(), rstd.data_ptr(), out.data_ptr(),
            b, c, hid, d * h * w, _cuda.stream_ptr(out1.device))
    _cuda.check(lib, err, "jlc_stage2")
    jlc_stage2.launches += 1
    return out


def mlp_bwd_chunks(b: int, s: int, sms: int) -> int:
    """Tile chunks of K5b: about two blocks per SM, none of them empty."""
    tiles = b * -(-s // _TILE)
    per = -(-tiles // max(1, min(tiles, 2 * sms)))
    return -(-tiles // per)


def jlc_stage2_bwd(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, g: torch.Tensor):
    """K5b: ``(dx, dw1, db1, dw2, db2)`` of stage 2."""
    if out1.device.type == "cpu":
        return jlc_stage2_bwd_plain(out1, w1, b1, w2, g)
    b, c, d, h, w = out1.shape
    s = d * h * w
    w1m, w2m, hid = _stage2_mats(out1, w1, w2)
    _check_cuda(out1, w1m, b1, w2m, g)
    if b1.shape != (hid,) or g.shape != out1.shape:
        raise ValueError(f"K5b: b1 {tuple(b1.shape)} or g {tuple(g.shape)} "
                         f"does not match C={c}, E·C={hid}")
    chunks = mlp_bwd_chunks(b, s, _cuda.sm_count(out1.device))
    dev = out1.device
    mean = torch.empty((b * c,), device=dev)
    rstd = torch.empty_like(mean)
    dz = torch.empty_like(out1)
    part = torch.empty((chunks, 2 * hid * c + hid + c), device=dev)
    dx = torch.empty_like(out1)
    dw1 = torch.empty((hid, c), device=dev)
    dw2 = torch.empty((c, hid), device=dev)
    db1 = torch.empty((hid,), device=dev)
    db2 = torch.empty((c,), device=dev)
    lib = _cuda.lib("jlc_stage2")
    with torch.cuda.device(dev):
        err = lib.vs_jlc_stage2_bwd(
            out1.data_ptr(), w1m.data_ptr(), b1.data_ptr(), w2m.data_ptr(),
            g.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dz.data_ptr(),
            part.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), b, c, hid, s, chunks,
            _cuda.stream_ptr(dev))
    _cuda.check(lib, err, "jlc_stage2_bwd")
    jlc_stage2_bwd.launches += 1
    return dx, dw1.reshape(w1.shape), db1, dw2.reshape(w2.shape), db2


jlc_stage2_bwd.launches = 0


# ---------------------------------------------------------------------------
# The two stages as autograd Functions.
# ---------------------------------------------------------------------------

class _Stage1(torch.autograd.Function):
    """Inputs ``(x, groups, nb, *weights, *biases)``."""

    @staticmethod
    def forward(ctx, x, groups, nb, *params):
        weights, biases = params[:nb], params[nb:]
        ctx.groups, ctx.nb = groups, nb
        ctx.save_for_backward(x, *weights)
        return _jlc_stage1_fwd(x, weights, biases, groups)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        g = g.contiguous()
        dy = jlc_stage1_bwd(x, weights, g, ctx.groups)
        dx = g
        dws: List[torch.Tensor] = []
        for w, dyj in zip(weights, dy):
            # the branch conv's dgrad and wgrad on cuDNN (CPU: ATen)
            dxj, dwj, _ = torch.ops.aten.convolution_backward(
                dyj, x, w, None, [1, 1, 1], [w.shape[-1] // 2] * 3,
                [1, 1, 1], False, [0, 0, 0], ctx.groups, [True, True, False])
            dx = dx + dxj
            dws.append(dwj)
        zeros = [torch.zeros(w.shape[0], device=w.device, dtype=w.dtype)
                 for w in weights]
        return (dx, None, None, *dws, *zeros)


class _Stage2(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out1, w1, b1, w2, b2):
        ctx.save_for_backward(out1, w1, b1, w2)
        return _jlc_stage2_fwd(out1, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        out1, w1, b1, w2 = ctx.saved_tensors
        return jlc_stage2_bwd(out1, w1, b1, w2, g.contiguous())


def _needs_graph(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def jlc_stage1(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], groups: int) -> torch.Tensor:
    """JLC stage 1 on ``(B, C, D, H, W)``; ``weights[j]`` is the
    ``(C, C/groups, k, k, k)`` kernel of branch j (odd k). K4f forward;
    under autograd, K4b and the convs' dgrad/wgrad backward."""
    if not _needs_graph(x, *weights, *biases):
        return _jlc_stage1_fwd(x, weights, biases, groups)
    return _Stage1.apply(x, groups, len(weights), *weights, *biases)


jlc_stage1.launches = 0


def jlc_stage2(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """JLC stage 2 on ``(B, C, D, H, W)``: K5f forward, K5b backward."""
    if not _needs_graph(out1, w1, b1, w2, b2):
        return _jlc_stage2_fwd(out1, w1, b1, w2, b2)
    return _Stage2.apply(out1, w1, b1, w2, b2)


jlc_stage2.launches = 0
