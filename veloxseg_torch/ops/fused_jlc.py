"""JLC block forward: kernels K4f (stage 1) and K5f (stage 2).

Replaces the forward Pallas kernels of ``veloxseg_tpu/ops/fused_jlc.py``
(``_k1_kernel`` and ``_k2_kernel``, reached through ``jlc_block``). The
port runs them on plain channels-first tensors ``(B, C, D, H, W)``; the
2×2×2 packed parity stream of the TPU layout is not carried over.

- stage 1: ``out1 = x + Σ_k GELU(IN(gconv_k(x)))`` (``csrc/jlc_stage1.cu``)
- stage 2: ``out = out1 + W2·GELU(W1·IN(out1) + b1) + b2``
  (``csrc/jlc_stage2.cu``)

IN is the affine-free InstanceNorm (eps 1e-5, ``max(var, 0)``); GELU is
exact (erf). Each wrapper runs the plain version for a CPU tensor and the
kernel for a CUDA tensor. The kernel does not read the branch conv biases:
they cancel inside the branch InstanceNorm. The plain version adds them,
and the tests show that the two agree.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..nn.norms import instance_norm
from . import _cuda

_MAX_BRANCHES = 3
_OCH = 4  # output channels per conv thread (csrc/jlc_stage1.cu)


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


def jlc_stage2_plain(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Stage 2 with torch ops; ``w1`` (E·C, C, 1, 1, 1), ``w2`` (C, E·C,
    1, 1, 1) as the reference's 1×1 convs store them."""
    z = F.conv3d(instance_norm(out1), w1, b1)
    z = F.conv3d(F.gelu(z), w2, b2)
    return out1 + z


def _check_cuda(x: torch.Tensor, *tensors: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for t in (x,) + tensors:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous float32 tensors on "
                             f"{x.device}, got {t.dtype} on {t.device}")


def jlc_stage1(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], groups: int) -> torch.Tensor:
    """JLC stage 1 on ``(B, C, D, H, W)``; ``weights[j]`` is the
    ``(C, C/groups, k, k, k)`` kernel of branch j (odd k)."""
    if x.device.type == "cpu":
        return jlc_stage1_plain(x, weights, biases, groups)
    weights = [w.contiguous() for w in weights]
    _check_cuda(x, *weights)
    b, c, d, h, w = x.shape
    nb = len(weights)
    ks = [int(wt.shape[-1]) for wt in weights]
    cg = c // groups
    if not 1 <= nb <= _MAX_BRANCHES or cg * groups != c or cg % _OCH \
            or any(k % 2 == 0 for k in ks) \
            or any(tuple(wt.shape) != (c, cg, k, k, k)
                   for wt, k in zip(weights, ks)):
        raise ValueError(f"K4f takes 1-{_MAX_BRANCHES} odd cubic branches "
                         f"with C/groups a multiple of {_OCH}; got C={c}, "
                         f"groups={groups}, kernels {ks}")
    scratch = torch.empty((nb, b, c, d, h, w), device=x.device)
    mean = torch.empty((nb * b * c,), device=x.device)
    rstd = torch.empty_like(mean)
    out = torch.empty_like(x)
    ptrs = [wt.data_ptr() for wt in weights] + [None] * (_MAX_BRANCHES - nb)
    ks = ks + [0] * (_MAX_BRANCHES - nb)
    lib = _cuda.lib("jlc_stage1")
    with torch.cuda.device(x.device):
        err = lib.vs_jlc_stage1(
            x.data_ptr(), *ptrs, scratch.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), out.data_ptr(), b, c, d, h, w, groups, nb, *ks,
            _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "jlc_stage1")
    jlc_stage1.launches += 1
    return out


jlc_stage1.launches = 0


def jlc_stage2(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """JLC stage 2 on ``(B, C, D, H, W)``."""
    if out1.device.type == "cpu":
        return jlc_stage2_plain(out1, w1, b1, w2, b2)
    b, c, d, h, w = out1.shape
    hid = w1.shape[0]
    w1m = w1.reshape(hid, -1).contiguous()
    w2m = w2.reshape(w2.shape[0], -1).contiguous()
    _check_cuda(out1, w1m, b1, w2m, b2)
    if w1m.shape != (hid, c) or w2m.shape != (c, hid) \
            or b1.shape != (hid,) or b2.shape != (c,):
        raise ValueError(f"K5f weight shapes do not match C={c}: "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
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


jlc_stage2.launches = 0
