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
"""

from __future__ import annotations

import torch

from . import _cuda

_NEG = -1e38


def wkv_plain(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``wkv_scan``'s recurrence as a loop over T. w, u: (C,); k, v:
    (B, T, C); returns (B, T, C), float32."""
    b, t, c = k.shape
    kf, vf = k.float(), v.float()
    wf, uf = w.float()[None], u.float()[None]
    aa = torch.zeros((b, c), device=k.device)
    bb = torch.zeros((b, c), device=k.device)
    pp = torch.full((b, c), _NEG, device=k.device)
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


def wkv(w: torch.Tensor, u: torch.Tensor, k: torch.Tensor,
        v: torch.Tensor) -> torch.Tensor:
    """K6 on CUDA tensors, the plain version on CPU tensors; (B, T, C)."""
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
    lib = _cuda.lib("wkv")
    with torch.cuda.device(k.device):
        err = lib.vs_wkv(w.data_ptr(), u.data_ptr(), k.data_ptr(),
                         v.data_ptr(), y.data_ptr(), b, t, c,
                         _cuda.stream_ptr(k.device))
    _cuda.check(lib, err, "wkv")
    wkv.launches += 1
    return y


wkv.launches = 0
