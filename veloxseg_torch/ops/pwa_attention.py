"""Eval paired-window attention: kernel K1 and its plain version.

Replaces ``veloxseg_tpu/ops/pwa_attention.py:window_attention_pallas``
(the Pallas ``_attn_kernel``). Token layout ``(B, h, N, C, L)``: per
(batch, head, window), q/k are ``(Cqk, L)`` and v ``(Cv, L)``; the bias is
``(h, L, L)``. The CUDA kernel is ``csrc/pwa_attention.cu``.

:func:`window_attention` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import _cuda

# (Cqk, Cv) pairs the kernel is instantiated for (csrc/pwa_attention.cu).
KERNEL_WIDTHS = {(cq, cv) for cq in (4, 8, 16) for cv in (4, 8, 16, 32)}


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, scale: float) -> torch.Tensor:
    """einsum → +bias → softmax → einsum, as ``window_attention_xla``."""
    scores = torch.einsum("bhncl,bhncm->bhnlm", q, k) * scale
    scores = scores + bias[None, :, None]
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhnlm,bhncm->bhncl", weights, v)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Eval window attention; (B, h, N, Cv, L) out."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale)
    b, h, n, c_qk, l = q.shape
    c_v = v.shape[3]
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if k.shape != q.shape or v.shape != (b, h, n, c_v, l) \
            or bias.shape != (h, l, l):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} bias "
                         f"{tuple(bias.shape)}")
    if (c_qk, c_v) not in KERNEL_WIDTHS:
        raise ValueError(f"no K1 instance for Cqk={c_qk}, Cv={c_v}")
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
