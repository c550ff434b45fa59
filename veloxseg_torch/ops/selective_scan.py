"""The selective scan (Mamba's S6 recurrence) of HCMA-UNet.

Replaces ``veloxseg_tpu/ops/selective_scan.py``, which is XLA there
(``jax.lax.associative_scan``), not a Pallas kernel; here it is torch ops::

    delta = softplus(delta + delta_bias)
    h_t   = exp(delta_t ∘ A) · h_{t-1} + delta_t · B_t · u_t   per (d, n)
    y_t   = C_t · h_t + D ∘ u_t

:func:`selective_scan` runs the recurrence as a doubling (Kogge-Stone)
scan over the state ``(…, L, d, n)``: ⌈log₂ L⌉ steps k = 1, 2, 4, …, each
``b[t] ← a[t]·b[t−k] + b[t]`` and then ``a[t] ← a[t]·a[t−k]`` for t ≥ k,
with the ``a`` of before the step. There is no loop over L on the host
(HCMA's level-0 slices have L = 2304 at 96³), and no division by a
cumulative product (exp(Δ·A) with A down to −32 underflows fp32 within a
few dozen steps, and ``P_t · Σ b_s / P_s`` would be 0/0). Its association
order differs from ``jax.lax.associative_scan``'s, so the two agree to
fp32 rounding, not bit for bit.

:func:`selective_scan` is differentiable through its own backward
(:class:`_SelectiveScan`), where autograd through the doubling steps
would keep each step's state: 24 tensors of ``(…, L, d, n)`` fp32 a
call, tens of GB at HCMA's 96³ B = 4 training step. The adjoint of the
linear recurrence is the reversed recurrence ``λ_t = ∂y_t·C_t +
a_{t+1}·λ_{t+1}``, so the backward recomputes ``a``, ``b`` and ``h``
with the forward's doubling scan and runs the same scan mirrored for
``λ``; then ``∂b = λ`` and ``∂(Δ·A) = λ·a·h_{t−1} = λ·(h − b)``. It
saves the inputs alone and holds five state tensors at its peak. JAX
differentiates ``associative_scan`` with XLA; the two agree to fp32
rounding.

:func:`selective_scan_ref` is the plain sequential recurrence, for the
tests; nothing on the model's path calls it.

Both run in fp32 and cast back to ``u``'s dtype, as the JAX functions do
(``selective_scan.py:46-65``), but for float64, which stays float64 as
the port's norms and attention scores keep it (``models/zoo/common.
wide``): a float64 forward is then a reference for the fp32 one (the JAX
function would round its scan to fp32 there too). Layouts are channels-last: ``u`` and
``delta`` ``(…, L, d)``, ``A`` ``(…, d, n)``, ``B`` and ``C`` ``(…, L,
n)``, ``D`` and ``delta_bias`` ``(…, d)``; the leading axes broadcast
(HCMA passes its four scan directions as a leading axis, where the JAX
module ``vmap``\\ s the function over them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _coefficients(u, delta, A, B, delta_bias, delta_softplus):
    """(u, Δ, a, b) in fp32 (float64 stays float64): a = exp(Δ·A) and
    b = Δ·u·B, each (…, L, d, n)."""
    dt = torch.float64 if u.dtype == torch.float64 else torch.float32
    u = u.to(dt)
    delta = delta.to(dt)
    if delta_bias is not None:
        delta = delta + delta_bias.to(dt).unsqueeze(-2)
    if delta_softplus:
        delta = F.softplus(delta)
    a = torch.exp(delta.unsqueeze(-1) * A.to(dt).unsqueeze(-3))
    b = (delta * u).unsqueeze(-1) * B.to(dt).unsqueeze(-2)
    return u, delta, a, b


def _output(u, h, C, D):
    """y = C·h + D∘u, (…, L, d)."""
    y = (h @ C.to(h.dtype).unsqueeze(-1)).squeeze(-1)
    return y + u * D.to(h.dtype).unsqueeze(-2)


def _scan_(a: torch.Tensor, b: torch.Tensor, reverse: bool = False
           ) -> torch.Tensor:
    """``h_t = a_t·h_{t−1} + b_t`` over axis −3 (with ``reverse``,
    ``h_t = a_t·h_{t+1} + b_t``), as a doubling scan in place: ``b``
    becomes ``h`` and ``a`` is consumed; a product of the halves is the
    only temporary."""
    length = a.shape[-3]
    k = 1
    while k < length:
        if reverse:
            b[..., :-k, :, :] += a[..., :-k, :, :] * b[..., k:, :, :]
            if 2 * k < length:
                a[..., :-k, :, :] = a[..., :-k, :, :] * a[..., k:, :, :]
        else:
            b[..., k:, :, :] += a[..., k:, :, :] * b[..., :-k, :, :]
            if 2 * k < length:
                a[..., k:, :, :] = a[..., k:, :, :] * a[..., :-k, :, :]
        k *= 2
    return b


class _SelectiveScan(torch.autograd.Function):
    """The scan's forward and its backward by the reversed recurrence
    (the module docstring); the inputs are saved, the state recomputed."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, delta_bias, delta_softplus):
        ctx.save_for_backward(u, delta, A, B, C, D, delta_bias)
        ctx.delta_softplus = delta_softplus
        u32, _, a, b = _coefficients(u, delta, A, B, delta_bias,
                                     delta_softplus)
        return _output(u32, _scan_(a, b), C, D).to(u.dtype)

    @staticmethod
    def backward(ctx, gy):
        u, delta, A, B, C, D, bias = ctx.saved_tensors
        uf, step, a, b = _coefficients(u, delta, A, B, bias,
                                       ctx.delta_softplus)
        Af, Bf, Cf, Df = (t.to(uf.dtype) for t in (A, B, C, D))
        gy = gy.to(uf.dtype)
        # the reversed recurrence's coefficients: c_t = a_{t+1}, c_L = 0
        c = torch.zeros_like(a)
        c[..., :-1, :, :] = a[..., 1:, :, :]
        h = _scan_(a, b)
        del a, b
        gC = (gy.unsqueeze(-2) @ h).squeeze(-2)
        lam = _scan_(c, gy.unsqueeze(-1) * Cf.unsqueeze(-2), reverse=True)
        del c
        # ∂b = λ: b = Δ·u·B
        lam_b = (lam @ Bf.unsqueeze(-1)).squeeze(-1)         # Σ_n λ·B
        gB = ((step * uf).unsqueeze(-2) @ lam).squeeze(-2)   # Σ_d λ·Δ·u
        # ∂(Δ·A) = λ·a_t·h_{t−1} = λ·(h − b), into h's storage
        h.sub_((step * uf).unsqueeze(-1) * Bf.unsqueeze(-2))
        h.mul_(lam)
        del lam
        g_step = (h * Af.unsqueeze(-3)).sum(-1) + lam_b * uf
        gA = (h * step.unsqueeze(-1)).sum(-3)
        del h
        gu = lam_b * step + gy * Df.unsqueeze(-2)
        gD = (gy * uf).sum(-2)
        # softplus'(p) = sigmoid(p) = 1 − exp(−softplus(p))
        g_pre = -g_step * torch.expm1(-step) if ctx.delta_softplus \
            else g_step

        def like(g, t):
            """``g`` summed over t's broadcast axes, in t's dtype."""
            return g.sum_to_size(t.shape).to(t.dtype)

        return (like(gu, u), like(g_pre, delta), like(gA, A), like(gB, B),
                like(gC, C), like(gD, D),
                None if bias is None else like(g_pre.sum(-2), bias), None)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = True) -> torch.Tensor:
    """The S6 scan, as a doubling scan; returns ``y`` (…, L, d) in ``u``'s
    dtype. ``a`` and ``b`` are updated in place (with a product of the
    halves as the only temporary), so the state costs three times
    ``(…, L, d, n)`` fp32 at most; under autograd the backward is
    :class:`_SelectiveScan`'s. Its work is one profiler range,
    ``selective_scan``, which ``tools/profile_torch_eval.py`` reports."""
    with torch.profiler.record_function("selective_scan"):
        return _SelectiveScan.apply(u, delta, A, B, C, D, delta_bias,
                                    delta_softplus)


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor,
                       A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       D: torch.Tensor,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = True) -> torch.Tensor:
    """The same recurrence one step of L at a time (``h = a_t·h + b_t``);
    returns fp32 (float64 for float64), as ``veloxseg_tpu/ops/
    selective_scan.selective_scan_ref`` returns fp32."""
    u, _, a, b = _coefficients(u, delta, A, B, delta_bias, delta_softplus)
    h = torch.zeros_like(b[..., 0, :, :])
    hs = []
    for t in range(a.shape[-3]):
        h = a[..., t, :, :] * h + b[..., t, :, :]
        hs.append(h)
    return _output(u, torch.stack(hs, dim=-3), C, D)
