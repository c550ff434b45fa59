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
    """(u, a, b) in fp32 (float64 stays float64): a = exp(Δ·A) and
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
    return u, a, b


def _output(u, h, C, D):
    """y = C·h + D∘u, (…, L, d)."""
    y = (h @ C.to(h.dtype).unsqueeze(-1)).squeeze(-1)
    return y + u * D.to(h.dtype).unsqueeze(-2)


def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   delta_bias: Optional[torch.Tensor] = None,
                   delta_softplus: bool = True) -> torch.Tensor:
    """The S6 scan, as a doubling scan; returns ``y`` (…, L, d) in ``u``'s
    dtype. ``a`` and ``b`` are updated in place (with a product of the
    halves as the only temporary), so the state costs three times
    ``(…, L, d, n)`` fp32 at most. Its work is one profiler range,
    ``selective_scan``, which ``tools/profile_torch_eval.py`` reports."""
    with torch.profiler.record_function("selective_scan"):
        dtype = u.dtype
        u, a, b = _coefficients(u, delta, A, B, delta_bias, delta_softplus)
        length = a.shape[-3]
        k = 1
        while k < length:
            b[..., k:, :, :] += a[..., k:, :, :] * b[..., :-k, :, :]
            if 2 * k < length:
                a[..., k:, :, :] = a[..., k:, :, :] * a[..., :-k, :, :]
            k *= 2
        del a
        return _output(u, b, C, D).to(dtype)


def selective_scan_ref(u: torch.Tensor, delta: torch.Tensor,
                       A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       D: torch.Tensor,
                       delta_bias: Optional[torch.Tensor] = None,
                       delta_softplus: bool = True) -> torch.Tensor:
    """The same recurrence one step of L at a time (``h = a_t·h + b_t``);
    returns fp32 (float64 for float64), as ``veloxseg_tpu/ops/
    selective_scan.selective_scan_ref`` returns fp32."""
    u, a, b = _coefficients(u, delta, A, B, delta_bias, delta_softplus)
    h = torch.zeros_like(b[..., 0, :, :])
    hs = []
    for t in range(a.shape[-3]):
        h = a[..., t, :, :] * h + b[..., t, :, :]
        hs.append(h)
    return _output(u, torch.stack(hs, dim=-3), C, D)
