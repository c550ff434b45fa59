"""The WKV backward on the CPU: ``ops/wkv.wkv_bwd_plain`` (K6b's two
sweeps in torch ops, and the CPU path of the port's WKV under autograd)
against the JAX package's ``jax.vjp(wkv_scan)`` (the backward of its
``custom_vjp`` ``wkv``, ``veloxseg_tpu/ops/wkv.py:142-167``) in fp32, and
against torch autograd of ``wkv_plain`` in float64, the check that the
analytic sweeps are right independent of JAX; the port's ``wkv`` under
autograd on bf16 operands against JAX's ``wkv`` on the same.

Chains of T = 1, 8 and 216 (U-RWKV's 6³ bottleneck at 96³), ``w`` of both
signs, at U-RWKV's scale (``decay / T``) and at |w| up to 2, where the
state's log-max rescaling runs at every step (e^(T·w) is far outside
fp32). fp32 tolerances are relative to each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_bf16_match
from veloxseg_torch.models.zoo.urwkv import _fancy_init
from veloxseg_torch.ops import wkv as port_wkv
from veloxseg_tpu.ops import wkv as jax_wkv

# (B, T, C, w): "model" is U-RWKV's decay / T; a number is the largest |w|
# of a seeded uniform draw of both signs
CASES = [(2, 1, 8, 1.0), (2, 8, 16, 2.0), (4, 216, 32, "model"),
         (2, 216, 16, 2.0), (3, 216, 12, 0.5)]


def _operands(b, t, c, w_kind, seed=0):
    rng = np.random.default_rng(seed)
    if w_kind == "model":
        decay, first, *_ = _fancy_init(c)
        w, u = decay / t, first / t
    else:
        w = rng.uniform(-w_kind, w_kind, c)
        u = rng.standard_normal(c)
    k = 2.0 * rng.standard_normal((b, t, c))
    v = rng.standard_normal((b, t, c))
    gy = rng.standard_normal((b, t, c))
    return [np.asarray(a, np.float64) for a in (w, u, k, v, gy)]


def _rel_err(got, ref) -> float:
    got, ref = (np.asarray(a, np.float64) for a in (got, ref))
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("b,t,c,w_kind", CASES)
def test_wkv_bwd_plain_matches_jax_vjp(b, t, c, w_kind):
    w, u, k, v, gy = (a.astype(np.float32)
                      for a in _operands(b, t, c, w_kind))
    _, vjp = jax.vjp(jax_wkv.wkv_scan, *(jnp.asarray(a)
                                         for a in (w, u, k, v)))
    ref = vjp(jnp.asarray(gy))
    got = port_wkv.wkv_bwd_plain(*(torch.from_numpy(a)
                                   for a in (w, u, k, v, gy)))
    for name, g, r in zip(("gw", "gu", "gk", "gv"), got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        if not np.abs(np.asarray(r)).max():      # w at T = 1
            assert float(g.abs().max()) == 0.0, name
            continue
        # fp32 both ways: the analytic sweeps against the scan's
        # transpose, which differentiates through the log-max as well
        assert _rel_err(g.numpy(), r) <= 1e-4, (name, _rel_err(g.numpy(), r))


@pytest.mark.parametrize("b,t,c,w_kind", CASES)
def test_wkv_bwd_plain_matches_autograd_in_float64(b, t, c, w_kind):
    w, u, k, v, gy = (torch.from_numpy(a)
                      for a in _operands(b, t, c, w_kind, seed=1))
    leaves = [a.clone().requires_grad_() for a in (w, u, k, v)]
    y = port_wkv.wkv_plain(*leaves)
    ref = torch.autograd.grad(y, leaves, gy, allow_unused=True)
    got = port_wkv.wkv_bwd_plain(w, u, k, v, gy)
    for name, g, r, x in zip(("gw", "gu", "gk", "gv"), got, ref, leaves):
        r = torch.zeros_like(x) if r is None else r   # w at T = 1
        assert g.dtype == torch.float64
        scale = max(float(r.abs().max()), 1e-300)
        assert float((g - r).abs().max()) <= 1e-10 * scale, name


def test_wkv_function_on_cpu_runs_the_plain_sweeps():
    """On CPU tensors the autograd Function's forward is ``wkv_plain`` and
    its backward ``wkv_bwd_plain``: the same gradients bit for bit, no
    kernel launch counted; ``gradcheck`` passes in float64."""
    w, u, k, v, gy = (torch.from_numpy(a)
                      for a in _operands(2, 8, 4, 1.0, seed=2))
    leaves = [a.clone().requires_grad_() for a in (w, u, k, v)]
    n6, n6b = port_wkv.wkv.launches, port_wkv.wkv_bwd.launches
    y = port_wkv.wkv(*leaves)
    assert torch.equal(y, port_wkv.wkv_plain(w, u, k, v))
    grads = torch.autograd.grad(y, leaves, gy)
    for g, r in zip(grads, port_wkv.wkv_bwd_plain(w, u, k, v, gy)):
        assert torch.equal(g, r)
    assert (port_wkv.wkv.launches, port_wkv.wkv_bwd.launches) == (n6, n6b)
    assert torch.autograd.gradcheck(port_wkv.wkv, tuple(leaves))


@pytest.mark.parametrize("w_kind", ["model", 1.0])
def test_wkv_bf16_gradients_match_jax_custom_vjp(w_kind):
    """bf16 operands, cast to fp32 at the edges on both sides: the
    gradients come back in bf16, the JAX ``custom_vjp``'s and the port's
    autograd's rounded from the same fp32 values."""
    w, u, k, v, gy = _operands(4, 216, 32, w_kind, seed=3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (w, u, k, v)]
    y_ref, vjp = jax.vjp(jax_wkv.wkv, *bf)
    ref = vjp(jnp.asarray(gy, jnp.bfloat16))

    def to_torch(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    leaves = [to_torch(a).requires_grad_() for a in bf]
    y = port_wkv.wkv(*leaves)
    assert y.dtype == torch.bfloat16
    assert_bf16_match(y.detach(), to_torch(y_ref), "wkv bf16 forward")
    grads = torch.autograd.grad(y, leaves, to_torch(jnp.asarray(
        gy, jnp.bfloat16)))
    for name, g, r in zip(("gw", "gu", "gk", "gv"), grads, ref):
        assert g.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        r = to_torch(r)
        # with |w| ~ 1 a gradient spans tens of orders of magnitude (e^(t·w)
        # of the chain's early steps); below 1e-6 of its scale both sides
        # hold fp32 rounding noise, rounded to bf16, which the bf16 rule
        # (a share of elements bit for bit) does not fit: those are held
        # to 1e-6 of the scale, the rest by the rule
        scale = float(r.float().abs().max())
        tiny = r.float().abs() <= 1e-6 * scale
        gap = (g.float() - r.float())[tiny].abs()
        assert not gap.numel() or float(gap.max()) <= 1e-6 * scale, name
        assert_bf16_match(g[~tiny], r[~tiny], f"wkv bf16 {name}")
