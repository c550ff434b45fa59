"""The port's selective scan (``veloxseg_torch/ops/selective_scan.py``)
against the JAX package's ``selective_scan`` (``jax.lax.associative_scan``)
and ``selective_scan_ref`` (``lax.scan``), and against a float64 numpy
recurrence, on seeded inputs at HCMA-UNet's level-0 widths (d_inner 4,
d_state 32, ``A = −exp(log(1..32))`` down to −32 as its init, noised).

- fp32: within 1e-5 of the output's largest magnitude, L in {1, 7, 144,
  2304} (2304 = 48², HCMA's level-0 slice at 96³), with and without
  ``delta_bias`` and the softplus. The doubling scan associates in
  another order than ``associative_scan``: they agree to fp32 rounding,
  not bit for bit.
- bf16 operands: cast to fp32 at the edges and the result back to bf16,
  as the JAX function does; held by the rule of a bf16 twin
  (``assert_bf16_match``).
- The number of aten operations of a call at L = 2304 is at most 1.5× the
  number at L = 144 (a loop over L would multiply it by 16).
- ``selective_scan_ref`` is named by no module of the port but its own.
- Its backward (``_SelectiveScan``, the reversed recurrence through the
  same doubling scan): every input's gradient against ``jax.vjp`` of the
  JAX ``selective_scan`` within 1e-5 of that gradient's largest
  magnitude, and against autograd through the float64 sequential
  recurrence; the graph saves the inputs alone, and the backward's
  operation count grows with log L, as the forward's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_helpers import assert_bf16_match
from veloxseg_torch.ops import selective_scan as port
from veloxseg_tpu.ops import selective_scan as ref

LENGTHS = (1, 7, 144, 2304)


def _case(length: int, seed: int, b: int = 2, d: int = 4, n: int = 32):
    rng = np.random.default_rng(seed)
    a_log = np.log(np.arange(1, n + 1, dtype=np.float32))[None] \
        + 0.1 * rng.standard_normal((d, n))
    return dict(
        u=rng.standard_normal((b, length, d)).astype(np.float32),
        delta=(0.5 * rng.standard_normal((b, length, d))).astype(np.float32),
        A=(-np.exp(a_log)).astype(np.float32),
        B=rng.standard_normal((b, length, n)).astype(np.float32),
        C=rng.standard_normal((b, length, n)).astype(np.float32),
        D=rng.standard_normal(d).astype(np.float32),
        delta_bias=(0.5 * rng.standard_normal(d) - 2.0).astype(np.float32))


def _float64_recurrence(u, delta, A, B, C, D, delta_bias, delta_softplus):
    u, delta, A, B, C, D = (np.asarray(t, np.float64)
                            for t in (u, delta, A, B, C, D))
    if delta_bias is not None:
        delta = delta + np.asarray(delta_bias, np.float64)[None, None]
    if delta_softplus:
        delta = np.logaddexp(delta, 0.0)
    h = np.zeros((u.shape[0], u.shape[2], A.shape[1]))
    y = np.empty_like(u)
    for t in range(u.shape[1]):
        h = np.exp(delta[:, t, :, None] * A[None]) * h \
            + (delta[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        y[:, t] = np.einsum("bdn,bn->bd", h, C[:, t]) + D * u[:, t]
    return y


def _args(case, with_bias, softplus=True):
    """The case's arguments; without the softplus the timesteps are made
    positive (a negative one grows the state without bound)."""
    out = {k: v for k, v in case.items() if with_bias or k != "delta_bias"}
    if not softplus:
        out.update({k: np.abs(out[k]) for k in ("delta", "delta_bias")
                    if k in out})
    return out


def _port(args, softplus, dtype=torch.float32):
    with torch.no_grad():
        return port.selective_scan(
            **{k: torch.from_numpy(np.array(v)).to(dtype)
               for k, v in args.items()},
            delta_softplus=softplus)


@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("length", LENGTHS)
def test_fp32_matches_jax_and_float64(length, with_bias, softplus):
    args = _args(_case(length, seed=length), with_bias, softplus)
    got = _port(args, softplus).numpy()
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    want = np.asarray(ref.selective_scan(**jargs, delta_softplus=softplus))
    seq = np.asarray(jax.jit(ref.selective_scan_ref,
                             static_argnames="delta_softplus")(
        **jargs, delta_softplus=softplus))
    exact = _float64_recurrence(**{"delta_bias": None, **args},
                                delta_softplus=softplus)
    assert got.shape == want.shape == (2, length, 4)
    scale = float(np.abs(exact).max())
    for other in (want, seq, exact):
        err = float(np.abs(got - other).max())
        assert err <= 1e-5 * scale, (err, scale)


def test_ref_matches_the_doubling_scan():
    args = _args(_case(144, seed=3), True)
    with torch.no_grad():
        seq = port.selective_scan_ref(
            **{k: torch.from_numpy(v) for k, v in args.items()}).numpy()
    got = _port(args, True).numpy()
    assert np.abs(got - seq).max() <= 1e-5 * np.abs(seq).max()


@pytest.mark.parametrize("length", (7, 144))
def test_bf16_casts_at_the_edges_as_jax(length):
    args = _args(_case(length, seed=40 + length), True)
    b16 = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                         .astype(jnp.float32)) for k, v in args.items()}
    want = ref.selective_scan(**{k: jnp.asarray(v).astype(jnp.bfloat16)
                                 for k, v in b16.items()})
    assert want.dtype == jnp.bfloat16
    got = _port(b16, True, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_bf16_match(got, torch.from_numpy(
        np.asarray(want.astype(jnp.float32))).to(torch.bfloat16),
        f"selective_scan bf16 L={length}")


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += 1
        return func(*args, **(kwargs or {}))


def test_op_count_grows_with_log_length():
    counts = {}
    for length in (144, 2304):
        args = {k: torch.from_numpy(v)
                for k, v in _case(length, seed=9, b=1, d=2, n=4).items()}
        with torch.no_grad(), _CountOps() as mode:
            port.selective_scan(**args)
        counts[length] = mode.count
    assert counts[2304] <= 1.5 * counts[144], counts


def test_the_sequential_reference_is_off_the_path():
    root = os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
    users = []
    for folder, _, files in os.walk(root):
        for f in files:
            path = os.path.join(folder, f)
            if f.endswith(".py") and path != port.__file__:
                with open(path, encoding="utf-8") as fh:
                    if "selective_scan_ref" in fh.read():
                        users.append(path)
    assert users == []


NAMES = ("u", "delta", "A", "B", "C", "D", "delta_bias")


def _port_grads(args, gy, softplus, dtype=torch.float32, scan=None):
    leaves = {k: torch.from_numpy(np.array(v)).to(dtype).requires_grad_()
              for k, v in args.items()}
    y = (scan or port.selective_scan)(**leaves, delta_softplus=softplus)
    y.backward(torch.from_numpy(gy).to(dtype))
    return {k: t.grad.double().numpy() for k, t in leaves.items()}


@pytest.mark.parametrize("softplus", [True, False])
@pytest.mark.parametrize("length", (7, 144, 2304))
def test_gradients_match_jax_vjp_and_float64(length, softplus):
    args = _args(_case(length, seed=70 + length), True, softplus)
    gy = np.random.default_rng(length).standard_normal(
        (2, length, 4)).astype(np.float32)
    got = _port_grads(args, gy, softplus)
    names = [k for k in NAMES if k in args]

    @jax.jit
    def vjp(g, *a):
        return jax.vjp(lambda *b: ref.selective_scan(
            *b, delta_softplus=softplus), *a)[1](g)

    want = dict(zip(names, (np.asarray(g) for g in vjp(
        jnp.asarray(gy), *(jnp.asarray(args[k]) for k in names)))))
    exact = _port_grads(args, gy, softplus, torch.float64,
                        port.selective_scan_ref)
    for k in names:
        assert got[k].shape == want[k].shape == args[k].shape, k
        scale = float(np.abs(exact[k]).max())
        for other in (want[k], exact[k]):
            err = float(np.abs(got[k] - other).max())
            assert err <= 1e-5 * scale, (k, err, scale)


def test_autograd_saves_the_inputs_alone():
    """Under autograd the scan keeps its inputs, not its (…, L, d, n)
    state: the saved bytes are the inputs' bytes."""
    args = {k: torch.from_numpy(v).requires_grad_()
            for k, v in _case(144, seed=11).items()}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel()) or t, lambda t: t):
        port.selective_scan(**args)
    assert sum(saved) == sum(t.numel() for t in args.values()), saved


def test_backward_op_count_grows_with_log_length():
    counts = {}
    for length in (144, 2304):
        args = {k: torch.from_numpy(v).requires_grad_()
                for k, v in _case(length, seed=9, b=1, d=2, n=4).items()}
        y = port.selective_scan(**args)
        with _CountOps() as mode:
            y.backward(torch.ones_like(y))
        counts[length] = mode.count
    assert counts[2304] <= 1.5 * counts[144], counts
