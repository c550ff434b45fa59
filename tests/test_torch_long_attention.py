"""K3, the train window attention for long windows: the dispatch rule
between K2 and K3, and the port's long-window path (forward, dq, dk, dv
and dbias) against the JAX package's row-blocked Pallas kernels in
interpret mode and against ``_train_xla`` and its VJP, at L = 1024 (the
128³ flagship's level 1). The CUDA kernels against the plain versions are
in ``test_torch_kernels.py``. The bf16 plain versions (K3's bf16
forms' twins) are held against the same Pallas kernels on bf16 operands by
``torch_port_helpers.assert_bf16_match``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_bf16_match, normal
from veloxseg_torch.ops import pwa_attention as port
from veloxseg_tpu.ops.pwa_attention import (_full_train_fits,
                                            _rowblock_size,
                                            _train_bwd_pallas,
                                            _train_fwd_pallas, _train_xla,
                                            window_attention_train)


def test_dispatch_rule_sends_long_windows_to_k3():
    # the flagship's level 1 (bench.py:57-62 at 128³), at the one width K3
    # is built for
    assert port.uses_long_kernel(1024)
    assert port.LONG_KERNEL_WIDTHS == {(8, 8)}
    # every window of the dataset configs and the flagship's other levels:
    # AutoPET 54/432, BraTS 216, Hecktor 64/512, flagship 128
    for l in (54, 64, 128, 216, 432, 512):
        assert not port.uses_long_kernel(l), l
    # it agrees with the JAX package's choice of its row-blocked kernels
    for l in (54, 128, 432, 512, 1024):
        assert port.uses_long_kernel(l) == (not _full_train_fits(l))
    assert _rowblock_size(1024) > 0


@pytest.mark.parametrize("l,want", [(128, "short"), (1024, "long")])
def test_train_attention_dispatches_by_the_rule(monkeypatch, l, want):
    calls = []
    for name in ("window_attention_train_fwd", "window_attention_train_bwd",
                 "window_attention_train_fwd_long",
                 "window_attention_train_bwd_long"):
        real = getattr(port, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(port, name, spy)
    q, k, v, bias, do = _inputs(1, 1, 1, 4, 4, l)
    _port_fwd_bwd(q, k, v, bias, do, [3, 0], 0.5, 0.1)
    suffix = "_long" if want == "long" else ""
    assert calls == [f"window_attention_train_fwd{suffix}",
                     f"window_attention_train_bwd{suffix}"]


def _inputs(b, h, n, c_qk, c_v, l, seed=0):
    return (normal((b, h, n, c_qk, l), seed),
            normal((b, h, n, c_qk, l), seed + 1),
            normal((b, h, n, c_v, l), seed + 2),
            normal((h, l, l), seed + 3, 0.5),
            normal((b, h, n, c_v, l), seed + 4))


def _port_fwd_bwd(q, k, v, bias, do, seed, scale, p):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    st = torch.tensor(seed, dtype=torch.int32)
    out = port.window_attention_train(*ts, st, scale, p)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(do))
    return out.detach().numpy(), [g.numpy() for g in grads]


# (B, h, N, Cqk, Cv, L, p), as tests/test_pwa_attention.py:167-196 runs the
# row-blocked kernels
SHAPES = [(1, 1, 2, 8, 8, 1024, 0.3), (1, 2, 2, 8, 8, 1024, 0.2)]


@pytest.mark.parametrize("oracle", ["interpret", "xla"])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l,p", SHAPES)
def test_long_path_matches_jax(b, h, n, c_qk, c_v, l, p, oracle):
    q, k, v, bias, do = _inputs(b, h, n, c_qk, c_v, l, seed=7)
    seed, scale = [4321, 0], 1.0 / np.sqrt(c_qk)
    got, grads = _port_fwd_bwd(q, k, v, bias, do, seed, scale, p)
    sj = jnp.asarray([seed], jnp.int32)
    if oracle == "interpret":
        fn = lambda *a: window_attention_train(*a, sj, scale, p, True)  # noqa
    else:
        fn = lambda *a: _train_xla(*a, sj, scale, p)  # noqa
    ref, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, bias)))
    # fp32 both ways, the same mask, sums in other orders: 1e-5 on the
    # outputs, 1e-4 of each gradient's max (dbias sums 2·h·L² terms)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))


def test_cpu_tensors_take_plain_versions_without_counting():
    q, k, v, bias, do = _inputs(1, 1, 1, 8, 8, 1024, seed=3)
    f0 = port.window_attention_train_fwd_long.launches
    b0 = port.window_attention_train_bwd_long.launches
    got, _ = _port_fwd_bwd(q, k, v, bias, do, [5, 0], 0.5, 0.2)
    assert port.window_attention_train_fwd_long.launches == f0
    assert port.window_attention_train_bwd_long.launches == b0
    again, _ = _port_fwd_bwd(q, k, v, bias, do, [5, 0], 0.5, 0.2)
    np.testing.assert_array_equal(got, again)


@pytest.mark.parametrize("l", [600, 1000, 1024])
def test_long_bwd_tiles_cover_every_score_once(l):
    # K3b's grid: (column tile, row tile, head); each block owns the
    # 128 × 128 dbias tile at (row tile·128, column tile·128) and writes one
    # dq partial per column tile and one dk, dv partial per row tile
    tiles = port.long_bwd_tiles(l)
    seen = np.zeros((l, l), np.int64)
    for i in range(tiles):
        for j in range(tiles):
            assert i * 128 < l and j * 128 < l
            seen[i * 128:(i + 1) * 128, j * 128:(j + 1) * 128] += 1
    assert (seen == 1).all()
    assert tiles == -(-l // 128) and (tiles - 1) * 128 < l


def test_long_bwd_decomposition_matches_jax_vjp():
    # P from the forward's log-sum-exp, D = rowsum(dO ⊙ out), dS once per
    # (row tile, column tile), against _train_xla's VJP at L = 1024 with
    # dropout 0.1
    q, k, v, bias, do = _inputs(1, 2, 2, 8, 8, 1024, seed=11)
    seed, scale, p = [99, 1], 1.0 / np.sqrt(8), 0.1
    ts = [torch.from_numpy(a) for a in (q, k, v, bias, do)]
    st = torch.tensor(seed, dtype=torch.int32)
    out, lse, _ = port.window_attention_train_fwd_long(*ts[:4], st, scale, p)
    # K3b's tiles of 128, all windows of a head in one chunk
    grads = port.window_attention_train_bwd_tiled_plain(
        *ts[:4], st, ts[4], out, lse, scale, p, 128, 2)
    sj = jnp.asarray([seed], jnp.int32)
    ref, vjp = jax.vjp(lambda *a: _train_xla(*a, sj, scale, p),
                       *map(jnp.asarray, (q, k, v, bias)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        # fp32 both ways, the same mask; P from the saved log-sum-exp and
        # sums in other orders: 1e-4 of each gradient's max
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))


def _bf16(a) -> torch.Tensor:
    """A JAX array (bf16 or fp32) as a torch tensor of the same dtype."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_long_bf16_twins_match_pallas(p):
    # K3's bf16 forms' plain versions against the interpret-mode row-blocked
    # Pallas kernels on bf16 q, k, v, dO at L = 1024: one head, one window
    q, k, v, bias, do = _inputs(1, 1, 1, 8, 8, 1024, seed=21)
    seed, scale = [[4321, 1]], 1.0 / np.sqrt(8)
    q16, k16, v16, do16 = (jnp.asarray(a).astype(jnp.bfloat16)
                           for a in (q, k, v, do))
    sj = jnp.asarray(seed, jnp.int32)
    out_j = _train_fwd_pallas(q16, k16, v16, jnp.asarray(bias), sj, scale, p,
                              interpret=True)
    grads_j = _train_bwd_pallas(q16, k16, v16, jnp.asarray(bias), sj, do16,
                                scale, p, interpret=True)
    qt, kt, vt, dot = (_bf16(a) for a in (q16, k16, v16, do16))
    bt = torch.from_numpy(bias)
    st = torch.tensor(seed[0], dtype=torch.int32)
    out, lse, out32 = port.window_attention_train_fwd_long(qt, kt, vt, bt, st,
                                                           scale, p)
    assert out.dtype == torch.bfloat16
    assert lse.dtype == out32.dtype == torch.float32
    ref = _bf16(out_j)
    assert_bf16_match(out, ref, "K3f out")
    # the Pallas kernel rounds the weights before ·V: without that rounding
    # (K2's function, out32 rounded once) far fewer elements agree
    with pytest.raises(AssertionError):
        assert_bf16_match(out32.to(torch.bfloat16), ref, "unrounded weights")
    grads = port.window_attention_train_bwd_long(qt, kt, vt, bt, st, dot,
                                                 scale, p, out32, lse)
    for name, g, r in zip(("dq", "dk", "dv"), grads, grads_j):
        assert_bf16_match(g, _bf16(r), f"K3b {name}")
    # dbias, fp32 on both sides, sums the unrounded dS: within 1e-4 of its
    # scale, as K2b's bf16 dbias is held (test_torch_bf16.py)
    db = _bf16(grads_j[3])
    assert grads[3].dtype == db.dtype == torch.float32
    torch.testing.assert_close(grads[3], db, rtol=1e-4,
                               atol=1e-4 * float(db.abs().max()))
