"""K2, the train window attention: the counter-hash dropout mask bit for bit
against ``_keep_mask``, and the port's plain forward and backward against
``_train_xla`` (and ``jax.vjp`` of it) and the interpret-mode Pallas
kernels. The CUDA kernels against the plain versions are in
``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal
from veloxseg_torch.ops import pwa_attention as port
from veloxseg_tpu.ops.pwa_attention import (_block_windows_train,
                                            _keep_mask, _train_xla,
                                            window_attention_train)


@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
def test_keep_mask_bit_identical_on_random_ids(p):
    rng = np.random.default_rng(0)
    # the whole uint32 range: ids, and seeds, whose products wrap past 2³²
    gid = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    gid[:4] = [0, 1, 2 ** 32 - 1, 0x9E3779B9]
    for seed in (0, 1234, 2 ** 31 - 2):
        ref = np.asarray(_keep_mask(jnp.asarray(gid), p,
                                    jnp.uint32(seed)))
        got = port.keep_mask(torch.from_numpy(gid.astype(np.int64)), p,
                             seed).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 0.0 < got.mean() < 1.0


def test_keep_mask_over_a_whole_window_grid():
    # (B, h, N, L, L) with a batch offset: the ids _train_xla builds
    b, h, n, l, off, seed, p = 2, 3, 5, 27, 4, 987654, 0.3
    s = jnp.asarray([[seed, off]], jnp.int32)
    wid = ((off + jnp.arange(b, dtype=jnp.uint32))[:, None, None]
           * jnp.uint32(h) + jnp.arange(h, dtype=jnp.uint32)[None, :, None]
           ) * jnp.uint32(n) + jnp.arange(n, dtype=jnp.uint32)
    i = jnp.arange(l, dtype=jnp.uint32)
    gid = ((wid[..., None, None] * jnp.uint32(l) + i[:, None])
           * jnp.uint32(l) + i[None, :])
    ref = np.asarray(_keep_mask(gid, p, s[0, 0].astype(jnp.uint32)))
    ids = port.window_ids(b, h, n, l, off)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(gid))
    np.testing.assert_array_equal(port.keep_mask(ids, p, seed).numpy(), ref)


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


def _close(got, ref, what):
    # 1e-5 absolute on outputs, 1e-4 of each gradient's max
    if what == "out":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(
            got, ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()))


# L = 54 (AutoPET L0, L2, L3), 216 (BraTS); ragged window counts
@pytest.mark.parametrize("p", [0.0, 0.3])
@pytest.mark.parametrize("l,n", [(54, 7), (216, 3)])
def test_plain_matches_train_xla_and_its_vjp(l, n, p):
    q, k, v, bias, do = _inputs(2, 2, n, 4, 8, l)
    seed, scale = [4321, 0], 0.5
    got, grads = _port_fwd_bwd(q, k, v, bias, do, seed, scale, p)
    sj = jnp.asarray([seed], jnp.int32)
    ref, vjp = jax.vjp(lambda *a: _train_xla(*a, sj, scale, p),
                       *map(jnp.asarray, (q, k, v, bias)))
    _close(got, np.asarray(ref), "out")
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        _close(g, np.asarray(r), "grad")


def test_plain_matches_interpret_pallas_kernels():
    # N a multiple of the Pallas block (24 windows at L = 54): no padding,
    # so the Pallas mask is the oracle's (module docstring)
    l = 54
    n = _block_windows_train(l)
    q, k, v, bias, do = _inputs(1, 1, n, 4, 4, l, seed=7)
    seed, scale, p = [99, 0], 0.5, 0.3
    got, grads = _port_fwd_bwd(q, k, v, bias, do, seed, scale, p)
    sj = jnp.asarray([seed], jnp.int32)
    ref, vjp = jax.vjp(
        lambda *a: window_attention_train(*a, sj, scale, p, True),
        *map(jnp.asarray, (q, k, v, bias)))
    _close(got, np.asarray(ref), "out")
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        _close(g, np.asarray(r), "grad")


def test_cpu_tensors_take_plain_versions_without_counting():
    q, k, v, bias, do = _inputs(1, 1, 3, 4, 4, 27)
    f0 = port.window_attention_train_fwd.launches
    b0 = port.window_attention_train_bwd.launches
    got, _ = _port_fwd_bwd(q, k, v, bias, do, [5, 0], 0.5, 0.2)
    assert port.window_attention_train_fwd.launches == f0
    assert port.window_attention_train_bwd.launches == b0
    again, _ = _port_fwd_bwd(q, k, v, bias, do, [5, 0], 0.5, 0.2)
    other, _ = _port_fwd_bwd(q, k, v, bias, do, [6, 0], 0.5, 0.2)
    np.testing.assert_array_equal(got, again)
    assert not np.allclose(got, other)
