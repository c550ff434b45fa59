"""K2, the train window attention: the counter-hash dropout mask bit for bit
against ``_keep_mask``, the port's plain forward and backward against
``_train_xla`` (and ``jax.vjp`` of it) and the interpret-mode Pallas
kernels, the log-sum-exp the forward saves for K2b, and K2b's tiled
decomposition and launch geometry. The CUDA kernels against the plain
versions are in ``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal
from veloxseg_torch.ops import pwa_attention as port
from veloxseg_tpu.ops.pwa_attention import (_block_windows_train,
                                            _keep_mask, _train_bwd_pallas,
                                            _train_xla,
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


def test_forward_saves_out_and_the_rows_log_sum_exp():
    # what K2b takes: the forward's output and each row's log-sum-exp of
    # its logits, against JAX's logsumexp of the same logits
    q, k, v, bias, _ = _inputs(2, 2, 3, 4, 8, 54, seed=21)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    st = torch.tensor([7, 0], dtype=torch.int32)
    out = port.window_attention_train(*ts, st, 0.5, 0.1)
    saved_out, lse = out.grad_fn.saved_tensors[-2:]
    assert torch.equal(saved_out, out.detach())
    logits = (jnp.einsum("bhncl,bhncm->bhnlm", q, k) * 0.5
              + jnp.asarray(bias)[None, :, None])
    ref = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    np.testing.assert_allclose(lse.numpy(), ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        lse, port.train_lse_plain(*(t.detach() for t in ts[:2]),
                                  ts[3].detach(), 0.5), rtol=0, atol=0)


# (B, h, N, Cqk, Cv, L, SMs): L = 54 (one 64-tile a window) and a ragged
# multi-tile L = 150 (128 + 22), with few SMs so that each head's windows
# fall in several chunks
TILED = [(2, 1, 7, 4, 4, 54, 3), (1, 2, 5, 8, 16, 150, 24)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l,sms", TILED)
def test_tiled_backward_matches_train_xla_vjp(b, h, n, c_qk, c_v, l, sms, p):
    lw = port.train_bwd_launch(b, h, n, l, c_qk, c_v, sms)
    assert lw.chunks > 1 and (l <= 64) == (lw.tiles == 1)
    q, k, v, bias, do = _inputs(b, h, n, c_qk, c_v, l, seed=13)
    seed, scale = [4321, 1], 1.0 / np.sqrt(c_qk)
    ts = [torch.from_numpy(a) for a in (q, k, v, bias, do)]
    st = torch.tensor(seed, dtype=torch.int32)
    out, lse, _ = port.window_attention_train_fwd(*ts[:4], st, scale, p)
    grads = port.window_attention_train_bwd_tiled_plain(
        *ts[:4], st, ts[4], out, lse, scale, p, lw.tile, lw.per)
    sj = jnp.asarray([seed], jnp.int32)
    _, vjp = jax.vjp(lambda *a: _train_xla(*a, sj, scale, p),
                     *map(jnp.asarray, (q, k, v, bias)))
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        _close(g.numpy(), np.asarray(r), "grad")


def test_tiled_backward_matches_interpret_pallas_backward():
    # at p = 0 the Pallas kernel's padded window numbering does not matter
    b, h, n, c_qk, c_v, l = 2, 1, 7, 4, 4, 54
    lw = port.train_bwd_launch(b, h, n, l, c_qk, c_v, 3)
    q, k, v, bias, do = _inputs(b, h, n, c_qk, c_v, l, seed=17)
    ts = [torch.from_numpy(a) for a in (q, k, v, bias, do)]
    st = torch.tensor([5, 0], dtype=torch.int32)
    out, lse, _ = port.window_attention_train_fwd(*ts[:4], st, 0.5, 0.0)
    grads = port.window_attention_train_bwd_tiled_plain(
        *ts[:4], st, ts[4], out, lse, 0.5, 0.0, lw.tile, lw.per)
    refs = _train_bwd_pallas(*map(jnp.asarray, (q, k, v, bias)),
                             jnp.asarray([[5, 0]], jnp.int32),
                             jnp.asarray(do), 0.5, 0.0, interpret=True)
    for g, r in zip(grads, refs):
        _close(g.numpy(), np.asarray(r), "grad")


# (B, h, N, Cqk, Cv, L) of K2 on every main path: AutoPET-II 96³ at B = 2,
# the 128³ flagship at B = 16, and Hecktor's L = 512 level
K2_MAIN_PATH = [(2, 1, 585, 4, 4, 54), (2, 2, 9, 8, 8, 432),
                (2, 2, 9, 8, 16, 54), (2, 4, 1, 16, 32, 54),
                (16, 1, 585, 4, 4, 128), (16, 2, 9, 8, 16, 128),
                (16, 4, 1, 16, 32, 128), (2, 2, 9, 8, 8, 512)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", K2_MAIN_PATH)
def test_train_bwd_launch_covers_every_score_once(b, h, n, c_qk, c_v, l,
                                                  sms):
    lw = port.train_bwd_launch(b, h, n, l, c_qk, c_v, sms)
    t = lw.tile
    assert t in (64, 128) and (t == 64) == (
        l <= 64 or port._k2b_smem_floats(128, c_qk, c_v) * 4 > 232448)
    assert port._k2b_smem_floats(t, c_qk, c_v) * 4 <= 232448
    assert lw.tiles == -(-l // t)
    # the chunks split each head's windows in order, none of them empty
    ranges = lw.window_ranges(b * n)
    assert [j for lo, hi in ranges for j in range(lo, hi)] \
        == list(range(b * n))
    assert all(hi > lo for lo, hi in ranges)
    # grid (tile I·tiles + J, head, chunk), the kernel's own arithmetic:
    # block (x, hh, k) owns head hh, the windows of chunk k and the scores
    # of tile (x // tiles, x % tiles). The blocks are the product of the
    # three, so every (head, window, score) lies in exactly one block iff
    # the chunks cover each window once (above) and the tiles each score
    # of the (L, L) grid once (scores past L masked)
    seen = np.zeros((lw.tiles * t, lw.tiles * t), np.int64)
    for x in range(lw.tiles * lw.tiles):
        i, j = divmod(x, lw.tiles)
        assert i * t < l and j * t < l
        seen[i * t:(i + 1) * t, j * t:(j + 1) * t] += 1
    assert (seen[:l, :l] == 1).all()
