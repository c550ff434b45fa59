"""K2f and K3f, the train attention's forward, one kernel for every window
length (``csrc/pwa_attention_train.cu``): its decomposition in torch ops
(``window_attention_train_fwd_tiled_plain``: row blocks, column tiles and
lanes, the online softmax in base 2, the lanes' merge) against the JAX
package's ``_train_xla`` and its interpret-mode Pallas forwards, and its
launch geometry (``train_fwd_launch``) for coverage at every main-path
shape. The CUDA kernel against the plain versions is in
``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal
from veloxseg_torch.ops import pwa_attention as port
from veloxseg_tpu.ops.pwa_attention import _train_fwd_pallas, _train_xla


def _inputs(b, h, n, c_qk, c_v, l, seed=0):
    return (normal((b, h, n, c_qk, l), seed),
            normal((b, h, n, c_qk, l), seed + 1),
            normal((b, h, n, c_v, l), seed + 2),
            normal((h, l, l), seed + 3, 0.5))


# (B, h, N, Cqk, Cv, L, rows, chunk): L = 54 (AutoPET), 128 (the
# flagship), 432 (AutoPET L1) and 1024 (the flagship's level 1, K3f), in
# the kernel's tiles of 64 columns (ragged at 54 and 432); ragged last
# chunks (5 windows in chunks of 2, 6 in chunks of 4) and ragged last row
# blocks (54 = 32 + 22, 432 = 6·64 + 48). At these window counts the
# Pallas forwards pad no windows, so their mask is _train_xla's
TILED = [(1, 2, 5, 4, 8, 54, 32, 2), (2, 1, 3, 8, 16, 128, 16, 4),
         (1, 2, 2, 8, 8, 432, 64, 1), (1, 1, 2, 8, 8, 1024, 32, 2)]


@pytest.mark.parametrize("oracle", ["xla", "interpret"])
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l,rows,chunk", TILED)
def test_tiled_forward_matches_jax(b, h, n, c_qk, c_v, l, rows, chunk, p,
                                   oracle):
    q, k, v, bias = _inputs(b, h, n, c_qk, c_v, l, seed=31)
    seed, scale = [4321, 1], 1.0 / np.sqrt(c_qk)
    st = torch.tensor(seed, dtype=torch.int32)
    out, lse = port.window_attention_train_fwd_tiled_plain(
        *map(torch.from_numpy, (q, k, v, bias)), st, scale, p, rows, 64,
        chunk)
    sj = jnp.asarray([seed], jnp.int32)
    qj, kj, vj, bj = map(jnp.asarray, (q, k, v, bias))
    if oracle == "xla":
        ref = _train_xla(qj, kj, vj, bj, sj, scale, p)
    else:
        ref = _train_fwd_pallas(qj, kj, vj, bj, sj, scale, p, interpret=True)
    logits = jnp.einsum("bhncl,bhncm->bhnlm", qj, kj) * scale + bj[None, :,
                                                                   None]
    ref_lse = jax.nn.logsumexp(logits, axis=-1)
    # fp32 both ways, the same mask; exp2 of log2e-scaled logits and sums
    # in other orders: 1e-5 absolute on out and on lse
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0,
                               atol=1e-5)


# (B, h, N, Cqk, Cv, L) of K2 on every main path (test_torch_train_attention
# .K2_MAIN_PATH) and of K3 at the flagship's level 1
MAIN_PATH = [(2, 1, 585, 4, 4, 54), (2, 2, 9, 8, 8, 432),
             (2, 2, 9, 8, 16, 54), (2, 4, 1, 16, 32, 54),
             (16, 1, 585, 4, 4, 128), (16, 2, 9, 8, 16, 128),
             (16, 4, 1, 16, 32, 128), (2, 2, 9, 8, 8, 512),
             (16, 2, 9, 8, 8, 1024)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", MAIN_PATH)
def test_train_fwd_launch_covers_every_row_and_column_once(b, h, n, c_qk,
                                                           c_v, l, sms):
    lw = port.train_fwd_launch(b, h, n, l, c_qk, c_v, sms)
    # what the kernel takes (csrc/pwa_attention_train.cu: geometry_ok,
    # rows_per_lane, fwd_smem_floats): at most 16 warps, 8·RM rows a slab,
    # no slab wholly past L, a block's shared memory
    rm = 4 if c_qk + c_v <= 8 else 2 if c_qk + c_v <= 24 else 1
    assert port._fwd_rows_per_lane(c_qk, c_v) == rm
    assert lw.rows == lw.slabs * 8 * rm and (lw.slabs - 1) * 8 * rm < l
    assert 1 <= lw.slabs * lw.windows <= 16
    assert port._k2f_smem_floats(lw.slabs, lw.windows, l, c_qk, c_v) * 4 \
        <= 232448
    # the chunks split each head's windows in order, none of them empty
    bn = b * n
    ranges = lw.window_ranges(bn)
    assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(bn))
    assert all(hi > lo for lo, hi in ranges) and len(ranges) == lw.chunks
    # grid (row block, head, chunk): block (x, hh, z) owns rows
    # [x·rows, x·rows + rows) of the windows of chunk z of head hh, taken
    # ``windows`` at a time by its window slots: each (head, window, row)
    # lies in one block and one slot iff the row blocks cover [0, L) once,
    # the chunks each window once (above) and the slots each window of a
    # chunk once
    seen = np.zeros(l, np.int64)
    for x in range(-(-l // lw.rows)):
        assert x * lw.rows < l
        seen[x * lw.rows:(x + 1) * lw.rows] += 1
    assert (seen == 1).all()
    for lo, hi in ranges:
        slots = [lo + bt * lw.windows + wl
                 for bt in range(-(-(hi - lo) // lw.windows))
                 for wl in range(lw.windows)]
        assert sorted(j for j in slots if j < hi) == list(range(lo, hi))
    # columns: lane x takes [4x, 4x + 4) and [16 + 4x, 16 + 4x + 4) of
    # every step of 32
    cols = np.zeros(-(-l // 32) * 32, np.int64)
    for t0 in range(0, l, 32):
        for x in range(4):
            for a in (t0 + 4 * x, t0 + 16 + 4 * x):
                cols[a:a + 4] += 1
    assert (cols == 1).all()
