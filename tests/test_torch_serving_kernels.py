"""The serving kernels' decompositions in torch ops against the JAX package
on the CPU: K6's two-pass chunked scan (``wkv_chunked_plain``) against
``wkv_scan``, and K1 as the train forward's instance without dropout
(``window_attention_train_fwd_tiled_plain`` at p = 0, in K1's geometry)
against ``window_attention_pallas`` in interpret mode and
``window_attention_xla``; each launch geometry (``wkv_launch``,
``eval_fwd_launch``) for coverage at the main paths' shapes. The CUDA
kernels against the plain versions are in ``test_torch_kernels.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal
from veloxseg_torch.models.zoo import urwkv as port_urwkv
from veloxseg_torch.ops import pwa_attention as port_attn
from veloxseg_torch.ops import wkv as port_wkv
from veloxseg_tpu.ops.pwa_attention import (window_attention_pallas,
                                            window_attention_xla)
from veloxseg_tpu.ops.wkv import wkv_scan


def _wkv_args(b, t, c, decay, k_scale):
    rng = np.random.default_rng(0)
    if decay == "urwkv":
        # U-RWKV's arguments: w = spatial_decay / T, u = spatial_first / T
        d0, f0, *_ = port_urwkv._fancy_init(c)
        w, u = d0 / t, f0 / t
    else:
        w = -np.exp(rng.standard_normal(c))
        u = rng.standard_normal(c)
    k = rng.standard_normal((b, t, c)) * k_scale
    v = rng.standard_normal((b, t, c))
    return [np.asarray(a, np.float32) for a in (w, u, k, v)]


# T = 27 and 50 (ragged against 4 and 16 chunks), T = 5 < 16 chunks
@pytest.mark.parametrize("chunks", [1, 4, 16])
@pytest.mark.parametrize("decay", ["urwkv", "negative"])
@pytest.mark.parametrize("b,t,c", [(2, 27, 16), (3, 50, 8), (2, 5, 12)])
def test_wkv_chunked_matches_wkv_scan(b, t, c, decay, chunks):
    args = _wkv_args(b, t, c, decay, 1.0)
    got = port_wkv.wkv_chunked_plain(*map(torch.from_numpy, args), chunks)
    ref = wkv_scan(*(jnp.asarray(a) for a in args))
    # fp32 both ways, the same steps summed in another order: the
    # tolerance of the sequential loop against wkv_scan
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# keys at twice U-RWKV's scale, where two fp32 orders of the same sums
# part by more than the fp32 tolerance above: in float64 the chunked scan
# is the recurrence itself, at every chunk count
@pytest.mark.parametrize("chunks", [1, 4, 16, 64])
@pytest.mark.parametrize("b,t,c,decay", [(2, 27, 16, "urwkv"),
                                         (2, 216, 8, "urwkv"),
                                         (3, 40, 8, "negative")])
def test_wkv_chunked_is_the_recurrence_in_float64(b, t, c, decay, chunks):
    args = [torch.from_numpy(a).double()
            for a in _wkv_args(b, t, c, decay, 2.0)]
    got = port_wkv.wkv_chunked_plain(*args, chunks)
    ref = port_wkv.wkv_plain(*args)
    assert got.dtype == ref.dtype == torch.float64
    # float64 rounding over at most 216 steps
    torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-12)


# T of U-RWKV's bottleneck at 96³ tiles (216), at 192³ (1728), the card
# tests' ragged 50 and 5, the longest chain a block of 8 channels holds
# (3600) and one past it (3700: 4 channels)
@pytest.mark.parametrize("t", [216, 50, 5, 1728, 3600, 3700])
def test_wkv_launch_covers_every_step_once(t):
    lw = port_wkv.wkv_launch(t)
    # what the kernel takes (csrc/wkv.cu: vs_wkv): whole 16-byte groups
    # of channels, at most 1024 threads, a block's shared memory
    assert lw.channels % 4 == 0 and lw.chunks >= 1
    assert lw.channels * lw.chunks <= 1024
    assert port_wkv.wkv_smem_bytes(t, lw) <= 232448
    # chunk j takes steps [j·n, min(T, (j + 1)·n)), n = ⌈T/P⌉: in order,
    # each step once
    n = -(-t // lw.chunks)
    steps = [s for j in range(lw.chunks)
             for s in range(j * n, min(t, (j + 1) * n))]
    assert steps == list(range(t))


def test_wkv_launch_refuses_chains_too_long_for_a_block():
    with pytest.raises(ValueError, match="shared memory"):
        port_wkv.wkv_launch(8000)


def _attn_inputs(b, h, n, c_qk, c_v, l, seed=0):
    return (normal((b, h, n, c_qk, l), seed),
            normal((b, h, n, c_qk, l), seed + 1),
            normal((b, h, n, c_v, l), seed + 2),
            normal((h, l, l), seed + 3, 0.5))


# (B, h, N, Cqk, Cv, L, SMs): one-tile windows of 54 (AutoPET L0, L2, L3
# widths) and AutoPET L1's 432 (7 tiles, the last ragged), each in the
# geometry eval_fwd_launch picks for it on 132 SMs and on 2 (fewer
# chunks of more windows)
EVAL = [(1, 2, 5, 4, 4, 54, 132), (2, 1, 3, 8, 16, 54, 2),
        (1, 2, 2, 16, 32, 54, 132), (1, 2, 2, 8, 8, 432, 132),
        (2, 1, 3, 8, 8, 432, 2)]


@pytest.mark.parametrize("oracle", ["xla", "interpret"])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l,sms", EVAL)
def test_eval_tiled_forward_matches_jax(b, h, n, c_qk, c_v, l, sms, oracle):
    q, k, v, bias = _attn_inputs(b, h, n, c_qk, c_v, l, seed=41)
    scale = 1.0 / np.sqrt(c_qk)
    lw = port_attn.eval_fwd_launch(b, h, n, l, c_qk, c_v, sms)
    out, _ = port_attn.window_attention_train_fwd_tiled_plain(
        *map(torch.from_numpy, (q, k, v, bias)),
        torch.zeros(2, dtype=torch.int32), scale, 0.0, lw.rows, 64, lw.per)
    qj, kj, vj, bj = map(jnp.asarray, (q, k, v, bias))
    if oracle == "xla":
        ref = window_attention_xla(qj, kj, vj, bj, scale)
    else:
        ref = window_attention_pallas(qj, kj, vj, bj, scale,
                                      block_windows=2, interpret=True)
    # fp32 both ways; exp2 of log2e-scaled logits and sums in other
    # orders: 1e-5 absolute, as the train forward's mirror
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


# (B, h, N, Cqk, Cv, L) of K1 on the serving path (4 tiles of 96³),
# Hecktor's L = 512 and the flagship's L = 1024
SERVING = [(4, 1, 585, 4, 4, 54), (4, 2, 9, 8, 8, 432), (4, 2, 9, 8, 16, 54),
           (4, 4, 1, 16, 32, 54), (4, 2, 9, 8, 8, 512),
           (4, 2, 9, 8, 8, 1024)]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", SERVING)
def test_eval_fwd_launch_covers_every_row_and_window(b, h, n, c_qk, c_v, l,
                                                     sms):
    lw = port_attn.eval_fwd_launch(b, h, n, l, c_qk, c_v, sms)
    # what the kernel takes (csrc/pwa_attention_train.cu: geometry_ok,
    # fwd_smem_floats): at most 16 warps, 8·RM rows a slab, no slab wholly
    # past L, a block's shared memory; the bias through L1 for a window of
    # one tile
    rm = port_attn._fwd_rows_per_lane(c_qk, c_v)
    assert lw.rows == lw.slabs * 8 * rm and (lw.slabs - 1) * 8 * rm < l
    assert 1 <= lw.slabs * lw.windows <= 16
    assert port_attn._k2f_smem_floats(lw.slabs, lw.windows, l, c_qk, c_v,
                                      lw.ldg) * 4 <= 232448
    assert lw.ldg == (l <= 64)
    bn = b * n
    ranges = lw.window_ranges(bn)
    assert [j for lo, hi in ranges for j in range(lo, hi)] == list(range(bn))
    assert all(hi > lo for lo, hi in ranges) and len(ranges) == lw.chunks
