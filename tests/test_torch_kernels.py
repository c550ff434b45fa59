"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no GPU (a CUDA kernel has
no CPU mode). This file imports neither JAX nor the JAX package, so it runs
on a machine with the card and PyTorch alone:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import (TINY, assert_bf16_match, cf, cuda_or_skip,
                                normal, randomize_)
from veloxseg_torch.core.config import VeloxSegConfig
from veloxseg_torch.nn.conv_blocks import JLC
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.ops import fused_jlc, pwa_attention

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from chip_measure import FORWARD_BOUND, forward_distances  # noqa: E402

pytestmark = pytest.mark.cuda

# (L, Cqk, Cv): AutoPET L0, L3 and L1 (432 = 2 x 6^3), Hecktor L0 and L1
ATTN_SHAPES = [(54, 4, 4), (54, 16, 32), (432, 8, 8), (64, 8, 8),
               (512, 8, 8)]


@pytest.mark.parametrize("l,c_qk,c_v", ATTN_SHAPES)
def test_attention_kernel_matches_plain(l, c_qk, c_v):
    dev = cuda_or_skip()
    # n = 7 windows: no padding of a ragged window count
    q, k, v, bias = (torch.from_numpy(normal(s, i)).to(dev) for i, s in
                     enumerate([(2, 2, 7, c_qk, l), (2, 2, 7, c_qk, l),
                                (2, 2, 7, c_v, l), (2, l, l)]))
    scale = 1.0 / np.sqrt(c_qk)
    before = pwa_attention.window_attention.launches
    got = pwa_attention.window_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert pwa_attention.window_attention.launches == before + 1
    ref = pwa_attention.window_attention_plain(q, k, v, bias, scale)
    # fp32 both ways; the kernel sums in another order and uses expf
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


# K1 at the AutoPET-II serving forward's four levels (4 tiles of 96³),
# Hecktor's L = 512 and the flagship's L = 1024, at B = 4
K1_SERVING = [(4, 1, 585, 4, 4, 54), (4, 2, 9, 8, 8, 432),
              (4, 2, 9, 8, 16, 54), (4, 4, 1, 16, 32, 54),
              (4, 2, 9, 8, 8, 512), (4, 2, 9, 8, 8, 1024)]


@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", K1_SERVING)
def test_attention_kernel_at_serving_shapes(b, h, n, c_qk, c_v, l):
    dev = cuda_or_skip()
    q, k, v, bias = (torch.from_numpy(normal(s, 20 + i)).to(dev) for i, s in
                     enumerate([(b, h, n, c_qk, l), (b, h, n, c_qk, l),
                                (b, h, n, c_v, l), (h, l, l)]))
    scale = 1.0 / np.sqrt(c_qk)
    pa = pwa_attention
    lw = pa.eval_fwd_launch(
        b, h, n, l, c_qk, c_v,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    before = pa.window_attention.launches
    out = pa.window_attention(q, k, v, bias, scale)
    again = pa.window_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert pa.window_attention.launches == before + 2
    ref = pa.window_attention_plain(q, k, v, bias, scale)
    # fp32 both ways; sums in another order and exp2
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    # the kernel's own decomposition (the train forward's at p = 0)
    seed = torch.zeros(2, dtype=torch.int32, device=dev)
    mirror, _ = pa.window_attention_train_fwd_tiled_plain(
        q, k, v, bias, seed, scale, 0.0, lw.rows, 64, lw.per)
    torch.testing.assert_close(out, mirror, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, again)


# K1 under geometries other than its pick, the bias staged and read
# through L1 (ldg): a ragged last chunk, a partial window batch, L not a
# multiple of 4 (4-byte staging), each width class of rows per lane
@pytest.mark.parametrize("ldg", [False, True])
@pytest.mark.parametrize("c_qk,c_v,l,slabs,windows,per", [
    (4, 4, 54, 2, 2, 4), (8, 16, 54, 3, 4, 3), (16, 32, 50, 6, 1, 5),
    (4, 8, 9, 1, 8, 21)])
def test_attention_kernel_at_other_geometries(c_qk, c_v, l, slabs, windows,
                                              per, ldg):
    dev = cuda_or_skip()
    b, h, n = 3, 2, 7
    q, k, v, bias, _ = _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=11)
    scale = 1.0 / np.sqrt(c_qk)
    pa = pwa_attention
    rows = slabs * 8 * pa._fwd_rows_per_lane(c_qk, c_v)
    lw = pa.TrainFwdLaunch(slabs, windows, -(-b * n // per), per, rows, ldg)
    out = pa.window_attention(q, k, v, bias, scale, launch=lw)
    torch.cuda.synchronize()
    ref = pa.window_attention_plain(q, k, v, bias, scale)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


# AutoPET per-level (C, groups, expansion, spatial) of a 96³ tile, B = 4
JLC_LEVELS = [(16, 4, 3, 24), (32, 4, 3, 12), (64, 8, 2, 6), (128, 8, 2, 3)]


def _wkv_bwd_inputs(dev, b, t, c, w_scale):
    """WKV operands and an output gradient; ``w`` of both signs, at
    ``w_scale`` large enough (relative to T) that the log-max rescaling
    of the state runs."""
    w = torch.from_numpy(normal((c,), 81, w_scale)).to(dev)
    u = torch.from_numpy(normal((c,), 82)).to(dev)
    k, v, gy = (torch.from_numpy(normal((b, t, c), s)).to(dev)
                for s in (83, 84, 85))
    return w, u, k, v, gy


# K6b at U-RWKV's train shapes ((4, 216, 128): AutoPET-II and BraTS;
# (4, 256, 128): Hecktor) with w = decay / T as the model passes it and
# with |w| ~ 1 of both signs; a ragged last channel group (40 = 32 + 8);
# C not a multiple of 4 (4-byte staging); T = 1
@pytest.mark.parametrize("b,t,c,w_scale", [
    (4, 216, 128, 3.0 / 216), (4, 216, 128, 1.0), (4, 256, 128, 1.0),
    (3, 50, 40, 0.5), (2, 30, 10, 2.0), (2, 1, 8, 1.0)])
def test_wkv_bwd_kernel_matches_plain(b, t, c, w_scale):
    from veloxseg_torch.ops import wkv as wkv_ops
    dev = cuda_or_skip()
    w, u, k, v, gy = _wkv_bwd_inputs(dev, b, t, c, w_scale)
    n0 = wkv_ops.wkv_bwd.launches
    got = wkv_ops.wkv_bwd(w, u, k, v, gy)
    again = wkv_ops.wkv_bwd(w, u, k, v, gy)
    torch.cuda.synchronize()
    assert wkv_ops.wkv_bwd.launches == n0 + 2
    ref = wkv_ops.wkv_bwd_plain(w, u, k, v, gy)
    for name, g, r, g2 in zip(("gw", "gu", "gk", "gv"), got, ref, again):
        # fp32; the same two sweeps, expf and fused multiply-adds on the
        # card, the batch sums in the same order
        scale = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-4 * scale + 1e-7, name
        assert torch.equal(g, g2), name       # bit for bit on repeat


def test_wkv_autograd_runs_k6_and_k6b():
    from veloxseg_torch.ops import wkv as wkv_ops
    dev = cuda_or_skip()
    w, u, k, v, gy = _wkv_bwd_inputs(dev, 4, 216, 128, 1.0)
    for dt in (torch.float32, torch.bfloat16):
        leaves = [t.to(dt).requires_grad_() for t in (w, u, k, v)]
        n6, n6b = wkv_ops.wkv.launches, wkv_ops.wkv_bwd.launches
        y = wkv_ops.wkv(*leaves)
        grads = torch.autograd.grad(y, leaves, gy.to(dt))
        torch.cuda.synchronize()
        assert (wkv_ops.wkv.launches - n6, wkv_ops.wkv_bwd.launches - n6b) \
            == (1, 1)
        assert all(g.dtype == dt for g in grads)
        ref = wkv_ops.wkv_bwd_plain(*(t.to(dt).float() for t in (w, u, k, v)),
                                    gy.to(dt).float())
        for g, r in zip(grads, ref):
            if dt == torch.float32:
                assert float((g - r).abs().max()) \
                    <= 1e-4 * float(r.abs().max()) + 1e-7
            else:
                assert_bf16_match(g, r.to(dt), "K6b bf16")


@pytest.mark.parametrize("c,groups,expansion,s", JLC_LEVELS)
def test_jlc_kernels_match_plain(c, groups, expansion, s):
    dev = cuda_or_skip()
    blk = randomize_(JLC(c, (1, 3, 5), groups, expansion), c).to(dev)
    x = cf(normal((4, s, s, s, c), seed=9)).contiguous().to(dev)
    convs = blk._convs()
    ws, bs = [m.weight for m in convs], [m.bias for m in convs]
    expand, project = blk.channel_conv[1], blk.channel_conv[3]
    with torch.no_grad():
        n1 = fused_jlc.jlc_stage1.launches
        n2 = fused_jlc.jlc_stage2.launches
        out1 = fused_jlc.jlc_stage1(x, ws, bs, groups)
        out = fused_jlc.jlc_stage2(out1, expand.weight, expand.bias,
                                   project.weight, project.bias)
        torch.cuda.synchronize()
        assert fused_jlc.jlc_stage1.launches == n1 + 1
        assert fused_jlc.jlc_stage2.launches == n2 + 1
        ref1 = fused_jlc.jlc_stage1_plain(x, ws, bs, groups)
        ref = fused_jlc.jlc_stage2_plain(out1, expand.weight, expand.bias,
                                         project.weight, project.bias)
    # fp32 (TF32 off); other summation orders, double-precision statistics
    torch.testing.assert_close(out1, ref1, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


# K5f at every main path's JLC levels: (B, C, E, edge) of the AutoPET-II
# forward (4 tiles) and of the 128³ flagship step (B = 16), the AutoPET-II
# train step's L0 (B = 2, two hidden slices), and widths it runs padded
K5F_SHAPES = [(b, 16 * 2 ** i, e, s0 // 2 ** i)
              for b, s0 in ((4, 24), (16, 32))
              for i, e in enumerate((3, 3, 2, 2))] + [
    (2, 16, 3, 24), (2, 12, 3, 5), (3, 6, 3, 7), (2, 20, 2, 6)]


@pytest.mark.parametrize("b,c,e,s", K5F_SHAPES)
def test_jlc_stage2_kernel_at_main_path_shapes(b, c, e, s):
    dev = cuda_or_skip()
    hid = e * c
    x = torch.from_numpy(normal((b, c, s, s, s), seed=31, scale=1.5)).to(dev)
    w1 = torch.from_numpy(normal((hid, c, 1, 1, 1), 32,
                                 (2.0 / c) ** 0.5)).to(dev)
    b1 = torch.from_numpy(normal((hid,), 33, 0.1)).to(dev)
    w2 = torch.from_numpy(normal((c, hid, 1, 1, 1), 34,
                                 (2.0 / hid) ** 0.5)).to(dev)
    b2 = torch.from_numpy(normal((c,), 35, 0.1)).to(dev)
    n2 = fused_jlc.jlc_stage2.launches
    with torch.no_grad():
        out, mean, rstd = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
        again = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage2.launches == n2 + 2
    ref = fused_jlc.jlc_stage2_plain(x, w1, b1, w2, b2)
    m, r = fused_jlc._plane_stats(x)
    # fp32 (TF32 off); other summation orders, double-precision statistics
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mean, m.reshape(-1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, r.reshape(-1), rtol=1e-5, atol=1e-6)
    # fixed-order sums: the output and the statistics repeat bit for bit
    for a, a2 in zip((out, mean, rstd), again):
        assert torch.equal(a, a2)


# (B, h, N, Cqk, Cv, L) of the train attention at AutoPET (B = 2), plus a
# Hecktor L1 window and a ragged window count
TRAIN_ATTN = [(2, 1, 585, 4, 4, 54), (2, 2, 9, 8, 8, 432),
              (2, 2, 9, 8, 16, 54), (2, 4, 1, 16, 32, 54),
              (2, 2, 7, 8, 8, 512)]
# K2's main-path shapes: AutoPET-II 96³ at B = 2 (L0-L3) and the 128³
# flagship at B = 16 (L0, L2, L3), and Hecktor's L = 512 window
K2_MAIN_PATH = [(2, 1, 585, 4, 4, 54), (2, 2, 9, 8, 8, 432),
                (2, 2, 9, 8, 16, 54), (2, 4, 1, 16, 32, 54),
                (16, 1, 585, 4, 4, 128), (16, 2, 9, 8, 16, 128),
                (16, 4, 1, 16, 32, 128), (2, 2, 9, 8, 8, 512)]


def _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=0):
    q, k, v, do = (torch.from_numpy(normal(s, seed + i)).to(dev)
                   for i, s in enumerate([(b, h, n, c_qk, l)] * 2
                                         + [(b, h, n, c_v, l)] * 2))
    bias = torch.from_numpy(normal((h, l, l), seed + 4, 0.5)).to(dev)
    return q, k, v, bias, do


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", TRAIN_ATTN)
def test_train_attention_kernels_match_plain(b, h, n, c_qk, c_v, l, p):
    dev = cuda_or_skip()
    q, k, v, bias, do = _train_inputs(dev, b, h, n, c_qk, c_v, l)
    seed = torch.tensor([1234, 0], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(c_qk)
    f0 = pwa_attention.window_attention_train_fwd.launches
    b0 = pwa_attention.window_attention_train_bwd.launches
    out, lse, _ = pwa_attention.window_attention_train_fwd(q, k, v, bias,
                                                           seed, scale, p)
    grads = pwa_attention.window_attention_train_bwd(q, k, v, bias, seed,
                                                     do, scale, p, out, lse)
    again = pwa_attention.window_attention_train_bwd(q, k, v, bias, seed,
                                                     do, scale, p, out, lse)
    torch.cuda.synchronize()
    assert pwa_attention.window_attention_train_fwd.launches == f0 + 1
    assert pwa_attention.window_attention_train_bwd.launches == b0 + 2
    ref = pwa_attention.window_attention_train_fwd_plain(q, k, v, bias, seed,
                                                         scale, p)
    refs = pwa_attention.window_attention_train_bwd_plain(q, k, v, bias,
                                                          seed, do, scale, p)
    # fp32; the same mask on both sides, sums taken in other orders
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        lse, pwa_attention.train_lse_plain(q, k, bias, scale), rtol=1e-5,
        atol=1e-5)
    for got, r in zip(grads, refs):
        scale_r = float(r.abs().max())
        torch.testing.assert_close(got, r, rtol=1e-4, atol=1e-4 * scale_r)
    # dbias is reduced in a fixed order: bit-identical between calls
    assert torch.equal(grads[3], again[3])


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", K2_MAIN_PATH)
def test_train_attention_backward_at_main_path_shapes(b, h, n, c_qk, c_v, l,
                                                      p):
    dev = cuda_or_skip()
    q, k, v, bias, do = _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=3)
    seed = torch.tensor([99, 2], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(c_qk)
    out, lse, _ = pwa_attention.window_attention_train_fwd(q, k, v, bias,
                                                           seed, scale, p)
    grads = pwa_attention.window_attention_train_bwd(q, k, v, bias, seed,
                                                     do, scale, p, out, lse)
    again = pwa_attention.window_attention_train_bwd(q, k, v, bias, seed,
                                                     do, scale, p, out, lse)
    lw = pwa_attention.train_bwd_launch(b, h, n, l, c_qk, c_v,
                                        torch.cuda.get_device_properties(
                                            dev).multi_processor_count)
    refs = pwa_attention.window_attention_train_bwd_tiled_plain(
        q, k, v, bias, seed, do, out, lse, scale, p, lw.tile, lw.per)
    # the same P, D and mask from the same out and lse; sums in other
    # orders
    for got, r in zip(grads, refs):
        torch.testing.assert_close(got, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    # no atomics: all four outputs repeat bit for bit
    for a, a2 in zip(grads, again):
        assert torch.equal(a, a2)


def test_train_attention_backward_needs_the_forward():
    dev = cuda_or_skip()
    q, k, v, bias, do = _train_inputs(dev, 1, 1, 2, 4, 4, 54)
    seed = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    # K2f's lse is one float per row: one of another shape is refused
    with pytest.raises(ValueError, match="lse"):
        pwa_attention.window_attention_train_bwd(
            q, k, v, bias, seed, do, 0.5, 0.1, do,
            torch.zeros(1, 1, 2, 53, device=dev))


# (B, h, N, Cqk, Cv, L) of the long-window train attention: the 128³
# flagship's level 1 (K3's one width), and ragged L (partial tiles)
LONG_ATTN = [(2, 2, 9, 8, 8, 1024), (1, 2, 3, 8, 8, 1024),
             (1, 1, 3, 8, 8, 1000), (2, 1, 2, 8, 8, 600)]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", LONG_ATTN)
def test_long_train_attention_kernels_match_plain(b, h, n, c_qk, c_v, l, p):
    dev = cuda_or_skip()
    q, k, v, bias, do = _train_inputs(dev, b, h, n, c_qk, c_v, l)
    seed = torch.tensor([1234, 3], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(c_qk)
    f0 = pwa_attention.window_attention_train_fwd_long.launches
    b0 = pwa_attention.window_attention_train_bwd_long.launches
    out, lse, _ = pwa_attention.window_attention_train_fwd_long(
        q, k, v, bias, seed, scale, p)
    grads = pwa_attention.window_attention_train_bwd_long(
        q, k, v, bias, seed, do, scale, p, out, lse)
    again = pwa_attention.window_attention_train_bwd_long(
        q, k, v, bias, seed, do, scale, p, out, lse)
    torch.cuda.synchronize()
    assert pwa_attention.window_attention_train_fwd_long.launches == f0 + 1
    assert pwa_attention.window_attention_train_bwd_long.launches == b0 + 2
    ref = pwa_attention.window_attention_train_fwd_plain(q, k, v, bias, seed,
                                                         scale, p)
    refs = pwa_attention.window_attention_train_bwd_plain(q, k, v, bias,
                                                          seed, do, scale, p)
    # as K2: fp32, the same mask on both sides, other summation orders
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(
        lse, pwa_attention.train_lse_plain(q, k, bias, scale), rtol=1e-5,
        atol=1e-5)
    for got, r in zip(grads, refs):
        scale_r = float(r.abs().max())
        torch.testing.assert_close(got, r, rtol=1e-4, atol=1e-4 * scale_r)
    # every sum is taken in a fixed order: bit-identical between calls
    for a, b_ in zip(grads, again):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("l", [1000, 1024])
def test_long_train_attention_backward_matches_its_decomposition(l, p):
    dev = cuda_or_skip()
    q, k, v, bias, do = _train_inputs(dev, 2, 2, 3, 8, 8, l, seed=5)
    seed = torch.tensor([77, 1], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(8)
    out, lse, _ = pwa_attention.window_attention_train_fwd_long(
        q, k, v, bias, seed, scale, p)
    grads = pwa_attention.window_attention_train_bwd_long(
        q, k, v, bias, seed, do, scale, p, out, lse)
    refs = pwa_attention.window_attention_train_bwd_tiled_plain(
        q, k, v, bias, seed, do, out, lse, scale, p, 128, 2 * 3)
    # the same P, D and mask from the same out and lse; sums in other
    # orders
    for got, r in zip(grads, refs):
        torch.testing.assert_close(got, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))


def test_long_train_attention_backward_needs_the_forward():
    dev = cuda_or_skip()
    q, k, v, bias, do = _train_inputs(dev, 1, 1, 2, 8, 8, 1024)
    seed = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    # K3f's lse is one float per row: one of another shape is refused
    with pytest.raises(ValueError, match="lse"):
        pwa_attention.window_attention_train_bwd_long(
            q, k, v, bias, seed, do, 0.25, 0.1, do,
            torch.zeros(1, 1, 2, 1000, device=dev))


# K2f (L <= 512) and K3f (L > 512) are one kernel: every main-path shape
# of both routes
TRAIN_FWD = [(False, *s) for s in K2_MAIN_PATH] + [
    (True, *s) for s in LONG_ATTN]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("long,b,h,n,c_qk,c_v,l", TRAIN_FWD)
def test_train_forward_at_main_path_shapes(long, b, h, n, c_qk, c_v, l, p):
    dev = cuda_or_skip()
    q, k, v, bias, _ = _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=8)
    seed = torch.tensor([4321, 1], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(c_qk)
    pa = pwa_attention
    assert pa.uses_long_kernel(l) == long
    fwd = pa.window_attention_train_fwd_long if long \
        else pa.window_attention_train_fwd
    lw = pa.train_fwd_launch(
        b, h, n, l, c_qk, c_v,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    f0 = fwd.launches
    out, lse, _ = fwd(q, k, v, bias, seed, scale, p)
    again = fwd(q, k, v, bias, seed, scale, p)
    torch.cuda.synchronize()
    assert fwd.launches == f0 + 2
    ref = pa.window_attention_train_fwd_plain(q, k, v, bias, seed, scale, p)
    # fp32, the same mask on both sides, sums in other orders and exp2
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, pa.train_lse_plain(q, k, bias, scale),
                               rtol=1e-5, atol=1e-5)
    # the kernel's own decomposition, in the same order
    mo, ml = pa.window_attention_train_fwd_tiled_plain(
        q, k, v, bias, seed, scale, p, lw.rows, 64, lw.per)
    torch.testing.assert_close(out, mo, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ml, rtol=1e-5, atol=1e-5)
    # no atomics: out and lse repeat bit for bit
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# geometries the model may not pick: a ragged last chunk (21 windows in
# chunks of 4) and a partial last batch of window slots (4 windows 3 at a
# time), one slab and several, each width class of rows per lane
@pytest.mark.parametrize("c_qk,c_v,l,slabs,windows,per", [
    (8, 8, 432, 2, 3, 4), (4, 4, 54, 1, 4, 4), (16, 32, 128, 4, 2, 3),
    (8, 16, 1000, 1, 8, 4)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_train_forward_at_other_geometries(c_qk, c_v, l, slabs, windows,
                                           per, p):
    dev = cuda_or_skip()
    b, h, n = 3, 2, 7
    q, k, v, bias, _ = _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=9)
    seed = torch.tensor([4321, 1], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(c_qk)
    pa = pwa_attention
    rows = slabs * 8 * pa._fwd_rows_per_lane(c_qk, c_v)
    lw = pa.TrainFwdLaunch(slabs, windows, -(-b * n // per), per, rows)
    assert pa._k2f_smem_floats(slabs, windows, l, c_qk, c_v) * 4 <= 232448
    out, lse, _ = pa._train_fwd_kernel(
        pa.window_attention_train_fwd, "vs_pwa_attention_train",
        pa.KERNEL_WIDTHS, q, k, v, bias, seed, scale, p, launch=lw)
    torch.cuda.synchronize()
    ref = pa.window_attention_train_fwd_plain(q, k, v, bias, seed, scale, p)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, pa.train_lse_plain(q, k, bias, scale),
                               rtol=1e-5, atol=1e-5)


def test_long_train_attention_refuses_other_widths():
    dev = cuda_or_skip()
    q, k, v, bias, do = _train_inputs(dev, 1, 1, 2, 16, 32, 1024)
    seed = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no kernel instance"):
        pwa_attention.window_attention_train_fwd_long(q, k, v, bias, seed,
                                                      0.25, 0.1)
    with pytest.raises(ValueError, match="no kernel instance"):
        pwa_attention.window_attention_train_bwd_long(
            q, k, v, bias, seed, do, 0.25, 0.1, do,
            torch.zeros(1, 1, 2, 1024, device=dev))


@pytest.mark.parametrize("b,t,c", [(4, 216, 128), (3, 50, 40)])
def test_wkv_kernel_matches_plain(b, t, c):
    from veloxseg_torch.ops import wkv as wkv_ops
    dev = cuda_or_skip()
    # U-RWKV's arguments: w = decay / T, u = first / T (urwkv.py:128)
    w = torch.from_numpy(normal((c,), 0, 3.0) / t).to(dev)
    u = torch.from_numpy(normal((c,), 1) / t).to(dev)
    k, v = (torch.from_numpy(normal((b, t, c), s)).to(dev) for s in (2, 3))
    n0 = wkv_ops.wkv.launches
    with torch.no_grad():
        got = wkv_ops.wkv(w, u, k, v)
    torch.cuda.synchronize()
    assert wkv_ops.wkv.launches == n0 + 1
    ref = wkv_ops.wkv_plain(w, u, k, v)
    # fp32; the same recurrence, expf and fused multiply-adds on the card
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _wkv_inputs(dev, b, t, c):
    w = torch.from_numpy(normal((c,), 0, 3.0) / t).to(dev)
    u = torch.from_numpy(normal((c,), 1) / t).to(dev)
    k, v = (torch.from_numpy(normal((b, t, c), s)).to(dev) for s in (2, 3))
    return w, u, k, v


# K6 under geometries other than its pick: the main path's shape in
# chunks of 32, 8 and 1 (the sequential loop) and 16 channels a block;
# ragged T (50 in chunks of 16: three empty) and a ragged last channel
# group (40 = 32 + 8); T < chunks; C not a multiple of 4 (4-byte staging)
@pytest.mark.parametrize("b,t,c,channels,chunks", [
    (4, 216, 128, 4, 32), (4, 216, 128, 16, 8), (4, 216, 128, 8, 1),
    (3, 50, 40, 16, 16), (2, 5, 12, 4, 16), (2, 30, 10, 8, 4)])
def test_wkv_kernel_at_other_geometries(b, t, c, channels, chunks):
    from veloxseg_torch.ops import wkv as wkv_ops
    dev = cuda_or_skip()
    w, u, k, v = _wkv_inputs(dev, b, t, c)
    lw = wkv_ops.WkvLaunch(channels, chunks)
    with torch.no_grad():
        got = wkv_ops.wkv(w, u, k, v, launch=lw)
        again = wkv_ops.wkv(w, u, k, v, launch=lw)
    torch.cuda.synchronize()
    # fp32; the same recurrence cut into chunks, expf on the card
    torch.testing.assert_close(got, wkv_ops.wkv_plain(w, u, k, v),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, wkv_ops.wkv_chunked_plain(w, u, k, v,
                                                              chunks),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)


@pytest.mark.parametrize("c,groups,expansion,s", JLC_LEVELS)
def test_jlc_backward_kernels_match_plain(c, groups, expansion, s):
    dev = cuda_or_skip()
    blk = randomize_(JLC(c, (1, 3, 5), groups, expansion), c).to(dev)
    x = cf(normal((2, s, s, s, c), seed=9)).contiguous().to(dev)
    g = cf(normal((2, s, s, s, c), seed=10)).contiguous().to(dev)
    ws = [m.weight.detach() for m in blk._convs()]
    expand, project = blk.channel_conv[1], blk.channel_conv[3]
    w1, b1, w2 = (t.detach() for t in (expand.weight, expand.bias,
                                        project.weight))
    with torch.no_grad():
        _, mean, rstd = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2,
                                                  project.bias)
    n1 = fused_jlc.jlc_stage1_bwd.launches
    n2 = fused_jlc.jlc_stage2_bwd.launches
    dy, _ = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
    got2 = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
    again2 = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage1_bwd.launches == n1 + 1
    assert fused_jlc.jlc_stage2_bwd.launches == n2 + 2
    ref_dy, _ = fused_jlc.jlc_stage1_bwd_plain(x, ws, g, groups)
    ref2 = fused_jlc.jlc_stage2_bwd_plain(x, w1, b1, w2, g)
    # fp32 (TF32 off); other summation orders, double-precision statistics
    torch.testing.assert_close(dy, ref_dy, rtol=1e-4,
                               atol=1e-4 * float(ref_dy.abs().max()))
    for got, r in zip(got2, ref2):
        torch.testing.assert_close(got, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    # the weight gradients are reduced in a fixed order: bit-identical
    for a, b_ in zip(got2[1:], again2[1:]):
        assert torch.equal(a, b_)


# K5b at the 128-channel level (eight hidden slices) with odd voxel counts,
# a 16-channel level whose volume is not a multiple of the 64-voxel tile,
# TINY's 8 channels, and widths it runs padded (C not a multiple of 8, E·C
# not one of 4)
@pytest.mark.parametrize("b,c,e,shape", [
    (2, 128, 2, (3, 5, 7)), (16, 128, 2, (3, 3, 3)), (2, 16, 3, (9, 11, 13)),
    (1, 8, 3, (16, 16, 17)), (2, 4, 3, (5, 6, 7)), (2, 12, 3, (4, 4, 4)),
    (1, 6, 3, (3, 5, 7))])
def test_jlc_stage2_backward_kernel_at_every_tiling(b, c, e, shape):
    dev = cuda_or_skip()
    hid = e * c
    x, g = (torch.from_numpy(normal((b, c) + shape, seed=s)).to(dev)
            for s in (21, 22))
    w1 = torch.from_numpy(normal((hid, c, 1, 1, 1), 23,
                                 (2.0 / c) ** 0.5)).to(dev)
    b1 = torch.from_numpy(normal((hid,), 24, 0.1)).to(dev)
    w2 = torch.from_numpy(normal((c, hid, 1, 1, 1), 25,
                                 (2.0 / hid) ** 0.5)).to(dev)
    b2 = torch.from_numpy(normal((c,), 26, 0.1)).to(dev)
    with torch.no_grad():
        _, mean, rstd = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
    n2 = fused_jlc.jlc_stage2_bwd.launches
    got = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
    again = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage2_bwd.launches == n2 + 2
    refs = fused_jlc.jlc_stage2_bwd_plain(x, w1, b1, w2, g)
    # fp32 (TF32 off); other summation orders, double-precision statistics
    for a, r in zip(got, refs):
        assert a.shape == r.shape
        torch.testing.assert_close(a, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    # fixed-order sums: bit-identical between calls
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)


def test_jlc_stage2_backward_kernel_refuses_too_wide_stages():
    dev = cuda_or_skip()
    c, hid = 256, 512
    x = torch.zeros(1, c, 2, 2, 2, device=dev)
    stats = torch.zeros(c, device=dev)
    with pytest.raises(ValueError, match="no hidden slice"):
        fused_jlc.jlc_stage2_bwd(x, torch.zeros(hid, c, 1, 1, 1, device=dev),
                                 torch.zeros(hid, device=dev),
                                 torch.zeros(c, hid, 1, 1, 1, device=dev), x,
                                 stats, stats)


# K4's tilings: a volume smaller than the k = 5 cube, odd edges, and the
# 96³ and 128³ L0 edges; C/groups 4, 8 and 16
@pytest.mark.parametrize("cg", [4, 8, 16])
@pytest.mark.parametrize("shape", [(3, 3, 3), (5, 7, 9), (24, 24, 24),
                                   (32, 32, 32)])
def test_jlc_stage1_kernels_match_plain_at_every_tiling(shape, cg):
    dev = cuda_or_skip()
    c, groups, b = 2 * cg, 2, 2
    x, g = (torch.from_numpy(normal((b, c) + shape, seed=s)).to(dev)
            for s in (11, 12))
    ws = [torch.from_numpy(normal((c, cg, k, k, k), seed=13 + k,
                                  scale=(2.0 / (cg * k ** 3)) ** 0.5)).to(dev)
          for k in (1, 3, 5)]
    bs = [torch.zeros(c, device=dev) for _ in ws]
    n4b, nw = fused_jlc.jlc_stage1_bwd.launches, \
        fused_jlc.jlc_branch_wgrad.launches
    with torch.no_grad():
        out1 = fused_jlc.jlc_stage1(x, ws, bs, groups)
    dy, dws = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
    _, again = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
    alone = fused_jlc.jlc_branch_wgrad(x, dy, ws, groups)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage1_bwd.launches == n4b + 2
    assert fused_jlc.jlc_branch_wgrad.launches == nw + 3
    ref1 = fused_jlc.jlc_stage1_plain(x, ws, bs, groups)
    ref_dy, ref_dws = fused_jlc.jlc_stage1_bwd_plain(x, ws, g, groups)
    # fp32 (TF32 off); other summation orders, double-precision statistics
    torch.testing.assert_close(out1, ref1, rtol=1e-4, atol=1e-4)
    for got, r in [(dy, ref_dy)] + list(zip(dws, ref_dws)):
        torch.testing.assert_close(got, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    # dW is summed in a fixed order: bit-identical between calls, and the
    # wgrad launches alone give K4b's own
    for a, a2, a3 in zip(dws, again, alone):
        assert torch.equal(a, a2) and torch.equal(a, a3)


# The bf16 forms, on the operands the JAX trainer passes: K2f and K2b at the
# AutoPET-II train step's four levels (B = 2) and the flagship's L0, K4f,
# K4b and its wgrad at the four JLC levels, each against its bf16 plain
# version. bf16 outputs: at least 99% of the elements bit for bit equal,
# the rest within 1 bf16 ulp (torch_port_helpers.assert_bf16_match); the
# fp32 ones (lse, K2f's out32, dbias) as the fp32 forms' tests hold them.
K2_BF16 = K2_MAIN_PATH[:5]


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", K2_BF16)
def test_train_attention_bf16_forms_match_plain(b, h, n, c_qk, c_v, l, p):
    dev = cuda_or_skip()
    pa = pwa_attention
    q, k, v, bias, do = _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=21)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    seed = torch.tensor([1234, 0], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(c_qk)
    f0 = pa.window_attention_train_fwd.launches_bf16
    b0 = pa.window_attention_train_bwd.launches_bf16
    out, lse, out32 = pa.window_attention_train_fwd(q, k, v, bias, seed,
                                                    scale, p)
    grads = pa.window_attention_train_bwd(q, k, v, bias, seed, do, scale, p,
                                          out32, lse)
    again = pa.window_attention_train_bwd(q, k, v, bias, seed, do, scale, p,
                                          out32, lse)
    torch.cuda.synchronize()
    assert pa.window_attention_train_fwd.launches_bf16 == f0 + 1
    assert pa.window_attention_train_bwd.launches_bf16 == b0 + 2
    assert_bf16_match(out, pa.window_attention_train_fwd_plain(
        q, k, v, bias, seed, scale, p), "K2f out")
    torch.testing.assert_close(out32, pa.window_attention_train_fwd_plain(
        q.float(), k.float(), v.float(), bias, seed, scale, p), rtol=1e-4,
        atol=1e-5)
    torch.testing.assert_close(lse, pa.train_lse_plain(q, k, bias, scale),
                               rtol=1e-5, atol=1e-5)
    refs = pa.window_attention_train_bwd_plain(q, k, v, bias, seed, do,
                                               scale, p)
    for name, got, r in zip(("dq", "dk", "dv"), grads, refs):
        assert_bf16_match(got, r, f"K2b {name}")
    assert grads[3].dtype == torch.float32
    torch.testing.assert_close(grads[3], refs[3], rtol=1e-4,
                               atol=1e-4 * float(refs[3].abs().max()))
    for a, a2 in zip(grads, again):
        assert torch.equal(a, a2)


# K3f and K3b in bf16 at the long windows (the flagship's level 1 at L =
# 1024, and ragged L), each against its bf16 plain version: the kept
# weights rounded before ·V and the dV product, dS before the dq and dk
# products; out32 the output of the unrounded weights
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", LONG_ATTN)
def test_long_train_attention_bf16_forms_match_plain(b, h, n, c_qk, c_v, l,
                                                     p):
    dev = cuda_or_skip()
    pa = pwa_attention
    q, k, v, bias, do = _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=22)
    q, k, v, do = (t.to(torch.bfloat16) for t in (q, k, v, do))
    seed = torch.tensor([1234, 3], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(c_qk)
    f0 = pa.window_attention_train_fwd_long.launches_bf16
    b0 = pa.window_attention_train_bwd_long.launches_bf16
    out, lse, out32 = pa.window_attention_train_fwd_long(q, k, v, bias, seed,
                                                         scale, p)
    grads = pa.window_attention_train_bwd_long(q, k, v, bias, seed, do, scale,
                                               p, out32, lse)
    again = pa.window_attention_train_bwd_long(q, k, v, bias, seed, do, scale,
                                               p, out32, lse)
    torch.cuda.synchronize()
    assert pa.window_attention_train_fwd_long.launches_bf16 == f0 + 1
    assert pa.window_attention_train_bwd_long.launches_bf16 == b0 + 2
    ref, ref32 = pa.window_attention_train_fwd_long_plain(q, k, v, bias,
                                                          seed, scale, p)
    assert_bf16_match(out, ref, "K3f out")
    torch.testing.assert_close(out32, ref32, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(lse, pa.train_lse_plain(q, k, bias, scale),
                               rtol=1e-5, atol=1e-5)
    refs = pa.window_attention_train_bwd_plain(q, k, v, bias, seed, do,
                                               scale, p, row_blocked=True)
    for name, got, r in zip(("dq", "dk", "dv"), grads, refs):
        assert_bf16_match(got, r, f"K3b {name}")
    assert grads[3].dtype == torch.float32
    torch.testing.assert_close(grads[3], refs[3], rtol=1e-4,
                               atol=1e-4 * float(refs[3].abs().max()))
    for a, a2 in zip(grads, again):
        assert torch.equal(a, a2)


# K3f's bf16 form (one pass over each window on the tensor cores) at the
# flagship's L = 1024 (B = 2) and at a ragged L = 729 (9³, staged by plain
# loads): out against the plain version and against the kernel's own split
# of its products (hi·V, and out32 = hi·V + lo·V); out, out32 and lse
# repeat bit for bit
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("b,h,n,l", [(2, 2, 9, 1024), (1, 2, 3, 729)])
def test_long_train_attention_bf16_form_repeats(b, h, n, l, p):
    dev = cuda_or_skip()
    pa = pwa_attention
    q, k, v, bias, _ = _train_inputs(dev, b, h, n, 8, 8, l, seed=23)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    seed = torch.tensor([77, 5], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(8)
    f0 = pa.window_attention_train_fwd_long.launches_bf16
    got = pa.window_attention_train_fwd_long(q, k, v, bias, seed, scale, p)
    again = pa.window_attention_train_fwd_long(q, k, v, bias, seed, scale, p)
    torch.cuda.synchronize()
    assert pa.window_attention_train_fwd_long.launches_bf16 == f0 + 2
    ref, ref32 = pa.window_attention_train_fwd_long_plain(q, k, v, bias,
                                                          seed, scale, p)
    assert_bf16_match(got[0], ref, "K3f out")
    torch.testing.assert_close(got[2], ref32, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[1], pa.train_lse_plain(q, k, bias, scale),
                               rtol=1e-5, atol=1e-5)
    mo, m32 = pa.window_attention_train_fwd_long_mma_plain(q, k, v, bias,
                                                           seed, scale, p)
    assert_bf16_match(got[0], mo, "K3f out against its split")
    # the tensor cores' fp32 sums round toward zero: ~5e-6 at 1024 columns
    torch.testing.assert_close(got[2], m32, rtol=1e-5, atol=1e-5)
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)


@pytest.mark.parametrize("c,groups,expansion,s", JLC_LEVELS)
def test_jlc_stage1_bf16_forms_match_plain(c, groups, expansion, s):
    dev = cuda_or_skip()
    bf = torch.bfloat16
    cg = c // groups
    x, g = (cf(normal((2, s, s, s, c), seed=sd)).contiguous().to(dev, bf)
            for sd in (31, 32))
    ws = [torch.from_numpy(normal((c, cg, k, k, k), seed=33 + k,
                                  scale=(2.0 / (cg * k ** 3)) ** 0.5))
          .to(dev, bf) for k in (1, 3, 5)]
    bs = [torch.zeros(c, device=dev, dtype=bf) for _ in ws]
    n4f = fused_jlc.jlc_stage1.launches_bf16
    n4b = fused_jlc.jlc_stage1_bwd.launches_bf16
    nw = fused_jlc.jlc_branch_wgrad.launches_bf16
    with torch.no_grad():
        out1 = fused_jlc.jlc_stage1(x, ws, bs, groups)
    dy, dws = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
    alone = fused_jlc.jlc_branch_wgrad(x, dy, ws, groups)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage1.launches_bf16 == n4f + 1
    assert fused_jlc.jlc_stage1_bwd.launches_bf16 == n4b + 1
    assert fused_jlc.jlc_branch_wgrad.launches_bf16 == nw + 2
    assert_bf16_match(out1, fused_jlc.jlc_stage1_plain(x, ws, bs, groups),
                      "K4f out1")
    ref_dy, _ = fused_jlc.jlc_stage1_bwd_plain(x, ws, g, groups)
    assert_bf16_match(dy, ref_dy, "K4b dy")
    # the wgrad on the kernel's own dy, against the library's on it
    for j, (got, r) in enumerate(zip(dws, fused_jlc.jlc_branch_wgrad_plain(
            x, dy, ws, groups))):
        assert_bf16_match(got, r, f"K4b dW{j}")
    for a, a2 in zip(dws, alone):
        assert torch.equal(a, a2)


# K1's bf16 form at the speed CLI's shapes: AutoPET-II's four levels at
# B = 16 (the batch the CLI finds), Hecktor's L = 512 and BraTS's L = 216
K1_BF16 = [(16, 1, 585, 4, 4, 54), (16, 2, 9, 8, 8, 432),
           (16, 2, 9, 8, 16, 54), (16, 4, 1, 16, 32, 54),
           (16, 2, 9, 8, 8, 512), (16, 2, 8, 8, 8, 216), (2, 2, 7, 8, 8, 50)]


@pytest.mark.parametrize("b,h,n,c_qk,c_v,l", K1_BF16)
def test_attention_bf16_form_matches_plain(b, h, n, c_qk, c_v, l):
    dev = cuda_or_skip()
    pa = pwa_attention
    q, k, v, bias, _ = _train_inputs(dev, b, h, n, c_qk, c_v, l, seed=41)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    scale = 1.0 / np.sqrt(c_qk)
    n1 = pa.window_attention.launches_bf16
    with torch.no_grad():
        out = pa.window_attention(q, k, v, bias, scale)
    torch.cuda.synchronize()
    assert pa.window_attention.launches_bf16 == n1 + 1
    assert out.dtype == torch.bfloat16
    assert_bf16_match(out, pa.window_attention_plain(q, k, v, bias, scale),
                      "K1 out")


def _stage2_inputs(dev, b, c, e, shape, dtype, seed):
    hid = e * c
    x, g = (torch.from_numpy(normal((b, c) + tuple(shape), seed=seed + i,
                                    scale=1.5)).to(dev, dtype)
            for i in (0, 1))
    w1 = torch.from_numpy(normal((hid, c, 1, 1, 1), seed + 2,
                                 (2.0 / c) ** 0.5)).to(dev, dtype)
    b1 = torch.from_numpy(normal((hid,), seed + 3, 0.1)).to(dev, dtype)
    w2 = torch.from_numpy(normal((c, hid, 1, 1, 1), seed + 4,
                                 (2.0 / hid) ** 0.5)).to(dev, dtype)
    b2 = torch.from_numpy(normal((c,), seed + 5, 0.1)).to(dev, dtype)
    return x, g, w1, b1, w2, b2


# K5f's bf16 form at the speed CLI's four JLC levels (B = 16, AutoPET-II
# 96³: 24³ to 3³), at B = 2's L0 and at padded widths
K5_BF16 = [(16, 16 * 2 ** i, e, (24 // 2 ** i,) * 3)
           for i, e in enumerate((3, 3, 2, 2))] + [
    (2, 16, 3, (24, 24, 24)), (2, 12, 3, (5, 5, 5)), (3, 6, 3, (3, 5, 7))]
# K5b's at the bf16 train step's four levels (B = 2) and every tiling
K5B_BF16 = [(2, 16 * 2 ** i, e, (24 // 2 ** i,) * 3)
            for i, e in enumerate((3, 3, 2, 2))] + [
    (2, 128, 2, (3, 5, 7)), (2, 16, 3, (9, 11, 13)), (2, 12, 3, (4, 4, 4))]


@pytest.mark.parametrize("b,c,e,shape", K5_BF16)
def test_jlc_stage2_bf16_form_matches_plain(b, c, e, shape):
    dev = cuda_or_skip()
    x, _, w1, b1, w2, b2 = _stage2_inputs(dev, b, c, e, shape,
                                          torch.bfloat16, 51)
    n2 = fused_jlc.jlc_stage2.launches_bf16
    with torch.no_grad():
        out, mean, rstd = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
        again = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage2.launches_bf16 == n2 + 2
    assert out.dtype == torch.bfloat16 and mean.dtype == torch.float32
    assert_bf16_match(out, fused_jlc.jlc_stage2_plain(x, w1, b1, w2, b2),
                      "K5f out")
    m, r = fused_jlc._plane_stats(x.float())
    torch.testing.assert_close(mean, m.reshape(-1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, r.reshape(-1), rtol=1e-5, atol=1e-6)
    for a, a2 in zip((out, mean, rstd), again):
        assert torch.equal(a, a2)


# K5f's bf16 form at the bf16 B = 2 step's four levels (conv_drop 0) with
# every split of the hidden rows among a block's warps that the widths take
K5F_SPLITS = [(b, c, e, shape, hs) for b, c, e, shape in K5B_BF16[:4]
              for hs in (1, 2, 4) if (e * c) % (16 * hs) == 0]


@pytest.mark.parametrize("b,c,e,shape,hsplit", K5F_SPLITS)
def test_jlc_stage2_bf16_form_at_every_split(b, c, e, shape, hsplit):
    dev = cuda_or_skip()
    x, _, w1, b1, w2, b2 = _stage2_inputs(dev, b, c, e, shape,
                                          torch.bfloat16, 71)
    lw = fused_jlc.stage2_mma_launch(
        b, c, e * c, int(np.prod(shape)),
        torch.cuda.get_device_properties(dev).multi_processor_count, hsplit)
    with torch.no_grad():
        out, mean, rstd = fused_jlc._jlc_stage2_fwd_mma(x, w1, b1, w2, b2,
                                                        launch=lw)
        again = fused_jlc._jlc_stage2_fwd_mma(x, w1, b1, w2, b2, launch=lw)
        chosen = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert_bf16_match(out, fused_jlc.jlc_stage2_plain(x, w1, b1, w2, b2),
                      "K5f out")
    assert_bf16_match(out, fused_jlc.jlc_stage2_mma_plain(
        x, w1, b1, w2, b2, hsplit), "K5f out against its split")
    for a, a2 in zip((out, mean, rstd), again):
        assert torch.equal(a, a2)
    # the statistics do not depend on the split
    assert torch.equal(mean, chosen[1]) and torch.equal(rstd, chosen[2])


@pytest.mark.parametrize("b,c,e,shape", K5B_BF16)
def test_jlc_stage2_backward_bf16_form_matches_plain(b, c, e, shape):
    dev = cuda_or_skip()
    x, g, w1, b1, w2, b2 = _stage2_inputs(dev, b, c, e, shape,
                                          torch.bfloat16, 61)
    with torch.no_grad():
        _, mean, rstd = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
    n2 = fused_jlc.jlc_stage2_bwd.launches_bf16
    got = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
    again = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage2_bwd.launches_bf16 == n2 + 2
    refs = fused_jlc.jlc_stage2_bwd_plain(x, w1, b1, w2, g)
    for name, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got, refs):
        assert a.shape == r.shape
        assert_bf16_match(a, r, f"K5b {name}")
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)


def test_wkv_bf16_runs_the_fp32_kernel_at_its_edges():
    from veloxseg_torch.models.zoo.urwkv import _fancy_init
    from veloxseg_torch.ops import wkv
    dev = cuda_or_skip()
    b, t, c = 4, 216, 128
    decay, first, *_ = _fancy_init(c)
    w, u = (torch.from_numpy(a / t).to(dev, torch.bfloat16)
            for a in (decay, first))
    k, v = (torch.from_numpy(normal((b, t, c), seed=s)).to(dev, torch.bfloat16)
            for s in (71, 72))
    n6 = wkv.wkv.launches
    with torch.no_grad():
        got = wkv.wkv(w, u, k, v)
    torch.cuda.synchronize()
    assert wkv.wkv.launches == n6 + 1 and got.dtype == torch.bfloat16
    ref = wkv.wkv_plain(w.float(), u.float(), k.float(), v.float())
    assert_bf16_match(got, ref.to(torch.bfloat16), "K6 bf16")


def test_tiny_bf16_forward_on_card_matches_cpu():
    dev = cuda_or_skip()
    cfg = VeloxSegConfig(**TINY)
    x = torch.from_numpy(normal((2, 32, 32, 32, 2), seed=4))
    outs = {}
    for d in (dev, torch.device("cpu")):
        model, _ = build_veloxseg(cfg, device=d, seed=3)
        n1 = pwa_attention.window_attention.launches_bf16
        with torch.inference_mode():
            outs[d.type] = model.to(torch.bfloat16)(
                x.to(d, torch.bfloat16)).float().cpu()
        if d.type == "cuda":
            assert pwa_attention.window_attention.launches_bf16 == n1 + 4
    with torch.no_grad():
        ref32 = build_veloxseg(cfg, device="cpu", seed=3)[0](x)
    # the same rounding points on both devices, other fp32 sum orders: held
    # as phase [4] of chip_smoke.py holds the full-width forward
    d = forward_distances(outs["cuda"], outs["cpu"], ref32)
    assert d["to_bf16"] <= FORWARD_BOUND["to_bf16"], d
    assert d["to_fp32"] >= FORWARD_BOUND["to_fp32"], d


def test_jlc_stage1_kernels_refuse_other_kernel_sets():
    dev = cuda_or_skip()
    x = torch.zeros(1, 8, 4, 4, 4, device=dev)
    ws = [torch.zeros(8, 4, k, k, k, device=dev) for k in (3, 5)]
    with pytest.raises(ValueError, match="branches"):
        fused_jlc.jlc_stage1(x, ws, [torch.zeros(8, device=dev)] * 2, 2)
    with pytest.raises(ValueError, match="branches"):
        fused_jlc.jlc_stage1_bwd(x, ws, x, 2)


def test_tiny_forward_on_card_matches_cpu():
    dev = cuda_or_skip()
    cfg = VeloxSegConfig(**TINY)
    gpu, _ = build_veloxseg(cfg, device=dev, seed=3)
    cpu, _ = build_veloxseg(cfg, device="cpu", seed=3)
    x = torch.from_numpy(normal((2, 32, 32, 32, 2), seed=4))
    with torch.no_grad():
        got = gpu(x.to(dev)).cpu()
        ref = cpu(x)
    scale = float(ref.abs().max())
    # fp32 on both; cuDNN and the kernels sum in other orders than the CPU
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * scale)


def test_tiny_train_step_on_card_matches_cpu():
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.optim import build_optimizer
    from veloxseg_torch.train.train_state import (create_train_state,
                                                  train_step_fn)
    dev = cuda_or_skip()
    cfg = VeloxSegConfig(**dict(TINY, attn_drop=0.0, proj_drop=0.0,
                                conv_drop=0.0))
    x = torch.from_numpy(normal((2, 32, 32, 32, 2), seed=5))
    y = (x[..., 0] > 0.5).long()
    loss = CompositeLoss("VeloxSeg", {"deep_Loss_weight": [1, 1, 1, 1],
                                      "RC_Loss_weight": 0.5,
                                      "Feature_Loss_weight": 2.0},
                         num_modal=cfg.num_modalities)
    grads, losses = [], []
    for d in (dev, torch.device("cpu")):
        model, _ = build_veloxseg(cfg, device=d, seed=3)
        state = create_train_state(model, build_optimizer(
            "adamw", {"lr": 2.5e-4, "weight_decay": 0.01},
            model.parameters()))
        _, aux = train_step_fn(loss, device=d)(state, x, y, None)
        losses.append(float(aux["loss"]))
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    g_all = max(float(g.abs().max()) for g in grads[1].values())
    for k, r in grads[1].items():
        err = float((grads[0][k] - r).abs().max())
        # as tests/test_torch_train_step.py holds the port against JAX
        assert err <= 1e-4 * float(r.abs().max()) + 1e-5 * g_all, k
