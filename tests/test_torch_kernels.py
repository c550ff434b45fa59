"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip where there is no GPU (a CUDA kernel has
no CPU mode). This file imports neither JAX nor the JAX package, so it runs
on a machine with the card and PyTorch alone:

    python -m pytest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, cf, cuda_or_skip, normal, randomize_
from veloxseg_torch.core.config import VeloxSegConfig
from veloxseg_torch.nn.conv_blocks import JLC
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.ops import fused_jlc, pwa_attention

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


# AutoPET per-level (C, groups, expansion, spatial) of a 96³ tile, B = 4
JLC_LEVELS = [(16, 4, 3, 24), (32, 4, 3, 12), (64, 8, 2, 6), (128, 8, 2, 3)]


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


# (B, h, N, Cqk, Cv, L) of the train attention at AutoPET (B = 2), plus a
# Hecktor L1 window and a ragged window count
TRAIN_ATTN = [(2, 1, 585, 4, 4, 54), (2, 2, 9, 8, 8, 432),
              (2, 2, 9, 8, 16, 54), (2, 4, 1, 16, 32, 54),
              (2, 2, 7, 8, 8, 512)]


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
    out = pwa_attention.window_attention_train_fwd(q, k, v, bias, seed,
                                                   scale, p)
    grads = pwa_attention.window_attention_train_bwd(q, k, v, bias, seed,
                                                     do, scale, p)
    again = pwa_attention.window_attention_train_bwd(q, k, v, bias, seed,
                                                     do, scale, p)
    torch.cuda.synchronize()
    assert pwa_attention.window_attention_train_fwd.launches == f0 + 1
    assert pwa_attention.window_attention_train_bwd.launches == b0 + 2
    ref = pwa_attention.window_attention_train_fwd_plain(q, k, v, bias, seed,
                                                         scale, p)
    refs = pwa_attention.window_attention_train_bwd_plain(q, k, v, bias,
                                                          seed, do, scale, p)
    # fp32; the same mask on both sides, sums taken in other orders
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    for got, r in zip(grads, refs):
        scale_r = float(r.abs().max())
        torch.testing.assert_close(got, r, rtol=1e-4, atol=1e-4 * scale_r)
    # dbias is reduced in a fixed order: bit-identical between calls
    assert torch.equal(grads[3], again[3])


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
    n1 = fused_jlc.jlc_stage1_bwd.launches
    n2 = fused_jlc.jlc_stage2_bwd.launches
    dy = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
    got2 = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g)
    again2 = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g)
    torch.cuda.synchronize()
    assert fused_jlc.jlc_stage1_bwd.launches == n1 + 1
    assert fused_jlc.jlc_stage2_bwd.launches == n2 + 2
    ref_dy = fused_jlc.jlc_stage1_bwd_plain(x, ws, g, groups)
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
    loss = CompositeLoss({"deep_Loss_weight": [1, 1, 1, 1],
                          "RC_Loss_weight": 0.5,
                          "Feature_Loss_weight": 2.0}, cfg)
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
