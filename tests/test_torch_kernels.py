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
