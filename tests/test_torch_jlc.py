"""K4f and K5f, the JLC block forward: the port's plain stage 1 ∘ stage 2
against the JAX Pallas block (``fused_jlc.jlc_block``, interpret mode, on
a packed stream as ``tests/test_fused_jlc.py`` runs it), the port's ``JLC``
module against the JAX ``JLC`` module. The CUDA kernels against their plain
versions are in ``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cf, cl, dense, dhwio, normal, randomize_
from veloxseg_torch.interop.jax_params import state_dict_from_jax
from veloxseg_torch.nn.conv_blocks import JLC
from veloxseg_torch.ops import fused_jlc as port
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn.conv_blocks import JLC as JaxJLC
from veloxseg_tpu.ops import fused_jlc, packed_conv


def _block(c, groups, expansion, seed, kernel_sizes=(1, 3, 5)):
    blk = JLC(c, kernel_sizes, groups, expansion).eval()
    return randomize_(blk, seed, scale=0.3)


def _params(blk):
    convs = blk._convs()
    return ([c.weight for c in convs], [c.bias for c in convs],
            blk.channel_conv[1], blk.channel_conv[3])


@pytest.mark.parametrize("c,groups,expansion", [(16, 4, 3), (32, 4, 2)])
def test_plain_stages_match_pallas_block(c, groups, expansion):
    blk = _block(c, groups, expansion, seed=c)
    x = normal((2, 8, 8, 8, c), seed=1)
    ws, bs, expand, project = _params(blk)
    with torch.no_grad():
        out1 = port.jlc_stage1(cf(x), ws, bs, groups)
        got = cl(port.jlc_stage2(out1, expand.weight, expand.bias,
                                 project.weight, project.bias))
    xp = packed_conv.pack_s2d(jnp.asarray(x))
    ref = fused_jlc.jlc_block(
        xp, [(w.shape[-1], jnp.asarray(dhwio(w))) for w in ws], groups,
        jnp.asarray(dense(expand.weight)), jnp.asarray(expand.bias.detach()),
        jnp.asarray(dense(project.weight)),
        jnp.asarray(project.bias.detach()), interpret=True)
    ref = np.asarray(packed_conv.unpack_s2d(ref, c))
    # fp32; the Pallas block drops the branch biases (they cancel in the
    # InstanceNorm) while the plain version adds them, and the packed conv
    # sums 27 parity taps in another order: 2e-4 as tests/test_fused_jlc.py
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


# the three-branch block of every repo config, and two branches with no
# 1×1 tap (K4f shares each input load between the branches that hold it)
@pytest.mark.parametrize("kernel_sizes", [(1, 3, 5), (3, 5)])
def test_jlc_module_matches_jax_module(kernel_sizes):
    c, groups, expansion = 16, 4, 3
    blk = _block(c, groups, expansion, seed=5, kernel_sizes=kernel_sizes)
    x = normal((2, 8, 8, 8, c), seed=6)
    with torch.no_grad():
        got = cl(blk(cf(x)))
    sd = {f"encoder.encoder_conv.layer1.0.{k}": v
          for k, v in blk.state_dict().items()}
    params = convert_state_dict(sd)["encoder"]["conv_layer1"]["JLC_0"]
    jblk = JaxJLC(kernel_sizes=kernel_sizes, groups=groups,
                  expansion_factor=expansion)
    ref = np.asarray(jax.jit(lambda p, v: jblk.apply({"params": p}, v, True))(
        params, jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_single_kernel_jlc_is_refused():
    # the reference's single-kernel form (a bare conv, no IN/GELU) is in no
    # repo config and is not ported: building or importing it raises
    with pytest.raises(ValueError, match="single-kernel"):
        JLC(16, (3,), 4, 3)
    params = {"encoder": {
        "conv_down1": {"GroupedConv3d_0": {"kernel": np.zeros(
            (3, 3, 3, 2, 8), np.float32)}},
        "conv_layer1": {"JLC_0": {"GroupedConv3d_0": {"kernel": np.zeros(
            (3, 3, 3, 2, 8), np.float32)}}}}}
    with pytest.raises(KeyError, match="single-kernel"):
        state_dict_from_jax(params)


def test_cpu_tensors_take_plain_versions_without_counting():
    blk = _block(16, 4, 3, seed=7)
    x = cf(normal((1, 4, 4, 4, 16), seed=8))
    n1, n2 = port.jlc_stage1.launches, port.jlc_stage2.launches
    with torch.no_grad():
        blk(x)
    assert (port.jlc_stage1.launches, port.jlc_stage2.launches) == (n1, n2)

