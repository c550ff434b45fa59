"""K4b and K5b, the JLC block backward: the port's two stage Functions
(plain versions on the CPU: the K4b and K5b twins, then the conv's dgrad
and wgrad) against ``jax.grad`` through the JAX Pallas block
(``fused_jlc.jlc_block``, interpret mode, as ``tests/test_fused_jlc.py``
runs it), and the JLC module with its stage-2 dropout. The CUDA kernels
against their plain versions are in ``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cf, cl, dense, dhwio, normal, randomize_
from veloxseg_torch.nn.conv_blocks import JLC
from veloxseg_torch.ops import fused_jlc as port
from veloxseg_tpu.ops import fused_jlc, packed_conv


@pytest.mark.parametrize("c,groups,expansion", [(16, 4, 3), (32, 4, 2)])
def test_stage_functions_match_jax_grad_of_pallas_block(c, groups,
                                                        expansion):
    blk = randomize_(JLC(c, (1, 3, 5), groups, expansion), seed=c,
                     scale=0.3)
    x = normal((2, 8, 8, 8, c), seed=1)
    cot = normal((2, 8, 8, 8, c), seed=2)
    convs = blk._convs()
    expand, project = blk.channel_conv[1], blk.channel_conv[3]

    xt = cf(x).contiguous().requires_grad_()
    params = ([m.weight for m in convs] + [m.bias for m in convs]
              + [expand.weight, expand.bias, project.weight, project.bias])
    out1 = port.jlc_stage1(xt, [m.weight for m in convs],
                           [m.bias for m in convs], groups)
    out = port.jlc_stage2(out1, expand.weight, expand.bias, project.weight,
                          project.bias)
    grads = torch.autograd.grad(out, [xt] + params, cf(cot))
    gx, gws, gbs = grads[0], grads[1:4], grads[4:7]
    gw1, gb1, gw2, gb2 = grads[7:]

    def loss(xp, ws, w1, b1, w2, b2):
        o = fused_jlc.jlc_block(
            xp, [(w.shape[0], w) for w in ws], groups, w1, b1, w2, b2,
            interpret=True)
        return jnp.sum(packed_conv.unpack_s2d(o, c) * jnp.asarray(cot))

    jargs = (packed_conv.pack_s2d(jnp.asarray(x)),
             [jnp.asarray(dhwio(m.weight)) for m in convs],
             jnp.asarray(dense(expand.weight)),
             jnp.asarray(expand.bias.detach()),
             jnp.asarray(dense(project.weight)),
             jnp.asarray(project.bias.detach()))
    r = jax.grad(loss, argnums=tuple(range(6)))(*jargs)
    refs = [np.asarray(packed_conv.unpack_s2d(r[0], c))]
    refs += [np.transpose(np.asarray(w), (4, 3, 0, 1, 2)) for w in r[1]]
    refs += [np.asarray(r[2]).T[:, :, None, None, None], np.asarray(r[3]),
             np.asarray(r[4]).T[:, :, None, None, None], np.asarray(r[5])]
    gots = [cl(gx)] + [g.numpy() for g in (*gws, gw1, gb1, gw2, gb2)]
    for got, ref in zip(gots, refs):
        # fp32; the packed conv sums its 27 parity taps in another order
        # and the Pallas block never reads the branch biases
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=2e-4 * float(np.abs(ref).max()))
    # the branch biases cancel in the branch InstanceNorm: exact zeros
    for g in gbs:
        assert float(g.abs().max()) <= 1e-6


def test_jlc_module_dropout_gate():
    blk = randomize_(JLC(16, (1, 3, 5), 4, 3, dropout=0.5), seed=3)
    x = cf(normal((2, 6, 6, 6, 16), seed=4))
    n2f, n2b = port.jlc_stage2.launches, port.jlc_stage2_bwd.launches
    with torch.no_grad():
        ref = blk.eval()(x)
        # train with dropout: library ops, the mask from the generator
        a = blk.train()(x, torch.Generator().manual_seed(1))
        b = blk(x, torch.Generator().manual_seed(1))
        c = blk(x, torch.Generator().manual_seed(2))
        blk.dropout = 0.0          # inactive dropout: the stage-2 Function
        d = blk(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    torch.testing.assert_close(d, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        JLC(16, (1, 3, 5), 4, 3, dropout=0.5).train()(x)
    # CPU tensors never count as kernel launches
    assert (port.jlc_stage2.launches, port.jlc_stage2_bwd.launches) == \
        (n2f, n2b)
