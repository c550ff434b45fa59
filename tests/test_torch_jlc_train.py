"""K4b and K5b, the JLC block backward: the port's two stage Functions
(plain versions on the CPU: the K4b twin with the branch weights'
gradient and the K5b twin, then the conv's dgrad) against ``jax.grad``
through the JAX Pallas block (``fused_jlc.jlc_block``, interpret mode, as
``tests/test_fused_jlc.py`` runs it) or, for volumes the 2×2×2 packing
cannot take, through the JAX ``JLC`` module; the JLC module with its
stage-2 dropout; and K4's launch geometry. The CUDA kernels against their
plain versions are in ``test_torch_kernels.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cf, cl, dense, dhwio, normal, randomize_
from veloxseg_torch.nn.conv_blocks import JLC
from veloxseg_torch.ops import fused_jlc as port
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn.conv_blocks import JLC as JaxJLC
from veloxseg_tpu.ops import fused_jlc, packed_conv


def _pallas_block_grads(c, groups, convs, expand, project, x, cot):
    """``jax.grad`` through the Pallas block on the packed stream (even
    volumes only: the 2×2×2 packing)."""
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
    return refs + [np.asarray(r[2]).T[:, :, None, None, None],
                   np.asarray(r[3]),
                   np.asarray(r[4]).T[:, :, None, None, None],
                   np.asarray(r[5])]


def _module_grads(blk, groups, expansion, x, cot):
    """``jax.grad`` through the JAX ``JLC`` module, which runs volumes the
    packing cannot take (odd edges) through its unpacked XLA path."""
    sd = {f"encoder.encoder_conv.layer1.0.{k}": v
          for k, v in blk.state_dict().items()}
    params = convert_state_dict(sd)["encoder"]["conv_layer1"]["JLC_0"]
    jblk = JaxJLC(kernel_sizes=(1, 3, 5), groups=groups,
                  expansion_factor=expansion)

    def loss(p, v):
        return jnp.sum(jblk.apply({"params": p}, v, True) * jnp.asarray(cot))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    refs = [np.asarray(gx)]
    refs += [np.transpose(np.asarray(gp[f"GroupedConv3d_{j}"]["kernel"]),
                          (4, 3, 0, 1, 2)) for j in range(3)]
    return refs + [np.asarray(gp["Dense_0"]["kernel"]).T[:, :, None, None,
                                                            None],
                   np.asarray(gp["Dense_0"]["bias"]),
                   np.asarray(gp["Dense_1"]["kernel"]).T[:, :, None, None,
                                                            None],
                   np.asarray(gp["Dense_1"]["bias"])]


# the first two: AutoPET L0/L1 widths at 8³; then C/groups = 16 on a 3³
# volume (smaller than the k = 5 cube) and on 6³ (packed 3³), and a
# non-cubic volume with odd edges
@pytest.mark.parametrize("c,groups,expansion,spatial", [
    pytest.param(16, 4, 3, (8, 8, 8), id="16-4-3"),
    pytest.param(32, 4, 2, (8, 8, 8), id="32-4-2"),
    pytest.param(16, 1, 3, (3, 3, 3), id="cg16-3x3x3"),
    pytest.param(32, 2, 2, (6, 6, 6), id="cg16-6x6x6"),
    pytest.param(16, 4, 2, (5, 6, 7), id="cg4-5x6x7")])
def test_stage_functions_match_jax_grad_of_pallas_block(c, groups,
                                                        expansion, spatial):
    blk = randomize_(JLC(c, (1, 3, 5), groups, expansion), seed=c,
                     scale=0.3)
    x = normal((2, *spatial, c), seed=1)
    cot = normal((2, *spatial, c), seed=2)
    convs = blk._convs()
    expand, project = blk.channel_conv[1], blk.channel_conv[3]

    xt = cf(x).contiguous().requires_grad_()
    params = ([m.weight for m in convs] + [m.bias for m in convs]
              + [expand.weight, expand.bias, project.weight, project.bias])
    n4b, nw = port.jlc_stage1_bwd.launches, port.jlc_branch_wgrad.launches
    out1 = port.jlc_stage1(xt, [m.weight for m in convs],
                           [m.bias for m in convs], groups)
    out = port.jlc_stage2(out1, expand.weight, expand.bias, project.weight,
                          project.bias)
    grads = torch.autograd.grad(out, [xt] + params, cf(cot))
    gx, gws, gbs = grads[0], grads[1:4], grads[4:7]
    gw1, gb1, gw2, gb2 = grads[7:]
    # the CPU backward takes K4b's plain version, weight gradient included
    assert (port.jlc_stage1_bwd.launches,
            port.jlc_branch_wgrad.launches) == (n4b, nw)

    if all(s % 2 == 0 for s in spatial):
        refs = _pallas_block_grads(c, groups, convs, expand, project, x, cot)
    else:
        refs = _module_grads(blk, groups, expansion, x, cot)
    gots = [cl(gx)] + [g.numpy() for g in (*gws, gw1, gb1, gw2, gb2)]
    for got, ref in zip(gots, refs):
        # fp32; the packed conv sums its 27 parity taps in another order,
        # the Pallas block never reads the branch biases and the module
        # adds them
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


# (B, C, groups, edge) of every main path's JLC levels: the AutoPET-II 96³
# forward (4 tiles) and train step (B = 2), the 128³ flagship step (B = 16)
MAIN_PATH_LEVELS = [(b, 16 * 2 ** i, 16 * 2 ** i // cg, s0 // 2 ** i)
                    for b, s0 in ((4, 24), (2, 24), (16, 32))
                    for i, cg in enumerate((4, 8, 8, 16))]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,c,groups,shape", [
    (b, c, g, (s, s, s)) for b, c, g, s in MAIN_PATH_LEVELS] + [
    (2, 16 * m, 4, shape) for m in (1, 2, 4)
    for shape in ((3, 3, 3), (5, 7, 9), (24, 24, 24), (32, 32, 32))])
def test_stage1_launch_covers_every_voxel_and_unit_once(b, c, groups, shape,
                                                        sms):
    d, h, w = shape
    lw = port.stage1_launch(b, c, groups, d, h, w, sms)
    quads = c // groups // 4
    assert max(lw.tz, lw.ty, lw.tx) <= 8 and lw.tx % lw.vx == 0
    assert quads % lw.oqb == 0 and quads % lw.ks == 0
    assert quads % lw.wgrad_oqb == 0 and lw.wgrad_oqb <= 2
    # the conv block's threads (csrc/jlc_stage1.cu:kConvMaxThreads)
    assert lw.ks * lw.oqb * lw.tz * lw.ty * (lw.tx // lw.vx) <= 512
    # the conv's tiles: tile t starts at (t // (ny·nx), t // nx % ny,
    # t % nx) times the edges, as csrc/jlc_stage1.cu:tile_origin
    seen = np.zeros(shape, np.int64)
    for t in range(lw.tiles):
        z0 = t // (lw.ny * lw.nx) * lw.tz
        y0 = t // lw.nx % lw.ny * lw.ty
        x0 = t % lw.nx * lw.tx
        assert z0 < d and y0 < h and x0 < w     # no tile lies off the volume
        seen[z0:z0 + lw.tz, y0:y0 + lw.ty, x0:x0 + lw.tx] += 1
    assert (seen == 1).all()
    # the wgrad's blocks split the (b, tile) units, none of them empty
    ranges = lw.wgrad_ranges(b)
    units = [u for lo, hi in ranges for u in range(lo, hi)]
    assert units == list(range(b * lw.tiles))
    assert all(hi > lo for lo, hi in ranges)
