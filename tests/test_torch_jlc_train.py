"""K4b and K5b, the JLC block backward: the port's two stage Functions
(plain versions on the CPU: the K4b twin with the branch weights'
gradient and the K5b twin, then the conv's dgrad) against ``jax.grad``
through the JAX Pallas block (``fused_jlc.jlc_block``, interpret mode, as
``tests/test_fused_jlc.py`` runs it) or, for volumes the 2×2×2 packing
cannot take, through the JAX ``JLC`` module; the JLC module with its
stage-2 dropout; K4's, K5f's and K5b's launch geometry; and K5f's and
K5b's decompositions and padding; K5f's bf16 form on the tensor cores:
its launch geometry at every published level and its split of the
products against the bf16 plain version. The CUDA kernels against their
plain versions are in ``test_torch_kernels.py``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_bf16_match, cf, cl, dense, dhwio,
                                normal, randomize_)
from veloxseg_torch.nn.conv_blocks import JLC
from veloxseg_torch.ops import fused_jlc as port
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn.conv_blocks import JLC as JaxJLC
from veloxseg_tpu.ops import fused_jlc, packed_conv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# (B, C, E·C, edge) of the two training paths' JLC levels (K5b runs where
# stage 2 is not under dropout): the 96³ step at B = 2, the 128³ flagship
# at B = 16
TRAIN_STAGE2_LEVELS = [(b, 16 * 2 ** i, e * 16 * 2 ** i, s0 // 2 ** i)
                       for b, s0 in ((2, 24), (16, 32))
                       for i, e in enumerate((3, 3, 2, 2))]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,c,hid,s", [
    (b, c, hid, s ** 3) for b, c, hid, s in TRAIN_STAGE2_LEVELS] + [
    (2, 128, 256, 105), (1, 8, 24, 16 * 16 * 17), (2, 16, 48, 1000),
    (3, 64, 128, 1)])
def test_stage2_bwd_launch_covers_every_voxel_and_unit_once(b, c, hid, s,
                                                            sms):
    lw = port.stage2_bwd_launch(b, c, hid, s, sms)
    # the hidden slices split E·C in order, each within the kernel's limits
    # (csrc/jlc_stage2.cu:vs_jlc_stage2_bwd)
    assert lw.hs * lw.slices == hid and lw.hs % 4 == 0
    assert lw.hs * c <= 8192 and lw.hs + c <= 256
    assert [r for lo, hi in lw.slice_rows() for r in range(lo, hi)] \
        == list(range(hid))
    if c == 128:
        assert lw.slices == 8          # W1 + W2 (256 KB) exceed a block
    # shared memory (floats): weights, two stage buffers of x and g, the
    # z1/dz1 tiles, b1
    floats = 3 * lw.hs * c + 4 * c * 68 + 2 * lw.hs * 68 + lw.hs
    assert floats * 4 <= 232448
    # with voxel parts the block adds them through 16 floats a thread
    assert port._k5b_smem_floats(c, lw.hs, lw.tp) == max(
        floats, 16 * 256 if lw.tp > 1 else 0)
    # every weight job has threads: JPT per thread, TP threads per job
    jobs = lw.hs * c // 8
    assert lw.jpt in (1, 2, 4) and 64 % (4 * lw.tp) == 0
    assert lw.jpt * (256 // lw.tp) >= jobs and (lw.tp == 1 or lw.jpt == 1)
    # the chunks split the (b, tile) units, none of them empty
    ranges = lw.unit_ranges()
    assert [u for lo, hi in ranges for u in range(lo, hi)] \
        == list(range(lw.units))
    assert all(hi > lo for lo, hi in ranges)
    assert lw.units == b * lw.tiles_per_sample
    # the 64-voxel tiles of a sample cover its voxels once
    seen = np.zeros(s, np.int64)
    for t in range(lw.tiles_per_sample):
        assert t * 64 < s
        seen[t * 64:(t + 1) * 64] += 1
    assert (seen == 1).all()
    # the planes launch's blocks of a plane cover it once
    vchunk = -(-s // lw.ysplit)
    assert (lw.ysplit - 1) * vchunk < s <= lw.ysplit * vchunk


@pytest.mark.parametrize("b,c,e,spatial,sms", [
    (2, 16, 3, (4, 6, 8), 3), (1, 128, 2, (4, 4, 6), 132),
    (2, 32, 3, (6, 6, 6), 2)])
def test_stage2_split_form_matches_jax_k2_bwd(b, c, e, spatial, sms):
    hid = e * c
    x, g = normal((b, c) + spatial, 31), normal((b, c) + spatial, 32)
    w1 = normal((hid, c), 33, (2.0 / c) ** 0.5)
    b1 = normal((hid,), 34, 0.1)
    w2 = normal((c, hid), 35, (2.0 / hid) ** 0.5)
    lw = port.stage2_bwd_launch(b, c, hid, int(np.prod(spatial)), sms)
    got = port.jlc_stage2_bwd_split_plain(
        torch.from_numpy(x), torch.from_numpy(w1)[..., None, None, None],
        torch.from_numpy(b1), torch.from_numpy(w2)[..., None, None, None],
        torch.from_numpy(g), lw)
    # the Pallas stage-2 backward in interpret mode on the packed stream,
    # with the block-diagonal weights jlc_block builds
    eye = jnp.eye(8, dtype=jnp.float32)
    big1 = (jnp.asarray(w1.T)[None, :, None, :]
            * eye[:, None, :, None]).reshape(8 * c, 8 * hid)
    big2 = (jnp.asarray(w2.T)[None, :, None, :]
            * eye[:, None, :, None]).reshape(8 * hid, 8 * c)
    b1t = packed_conv.tile_bias(jnp.asarray(b1), 1)[None, :]
    xp = packed_conv.pack_s2d(jnp.asarray(np.moveaxis(x, 1, -1)))
    gp = packed_conv.pack_s2d(jnp.asarray(np.moveaxis(g, 1, -1)))
    dxp, dbig1, db1t, dbig2, db2t = fused_jlc._k2_bwd(xp, big1, b1t, big2,
                                                      gp, interpret=True)
    diag = lambda m, r, k: np.einsum(  # noqa: E731
        "prpk->rk", np.asarray(m).reshape(8, r, 8, k))
    refs = [np.moveaxis(np.asarray(packed_conv.unpack_s2d(dxp, c)), -1, 1),
            diag(dbig1, c, hid).T, np.asarray(db1t).reshape(8, hid).sum(0),
            diag(dbig2, hid, c).T, np.asarray(db2t).reshape(8, c).sum(0)]
    for a, r in zip(got, refs):
        # fp32 both ways; sums in other orders (per chunk, slice and tile)
        np.testing.assert_allclose(a.numpy().reshape(r.shape), r, rtol=0,
                                   atol=1e-4 * float(np.abs(r).max()))


@pytest.mark.parametrize("c,e", [(4, 3), (6, 3), (12, 3), (10, 2)])
def test_stage2_padding_adds_nothing(c, e):
    # K5b runs C not a multiple of 8, or E·C not one of 4, on zero channels
    # and hidden rows: the padded decomposition, cut back, is the plain
    # backward
    b, spatial, hid = 2, (3, 4, 5), e * c
    x, g = (torch.from_numpy(normal((b, c) + spatial, s)) for s in (41, 42))
    w1 = torch.from_numpy(normal((hid, c), 43, (2.0 / c) ** 0.5))
    b1 = torch.from_numpy(normal((hid,), 44, 0.1))
    w2 = torch.from_numpy(normal((c, hid), 45, (2.0 / hid) ** 0.5))
    mean, rstd = (t.reshape(-1) for t in port._plane_stats(x))
    xp, w1p, b1p, w2p, gp, mp, rp = port.pad_stage2_bwd(x, w1, b1, w2, g,
                                                         mean, rstd)
    cp, hp = port.stage2_widths(c, hid)
    assert cp % 8 == 0 and hp % 4 == 0 and cp - c < 8 and hp - hid < 4
    assert xp.shape == (b, cp) + spatial and gp.shape == xp.shape
    assert w1p.shape == (hp, cp) and w2p.shape == (cp, hp)
    # the new planes normalize to 0 with the statistics the kernel gets
    assert torch.equal(mp.reshape(b, cp)[:, :c], mean.reshape(b, c))
    assert torch.equal(rp.reshape(b, cp)[:, :c], rstd.reshape(b, c))
    assert (mp.reshape(b, cp)[:, c:] == 0).all()
    assert (rp.reshape(b, cp)[:, c:] == 1).all()
    lw = port.stage2_bwd_launch(b, cp, hp, int(np.prod(spatial)), 4)
    got = port.jlc_stage2_bwd_split_plain(
        xp, w1p[..., None, None, None], b1p, w2p[..., None, None, None], gp,
        lw)
    dx, dw1, db1, dw2, db2 = got
    for pad in (dx[:, c:], dw1[hid:], dw1[:, c:], db1[hid:], dw2[c:],
                dw2[:, hid:], db2[c:]):
        assert not pad.any()
    refs = port.jlc_stage2_bwd_plain(x, w1[..., None, None, None], b1,
                                     w2[..., None, None, None], g)
    cut = (dx[:, :c], dw1[:hid, :c], db1[:hid], dw2[:c, :hid], db2[:c])
    for a, r in zip(cut, refs):
        # fp32 both ways; sums in other orders
        torch.testing.assert_close(a.reshape(r.shape), r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("c,hid", [(208, 416), (256, 512)])
def test_stage2_bwd_launch_refuses_stages_too_wide_for_a_block(c, hid):
    # the two stage buffers of x and g alone outgrow a block past C = 200
    with pytest.raises(ValueError, match="no hidden slice"):
        port.stage2_bwd_launch(2, c, hid, 1000, 132)
    port.stage2_bwd_launch(2, 200, 2 * 200, 1000, 132)


# (B, C, E·C, voxels) of every main path's K5f levels: the AutoPET-II
# forward (4 tiles of 96³), its train step at conv_drop 0 (B = 2), the 128³
# flagship step (B = 16)
FWD_STAGE2_LEVELS = [(b, 16 * 2 ** i, e * 16 * 2 ** i, (s0 // 2 ** i) ** 3)
                     for b, s0 in ((4, 24), (2, 24), (16, 32))
                     for i, e in enumerate((3, 3, 2, 2))]


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("b,c,hid,s", FWD_STAGE2_LEVELS + [
    (2, 16, 48, 105), (3, 8, 24, 27), (2, 200, 400, 64)])
def test_stage2_fwd_launch_covers_every_voxel_and_unit_once(b, c, hid, s,
                                                            sms):
    lw = port.stage2_fwd_launch(b, c, hid, s, sms)
    # tiles of a power of two from 32 to 256 voxels (dividing the 256
    # threads), C·vt at most 4096 floats unless vt is at its floor
    assert lw.vt in (32, 64, 128, 256)
    assert c * lw.vt <= 4096 or lw.vt == 32
    assert lw.hs % 4 == 0 and lw.hs * lw.slices == hid
    # shared memory (floats): W1ᵀ and W2ᵀ slices, b1, b2, two stage
    # buffers of ẑ, the hidden tile (csrc/jlc_stage2.cu)
    floats = 2 * lw.hs * c + lw.hs + c + (2 * c + lw.hs) * (lw.vt + 4)
    assert floats * 4 <= 232448
    if c == 128:
        assert lw.slices >= 2          # W1 + W2 (256 KB) exceed a block
    # the chunks split the tiles in order, none of them empty
    ranges = lw.tile_ranges()
    assert [t for lo, hi in ranges for t in range(lo, hi)] \
        == list(range(lw.tiles))
    assert all(hi > lo for lo, hi in ranges)
    # grid (chunk, slice): every (b, voxel, hidden row) in exactly one
    # block; tile t holds flattened voxels [t·vt, (t + 1)·vt), voxel u
    # being sample u // S, voxel u % S
    seen = np.zeros((b * s, hid), np.int8)
    for lo, hi in ranges:
        for e0, e1 in lw.slice_rows():
            for t in range(lo, hi):
                assert t * lw.vt < b * s
                seen[t * lw.vt:(t + 1) * lw.vt, e0:e1] += 1
    assert (seen == 1).all()


def _jax_jlc_forward(blk, c, groups, expansion, x):
    sd = {f"encoder.encoder_conv.layer1.0.{k}": v
          for k, v in blk.state_dict().items()}
    params = convert_state_dict(sd)["encoder"]["conv_layer1"]["JLC_0"]
    jblk = JaxJLC(kernel_sizes=(1, 3, 5), groups=groups,
                  expansion_factor=expansion)
    return np.asarray(jax.jit(lambda p, v: jblk.apply({"params": p}, v,
                                                      True))(
        params, jnp.asarray(x)))


# widths K5f runs padded (C 12 → 16, 20 → 24 in two hidden slices, 6 → 8
# with E·C 18 → 20) and a multiple of 8; odd volumes, so tiles span
# samples
@pytest.mark.parametrize("c,groups,e,spatial,sms", [
    (12, 3, 3, (3, 5, 7), 132), (20, 5, 2, (5, 5, 3), 132),
    (6, 2, 3, (3, 4, 5), 132), (16, 4, 3, (5, 7, 9), 1)])
def test_stage2_split_form_with_padding_matches_jax_jlc_module(
        c, groups, e, spatial, sms):
    blk = randomize_(JLC(c, (1, 3, 5), groups, e), seed=c, scale=0.3)
    x = normal((2, *spatial, c), seed=6)
    convs = blk._convs()
    expand, project = blk.channel_conv[1], blk.channel_conv[3]
    hid = e * c
    with torch.no_grad():
        out1 = port.jlc_stage1_plain(cf(x).contiguous(),
                                     [m.weight for m in convs],
                                     [m.bias for m in convs], groups)
        ins = port.pad_stage2_fwd(out1, expand.weight.reshape(hid, c),
                                  expand.bias, project.weight.reshape(c, hid),
                                  project.bias)
        cp, hp = port.stage2_widths(c, hid)
        assert ins[0].shape == (2, cp) + spatial and ins[1].shape == (hp, cp)
        lw = port.stage2_fwd_launch(2, cp, hp, int(np.prod(spatial)), sms)
        got = port.jlc_stage2_split_plain(
            ins[0], ins[1][..., None, None, None], ins[2],
            ins[3][..., None, None, None], ins[4], lw)
    # the padded output planes stay 0; the real ones are the JAX module's
    assert not got[:, c:].any()
    ref = _jax_jlc_forward(blk, c, groups, e, x)
    # fp32; sums in other orders (per slice and tile)
    np.testing.assert_allclose(cl(got[:, :c]), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


# K5f's bf16 form on the tensor cores (csrc/jlc_stage2_mma.cu): its launch
# geometry at every JLC level of the published configs (AutoPET-II,
# Hecktor, BraTS) at B = 2, 4 and 16, under its chosen and every forced
# split of the hidden rows: every voxel and hidden row taken once, the
# shared memory within a block's 232,448 bytes
MMA_SMS = 132


def _takes_once(ranges, n):
    """Whether ``[lo, hi)`` ranges, in order, take 0..n-1 once each."""
    return [i for lo, hi in ranges for i in range(lo, hi)] == list(range(n))


def _jlc_levels():
    """(dataset, level, C, E, S) of every JLC level of the published
    configs: C = base_ch·2^i, S the level's voxels."""
    out = []
    for ds in ("autopetii", "hecktor2022", "brats2021"):
        with open(os.path.join(ROOT, "config",
                               f"models_config_{ds}.json")) as f:
            cfg = json.load(f)["VeloxSeg"]
        size = [s // cfg["patch_size"] for s in cfg["input_size"]]
        for i, e in enumerate(cfg["conv_expansion_factor"]):
            out.append((ds, i, cfg["base_ch"] * 2 ** i, e,
                        int(np.prod([s // 2 ** i for s in size]))))
    return out


MMA_STAGE2 = [(b, *lv) for b in (2, 4, 16) for lv in _jlc_levels()]


@pytest.mark.parametrize("b,ds,level,c,e,s", MMA_STAGE2)
def test_stage2_mma_launch_takes_every_voxel_and_hidden_row(b, ds, level, c,
                                                            e, s):
    cp, hp = port.stage2_mma_widths(c, e * c)
    assert (cp, hp) == (c, e * c)
    for hsplit in (0, 1, 2, 4):
        if hsplit and hp % (16 * hsplit):
            continue
        try:
            lw = port.stage2_mma_launch(b, cp, hp, s, MMA_SMS, hsplit)
        except ValueError:  # a forced split whose partials do not fit
            assert hsplit > 1
            continue
        assert lw.smem_bytes <= 232448
        assert lw.smem_bytes == port._k5f_mma_smem_bytes(
            cp, hp, lw.vt, lw.hsplit)
        assert lw.tiles * lw.vt >= b * s > (lw.tiles - 1) * lw.vt
        assert _takes_once(lw.tile_ranges(), lw.tiles)
        assert all(lo < hi for lo, hi in lw.tile_ranges())
        work = lw.warp_work(hp)
        voxels = sorted({v for v, _ in work})
        assert _takes_once(voxels, lw.vt)
        for slot in voxels:  # each slot's warps split the hidden rows
            assert _takes_once(sorted(h for v, h in work if v == slot), hp)
        assert all((h1 - h0) % 16 == 0 for _, (h0, h1) in work)


def test_stage2_mma_widths_pad_to_the_built_channels():
    assert port.stage2_mma_widths(12, 36) == (16, 48)
    assert port.stage2_mma_widths(6, 18) == (16, 32)
    assert port.stage2_mma_widths(100, 200) == (128, 208)
    with pytest.raises(ValueError, match="C up to 128"):
        port.stage2_mma_widths(144, 288)


@pytest.mark.parametrize("c,e,hsplit", [(16, 3, 1), (32, 3, 2), (64, 2, 4),
                                        (128, 2, 4), (12, 3, 1)])
def test_stage2_mma_split_matches_the_plain_version(c, e, hsplit):
    """K5f's bf16 form adds its hidden parts' fp32 products before b2 and
    rounds where the plain version rounds (:func:`jlc_stage2_mma_plain`
    against :func:`jlc_stage2_plain`), at padded widths too."""
    b, shape = 2, (3, 4, 5)
    hid = e * c
    bf = torch.bfloat16
    x = torch.from_numpy(normal((b, c) + shape, 41, 1.5)).to(bf)
    w1 = torch.from_numpy(normal((hid, c, 1, 1, 1), 42, (2.0 / c) ** 0.5)
                          ).to(bf)
    b1 = torch.from_numpy(normal((hid,), 43, 0.1)).to(bf)
    w2 = torch.from_numpy(normal((c, hid, 1, 1, 1), 44, (2.0 / hid) ** 0.5)
                          ).to(bf)
    b2 = torch.from_numpy(normal((c,), 45, 0.1)).to(bf)
    ref = port.jlc_stage2_plain(x, w1, b1, w2, b2)
    ins = port.pad_stage2_fwd(x, w1.reshape(hid, c), b1, w2.reshape(c, hid),
                              b2, widths=port.stage2_mma_widths)
    got = port.jlc_stage2_mma_plain(*ins, hsplit)[:, :c]
    assert_bf16_match(got, ref, f"K5f split C={c} hsplit={hsplit}")
