"""The train-mode decoders and their pieces against ``veloxseg_tpu`` on the
CPU, weights carried across: the student ``SegDecoder`` (deep-supervision
heads and Gram), the teacher ``RCDecoder``, ``gram_matrix`` and
``resize_trilinear``; and the weights' round trip with the teachers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import TINY, cf, cl, normal, randomize_
from veloxseg_torch.core.config import VeloxSegConfig
from veloxseg_torch.nn.decoder import RCDecoder, SegDecoder
from veloxseg_torch.ops.gram import gram_matrix
from veloxseg_torch.ops.resize import resize_trilinear
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn import decoder as jdec
from veloxseg_tpu.ops.gram import gram_matrix as jgram
from veloxseg_tpu.ops.resize import resize_trilinear as jresize

CFG = VeloxSegConfig(**TINY)
# fp32 on both sides; only the summation order differs
TOL = dict(rtol=1e-4, atol=1e-4)


def _levels(widths, seed):
    """Channels-last per-level features of a 32³ TINY input, finest
    first (8³, 4³, 2³, 1³)."""
    return [normal((2, 8 >> i, 8 >> i, 8 >> i, c), seed + i)
            for i, c in enumerate(widths)]


def _params(module, prefix, *path):
    node = convert_state_dict({prefix + k: v
                               for k, v in module.state_dict().items()})
    for p in path:
        node = node[p]
    return node


def _jax_kwargs():
    c = CFG
    return dict(patch_size=c.patch_size, depths=c.conv_depths,
                kernel_sizes=c.kernel_sizes, min_dim_group=c.min_dim_group,
                expansion_factor=c.conv_expansion_factor)


def test_seg_decoder_train_outputs_match_jax():
    dec = randomize_(SegDecoder(CFG), seed=1, scale=0.3).train()
    encs = _levels([CFG.base_ch * 2 ** i for i in range(4)], seed=2)
    with torch.no_grad():
        preds, gram = dec([cf(e) for e in encs])
    jd = jdec.SegDecoder(base_ch=CFG.base_ch, out_ch=CFG.n_classes,
                         deep_supervision=True, **_jax_kwargs())
    rpreds, rgram = jax.jit(lambda p, e: jd.apply({"params": p}, e, False))(
        _params(dec, "decoder.", "decoder"), [jnp.asarray(e) for e in encs])
    assert len(preds) == len(rpreds) == 4
    for got, ref in zip(preds, rpreds):
        assert cl(got).shape == ref.shape
        np.testing.assert_allclose(cl(got), np.asarray(ref), **TOL)
    np.testing.assert_allclose(gram.numpy(), np.asarray(rgram), **TOL)
    # eval: the finest head's logits alone
    with torch.no_grad():
        np.testing.assert_allclose(cl(dec.eval()([cf(e) for e in encs])),
                                   np.asarray(rpreds[0]), **TOL)


@pytest.mark.parametrize("in_channel", [1, 4])
def test_rc_decoder_matches_jax(in_channel):
    dec = randomize_(RCDecoder(CFG, in_channel), seed=3, scale=0.3).train()
    widths = [(CFG.attn_base_ch + CFG.base_ch) * 2 ** i for i in range(4)]
    ins = _levels(widths, seed=4)
    with torch.no_grad():
        rec, gram = dec([cf(e) for e in ins])
    jd = jdec.RCDecoder(in_channel=in_channel, dec_channel=CFG.base_ch,
                        **_jax_kwargs())
    rrec, rgram = jax.jit(lambda p, e: jd.apply({"params": p}, e, False))(
        _params(dec, "rc_decoders.0.", "rc_decoder_0"),
        [jnp.asarray(e) for e in ins])
    assert cl(rec).shape == rrec.shape == (2, 32, 32, 32, in_channel)
    np.testing.assert_allclose(cl(rec), np.asarray(rrec), **TOL)
    np.testing.assert_allclose(gram.numpy(), np.asarray(rgram), **TOL)


def test_gram_matrix_matches_jax():
    x = normal((2, 5, 6, 7, 12), seed=5)
    np.testing.assert_allclose(gram_matrix(cf(x)).numpy(),
                               np.asarray(jgram(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


# the deep-supervision upscales (4³, 2³, 1³ → 32³) and a ragged one
@pytest.mark.parametrize("size,out", [((4, 4, 4), (32, 32, 32)),
                                      ((1, 1, 1), (32, 32, 32)),
                                      ((3, 5, 2), (7, 9, 4))])
def test_resize_trilinear_matches_jax(size, out):
    x = normal((2, *size, 3), seed=6)
    xt = cf(x).requires_grad_()
    got = resize_trilinear(xt, out)
    ref = jresize(jnp.asarray(x), out)
    np.testing.assert_allclose(cl(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    # the backward is autograd's transpose of the same operator
    cot = normal((2, *out, 3), seed=7)
    (g,) = torch.autograd.grad(got, xt, cf(cot))
    _, vjp = jax.vjp(lambda a: jresize(a, out), jnp.asarray(x))
    np.testing.assert_allclose(cl(g), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-5)
