"""The port's layers against their JAX modules, with the port's weights
carried across by ``convert_state_dict`` (each port module's state dict is
given the key prefix it has inside the full model, so the key map is
tested too). Channels-first in the port, channels-last in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cf, cl, normal, randomize_
from veloxseg_torch.nn import basic, conv_blocks, norms, patch, pwa
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn import basic as jbasic
from veloxseg_tpu.nn import conv_blocks as jconv
from veloxseg_tpu.nn import norms as jnorms
from veloxseg_tpu.nn import patch as jpatch
from veloxseg_tpu.nn import pwa as jpwa

# fp32 on both sides; only the summation order differs
TOL = dict(rtol=1e-4, atol=1e-4)


def _params(module, prefix, *path):
    sd = {prefix + k: v for k, v in module.state_dict().items()}
    node = convert_state_dict(sd)
    for p in path:
        node = node[p]
    return node


def _apply(jmodule, params, *args):
    return jax.jit(lambda p, *a: jmodule.apply({"params": p}, *a))(
        params, *args)


def _run(module, x):
    with torch.no_grad():
        return module.eval()(x)


def test_layer_norm_and_instance_norm():
    x = normal((2, 5, 6, 7, 12), seed=0, scale=3.0) + 1.5
    ln = randomize_(norms.LayerNorm(12), seed=1)
    ref = jnorms.LayerNorm().apply(
        {"params": {"scale": jnp.asarray(ln.weight.detach()),
                    "bias": jnp.asarray(ln.bias.detach())}}, jnp.asarray(x))
    np.testing.assert_allclose(cl(_run(ln, cf(x))), np.asarray(ref), **TOL)
    ref = jnorms.InstanceNorm().apply({}, jnp.asarray(x))
    np.testing.assert_allclose(cl(norms.instance_norm(cf(x))),
                               np.asarray(ref), **TOL)


@pytest.mark.parametrize("k,groups", [(1, 4), (3, 4), (5, 2)])
def test_grouped_conv3d(k, groups):
    x = normal((1, 6, 6, 6, 16), seed=2)
    conv = randomize_(basic.GroupedConv3d(16, 16, k, groups=groups), seed=3)
    jconv3 = jbasic.GroupedConv3d(features=16, kernel_size=(k, k, k),
                                  padding=[(k // 2, k // 2)] * 3,
                                  groups=groups)
    ref = _apply(jconv3, {"kernel": jnp.asarray(np.transpose(
        conv.weight.detach().numpy(), (2, 3, 4, 1, 0))),
        "bias": jnp.asarray(conv.bias.detach())}, jnp.asarray(x))
    np.testing.assert_allclose(cl(_run(conv, cf(x))), np.asarray(ref), **TOL)


@pytest.mark.parametrize("patch_size,cin", [(4, 2), (2, 16)])
def test_down_conv(patch_size, cin):
    x = normal((2, 16, 16, 8, cin), seed=4)
    m = randomize_(conv_blocks.DownConv(cin, 16, patch_size), seed=5)
    params = _params(m, "encoder.encoder_conv.down1.", "encoder",
                     "conv_down1")
    ref = _apply(jconv.DownConv(16, patch_size=patch_size), params,
                 jnp.asarray(x))
    np.testing.assert_allclose(cl(_run(m, cf(x))), np.asarray(ref), **TOL)


def test_up_conv():
    x = normal((2, 4, 4, 2, 32), seed=6)
    m = randomize_(conv_blocks.UpConv(32, 16), seed=7)
    params = _params(m, "decoder.layer_up1.", "decoder", "up1")
    ref = _apply(jconv.UpConv(16), params, jnp.asarray(x))
    np.testing.assert_allclose(cl(_run(m, cf(x))), np.asarray(ref), **TOL)


@pytest.mark.parametrize("use_norm", [False, True])
def test_patch_embed(use_norm):
    x = normal((2, 16, 16, 8, 1), seed=8)
    m = randomize_(patch.PatchEmbed(1, 8, 4, use_norm), seed=9)
    params = _params(m, "encoder.encoder_attn.patch_embeds.0.", "encoder",
                     "encoder_attn", "patch_embed_0")
    ref = _apply(jpatch.PatchEmbed(8, 4, use_norm=use_norm), params,
                 jnp.asarray(x))
    np.testing.assert_allclose(cl(_run(m, cf(x))), np.asarray(ref), **TOL)


def test_patch_merging():
    x = normal((2, 8, 8, 4, 8), seed=10)
    m = randomize_(patch.PatchMerging(8), seed=11)
    params = _params(m, "encoder.encoder_attn.layers.0.downs.0.", "encoder",
                     "encoder_attn", "stage_0", "down_0")
    ref = _apply(jpatch.PatchMerging(), params, jnp.asarray(x))
    np.testing.assert_allclose(cl(_run(m, cf(x))), np.asarray(ref), **TOL)


# (input size, big window, small window, heads, dim_head): AutoPET-like
# cubic windows, Hecktor's anisotropic ones, and pooled small windows
PWA_CASES = [((6, 6, 6), (3, 3, 3), (1, 1, 1), 2, 4),
             ((8, 8, 4), (4, 4, 2), (1, 1, 1), 1, 4),
             ((8, 8, 4), (4, 4, 2), (2, 2, 1), 2, 4)]


def _pwa_kwargs(size, big, small, heads, dim_head):
    return dict(input_size=size, in_channels=(8, 8), min_big_window=big,
                min_small_window=small, scale_factor=2, num_heads=heads,
                min_dim_head=dim_head)


@pytest.mark.parametrize("size,big,small,heads,dim_head", PWA_CASES)
def test_multimodal_pwa(size, big, small, heads, dim_head):
    kw = _pwa_kwargs(size, big, small, heads, dim_head)
    xs = [normal((2, *size, 8), seed=12 + m) for m in range(2)]
    m = randomize_(pwa.MultiModalPWA(**kw), seed=14, scale=0.5)
    got = _run(m, [cf(x) for x in xs])
    params = _params(m, "encoder.encoder_attn.layers.0.blocks.0.attn.",
                     "encoder", "encoder_attn", "stage_0", "block_0", "attn")
    ref = jax.jit(lambda p, a, b: jpwa.MultiModalPWA(**kw).apply(
        {"params": p}, [a, b], True))(params, *map(jnp.asarray, xs))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(cl(g), np.asarray(r), **TOL)


def test_pwa_block_and_bypass():
    kw = _pwa_kwargs(*PWA_CASES[1])
    xs = [normal((2, 8, 8, 4, 8), seed=15 + m) for m in range(2)]
    m = randomize_(pwa.PWABlock(**kw, ffn_expansion_ratio=3), seed=17,
                   scale=0.5)
    got = _run(m, [cf(x) for x in xs])
    params = _params(m, "encoder.encoder_attn.layers.0.blocks.0.",
                     "encoder", "encoder_attn", "stage_0", "block_0")
    ref = jax.jit(lambda p, a, b: jpwa.PWABlock(
        **kw, ffn_expansion_ratio=3).apply({"params": p}, [a, b], True))(
        params, *map(jnp.asarray, xs))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(cl(g), np.asarray(r), **TOL)
    bypass = pwa.MultiModalPWA(**dict(kw, num_heads=0))
    assert not list(bypass.parameters())
    ts = [cf(x) for x in xs]
    assert all(o is t for o, t in zip(_run(bypass, ts), ts))
