"""bench.py's flagship VeloxSeg (power-of-two windows, 1024-token windows at
level 1 of 128³) in the port against ``veloxseg_tpu`` on the CPU: the
config builder, the window layouts and the attention dispatch they give,
the window gather/scatter and relative position bias at (4,4,4) and
(8,8,8), and one train step (loss, every gradient, the parameters after
one AdamW step against optax) of a narrow model with the flagship's window
layout at every level: input 64³ with patch 2 gives the 128³ flagship's
32³ level-0 grid, so the same L (128, 1024, 128, 128) and window counts
(585, 9, 9, 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
from torch_port_helpers import cf, cl, configs, normal, randomize_
from veloxseg_torch.core.config import flagship_config
from veloxseg_torch.core.windows import compute_window_layout
from veloxseg_torch.interop.jax_params import state_dict_from_jax
from veloxseg_torch.nn import pwa as port_pwa
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.ops.pwa_attention import (LONG_KERNEL_WIDTHS,
                                            uses_long_kernel)
from veloxseg_torch.train import loss as tloss
from veloxseg_torch.train import optim as toptim
from veloxseg_torch.train.train_state import (create_train_state,
                                              train_step_fn)
from veloxseg_tpu.core.windows import \
    compute_window_layout as jax_compute_window_layout
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn import pwa as jpwa
from veloxseg_tpu.nn.veloxseg import VeloxSeg as JaxVeloxSeg
from veloxseg_tpu.train import loss as jloss
from veloxseg_tpu.train import optim as joptim

WINDOWS = ((4, 4, 4), (8, 8, 8), (4, 4, 4), (4, 4, 4))
# bench.py:146-151's loss weights and optimizer
TRAIN_CFG = {"deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
             "Feature_Loss_weight": 2.0}
OPT = {"lr": 2.5e-4, "weight_decay": 0.01}


def _levels(cfg):
    """(L, N, heads, Cqk, Cv) per level of a config."""
    size = [s // cfg.patch_size for s in cfg.input_size]
    out = []
    for i in range(cfg.num_levels):
        lay = compute_window_layout(
            size, cfg.min_big_window_sizes[i], cfg.min_small_window_sizes[i],
            cfg.scale_factors[i], cfg.num_heads[i], cfg.min_dim_head[i],
            cfg.attn_base_ch * 2 ** i)
        out.append((cfg.num_modalities * lay.tokens_per_window,
                    lay.num_windows, lay.num_heads, lay.dim_qk, lay.dim_v))
        size = [s // 2 for s in size]
    return out


@pytest.mark.parametrize("size", [(128, 128, 128), (96, 96, 96)])
def test_flagship_config_matches_bench(size):
    _, jcfg = bench._flagship(size)
    assert flagship_config(size).to_dict() == dataclasses.asdict(jcfg)


def test_flagship_windows_and_dispatch():
    cfg = flagship_config()
    assert cfg.min_big_window_sizes == WINDOWS
    levels = _levels(cfg)
    assert levels == [(128, 585, 1, 4, 4), (1024, 9, 2, 8, 8),
                      (128, 9, 2, 8, 16), (128, 1, 4, 16, 32)]
    # K3 at level 1 only: one K3f and one K3b per train step
    assert [uses_long_kernel(l) for l, *_ in levels] == \
        [False, True, False, False]
    assert levels[1][3:] in LONG_KERNEL_WIDTHS


@pytest.mark.parametrize("spatial,big", [((16, 16, 16), (8, 8, 8)),
                                         ((16, 16, 16), (4, 4, 4))])
def test_power_of_two_windows_match_jax(spatial, big):
    c, heads = 4, 2
    layout = compute_window_layout(spatial, big, (1, 1, 1), 2, heads, c, c)
    jlayout = jax_compute_window_layout(spatial, big, (1, 1, 1), 2, heads,
                                        c, c)
    assert dataclasses.asdict(layout) == dataclasses.asdict(jlayout)
    x = normal((1, *spatial, layout.num_pairs * heads * c), seed=0)
    tok = port_pwa.window_gather(cf(x), layout, c)
    jtok = np.asarray(jpwa.window_gather(jnp.asarray(x), jlayout, c))
    np.testing.assert_array_equal(tok.numpy(), jtok)
    vox = port_pwa.window_scatter(tok, layout, c, spatial)
    np.testing.assert_array_equal(cl(vox), np.asarray(jpwa.window_scatter(
        jnp.asarray(jtok), jlayout, c, spatial)))

    rpb = randomize_(port_pwa.RelativePositionBias(big, heads), seed=1)
    table = rpb.relative_position_bias_table.detach().numpy()
    assert table.shape == (int(np.prod([2 * t - 1 for t in big])), heads)
    ref = jpwa.RelativePositionBias(window=big, num_heads=heads).apply(
        {"params": {"table": jnp.asarray(table)}})
    with torch.no_grad():
        np.testing.assert_array_equal(rpb().numpy(), np.asarray(ref))


SMALL = dict(input_size=(64, 64, 64), patch_size=2, in_ch=(1, 1),
             n_classes=2, base_ch=8, attn_base_ch=8, depths=(1, 1, 1, 1),
             min_big_window_sizes=WINDOWS, attn_drop=0.0, proj_drop=0.0,
             conv_drop=0.0, drop_path=0.0)


def test_small_config_has_the_flagship_window_layout():
    tcfg, _ = configs(SMALL)
    assert [lv[:3] for lv in _levels(tcfg)] == \
        [lv[:3] for lv in _levels(flagship_config())]


def test_flagship_windows_train_step_matches_jax():
    tcfg, jcfg = configs(SMALL)
    model, _ = build_veloxseg(tcfg, device="cpu")
    randomize_(model, 1, scale=0.2)
    params = jax.tree_util.tree_map(jnp.array,
                                    convert_state_dict(model.state_dict()))
    # every key maps back, the (15³, 2) position tables of level 1 too
    assert set(state_dict_from_jax(jax.device_get(params))) == \
        set(model.state_dict())
    x = normal((1, 64, 64, 64, 2), seed=2)
    y = (np.random.default_rng(3).random((1, 64, 64, 64)) < 0.3
         ).astype(np.int32)
    jl = jloss.CompositeLoss("VeloxSeg", TRAIN_CFG)

    def loss_fn(p):
        outs = JaxVeloxSeg(jcfg).apply({"params": p}, jnp.asarray(x),
                                       train=True)
        return jl(outs, jnp.asarray(y), sr_labels=jnp.asarray(x))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = joptim.build_optimizer("adamw", OPT)
    updates, _ = tx.update(grads, tx.init(params), params)
    after = state_dict_from_jax(jax.device_get(
        optax.apply_updates(params, updates)))
    grads = state_dict_from_jax(jax.device_get(grads))

    state = create_train_state(model, toptim.build_optimizer(
        "adamw", OPT, model.parameters()))
    step = train_step_fn(tloss.CompositeLoss(TRAIN_CFG, tcfg), device="cpu")
    state, aux = step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                      None)
    # the tolerances of tests/test_torch_train_step.py
    assert float(aux["loss"]) == pytest.approx(float(loss), rel=1e-5)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(grads)
    g_all = max(float(v.abs().max()) for v in grads.values())
    tol = {k: 1e-4 * float(r.abs().max()) + 1e-5 * g_all
           for k, r in grads.items()}
    for k, r in grads.items():
        assert float((got[k] - r).abs().max()) <= tol[k], k
    # Adam's first step moves each element by about lr·sign(g): the two
    # sides agree to a fraction of lr where |g| is well above the
    # gradient's tolerance, and within the step's size, 2·lr, elsewhere
    lr = OPT["lr"]
    for k, r in after.items():
        err = (model.state_dict()[k] - r).abs()
        clear = grads[k].abs() > 10 * tol[k]
        assert float(torch.where(clear, err, 0.0).max()) <= 0.25 * lr, k
        assert float(err.max()) <= 2.0 * lr * 1.1, k
