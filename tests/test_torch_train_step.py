"""The port's training step against ``veloxseg_tpu`` on the CPU: the train
output contract, the composite loss, every parameter's gradient (JAX
``value_and_grad``, mapped to port keys by ``state_dict_from_jax``), and
the parameters after 1 and 3 AdamW steps against optax. TINY config with
every dropout rate at 0, same weights, same batch. Also: dropout is
reproducible from the generator's seed, and the loss, optimizer and
scheduler pieces match their JAX counterparts."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import TINY, configs, normal, randomize_
from veloxseg_torch.core.config import VeloxSegConfig
from veloxseg_torch.interop.jax_params import state_dict_from_jax
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.train import loss as tloss
from veloxseg_torch.train import optim as toptim
from veloxseg_torch.train.train_state import (create_train_state,
                                              train_step_fn)
from veloxseg_torch.utils import runtime as truntime
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn.veloxseg import VeloxSeg as JaxVeloxSeg
from veloxseg_tpu.train import loss as jloss
from veloxseg_tpu.train import optim as joptim
from veloxseg_tpu.utils import runtime as jruntime

# config/train_config_bs4.json's loss weights and optimizer
TRAIN_CFG = {"deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
             "Feature_Loss_weight": 2.0}
OPT = {"lr": 2.5e-4, "weight_decay": 0.01}
NO_DROP = dict(TINY, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
               drop_path=0.0)


def _batch(seed=2):
    x = normal((2, 32, 32, 32, 2), seed)
    y = (np.random.default_rng(seed + 1).random((2, 32, 32, 32))
         < 0.3).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def run():
    """Three steps on each side from the same weights and batch, with the
    port's gradients of step 1 and both sides' parameters after steps 1
    and 3."""
    tcfg, jcfg = configs(NO_DROP)
    model, _ = build_veloxseg(tcfg, device="cpu")
    randomize_(model, 1, scale=0.2)
    # copies: convert_state_dict's arrays may share the torch tensors'
    # memory, which the port's optimizer updates in place
    params = jax.tree_util.tree_map(jnp.array,
                                    convert_state_dict(model.state_dict()))
    x, y = _batch()
    jl = jloss.CompositeLoss("VeloxSeg", TRAIN_CFG)

    def loss_fn(p):
        outs = JaxVeloxSeg(jcfg).apply({"params": p}, jnp.asarray(x),
                                       train=True)
        return jl(outs, jnp.asarray(y), sr_labels=jnp.asarray(x)), outs

    # one jitted value_and_grad serves every step of this file
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = joptim.build_optimizer("adamw", OPT)
    opt_state = tx.init(params)
    jax_steps, p = [], params
    for _ in range(3):
        (loss, outs), grads = vg(p)
        if not jax_steps:
            first = (float(loss), jax.device_get(outs),
                     jax.device_get(grads))
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        jax_steps.append(state_dict_from_jax(jax.device_get(p)))

    with torch.no_grad():
        outs_port = model.train()(torch.from_numpy(x), None)
    state = create_train_state(model, toptim.build_optimizer(
        "adamw", OPT, model.parameters()))
    step = train_step_fn(tloss.CompositeLoss(
        "VeloxSeg", TRAIN_CFG, num_modal=tcfg.num_modalities), device="cpu")
    port_steps, losses = [], []
    for i in range(3):
        state, aux = step(state, torch.from_numpy(x),
                          torch.from_numpy(y).long(), None)
        losses.append(float(aux["loss"]))
        if i == 0:
            grads_port = {k: p.grad.clone()
                          for k, p in model.named_parameters()}
        port_steps.append({k: v.clone() for k, v in
                           model.state_dict().items()})
    return dict(jax_loss=first[0], jax_outs=first[1],
                jax_grads=state_dict_from_jax(first[2]),
                port_outs=outs_port, port_losses=losses,
                port_grads=grads_port, jax_steps=jax_steps,
                port_steps=port_steps, state=state)


def test_train_output_contract(run):
    outs, ref = run["port_outs"], run["jax_outs"]
    b, s, c = 2, (32, 32, 32), 2
    want = [(b, *s, c)] * 4 + [(b, *s, 2), (b, 8, 8), (b, 8, 8), (b, 8, 8)]
    assert [tuple(o.shape) for o in outs] == want
    assert [tuple(np.shape(r)) for r in ref] == want
    for o, r in zip(outs, ref):
        r = np.asarray(r)
        # fp32 through ~60 layers, sums taken in other orders
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(r).max()))


def test_composite_loss_matches_jax(run):
    # the whole step's loss, then the loss function alone on JAX's outputs
    assert run["port_losses"][0] == pytest.approx(run["jax_loss"], rel=1e-5)
    x, y = _batch()
    outs = [torch.from_numpy(np.array(o)) for o in run["jax_outs"]]
    got = tloss.CompositeLoss(
        "VeloxSeg", TRAIN_CFG,
        num_modal=VeloxSegConfig(**TINY).num_modalities)(
        outs, torch.from_numpy(y).long(), sr_labels=torch.from_numpy(x))
    ref = jloss.CompositeLoss("VeloxSeg", TRAIN_CFG)(
        [jnp.asarray(o) for o in run["jax_outs"]], jnp.asarray(y),
        sr_labels=jnp.asarray(x))
    # sums over 2·32³ voxels in fp32, taken in other orders
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


def test_every_gradient_matches_jax(run):
    got, ref = run["port_grads"], run["jax_grads"]
    assert set(got) == set(ref)
    g_all = max(float(v.abs().max()) for v in ref.values())
    for k, r in ref.items():
        err = float((got[k] - r).abs().max())
        # 1e-4 of the gradient's own max; plus a floor of 1e-5 of the
        # model's largest gradient for the gradients that are 0 in exact
        # arithmetic (biases in front of an InstanceNorm, the TINY deepest
        # level's single voxel), where both sides hold rounding noise
        assert err <= 1e-4 * float(r.abs().max()) + 1e-5 * g_all, k


@pytest.mark.parametrize("k", [1, 3])
def test_params_after_adamw_steps_match_optax(run, k):
    got, ref = run["port_steps"][k - 1], run["jax_steps"][k - 1]
    assert set(got) == set(ref)
    g_all = max(float(v.abs().max()) for v in run["jax_grads"].values())
    lr = OPT["lr"]
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        if float(run["jax_grads"][name].abs().max()) <= 1e-5 * g_all:
            # a gradient of pure rounding noise: Adam scales ~1e-9 of
            # noise up to a step of up to lr, of either sign on each side
            # (the envelope of tests/test_train_step.py)
            assert err <= 2.0 * k * lr * 1.1, name
        else:
            # a real gradient: elements whose gradient is near 0 can
            # still move apart by a fraction of lr
            assert err <= 0.25 * lr, name
    assert run["state"].step == 3


def _dropout_loss(seed):
    cfg = VeloxSegConfig(**dict(TINY, conv_drop=0.1, drop_path=0.1))
    model, _ = build_veloxseg(cfg, device="cpu", seed=0)
    x, y = _batch(5)
    state = create_train_state(model, toptim.build_optimizer(
        "adamw", OPT, model.parameters()))
    step = train_step_fn(tloss.CompositeLoss(
        "VeloxSeg", TRAIN_CFG, num_modal=cfg.num_modalities), device="cpu")
    gen = torch.Generator().manual_seed(seed)
    _, aux = step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                  gen)
    return float(aux["loss"])


def test_dropout_reproducible_from_the_generator_seed():
    a, b, c = _dropout_loss(7), _dropout_loss(7), _dropout_loss(8)
    assert a == b
    assert a != c


def test_fused_ce_dice_loss_matches_jax():
    logits = normal((2, 6, 5, 4, 3), seed=9, scale=2.0)
    labels = np.random.default_rng(10).integers(0, 3, (2, 6, 5, 4))
    got = tloss.fused_ce_dice_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    ref = jloss.fused_ce_dice_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == pytest.approx(float(ref), rel=1e-6)


def test_runtime_layout_and_weights_match_jax():
    for n, m in [(8, 2), (7, 4), (4, 1)]:
        assert truntime.veloxseg_output_layout(n, m) == \
            jruntime.veloxseg_output_layout(n, m)
    for w, n in [([1, 1, 1, 1], 4), ([1, 1, 1, 1], 2), ([4, 2, 1, 1], 4)]:
        assert truntime.normalized_deep_loss_weights(w, n) == \
            jruntime.normalized_deep_loss_weights(w, n)
    with pytest.raises(ValueError):
        truntime.normalized_deep_loss_weights([4, 2, 1], 4)


@pytest.mark.parametrize("kind,args", [
    ("adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    ("sgd", {"lr": 1e-2, "weight_decay": 0.1, "momentum": 0.9})])
def test_optimizers_match_optax(kind, args):
    w0 = normal((5, 4), seed=11)
    grads = [normal((5, 4), seed=12 + i) for i in range(3)]
    tx = joptim.build_optimizer(kind, args)
    p = jnp.asarray(w0)
    st = tx.init(p)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = toptim.build_optimizer(kind, args, [w])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        w.grad = torch.from_numpy(g)
        opt.step()
    # fp32; optax and torch order the sqrt, divide and decay differently
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p),
                               rtol=1e-5, atol=1e-6)


def test_epoch_scheduler_matches_jax():
    cfg = {"epochs": 300, "optimizer": {"optimizer_args": {"lr": 2.5e-4}},
           "warmup_scheduler": {"enabled": True, "warmup_epochs": 10},
           "train_scheduler": {"scheduler_type": "cosine_annealing",
                               "scheduler_args": {"epochs": 290,
                                                  "min_lr": 6e-6}}}
    got, ref = toptim.EpochScheduler(cfg), joptim.EpochScheduler(cfg)
    for e in (0, 5, 9, 10, 150, 299, 400):
        assert got.learning_rate(e) == ref.learning_rate(e)
    w = torch.nn.Parameter(torch.zeros(2))
    opt = toptim.build_optimizer("adamw", {"lr": 1.0}, [w])
    toptim.set_learning_rate(opt, got.learning_rate(3))
    assert opt.param_groups[0]["lr"] == ref.learning_rate(3)
