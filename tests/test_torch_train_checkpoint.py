"""The port's training checkpoints (``veloxseg_torch.train.checkpoint``,
``orbax_ckpt``, ``interop.jax_params.optimizer_state_from_jax``) against the
JAX package on the CPU, at the TINY config:

- a ``.pth`` round trip resumes exactly: the next step from the file
  equals the next step of the run that wrote it, bit for bit;
- a JAX ``.ckpt`` written after 2 optax steps (the JAX package's own
  optimizers: adamw through ``optax.flatten``, adam and sgd with momentum
  as params-shaped trees) loads into the port, and one more step on both,
  from the same gradient, gives the same parameters within 1e-3 of a
  learning rate (fp32 rounding of the same arithmetic; a moment placed
  on the wrong parameter moves it by ~lr);
- the port's ``val_best.pth`` read by the JAX ``load_params`` gives the
  JAX forward the port's logits within 1e-5 of their scale (the TINY
  forward's tolerance);
- the async writer's file holds what the synchronous one holds, from the
  state at the time of ``save``;
- the epoch scheduler's state round trip against the JAX class.
About 45 s alone (eager optax updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import TINY_JSON, normal, randomize_
from flax import serialization
from veloxseg_torch.interop.jax_params import (optimizer_state_from_jax,
                                               state_dict_from_jax)
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.train import checkpoint as tck
from veloxseg_torch.train import loss as tloss
from veloxseg_torch.train import optim as toptim
from veloxseg_torch.train import train_state as tts
from veloxseg_torch.train.orbax_ckpt import (AsyncCheckpointWriter,
                                             prune_checkpoint)
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn.veloxseg import VeloxSeg as JaxVeloxSeg
from veloxseg_tpu.core.config import VeloxSegConfig as JaxConfig
from veloxseg_tpu.train import checkpoint as jck
from veloxseg_tpu.train import optim as joptim

TRAIN_CFG = {"deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
             "Feature_Loss_weight": 2.0}
NO_DROP = dict(TINY_JSON, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
               drop_path=0.0)
SCHED_CFG = {"epochs": 20,
             "optimizer": {"optimizer_args": {"lr": 2.5e-4}},
             "warmup_scheduler": {"enabled": True, "warmup_epochs": 2},
             "train_scheduler": {"scheduler_type": "reducelronplateau",
                                 "patience": 1,
                                 "scheduler_args": {"min_lr": 1e-7}}}
OPTIMIZERS = {
    "adamw": {"lr": 2.5e-4, "weight_decay": 0.01},
    "adam": {"lr": 2.5e-4, "weight_decay": 0.01},
    "sgd": {"lr": 2.5e-4, "weight_decay": 0.01, "momentum": 0.9},
}


def _model(seed):
    model, _ = build_veloxseg(NO_DROP, device="cpu")
    return randomize_(model, seed, scale=0.2)


def _state(seed, kind="adamw"):
    model = _model(seed)
    return tts.create_train_state(model, toptim.build_optimizer(
        kind, OPTIMIZERS[kind], model.parameters()))


def _batch(seed):
    x = normal((1, 32, 32, 32, 2), seed)
    return (torch.from_numpy(x),
            torch.from_numpy((x[..., 1] > 0.5).astype(np.int32)))


def test_pth_round_trip_resumes_exactly(tmp_path):
    from veloxseg_torch.core.config import VeloxSegConfig
    loss = tloss.CompositeLoss(
        "VeloxSeg", TRAIN_CFG,
        num_modal=VeloxSegConfig.from_dict(NO_DROP).num_modalities)
    step = tts.train_step_fn(loss, "cpu", with_metrics=False)
    a = _state(1)
    a, _ = step(a, *_batch(2), None)
    path = str(tmp_path / "0.pth")
    sched = {"plateau_scale": 0.1, "best": 0.5, "bad_epochs": 1}
    tck.save_checkpoint(path, a.model, a.optimizer, epoch=0,
                        best_train_dice=0.25, best_val_dice=0.5,
                        scheduler_state=sched)
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"model", "optimizer", "scheduler_state",
                            "epoch", "best_train_dice", "best_val_dice"}
    b = _state(9)                      # other weights, fresh optimizer
    meta = tck.load_checkpoint(path, b.model, b.optimizer)
    assert meta == {"epoch": 0, "best_train_dice": 0.25,
                    "best_val_dice": 0.5, "scheduler_state": sched}
    a, aux_a = step(a, *_batch(3), None)
    b, aux_b = step(b, *_batch(3), None)
    assert float(aux_a["loss"]) == float(aux_b["loss"])
    for (k, pa), pb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(pa, pb), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in sa["state"].items():
        assert float(st["step"]) == float(sb["state"][i]["step"]) == 2.0
        assert torch.equal(st["exp_avg_sq"], sb["state"][i]["exp_avg_sq"])


def test_misplaced_optimizer_state_raises(tmp_path):
    """An optimizer state dict from a model that orders its parameters
    otherwise loads into torch silently; the checkpoint loader refuses
    it."""
    from veloxseg_torch.core.config import VeloxSegConfig
    loss = tloss.CompositeLoss(
        "VeloxSeg", TRAIN_CFG,
        num_modal=VeloxSegConfig.from_dict(NO_DROP).num_modalities)
    a, _ = tts.train_step_fn(loss, "cpu", with_metrics=False)(
        _state(1), *_batch(2), None)
    path = str(tmp_path / "0.pth")
    tck.save_checkpoint(path, a.model, a.optimizer)
    payload = torch.load(path, weights_only=True)
    state = payload["optimizer"]["state"]
    shapes = [tuple(state[i]["exp_avg"].shape) for i in sorted(state)]
    j = next(i for i in range(1, len(shapes)) if shapes[i] != shapes[0])
    state[0], state[j] = state[j], state[0]
    torch.save(payload, path)
    b = _state(3)
    with pytest.raises(ValueError, match="optimizer state"):
        tck.load_checkpoint(path, b.model, b.optimizer)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32) * 0.1), params)


def _reversed(tree):
    """The tree with its keys in reverse order at every level, as a model's
    ``init`` may order them (creation order), unlike ``jax.tree_util``,
    which sorts them."""
    if not isinstance(tree, dict):
        return tree
    return {k: _reversed(tree[k]) for k in reversed(list(tree))}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_jax_ckpt_resumes_optimizer(tmp_path, kind):
    params = jax.tree_util.tree_map(
        jnp.array, convert_state_dict(_model(4).state_dict()))
    tx = joptim.build_optimizer(kind, OPTIMIZERS[kind])
    opt_state = tx.init(params)
    for seed in (10, 11):
        updates, opt_state = tx.update(_grads(params, seed), opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
    path = str(tmp_path / "val_best.ckpt")
    jck.save_checkpoint(path, params, opt_state, epoch=1,
                        best_train_dice=0.3, best_val_dice=0.2,
                        scheduler_state={"plateau_scale": 1.0,
                                         "best": 0.2, "bad_epochs": 0})
    port = _state(5, kind)
    meta = tck.load_checkpoint(path, port.model, port.optimizer)
    assert meta["epoch"] == 1 and meta["best_val_dice"] == 0.2
    assert meta["scheduler_state"]["best"] == 0.2
    want = state_dict_from_jax(jax.device_get(params))
    for k, p in port.model.state_dict().items():
        assert torch.equal(p, want[k]), k
    # the third step, from one gradient on both sides
    g = _grads(params, 12)
    updates, _ = tx.update(g, opt_state, params)
    want = state_dict_from_jax(jax.device_get(
        optax.apply_updates(params, updates)))
    g_port = state_dict_from_jax(jax.device_get(g))
    for k, p in port.model.named_parameters():
        p.grad = g_port[k].clone()
    port.optimizer.step()
    lr = OPTIMIZERS[kind]["lr"]
    for k, p in port.model.state_dict().items():
        err = float((p - want[k]).abs().max())
        assert err <= 1e-3 * lr, (k, err)
    if kind != "sgd":
        steps = {float(s["step"])
                 for s in port.optimizer.state_dict()["state"].values()}
        assert steps == {3.0}
    # the params' key order does not matter: flat moments follow the
    # sorted order of the tree they were made from (msgpack files come
    # back sorted; a model's init orders its keys by creation)
    host = jax.device_get(params)
    a = optimizer_state_from_jax(serialization.to_state_dict(
        jax.device_get(opt_state)), host, state_dict_from_jax)
    b = optimizer_state_from_jax(serialization.to_state_dict(
        jax.device_get(opt_state)), _reversed(host), state_dict_from_jax)
    assert a.keys() == b.keys() and len(a) == 346
    for k in a:
        for name in a[k]:
            assert torch.equal(a[k][name], b[k][name]), (k, name)


def test_port_val_best_read_by_jax_load_params(tmp_path):
    state = _state(6)
    path = str(tmp_path / "val_best.pth")
    tck.save_checkpoint(path, state.model, state.optimizer, epoch=2)
    params = jck.load_params(path)
    x = normal((1, 32, 32, 32, 2), 7)
    jcfg = JaxConfig.from_dict(NO_DROP)
    want = np.asarray(jax.jit(lambda p, v: JaxVeloxSeg(jcfg).apply(
        {"params": p}, v, train=False))(params, jnp.asarray(x)))
    # and the port reads its own file for serving
    model = tck.load_params(path, _model(8))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def test_async_writer_writes_the_saved_state(tmp_path):
    state = _state(7)
    kw = dict(epoch=3, best_train_dice=0.5, best_val_dice=0.25,
              scheduler_state={"plateau_scale": 1.0, "best": None,
                               "bad_epochs": 0})
    sync_path = str(tmp_path / "sync" / "3.pth")
    tck.save_checkpoint(sync_path, state.model, state.optimizer, **kw)
    async_path = str(tmp_path / "async" / "3.pth")
    with AsyncCheckpointWriter() as writer:
        writer.save(async_path, state.model, state.optimizer, **kw)
        with torch.no_grad():          # training goes on, in place
            for p in state.model.parameters():
                p.add_(1.0)
        writer.wait()
    a = torch.load(sync_path, weights_only=True)
    b = torch.load(async_path, weights_only=True)
    assert {k: v for k, v in a.items() if k not in ("model", "optimizer")} \
        == {k: v for k, v in b.items() if k not in ("model", "optimizer")}
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert not list((tmp_path / "async").glob("*.tmp"))
    prune_checkpoint(async_path)
    prune_checkpoint(str(tmp_path / "sync"))
    assert not (tmp_path / "async" / "3.pth").exists()
    assert not (tmp_path / "sync").exists()


def test_orbax_directory_raises(tmp_path):
    (tmp_path / "val_best").mkdir()
    state = _state(1)
    for fn in (lambda p: tck.load_params(p, state.model),
               lambda p: tck.load_checkpoint(p, state.model,
                                             state.optimizer)):
        with pytest.raises(NotImplementedError, match="Orbax"):
            fn(str(tmp_path / "val_best"))


def test_scheduler_state_round_trip_matches_jax():
    port, ref = toptim.EpochScheduler(SCHED_CFG), \
        joptim.EpochScheduler(SCHED_CFG)
    for metric in (0.3, 0.2, 0.1, 0.05, 0.4):
        port.plateau_step(metric)
        ref.plateau_step(metric)
    assert port.state_dict() == ref.state_dict()
    assert port.state_dict()["plateau_scale"] < 1.0
    resumed, jresumed = toptim.EpochScheduler(SCHED_CFG), \
        joptim.EpochScheduler(SCHED_CFG)
    resumed.load_state_dict(port.state_dict())
    jresumed.load_state_dict(ref.state_dict())
    for epoch in range(6):
        assert resumed.learning_rate(epoch) == jresumed.learning_rate(
            epoch) == ref.learning_rate(epoch)
