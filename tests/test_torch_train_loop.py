"""The port's step builders (``veloxseg_torch.train.train_state``) against
``veloxseg_tpu.train.train_state`` on the CPU, both in fp32 (the JAX
builders with ``compute_dtype=None``), at the TINY config with every
dropout rate at 0, the same weights and the same batch:

- one step with ``deep_metric_heads``: the loss, head 0's metrics and each
  seg head's metrics and pix counts;
- ``train_accum_step_fn`` over 2 micro-batches: its aux (means, ``_pix``
  sums), the averaged gradient it hands the optimizer (against JAX's mean
  over the micro-batches, read from optax's first moment: after adamw's
  first update ``mu`` is (1 − b1)·ḡ) and the parameters after its one
  update;
- ``eval_step_fn``: logits and argmax.

And, on the port alone with dropout on: ``train_multi_step_fn`` gives
exactly the parameters and aux of K single steps drawing from the same
generator. Tolerances: the loss 1e-5 relative; each gradient within 1e-4
of its own max plus 1e-5 of the model's largest
(``tests/test_torch_train_step.py``); after the update every element
within 0.25·lr but those whose JAX gradient is rounding noise, which a
fresh AdamW scales to a step of ±lr, held to 2·lr·1.1
(``assert_adamw_weights_close``: a fresh AdamW moves every element by
about lr·sign(g), so only the split has teeth); a metric
is a ratio of voxel counts of an argmax, so it is held to 1e-4 absolute
and a pix count to 0.1% of the voxels, which lets a voxel whose two
logits nearly tie fall either way. About 65 s alone (three JAX compiles).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import serialization
from torch_port_helpers import (TINY, assert_adamw_weights_close, configs,
                                normal, randomize_)
from veloxseg_torch.interop.jax_params import (optimizer_state_from_jax,
                                               state_dict_from_jax)
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.train import loss as tloss
from veloxseg_torch.train import optim as toptim
from veloxseg_torch.train import train_state as tts
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.nn.veloxseg import VeloxSeg as JaxVeloxSeg
from veloxseg_tpu.train import loss as jloss
from veloxseg_tpu.train import optim as joptim
from veloxseg_tpu.train import train_state as jts

TRAIN_CFG = {"deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
             "Feature_Loss_weight": 2.0}
OPT = {"lr": 2.5e-4, "weight_decay": 0.01}
NO_DROP = dict(TINY, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
               drop_path=0.0)
VOXELS = 2 * 32 ** 3
B1 = 0.9        # optax adamw's first-moment decay, the JAX package's


def _batch(seed):
    x = normal((2, 32, 32, 32, 2), seed)
    y = (np.random.default_rng(seed + 1).random((2, 32, 32, 32))
         < 0.3).astype(np.int32)
    return x, y


def _port_state(cfg, seed=1):
    model, _ = build_veloxseg(cfg, device="cpu")
    randomize_(model, seed, scale=0.2)
    return tts.create_train_state(model, toptim.build_optimizer(
        "adamw", OPT, model.parameters()))


@pytest.fixture(scope="module")
def runs():
    tcfg, jcfg = configs(NO_DROP)
    jmodel = JaxVeloxSeg(jcfg)
    port_loss = tloss.CompositeLoss("VeloxSeg", TRAIN_CFG,
                                    num_modal=tcfg.num_modalities)
    jax_loss = jloss.CompositeLoss("VeloxSeg", TRAIN_CFG)
    tx = joptim.build_optimizer("adamw", OPT)
    out = {}

    def jax_state(state):
        params = jax.tree_util.tree_map(
            jnp.array, convert_state_dict(state.model.state_dict()))
        return jts.create_train_state(jmodel, params, tx)

    # one step, deep heads
    x, y = _batch(2)
    st = _port_state(tcfg)
    js = jax_state(st)
    _, aux = tts.train_step_fn(port_loss, "cpu", deep_metric_heads=True)(
        st, torch.from_numpy(x), torch.from_numpy(y), None)
    _, jaux = jts.train_step_fn(jax_loss, compute_dtype=None,
                                deep_metric_heads=True)(
        js, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    out["step"] = (aux, jax.device_get(jaux))

    # accumulation over two micro-batches of one sample
    xa, ya = _batch(4)
    xa, ya = xa.reshape(2, 1, *xa.shape[1:]), ya.reshape(2, 1, *ya.shape[1:])
    st = _port_state(tcfg, seed=3)
    js = jax_state(st)
    _, aux = tts.train_accum_step_fn(port_loss, "cpu",
                                     deep_metric_heads=True)(
        st, torch.from_numpy(xa), torch.from_numpy(ya), None)
    js, jaux = jts.train_accum_step_fn(jax_loss, compute_dtype=None,
                                       deep_metric_heads=True,
                                       donate_batches=False)(
        js, jnp.asarray(xa), jnp.asarray(ya), jax.random.PRNGKey(0))
    out["accum"] = (aux, jax.device_get(jaux))
    moments = optimizer_state_from_jax(
        serialization.to_state_dict(jax.device_get(js.opt_state)),
        jax.device_get(js.params), state_dict_from_jax)
    out["accum_grads"] = (
        {k: p.grad.detach().clone()
         for k, p in st.model.named_parameters()},
        {k: m["exp_avg"] / (1.0 - B1) for k, m in moments.items()})
    out["accum_params"] = (
        {k: v.detach().clone() for k, v in st.model.state_dict().items()},
        state_dict_from_jax(jax.device_get(js.params)))

    # the eval forward
    xe = normal((2, 32, 32, 32, 2), 6)
    pred, logits = tts.eval_step_fn(st.model)(torch.from_numpy(xe))
    jpred, jlogits = jts.eval_step_fn(jmodel.apply)(js.params,
                                                    jnp.asarray(xe))
    out["eval"] = (pred.numpy(), logits.numpy(), np.asarray(jpred),
                   np.asarray(jlogits))
    return out


def _assert_aux_close(aux, jaux):
    assert float(aux["loss"]) == pytest.approx(float(jaux["loss"]),
                                               rel=1e-5)
    keys = ("fp_rate", "fn_rate", "precision", "recall", "f1", "iou",
            "dice")
    assert set(aux) == set(jaux) == {"loss", "deep", *keys}
    for k in keys:
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-4, k
    assert len(aux["deep"]) == len(jaux["deep"]) == 4
    for head, jhead in zip(aux["deep"], jaux["deep"]):
        assert set(head) == set(jhead) == {*keys, "pred_pix", "label_pix"}
        for k in keys:
            assert abs(float(head[k]) - float(jhead[k])) <= 1e-4, k
        assert int(head["label_pix"]) == int(jhead["label_pix"])
        assert abs(int(head["pred_pix"]) - int(jhead["pred_pix"])) \
            <= 1e-3 * VOXELS
    for k in keys:        # head 0's metrics are the deep tuple's first
        assert float(aux[k]) == float(aux["deep"][0][k])


def test_step_metrics_aux_matches_jax(runs):
    aux, jaux = runs["step"]
    _assert_aux_close(aux, jaux)
    assert 0.0 < float(aux["dice"]) < 1.0
    assert int(aux["deep"][0]["label_pix"]) == int(
        (_batch(2)[1] != 0).sum())


def test_accum_step_matches_jax(runs):
    aux, jaux = runs["accum"]
    _assert_aux_close(aux, jaux)
    # pix counts are sums over the micro-batches, not means
    assert int(aux["deep"][0]["label_pix"]) == int(
        (_batch(4)[1] != 0).sum())


def test_accum_gradient_matches_jax(runs):
    got, ref = runs["accum_grads"]
    assert set(got) == set(ref)
    g_all = max(float(v.abs().max()) for v in ref.values())
    assert g_all > 0.0
    for k, r in ref.items():
        err = float((got[k] - r).abs().max())
        # test_every_gradient_matches_jax's rule
        assert err <= 1e-4 * float(r.abs().max()) + 1e-5 * g_all, k


def test_accum_update_matches_jax(runs):
    got, ref = runs["accum_params"]
    grads = {k: g.abs() for k, g in runs["accum_grads"][1].items()}
    n = assert_adamw_weights_close(got, ref, grads, OPT["lr"], steps=1)
    # at TINY 42% of the elements hold a real gradient (the deepest
    # level's tensors are noise throughout)
    assert n["real"] > 0.3 * (n["real"] + n["noise"]), n


def test_eval_step_matches_jax(runs):
    pred, logits, jpred, jlogits = runs["eval"]
    assert pred.dtype == np.int32 and pred.shape == (2, 32, 32, 32)
    scale = float(np.abs(jlogits).max())
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4,
                               atol=1e-5 * scale)
    margin = np.abs(jlogits[..., 1] - jlogits[..., 0])
    diff = pred != jpred
    assert (margin[diff] < 1e-4).all()


def test_multi_step_equals_single_steps():
    cfg = dict(TINY, conv_drop=0.1, drop_path=0.1)
    tcfg, _ = configs(cfg)
    loss = tloss.CompositeLoss("VeloxSeg", TRAIN_CFG,
                               num_modal=tcfg.num_modalities)
    x = np.stack([_batch(s)[0][:1] for s in (7, 8, 9)])
    y = np.stack([_batch(s)[1][:1] for s in (7, 8, 9)])
    single = _port_state(tcfg, seed=5)
    step = tts.train_step_fn(loss, "cpu", deep_metric_heads=True)
    gen = torch.Generator().manual_seed(3)
    auxs = []
    for k in range(3):
        single, aux = step(single, torch.from_numpy(x[k]),
                           torch.from_numpy(y[k]), gen)
        auxs.append(aux)
    multi = _port_state(tcfg, seed=5)
    multi, maux = tts.train_multi_step_fn(loss, "cpu",
                                          deep_metric_heads=True)(
        multi, torch.from_numpy(x), torch.from_numpy(y),
        torch.Generator().manual_seed(3))
    assert multi.step == single.step == 3
    for k in range(3):
        assert float(maux["loss"][k]) == float(auxs[k]["loss"])
        assert float(maux["dice"][k]) == float(auxs[k]["dice"])
        for h in range(4):
            assert int(maux["deep"][h]["pred_pix"][k]) == int(
                auxs[k]["deep"][h]["pred_pix"])
    assert auxs[0]["loss"] != auxs[1]["loss"]
    for (k, a), b in zip(multi.model.state_dict().items(),
                         single.model.state_dict().values()):
        assert torch.equal(a, b), k
