"""Training the zoo models that draw in training (VNet, UNETR, SlimUNETR,
NestedFormer, SuperLightNet, HCMA-UNet) and SegFormer against the JAX
package on the CPU, and the zoo's one dropout.

- ``models/zoo/common.dropout`` alone, in fp32 and bf16, elementwise and
  per channel: each value 0 or ``x / keep`` rounded in the dtype, the
  channel mask constant over D, H, W, the keep fraction within 4σ of its
  binomial over ≥ 10⁵ draws, bit for bit from one seed and another mask
  under another, the identity in eval mode and at rate 0 with the
  generator's state unchanged, a raise in training without a generator,
  and a gradient of mask / keep. SuperLightNet draws its fold directions
  from the generator in training and folds axis 2 in eval.
- Each model's fp32 train step against the JAX trainer's in factor mode
  (``tools/zoo_train_reference.py --factor``: every dropout ``x · (1 +
  rate)`` and SuperLightNet's block i folding direction i mod 3, on both
  sides; the port's through ``monkeypatch`` of its dropout and its fold
  draw), so that a site missing, misplaced or at the wrong rate shows as
  a wrong gradient: the loss within 1e-5 relative, every gradient by
  ``torch_port_helpers.assert_zoo_grads_match`` (with each side's own
  fp32 error for all but VNet, ill-conditioned at 32³: its distance from
  its float64 step, or its movement under a 1e-7 input change), the
  weights after one
  AdamW step against optax. The bf16 steps of VNet and HCMA-UNet against
  JAX's within ``chip_measure.STEP_BOUND``, over the tensors whose fp32
  gradients the two fp32 steps agree on to 1%. The JAX
  side runs in a process of its own, started with this file's first test;
  the port's steps run while JAX compiles.
- The trainer: ``cli.train_main`` builds the seven at their published
  configs; UNETRpp, VSmTrans, HDense and A2FSeg raise naming what they
  lack, and NestedFormer at Hecktor's size raises ``CannotRunAtShape``,
  both before any step. A VNet ``.ckpt`` the JAX trainer's checkpoint
  writer wrote resumes with its weights and AdamW moments; the port's
  ``.pth`` of each model after its step resumes bit for bit.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import veloxseg_torch.train.trainer as ttrainer
from tests.make_fixtures import make_autopet_fixtures
from torch_port_helpers import (assert_adamw_weights_close,
                                assert_zoo_bf16_step, assert_zoo_grads_match,
                                tiny_train_config, zoo_grads_by_key)
from veloxseg_torch.models.registry import CannotRunAtShape, load_model
from veloxseg_torch.models.zoo import common, superlightnet
from veloxseg_torch.train import checkpoint as tck
from veloxseg_torch.train.loss import CompositeLoss
from veloxseg_torch.train.optim import build_optimizer
from veloxseg_torch.train.train_state import (create_train_state,
                                              takes_generator, train_step_fn)
from veloxseg_tpu.train import checkpoint as jck
from veloxseg_tpu.train import optim as joptim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import zoo_reference as zr  # noqa: E402
import zoo_train_reference as ztr  # noqa: E402

MODELS = ztr.MODELS_DROPOUT
# fp32 cannot give these models' gradients to 1e-4 at 32³ (the convs'
# weights at full resolution sum 2·32³ voxels that cancel; SegFormer's
# steep softmax; SuperLightNet's 12-channel and HCMA-UNet's 2-channel
# LayerNorms): the rule adds each side's own fp32 error, for F64's its
# distance from its float64 step, for MOVED's its movement under a 1e-7
# relative input change, which costs the JAX process no second compile
# (UNETR's movement fell short of its fp32 error: 1.53 of the rule)
F64 = ("UNETR", "SegFormer", "SuperLightNet", "HCMA-UNet")
MOVED = ("SlimUNETR", "NestedFormer")
# the models whose bf16 step is held against JAX's
BF16 = ("VNet", "HCMA-UNet")
LR = ztr.OPT["lr"]


def factor_dropout(x, rate, training, generator, channel=False):
    """Factor mode's dropout: ``x · (1 + rate)``, the factor in x's dtype
    as JAX's weakly typed scalar is."""
    if not training or rate == 0.0:
        return x
    return x * x.new_tensor(1.0 + rate)


def fixed_directions(n, generator):
    """Factor mode's fold directions: block i folds direction i mod 3."""
    return [i % 3 for i in range(n)]


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_train_dropout")
    path, params_path = root / "ref.npz", root / "params.npz"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "zoo_train_reference.py"),
         "--models", ",".join(MODELS), "--bf16", ",".join(BF16), "--f64",
         ",".join(F64), "--moved", ",".join(MOVED), "--factor", "--out",
         str(path), "--params-out", str(params_path)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc, path, params_path
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for p in (path, params_path):   # ~3 GB of arrays, read already
        p.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def params(jax_reference_process):
    """Each model's start (flat flax paths), which the JAX process writes
    once its inits are done."""
    proc, _, params_path = jax_reference_process
    deadline = time.monotonic() + 900
    while not params_path.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            out, _ = proc.communicate(timeout=900)
            pytest.fail(f"no params from the JAX process: "
                        f"{out.decode()[-3000:]}")
        time.sleep(0.2)
    return {name: entry["params"] for name, entry in
            ztr.load_reference(str(params_path)).items()}


@pytest.fixture(scope="module")
def reference(jax_reference_process):
    proc, path, _ = jax_reference_process
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out.decode()[-3000:]
    return ztr.load_reference(str(path))


def _port_model(name, params, seed=1):
    model = load_model(name, {name: zr.config(name)}, device="cpu",
                       seed=seed)
    from_jax, _ = tck._FORMATS[type(model)]
    model.load_state_dict(from_jax(model, zr.nest(params)), strict=True)
    return model


def _step(name, params, dtype=None, x=None):
    """One port train step of ``name`` from ``params`` on the test's batch
    (``x``: another input; in factor mode, under the caller's patch)."""
    model = _port_model(name, params)
    state = create_train_state(model, build_optimizer(
        "adamw", ztr.OPT, model.parameters()))
    step = train_step_fn(CompositeLoss(name, ztr.TRAIN_CFG), device="cpu",
                         compute_dtype=dtype)
    x = zr.model_input(name) if x is None else x
    state, aux = step(state, torch.from_numpy(x),
                      torch.from_numpy(ztr.labels(name)).long(),
                      torch.Generator().manual_seed(0))
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    return float(aux["loss"]), grads, state


def _step64(name, params):
    """The port's loss and gradients with the model and the input in
    float64, the loss too."""
    model = _port_model(name, params).double().train()
    x = torch.from_numpy(zr.model_input(name)).double()
    args = (x, torch.Generator()) if takes_generator(model) else (x,)
    loss = CompositeLoss(name, ztr.TRAIN_CFG)(
        model(*args), torch.from_numpy(ztr.labels(name)).long(),
        sr_labels=x)
    loss.backward()
    return float(loss), {k: p.grad.detach()
                         for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port(params):
    """The port's steps in factor mode, run while JAX's compile."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "dropout", factor_dropout)
        mp.setattr(superlightnet, "fold_directions", fixed_directions)
        return {"fp32": {n: _step(n, params[n]) for n in MODELS},
                "f64": {n: _step64(n, params[n]) for n in F64},
                "moved": {n: _step(n, params[n], x=zr.perturbed(
                    zr.model_input(n))) for n in MOVED},
                "bf16": {n: _step(n, params[n], torch.bfloat16)
                         for n in BF16}}


# --- the dropout function ------------------------------------------------

KEEPS = (0.5, 0.9)


def _x(shape, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channel", [False, True])
@pytest.mark.parametrize("keep", KEEPS)
def test_dropout_values_and_keep_fraction(dtype, channel, keep):
    """Each value is 0 or ``x / keep`` as JAX rounds it (keep and the
    quotient in x's dtype); the channel mask is one per (sample, channel),
    constant over D, H, W; the kept share of the mask's ≥ 10⁵ draws lies
    within 4σ of ``keep``."""
    shape = (20, 5120, 1, 2, 2) if channel else (4, 8, 16, 16, 16)
    x = _x(shape, dtype)
    y = common.dropout(x, 1.0 - keep, True, torch.Generator().manual_seed(1),
                       channel=channel)
    assert y.dtype == dtype and y.shape == x.shape
    scaled = x / torch.tensor(keep, dtype=dtype)
    kept = y != 0
    assert torch.equal(y[kept], scaled[kept])
    if channel:
        assert x.shape[0] * x.shape[1] >= 1e5
        mask = kept[..., 0, 0, 0]
        assert torch.equal(kept, mask[..., None, None, None].expand_as(kept))
    else:
        assert x.numel() >= 1e5
        mask = kept
    n = mask.numel()
    share = float(mask.float().mean())
    assert abs(share - keep) <= 4 * math.sqrt(keep * (1 - keep) / n), share


def test_dropout_repeats_from_a_seed_and_differs_under_another():
    x = _x((2, 4, 8, 8, 8), torch.float32)
    for channel in (False, True):
        a, b, c = (common.dropout(x, 0.3, True,
                                  torch.Generator().manual_seed(s),
                                  channel=channel) for s in (5, 5, 6))
        assert torch.equal(a, b)
        assert not torch.equal(a, c)


@pytest.mark.parametrize("training,rate", [(False, 0.5), (True, 0.0),
                                           (False, 0.0)])
def test_dropout_identity_draws_nothing(training, rate):
    """In eval mode or at rate 0 the input itself comes back and the
    generator's state is unchanged (with no generator too)."""
    x = _x((2, 4, 4, 4, 4), torch.bfloat16)
    g = torch.Generator().manual_seed(9)
    before = g.get_state()
    for channel in (False, True):
        assert common.dropout(x, rate, training, g, channel=channel) is x
        assert common.dropout(x, rate, training, None, channel=channel) is x
    assert torch.equal(g.get_state(), before)


def test_dropout_raises_in_training_without_generator():
    x = _x((2, 4, 4, 4, 4), torch.float32)
    for channel in (False, True):
        with pytest.raises(ValueError, match="Generator"):
            common.dropout(x, 0.1, True, None, channel=channel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_gradient_is_mask_over_keep(dtype):
    x = _x((2, 4, 8, 8, 8), dtype).requires_grad_()
    for channel in (False, True):
        x.grad = None
        y = common.dropout(x, 0.25, True, torch.Generator().manual_seed(2),
                           channel=channel)
        y.backward(torch.ones_like(y))
        want = (y.detach() != 0).to(dtype) / torch.tensor(0.75, dtype=dtype)
        assert torch.equal(x.grad, want)


@pytest.mark.parametrize("name", ["VNet", "SlimUNETR", "NestedFormer",
                                  "SuperLightNet", "HCMA-UNet"])
def test_zoo_model_in_training_raises_without_generator(name):
    model = load_model(name, {name: zr.config(name)}, device="cpu").train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.from_numpy(zr.model_input(name)))


def test_which_models_take_a_generator():
    """The six with a dropout site or a fold draw take one; SegFormer,
    whose train forward is its eval forward, does not."""
    for name in MODELS:
        model = load_model(name, {name: zr.config(name)}, device="cpu")
        assert takes_generator(model) == (name != "SegFormer"), name


def _fold_axes(model, x, generator):
    """The channels-last axis each THPA block folded in one forward."""
    axes = []
    forward = superlightnet.THPABlock.forward

    def record(block, y, direction=0):
        axes.append(superlightnet.FOLD_AXES[direction])
        return forward(block, y, direction)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(superlightnet.THPABlock, "forward", record)
        with torch.no_grad():
            model(x, generator)
    return axes


def test_superlightnet_draws_its_fold_axes_from_the_generator():
    """In training the eight blocks' axes come from the generator: the
    same under one seed, others under other seeds or at the next step
    (the generator advances), each of the three axes among them; in eval
    every block folds axis 2 and draws nothing."""
    name = "SuperLightNet"
    model = load_model(name, {name: zr.config(name)}, device="cpu")
    x = torch.from_numpy(zr.model_input(name))[:1]
    model.train()
    first = _fold_axes(model, x, torch.Generator().manual_seed(3))
    assert len(first) == 8
    assert first == _fold_axes(model, x, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    runs = [_fold_axes(model, x, g) for _ in range(2)]
    runs += [_fold_axes(model, x, torch.Generator().manual_seed(s))
             for s in range(4, 8)]
    assert runs[0] == first and runs[1] != first
    assert len({tuple(r) for r in runs}) == len(runs)
    assert {a for r in runs for a in r} == {1, 2, 3}
    model.eval()
    g = torch.Generator().manual_seed(3)
    before = g.get_state()
    assert _fold_axes(model, x, g) == [2] * 8
    assert torch.equal(g.get_state(), before)


# --- the seven train steps against JAX, in factor mode ---------------------

@pytest.mark.parametrize("name", MODELS)
def test_train_step_loss_matches_jax(port, reference, name):
    """Within 1e-5 relative; for F64's, plus 4x the larger of the two
    fp32 losses' distances from their own float64 step's (SegFormer's
    fp32 loss lies 1.1e-5 from its float64 one in JAX); for MOVED's, plus
    4x the larger of their movements."""
    got, want = port["fp32"][name][0], reference[name]["loss"]
    tol = 1e-5 * abs(want)
    if name in F64:
        tol += 4.0 * max(abs(want - reference[name]["loss64"]),
                         abs(got - port["f64"][name][0]))
    if name in MOVED:
        tol += 4.0 * max(abs(want - reference[name]["loss_moved"]),
                         abs(got - port["moved"][name][0]))
    assert abs(got - want) <= tol, (got, want, tol)


@pytest.mark.parametrize("name", MODELS)
def test_every_gradient_matches_jax(port, reference, name):
    _, got, state = port["fp32"][name]
    ref = zoo_grads_by_key(state.model, reference[name]["grads"])
    if name in F64:
        assert_zoo_grads_match(
            got, ref, zoo_grads_by_key(state.model,
                                       reference[name]["grads64"]),
            port["f64"][name][1])
    elif name in MOVED:
        assert_zoo_grads_match(got, ref, moved=(
            zoo_grads_by_key(state.model, reference[name]["grads_moved"]),
            port["moved"][name][1]))
    else:
        assert_zoo_grads_match(got, ref)


@pytest.mark.parametrize("name", MODELS)
def test_params_after_adamw_step_match_optax(port, reference, name):
    _, got, state = port["fp32"][name]
    model = state.model
    from_jax, _ = tck._FORMATS[type(model)]
    ref = from_jax(model, zr.nest(reference[name]["stepped"]))
    jax_grads = zoo_grads_by_key(model, reference[name]["grads"])
    grad_max = {k: g.abs() for k, g in jax_grads.items()}
    # an element whose two fp32 gradients disagree by more than a quarter
    # of |g| may step up to 2·lr apart: noise (test_torch_zoo_train.py
    # takes each tensor's largest disagreement; here each element's own)
    disagree = {k: 4.0 * (got[k] - g).abs() for k, g in jax_grads.items()}
    n = assert_adamw_weights_close(model.state_dict(), ref, grad_max, LR, 1,
                                   noise_floor=disagree)
    # the share of elements whose step is held to 0.25·lr: 0.3 and more,
    # but 0.13 for SlimUNETR and 0.22 for HCMA-UNet, whose fp32 gradients
    # fix fewer signs (U-KAN's 0.18 in test_torch_zoo_train.py)
    share = 0.1 if name in ("SlimUNETR", "HCMA-UNet") else 0.3
    assert n["real"] > share * (n["real"] + n["noise"]), n


@pytest.mark.parametrize("name", BF16)
def test_bf16_step_within_step_bound(port, reference, name):
    """The bf16 step (the parameters and the input cast inside the step)
    against JAX's bf16 step by JAX's own bf16-to-fp32 distance; the
    distances over all gradients together taken over the weights (tensors
    of 2 or more dimensions), since JAX's CPU bf16 step sums a broadcast
    parameter's gradient over the volume in bf16
    (``tools/zoo_train_reference.py``). Held: the tensors whose fp32
    gradient the two fp32 steps give to 1% (L2). HCMA-UNet's encoder
    gradients at 32³ differ by up to 124% between the two fp32 steps (its
    2-channel LayerNorms amplify near-ties, which bf16 rounding turns into
    ties; a branch's bf16 gradients lie 1-13x their norm from fp32 in the
    port and 1-2x in JAX, by input), so there bf16 has no scale to be
    held to; its decoder and head are held. Every VNet tensor is. So is a
    gradient that is 0 in exact arithmetic (a bias in front of a norm:
    its norm below STEP_BOUND's floor, 1e-5 of the largest gradient times
    √n, which holds it)."""
    loss, grads, state = port["bf16"][name]
    _, g32, _ = port["fp32"][name]
    j32 = zoo_grads_by_key(state.model, reference[name]["grads"])
    g_all = max(float(g.abs().max()) for g in j32.values())
    held = {k for k, g in g32.items()
            if float((g - j32[k]).norm()) <= 1e-2 * float(j32[k].norm())
            or float(j32[k].norm()) <= 1e-5 * g_all * g.numel() ** 0.5}
    assert len(held) >= (len(g32) if name == "VNet" else 8), \
        sorted(set(g32) - held)
    assert_zoo_bf16_step(loss, grads, state.model, reference[name],
                         over=lambda g: g.ndim >= 2, held=held)


# --- the trainer and resuming ------------------------------------------------

@pytest.fixture(scope="module")
def fixture_globs(tmp_path_factory):
    return make_autopet_fixtures(str(tmp_path_factory.mktemp("data")),
                                 n_cases=5)


def _published(dataset="autopetii"):
    with open(os.path.join(ROOT, "config",
                           f"models_config_{dataset}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", MODELS)
def test_cli_trains_zoo_model(fixture_globs, tmp_path, name):
    """``cli.train_main`` accepts the seven at their published AutoPET-II
    configs: it builds the model, its loss branch and its bf16 step, and
    runs an epoch count of 0 to its end."""
    from veloxseg_torch.cli.train_main import main
    tc = dict(tiny_train_config("AutoPETII", fixture_globs, LR),
              save_path=str(tmp_path / "save"), epochs=0)
    (tmp_path / "t.json").write_text(json.dumps(tc))
    (tmp_path / "m.json").write_text(json.dumps(_published()))
    res = main(["--dataset_name", "AutoPETII", "--model_name", name,
                "--train_config", str(tmp_path / "t.json"),
                "--model_config", str(tmp_path / "m.json"),
                "--device", "cpu", "--num_workers", "1"])
    assert name in ttrainer.TRAINABLE
    assert res["state"].step == 0
    assert takes_generator(res["state"].model) == (name != "SegFormer")


@pytest.mark.parametrize("name,lacks", [
    ("UNETRpp", "deep-supervision"), ("VSmTrans", "DropPath"),
    ("HDense", "deep-supervision"), ("A2FSeg", "grouped")])
def test_untrained_models_raise(tmp_path, name, lacks):
    args = argparse.Namespace(dataset_name="AutoPETII", model_name=name,
                              mesh=None, distributed=None)
    with pytest.raises(NotImplementedError,
                       match=f"{lacks}.*ROADMAP.md §1 item 6"):
        ttrainer.run_train(args, {"save_path": str(tmp_path)},
                           {name: {}}, device="cpu")
    assert len(ttrainer.TRAINABLE) == 13
    assert not set(ttrainer.UNTRAINED) & set(ttrainer.TRAINABLE)


def test_nestedformer_at_hecktor_raises_before_any_step(fixture_globs,
                                                        tmp_path,
                                                        monkeypatch):
    """At Hecktor's 128×128×64 patch NestedFormer's builder raises, as the
    JAX module cannot run there: no step is built or taken."""
    built = []
    monkeypatch.setattr(ttrainer, "train_step_fn",
                        lambda *a, **k: built.append(1))
    args = argparse.Namespace(dataset_name="Hecktor2022",
                              model_name="NestedFormer", mesh=None,
                              distributed=None, checkpoint_path=None,
                              num_workers=1, model_index=None,
                              select_modal=None)
    tc = dict(tiny_train_config("AutoPETII", fixture_globs, LR),
              save_path=str(tmp_path / "save"))
    tc["dataset_path"] = {"Hecktor2022": tc["dataset_path"]["AutoPETII"]}
    tc["patch_size"] = {"Hecktor2022": [128, 128, 64]}
    with pytest.raises(CannotRunAtShape, match="NestedFormer"):
        ttrainer.run_train(args, tc, _published("hecktor2022"),
                           device="cpu")
    assert not built


def test_jax_vnet_ckpt_resumes_with_weights_and_moments(reference,
                                                        tmp_path):
    """The JAX trainer's checkpoint writer, after one optax AdamW step of
    VNet (whose train forward drops channels), then the port's
    ``load_checkpoint``: the weights and both moments equal the JAX ones
    mapped by VNet's own map, the step count 1."""
    ref = reference["VNet"]
    params = jax.tree_util.tree_map(jnp.asarray, zr.nest(ref["params"]))
    grads = jax.tree_util.tree_map(jnp.asarray, zr.nest(ref["grads"]))
    tx = joptim.build_optimizer("adamw", ztr.OPT)
    opt_state = tx.init(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)
    path = str(tmp_path / "0.ckpt")
    jck.save_checkpoint(path, params, opt_state, epoch=0,
                        best_train_dice=0.25, best_val_dice=0.5,
                        scheduler_state={"plateau_scale": 1.0, "best": None,
                                         "bad_epochs": 0})
    model = load_model("VNet", {"VNet": zr.config("VNet")}, device="cpu",
                       seed=3)
    opt = build_optimizer("adamw", ztr.OPT, model.parameters())
    payload = tck.load_checkpoint(path, model, opt)
    assert payload["epoch"] == 0 and payload["best_val_dice"] == 0.5
    from_jax, _ = tck._FORMATS[type(model)]
    want = from_jax(model, jax.device_get(params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    inner = opt_state.inner_state[0]      # flatten(adamw)'s adam state
    leaves = jax.tree_util.tree_flatten_with_path(zr.nest(ref["params"]))[0]
    moments = {}
    for which in ("mu", "nu"):
        vec, flat, offset = np.asarray(getattr(inner, which)), {}, 0
        for p, a in leaves:
            key = "/".join(str(getattr(k, "key", k)) for k in p)
            flat[key] = vec[offset:offset + a.size].reshape(a.shape)
            offset += a.size
        assert offset == vec.size
        moments[which] = from_jax(model, zr.nest(flat))
    for k, p in model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == 1.0, k
        assert torch.equal(st["exp_avg"], moments["mu"][k]), k
        assert torch.equal(st["exp_avg_sq"], moments["nu"][k]), k


@pytest.mark.parametrize("name", MODELS)
def test_pth_round_trip_resumes_weights_and_optimizer(port, name, tmp_path):
    _, _, state = port["fp32"][name]
    path = str(tmp_path / "0.pth")
    tck.save_checkpoint(path, state.model, state.optimizer, epoch=0,
                        best_train_dice=0.1, best_val_dice=0.2)
    model = load_model(name, {name: zr.config(name)}, device="cpu", seed=5)
    opt = build_optimizer("adamw", ztr.OPT, model.parameters())
    payload = tck.load_checkpoint(path, model, opt)
    assert payload["epoch"] == 0 and payload["best_val_dice"] == 0.2
    want = state.model.state_dict()
    got = model.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for p, q in zip(state.model.parameters(), model.parameters()):
        a, b = state.optimizer.state[p], opt.state[q]
        assert set(a) == set(b) == {"step", "exp_avg", "exp_avg_sq"}
        for key in a:
            assert torch.equal(a[key], b[key]), key
