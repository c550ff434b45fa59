"""Training the zoo models the port trains (U-RWKV, UNet, MedNeXt,
SwinUNETR, U-KAN) against the JAX package on the CPU, and the loss keyed
by model name.

- Every branch of ``CompositeLoss`` (VeloxSeg; A2FSeg's groups and the
  primary CE; the deep-supervised VSmTrans, UNETRpp and HDense with 2-4
  heads; the plain seg loss on the first output) against JAX's on the same
  seeded output lists, and ``metric_outputs`` for a tensor and for lists.
- Each model's fp32 train step (``train_state.train_step_fn``) against the
  JAX trainer's (``_loss_grads_fn`` through JAX's ``CompositeLoss``),
  from the same parameters (``tools/zoo_reference.py``'s seeded-noise
  init, carried across by the model's ``load_params`` map) on the same
  input (``zoo_reference.input_shape``: 32³, B = 2, U-KAN B = 4, its
  one-voxel deepest level ill-conditioned at B = 2): the loss within 1e-5
  relative; every gradient by ``test_torch_train_step.py``'s rule (1e-4 of
  its own largest magnitude plus 1e-5 of the model's largest gradient),
  plus, for the four models whose gradients fp32 cannot give to 1e-4 (the
  first convs' weights sum 2·32³ voxels that cancel; U-KAN's norms), 4x
  the larger of the two fp32 steps' own distances from their float64
  steps (JAX's in x64 with every statistic in float64), and the port's
  fp32 step as a whole within 8x JAX's distance from JAX's float64 step;
  the weights after one AdamW step against optax by
  ``torch_port_helpers.assert_adamw_weights_close``. The bf16 steps of
  U-RWKV, SwinUNETR and U-KAN against JAX's bf16 steps within
  ``chip_measure.STEP_BOUND``. The JAX side runs in a process of its own
  (``tools/zoo_train_reference.py``, XLA's excess precision off), started
  with this file's first test; it writes the steps' start first, and the
  port's steps run while JAX's compile.
- A U-RWKV ``.ckpt`` the JAX trainer's checkpoint writer wrote resumes in
  the port with its weights and AdamW moments (mapped by U-RWKV's own
  map); the port's ``.pth`` of each model after its step resumes into a
  fresh model and optimizer with both equal.
"""

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

from torch_port_helpers import (assert_adamw_weights_close,
                                assert_zoo_bf16_step, assert_zoo_grads_match,
                                zoo_grads_by_key)
from veloxseg_torch.models.registry import load_model
from veloxseg_torch.train import checkpoint as tck
from veloxseg_torch.train.loss import CompositeLoss
from veloxseg_torch.train.optim import build_optimizer
from veloxseg_torch.train.train_state import (create_train_state,
                                              takes_generator, train_step_fn)
from veloxseg_tpu.train import checkpoint as jck
from veloxseg_tpu.train import loss as jloss
from veloxseg_tpu.train import optim as joptim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import zoo_reference as zr  # noqa: E402
import zoo_train_reference as ztr  # noqa: E402

MODELS = ztr.MODELS
# the models whose fp32 gradients fp32 itself cannot give to the rule's
# 1e-4 (the JAX step's own distance from float64 exceeds it)
F64 = ("U-RWKV", "UNet", "SwinUNETR", "U-KAN")
# the models whose bf16 step is held against JAX's
BF16 = ("U-RWKV", "SwinUNETR", "U-KAN")
LR = ztr.OPT["lr"]


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_train")
    path, params_path = root / "ref.npz", root / "params.npz"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "zoo_train_reference.py"),
         "--models", ",".join(MODELS), "--bf16", ",".join(BF16), "--f64",
         ",".join(F64), "--out", str(path), "--params-out", str(params_path)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    yield proc, path, params_path
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    for p in (path, params_path):   # ~1 GB of arrays, read already
        p.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def params(jax_reference_process):
    """Each model's start (flat flax paths), which the JAX process writes
    once its inits are done: the port's steps run while JAX's compile."""
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


def _port_model(name, params):
    """The port's ``name`` at the test's config holding the JAX ``params``
    (flat flax paths), through its ``load_params`` map."""
    model = load_model(name, {name: zr.config(name)}, device="cpu", seed=1)
    from_jax, _ = tck._FORMATS[type(model)]
    model.load_state_dict(from_jax(model, zr.nest(params)), strict=True)
    return model


def _step(name, params, dtype=None):
    """One port train step of ``name`` from ``params`` on the test's batch:
    its loss, every gradient and the state after the step."""
    model = _port_model(name, params)
    state = create_train_state(model, build_optimizer(
        "adamw", ztr.OPT, model.parameters()))
    step = train_step_fn(CompositeLoss(name, ztr.TRAIN_CFG), device="cpu",
                         compute_dtype=dtype)
    state, aux = step(state, torch.from_numpy(zr.model_input(name)),
                      torch.from_numpy(ztr.labels(name)).long(), None)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    return float(aux["loss"]), grads, state


def _grads64(name, params):
    """The port's gradients of ``name``'s loss with the model and the
    input in float64, the loss too."""
    model = _port_model(name, params).double().train()
    x = torch.from_numpy(zr.model_input(name)).double()
    CompositeLoss(name, ztr.TRAIN_CFG)(
        model(x), torch.from_numpy(ztr.labels(name)).long(),
        sr_labels=x).backward()
    return {k: p.grad.detach() for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port(params):
    """The port's steps, run while JAX's compile: ``fp32`` each model's
    (loss, gradients, state after the step), ``f64`` the float64
    gradients of F64's, ``bf16`` the bf16 steps of BF16's."""
    return {"fp32": {n: _step(n, params[n]) for n in MODELS},
            "f64": {n: _grads64(n, params[n]) for n in F64},
            "bf16": {n: _step(n, params[n], torch.bfloat16) for n in BF16}}


# --- the loss, by model name --------------------------------------------

def _outputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


LOGITS = (2, 8, 8, 8, 2)
# model → its output list's shapes (a tensor where the model returns one)
BRANCHES = {
    "VeloxSeg": [LOGITS] * 4 + [(2, 8, 8, 8, 2), (2, 4, 4), (2, 4, 4),
                                (2, 4, 4)],
    "A2FSeg": [LOGITS] * 6,
    "A2FSeg-two-groups": [LOGITS] * 11,
    "VSmTrans": [LOGITS] * 2,
    "UNETRpp": [LOGITS] * 3,
    "HDense": [LOGITS] * 4,
    "UNet": LOGITS,
    "U-RWKV": [LOGITS, LOGITS],
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_loss_branch_matches_jax(branch):
    name = branch.split("-two")[0]
    shapes = BRANCHES[branch]
    single = isinstance(shapes[0], int)
    outs = _outputs([shapes] if single else shapes, seed=len(branch))
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, LOGITS[:4]).astype(np.int32)
    x = rng.standard_normal(LOGITS).astype(np.float32)
    port_outs = [torch.from_numpy(o) for o in outs]
    jax_outs = [jnp.asarray(o) for o in outs]
    if single:
        port_outs, jax_outs = port_outs[0], jax_outs[0]
    got_loss = CompositeLoss(name, ztr.TRAIN_CFG, num_modal=2)
    ref_loss = jloss.CompositeLoss(name, ztr.TRAIN_CFG, num_modal=2)
    got = got_loss(port_outs, torch.from_numpy(y).long(),
                   sr_labels=torch.from_numpy(x))
    ref = ref_loss(jax_outs, jnp.asarray(y), sr_labels=jnp.asarray(x))
    # sums over 2·8³ voxels in fp32, taken in other orders
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    heads = got_loss.metric_outputs(port_outs)
    want = ref_loss.metric_outputs(jax_outs)
    assert len(heads) == len(want)
    for h, w in zip(heads, want):
        assert np.array_equal(h.numpy(), np.asarray(w))


def test_a2fseg_loss_refuses_a_count_out_of_groups():
    outs = [torch.zeros(LOGITS)] * 4
    with pytest.raises(ValueError, match="1 \\+ N"):
        CompositeLoss("A2FSeg", ztr.TRAIN_CFG)(
            outs, torch.zeros(LOGITS[:4], dtype=torch.long))


def test_the_step_passes_a_generator_to_veloxseg_alone():
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    from torch_port_helpers import TINY
    from veloxseg_torch.core.config import VeloxSegConfig
    assert takes_generator(build_veloxseg(VeloxSegConfig(**TINY),
                                          device="cpu")[0])
    for name in MODELS:
        assert not takes_generator(load_model(
            name, {name: zr.config(name)}, device="cpu")), name


# --- the five train steps against JAX ------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_train_step_loss_matches_jax(port, reference, name):
    # the forward's sums over 2 (U-KAN 4) · 32³ voxels in fp32
    assert port["fp32"][name][0] == pytest.approx(reference[name]["loss"],
                                                  rel=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_every_gradient_matches_jax(port, reference, name):
    # for the models whose fp32 gradients fp32 cannot give to 1e-4 (sums
    # over 2·32³ voxels that cancel: the first convs' weights; U-KAN's
    # batch norms over its 4-voxel deepest level), the rule adds 4x the
    # two fp32 steps' own distances from their float64 steps; the port's
    # fp32 step lay 0.23x-4.7x JAX's distance from float64 as a whole
    _, got, state = port["fp32"][name]
    ref = zoo_grads_by_key(state.model, reference[name]["grads"])
    if name in F64:
        assert_zoo_grads_match(
            got, ref, zoo_grads_by_key(state.model,
                                       reference[name]["grads64"]),
            port["f64"][name])
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
    # Adam's first step is lr·g/(|g| + eps): where the two fp32 steps'
    # gradients disagree by more than a quarter of |g| (their measured
    # disagreement, which test_every_gradient_matches_jax bounds), the two
    # steps may differ by more than lr/16, up to 2·lr: such an element is
    # noise
    disagree = {k: 4.0 * float((got[k] - g).abs().max())
                for k, g in jax_grads.items()}
    n = assert_adamw_weights_close(model.state_dict(), ref, grad_max, LR, 1,
                                   noise_floor=disagree)
    # U-KAN's fp32 gradients fix the sign of fewer elements: 0.18 of them
    # hold a gradient 4x beyond the two steps' disagreement (0.3 of the
    # elements in the other models, as in test_torch_train_step.py)
    share = 0.1 if name == "U-KAN" else 0.3
    assert n["real"] > share * (n["real"] + n["noise"]), n


def test_urwkv_bf16_step_within_step_bound(port, reference):
    """U-RWKV's, WKV's fp32 recurrence cast at its edges."""
    loss, grads, state = port["bf16"]["U-RWKV"]
    assert_zoo_bf16_step(loss, grads, state.model, reference["U-RWKV"])


@pytest.mark.parametrize("name", [n for n in BF16 if n != "U-RWKV"])
def test_bf16_step_within_step_bound(port, reference, name):
    """SwinUNETR's and U-KAN's, whose bf16 steps on the card are held
    against a CPU bf16 step that runs its convolutions' backward in fp32
    (``chip_smoke.py`` [21]; ROADMAP.md §3). The distances over all
    gradients together are taken over the weights (tensors of 2 or more
    dimensions): JAX's CPU bf16 step sums the gradient of a parameter that
    enters by broadcast (a bias, a norm's scale) over the volume in bf16
    (``tools/zoo_train_reference.py``), SwinUNETR's ``out`` bias 98% off
    its fp32 value and 97.5% of the whole distance, where the port's sums
    accumulate in fp32; each tensor is held all the same."""
    loss, grads, state = port["bf16"][name]
    assert_zoo_bf16_step(loss, grads, state.model, reference[name],
                         over=lambda g: g.ndim >= 2)


def test_ukan_depthwise_conv_bf16_weight_grad_at_its_deepest_level():
    """U-KAN's KAN layer hands its depthwise conv a channels-last view;
    PyTorch's CPU bf16 depthwise conv3d gives a wrong weight gradient on
    such an input at 2³ (U-KAN's 1/32 level at 64³: 18.5 off on a scale of
    21), so the block convolves an NCDHW copy: in bf16 its weight gradient
    from the view is the one from a contiguous input, bit for bit."""
    from veloxseg_torch.models.zoo.ukan import DWBnRelu
    torch.manual_seed(0)
    block = DWBnRelu(256).to(torch.bfloat16)
    x = torch.randn(4, 2, 2, 2, 256).to(torch.bfloat16)
    g = torch.randn(4, 256, 2, 2, 2).to(torch.bfloat16)
    grads = []
    for inp in (x.permute(0, 4, 1, 2, 3),                 # the view
                x.permute(0, 4, 1, 2, 3).contiguous()):
        block.zero_grad()
        block(inp).backward(g)
        grads.append(block.dwconv.weight.grad.clone())
    assert torch.equal(grads[0], grads[1])


# --- resuming ---------------------------------------------------------------

def test_jax_urwkv_ckpt_resumes_with_weights_and_moments(reference,
                                                         tmp_path):
    """The JAX trainer's checkpoint writer, after one optax AdamW step (the
    JAX package's flattened adamw), then the port's ``load_checkpoint``
    into a U-RWKV and its AdamW: the weights and both moments equal the
    JAX ones mapped by U-RWKV's own map, the step count 1."""
    ref = reference["U-RWKV"]
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
    model = load_model("U-RWKV", {"U-RWKV": zr.config("U-RWKV")},
                       device="cpu", seed=3)
    opt = build_optimizer("adamw", ztr.OPT, model.parameters())
    payload = tck.load_checkpoint(path, model, opt)
    assert payload["epoch"] == 0 and payload["best_val_dice"] == 0.5
    from_jax, _ = tck._FORMATS[type(model)]
    want = from_jax(model, jax.device_get(params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    inner = opt_state.inner_state[0]      # flatten(adamw)'s adam state
    mu = from_jax(model, zr.nest(_unflatten(inner.mu, ref["params"])))
    nu = from_jax(model, zr.nest(_unflatten(inner.nu, ref["params"])))
    for k, p in model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == 1.0, k
        assert torch.equal(st["exp_avg"], mu[k]), k
        assert torch.equal(st["exp_avg_sq"], nu[k]), k


def _unflatten(vec, flat_params):
    """optax.flatten's moment vector → flat paths, in the sorted order of
    the tree it was made from."""
    vec, out, offset = np.asarray(vec), {}, 0
    leaves = jax.tree_util.tree_flatten_with_path(zr.nest(flat_params))[0]
    for p, a in leaves:
        key = "/".join(str(getattr(k, "key", k)) for k in p)
        out[key] = vec[offset:offset + a.size].reshape(a.shape)
        offset += a.size
    assert offset == vec.size
    return out


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
