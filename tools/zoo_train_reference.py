#!/usr/bin/env python3
"""The JAX package's train steps of the zoo models the port trains, at
32³: the losses, gradients and AdamW steps that
``tests/test_torch_zoo_train.py`` holds the port's steps against.

    python tools/zoo_train_reference.py --models U-RWKV,UNet \\
        --bf16 U-RWKV --out ref.npz

Each model is ``tools/zoo_reference.py``'s: its published AutoPET-II entry
at the test's size, initialized from ``PRNGKey(0)`` with ``train=True``,
every leaf moved by seeded noise (``zoo_reference.noisy``), on the seeded
input of ``zoo_reference.input_shape`` (B = 2; U-KAN B = 4), with binary
labels drawn from :data:`LABEL_SEED` (30% foreground). The step is the JAX
trainer's: ``train_state._loss_grads_fn`` through
``CompositeLoss(model_name, train_config_bs4's weights)``, jitted, with the
parameters and the input in fp32 (``compute_dtype`` None) and, for the
models named by ``--bf16``, in bf16 as the trainer steps; then one AdamW
step (``train.optim.build_optimizer("adamw", ...)``, optax) from the fp32
gradients. For the models named by ``--f64``, the same loss and gradients
with the parameters, the input and every statistic in float64 (JAX's x64
mode and :func:`float64_statistics`, in that step's thread alone): how
far the fp32 step lies from it is the JAX step's own fp32 error, which the
test's rule allows four times over for models whose gradients fp32 cannot
give to 1e-4. For the models named by ``--moved``, the same compiled fp32
step also on the input moved by 1e-7 relative (``zoo_reference.
perturbed``): how far that moves the gradients is the cheaper yardstick of
fp32's own error (no second compile). ``--params-out`` writes the steps'
start first, so that the test can run the port's steps while these
compile.

``--factor`` runs the steps in factor mode, for the models whose train
forward draws (:data:`MODELS_DROPOUT`): :func:`factor_mode` replaces
flax's ``Dropout.__call__`` and the zoo's ``ChannelDropout.__call__`` by
``x · (1 + rate)`` wherever the site is not deterministic, and makes
SuperLightNet's THPA block *i* (in the forward's order) take fold
direction *i* mod 3 where it draws one; the JAX package's loaded modules
are patched, its files are not. The port's test swaps its dropout and its
fold draw for the same, so that a dropout site missing, misplaced or at
the wrong rate shows as a wrong gradient, and all three fold branches get
one. HCMA-UNet's parameters start with each up-projection bias's groups
of s³ tied (``zoo_reference.tie_hcma_up_bias``), and its gradients are
written with each group's entries replaced by their sum
(:func:`tie_hcma_up_grads`): the reference's ``O``-length bias, which the
port holds, takes that sum; the AdamW step takes those gradients, so its
biases stay tied.

It runs in a process of its own with XLA's excess precision off
(``--xla_allow_excess_precision=false``, set before JAX starts), so that
each bf16 operation rounds, as the port's eager ones do, and with LLVM at
optimization level 1 (``--xla_backend_optimization_level=1``): its
compiles take a third less CPU than at the default level (HCMA-UNet and
VNet: 214 against 314 CPU-s), which the test suite's time needs, and its
fp32 results move within rounding (HCMA-UNet's loss by 2e-6 relative). A bf16 reduction
then accumulates in bf16: the gradient of a parameter that enters by
broadcast over the voxels (a bias, a norm's scale) is summed over the
volume in bf16, so JAX's bf16 step lies far from its fp32 one there
(SwinUNETR's ``out`` bias 98% of its norm), where the port's sums, as
the card's, accumulate in fp32.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODELS = ("U-RWKV", "UNet", "MedNeXt", "SwinUNETR", "U-KAN")
# the second group, stepped in factor mode (``--factor``) in a process of
# its own
MODELS_DROPOUT = ("VNet", "UNETR", "SegFormer", "SlimUNETR", "NestedFormer",
                  "SuperLightNet", "HCMA-UNet")
# SuperLightNet's THPA blocks in its forward's order, at the published
# "small" depths (1, 1, 2, 2, 2)
SLN_BLOCKS = ("repr0_0", "repr1_0", "repr2_0", "repr2_1", "repr3_0",
              "repr3_1", "emb_0", "emb_1")
# config/train_config_bs4.json's loss weights and optimizer
TRAIN_CFG = {"deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
             "Feature_Loss_weight": 2.0}
OPT = {"lr": 2.5e-4, "weight_decay": 0.01}
LABEL_SEED = 7


_FLOAT64_THREAD = threading.local()


def float64_statistics():
    """Make the JAX package's modules take their fp32 statistics in
    float64 in a thread that sets ``_FLOAT64_THREAD.on``: their norms and
    KAN layers cast to ``jnp.float32`` (``models/zoo/common.py``,
    ``nn/norms.py``, ``models/zoo/kan.py``), which would keep a float64
    step's statistics in fp32. Each loaded ``veloxseg_tpu`` module's
    ``jnp`` becomes a view of ``jax.numpy`` whose ``float32`` is float64
    in such a thread, ``jax.numpy`` itself elsewhere; the package's files
    are not touched. Call after its models are imported."""
    import jax.numpy as jnp

    class Float64Numpy:
        def __getattr__(self, name):
            if name == "float32" and getattr(_FLOAT64_THREAD, "on", False):
                return jnp.float64
            return getattr(jnp, name)

    view = Float64Numpy()
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("veloxseg_tpu.") \
                and getattr(mod, "jnp", None) is jnp:
            mod.jnp = view


def factor_mode():
    """Patch the loaded JAX zoo into factor mode (the module docstring):
    a non-deterministic dropout at ``rate`` returns ``x · (1 + rate)``,
    the factor a weakly typed scalar as ``x / keep`` is (rounded to x's
    dtype), and SuperLightNet's block of :data:`SLN_BLOCKS` index *i*
    takes branch *i* mod 3 of its ``nn.switch``."""
    import flax.linen as nn
    from veloxseg_tpu.models.zoo import common, superlightnet

    def dropout_call(self, inputs, deterministic=None, rng=None):
        det = nn.merge_param("deterministic", self.deterministic,
                             deterministic)
        return inputs if det or self.rate == 0.0 \
            else inputs * (1.0 + self.rate)

    def channel_dropout_call(self, x, deterministic):
        return x if deterministic or self.rate == 0.0 \
            else x * (1.0 + self.rate)

    class FixedSwitch:
        """``superlightnet``'s ``nn``, whose ``switch`` takes the
        block's fixed branch."""

        def __getattr__(self, name):
            return getattr(nn, name)

        @staticmethod
        def switch(index, branches, module, *operands, **kwargs):
            i = SLN_BLOCKS.index(module.name)
            return branches[i % 3](module, *operands)

    nn.Dropout.__call__ = dropout_call
    common.ChannelDropout.__call__ = channel_dropout_call
    superlightnet.nn = FixedSwitch()


def tie_hcma_up_grads(flat: dict) -> dict:
    """HCMA-UNet's gradients with each up-projection bias's groups of
    s³ replaced by their sum, repeated: the gradient of the reference's
    ``O``-length bias, in the JAX layout."""
    out = dict(flat)
    zr = zoo_reference()
    for u, s in enumerate(zr.HCMA_UP_STRIDES):
        key = f"up_{u}/up/bias"
        if key in out:
            sums = out[key].reshape(-1, s ** 3).sum(axis=1)
            out[key] = np.repeat(sums, s ** 3).astype(out[key].dtype)
    return out


def labels(name: str) -> np.ndarray:
    """The seeded binary labels of ``name``'s input, (B, D, H, W) int32."""
    shape = zoo_reference().input_shape(name)[:4]
    rng = np.random.default_rng(LABEL_SEED)
    return (rng.random(shape) < 0.3).astype(np.int32)


def zoo_reference():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import zoo_reference as zr
    return zr


def jax_train_reference(names, bf16, f64, path: str,
                        params_path: str = "", moved=()) -> dict:
    """Write ``{name}/params/{flax path}`` (the step's start),
    ``{name}/loss``, ``{name}/grads/{path}``, ``{name}/stepped/{path}``
    (the parameters after one AdamW step), for the models in ``bf16``
    ``{name}/loss_bf16`` and ``{name}/grads_bf16/{path}``, and for those
    in ``f64`` ``{name}/loss64`` and ``{name}/grads64/{path}``, to
    ``path`` (if given); returns them. With ``params_path``, the
    ``{name}/params/...`` alone are written there as soon as every init is
    done (to a temporary name, then renamed), while the steps still
    compile. Call in a process whose XLA flags are set (``main``)."""
    import jax
    import jax.numpy as jnp
    from veloxseg_tpu.models.registry import load_model
    from veloxseg_tpu.train.loss import CompositeLoss
    from veloxseg_tpu.train.optim import build_optimizer
    from veloxseg_tpu.train.train_state import (_loss_grads_fn,
                                                create_train_state)
    zr = zoo_reference()

    def flat(tree):
        return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
                for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def init(name):
        """The step's start: the init at the test's input, moved by noise."""
        x = zr.model_input(name)
        model = load_model(name, {name: zr.config(name)})
        variables = jax.jit(model.init, static_argnames="train")(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, *x.shape[1:]), jnp.float32), train=True)
        params = zr.noisy(flat(variables["params"]))
        if name == "HCMA-UNet":
            params = zr.tie_hcma_up_bias(params)
        return name, params

    def step(name, params, dt):
        """The JAX trainer's step core in ``dt`` (None: fp32, then one
        AdamW step from its gradients)."""
        t0 = time.perf_counter()
        x, y = zr.model_input(name), labels(name)
        model = load_model(name, {name: zr.config(name)})
        state = create_train_state(model, zr.nest(params),
                                   build_optimizer("adamw", OPT))
        suffix = "" if dt is None else "_bf16"
        loss_grads = jax.jit(_loss_grads_fn(
            CompositeLoss(name, TRAIN_CFG), compute_dtype=dt))
        loss, _, grads = loss_grads(state, jnp.asarray(x), jnp.asarray(y),
                                    jax.random.PRNGKey(2))
        out = {f"{name}/loss{suffix}": np.float64(loss)}
        g = flat(grads)
        if name == "HCMA-UNet":
            g = tie_hcma_up_grads(g)
            grads = zr.nest(g)
        out.update({f"{name}/grads{suffix}/{k}": a for k, a in g.items()})
        if dt is None and name in moved:
            # the same compiled step on the input moved by 1e-7 relative
            loss_m, _, grads_m = loss_grads(
                state, jnp.asarray(zr.perturbed(x)), jnp.asarray(y),
                jax.random.PRNGKey(2))
            gm = flat(grads_m)
            if name == "HCMA-UNet":
                gm = tie_hcma_up_grads(gm)
            out[f"{name}/loss_moved"] = np.float64(loss_m)
            out.update({f"{name}/grads_moved/{k}": a for k, a in gm.items()})
        if dt is None:
            stepped = jax.jit(lambda s, g: s.apply_gradients(grads=g))(
                state, grads)
            out.update({f"{name}/stepped/{k}": a
                        for k, a in flat(stepped.params).items()})
        print(f"{name}{suffix}: loss {float(loss):.6f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out

    def step64(name, params, _):
        """The fp32 step's loss and gradients with the parameters, the
        input and every statistic in float64 (JAX's x64 mode and
        :func:`float64_statistics` on in this thread alone)."""
        t0 = time.perf_counter()
        _FLOAT64_THREAD.on = True
        try:
            with jax.enable_x64(True):
                x, y = zr.model_input(name), labels(name)
                model = load_model(name, {name: zr.config(name)})
                loss_obj = CompositeLoss(name, TRAIN_CFG)
                with lock:
                    float64_statistics()
                p64 = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a, jnp.float64), zr.nest(params))
                xd = jnp.asarray(x, jnp.float64)

                def f(p):
                    outs = model.apply({"params": p}, xd, train=True,
                                       rngs={"dropout": jax.random.PRNGKey(2)})
                    return loss_obj(outs, jnp.asarray(y), sr_labels=xd)

                loss, grads = jax.jit(jax.value_and_grad(f))(p64)
                g = flat(grads)
                if name == "HCMA-UNet":
                    g = tie_hcma_up_grads(g)
                out = {f"{name}/grads64/{k}": a for k, a in g.items()}
                out[f"{name}/loss64"] = np.float64(loss)
        finally:
            _FLOAT64_THREAD.on = False
        print(f"{name} float64: loss {float(loss):.9f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return out

    lock = threading.Lock()
    # every compile runs side by side (XLA compiles without the GIL): the
    # inits first, then each model's steps once its parameters are drawn
    out = {}
    n_tasks = len(names) * 2 + len(bf16) + len(f64)
    with ThreadPoolExecutor(max_workers=n_tasks) as pool:
        steps = []
        for fut in as_completed([pool.submit(init, n) for n in names]):
            name, params = fut.result()
            out.update({f"{name}/params/{k}": a for k, a in params.items()})
            for fn, dt, wanted in ((step, None, True),
                                   (step, jnp.bfloat16, name in bf16),
                                   (step64, None, name in f64)):
                if wanted:
                    steps.append(pool.submit(fn, name, params, dt))
        if params_path:
            tmp = params_path + ".partial.npz"
            np.savez(tmp, **out)
            os.replace(tmp, params_path)
        for fut in steps:
            out.update(fut.result())
    if path:
        np.savez(path, **out)
    return out


def load_reference(path: str) -> dict:
    """``{name: {"params"|"grads"|"stepped"|"grads_bf16": {flax path:
    array}, "loss": x[, "loss_bf16": x]}}`` of a written reference."""
    data = np.load(path)
    ref: dict = {}
    for key in data.files:
        name, rest = key.split("/", 1)
        entry = ref.setdefault(name, {})
        if "/" in rest:
            group, leaf = rest.split("/", 1)
            entry.setdefault(group, {})[leaf] = data[key]
        else:
            entry[rest] = float(data[key])
    return ref


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default=",".join(MODELS),
                    help="comma list of registry names")
    ap.add_argument("--bf16", default="",
                    help="comma list of the models also stepped in bf16")
    ap.add_argument("--f64", default="",
                    help="comma list of the models also stepped in float64")
    ap.add_argument("--out", help="the .npz to write")
    ap.add_argument("--params-out", default="",
                    help="an .npz to write the steps' start to first")
    ap.add_argument("--moved", default="",
                    help="comma list of the models whose fp32 step also "
                         "runs on the input moved by 1e-7 relative")
    ap.add_argument("--factor", action="store_true",
                    help="step in factor mode (the dropouts x·(1 + rate), "
                         "SuperLightNet's fold directions fixed)")
    args = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        flags += " --xla_allow_excess_precision=false"
    if "xla_backend_optimization_level" not in flags:
        flags += " --xla_backend_optimization_level=1"
    os.environ["XLA_FLAGS"] = flags.strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    if args.factor:
        factor_mode()
    jax_train_reference([n for n in args.models.split(",") if n],
                        {n for n in args.bf16.split(",") if n},
                        {n for n in args.f64.split(",") if n}, args.out,
                        args.params_out,
                        {n for n in args.moved.split(",") if n})
    return 0


if __name__ == "__main__":
    sys.exit(main())
