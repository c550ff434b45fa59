#!/usr/bin/env python3
"""The JAX package's TINY train step in bf16 and in fp32: the reference that
``tests/test_torch_bf16.py`` holds the port's bf16 step against, and the
sizes behind its bound.

    python tools/bf16_step_reference.py --out ref.npz   # the reference
    python tools/bf16_step_reference.py --report        # the sizes

The reference: ``train_state._loss_grads_fn`` (the forward, loss and fp32
gradients that ``train_step_fn`` and ``train_accum_step_fn`` are built on)
at ``compute_dtype`` bf16 and None, on two batches, at TINY with every
dropout 0 and the seeded weights of :func:`port_model`. Attention runs
through the interpret-mode Pallas train kernels, as on the TPU
(``pwa_attention.set_force_interpret``); the JLC blocks take the XLA packed
path, as on the TPU, where ``fused_jlc.usable`` is False. It runs in a
process of its own with XLA's excess precision off
(``--xla_allow_excess_precision=false``, set before JAX starts), so that
each bf16 operation of the JAX step rounds, as the port's eager ones do:
with it on, XLA keeps whole chains of bf16 operations in fp32 on the CPU.

``--report`` prints, for the single step and the two-batch accumulation,
the port's bf16 step's distances from the JAX bf16 and fp32 steps relative
to the JAX step's own bf16-to-fp32 distance (:func:`distances`), the same
for a port step that ignores ``compute_dtype`` (fp32), and the JAX JLC
block's XLA path against its interpret-mode Pallas kernels in bf16.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

# config/train_config_bs4.json's loss weights
TRAIN_CFG = {"deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
             "Feature_Loss_weight": 2.0}
BATCH_SEEDS = (2, 4)            # the two batches (accumulation: both)
WEIGHT_SEED, WEIGHT_SCALE = 1, 0.2
DTYPES = ("bf16", "fp32")


def no_drop_config():
    from torch_port_helpers import TINY
    return dict(TINY, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
                drop_path=0.0)


def batch(seed: int):
    """(x (2, 32³, 2) fp32, labels (2, 32³) int32) of one seed."""
    from torch_port_helpers import normal
    x = normal((2, 32, 32, 32, 2), seed)
    y = (np.random.default_rng(seed + 1).random((2, 32, 32, 32))
         < 0.3).astype(np.int32)
    return x, y


def port_model():
    """The port's TINY model with the seeded weights both sides start
    from."""
    from torch_port_helpers import configs, randomize_
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    tcfg, _ = configs(no_drop_config())
    model, _ = build_veloxseg(tcfg, device="cpu")
    return randomize_(model, WEIGHT_SEED, scale=WEIGHT_SCALE), tcfg


def jax_reference(path: str) -> None:
    """Write the JAX losses and gradients (port keys) of every batch and
    compute dtype to ``path`` (``{dtype}/{batch}/loss``, ``{dtype}/{batch}/
    {key}``). Call in a process whose XLA flags are set (``main``)."""
    import jax
    import jax.numpy as jnp
    import optax
    from veloxseg_torch.interop.jax_params import state_dict_from_jax
    from veloxseg_tpu.interop.torch_import import convert_state_dict
    from veloxseg_tpu.nn.veloxseg import VeloxSeg as JaxVeloxSeg
    from veloxseg_tpu.ops import pwa_attention as jpa
    from veloxseg_tpu.train import loss as jloss
    from veloxseg_tpu.train import train_state as jts
    from torch_port_helpers import configs

    model, _ = port_model()
    _, jcfg = configs(no_drop_config())
    params = jax.tree_util.tree_map(jnp.array,
                                    convert_state_dict(model.state_dict()))
    state = jts.create_train_state(JaxVeloxSeg(jcfg), params,
                                   optax.adamw(1e-3))
    loss_obj = jloss.CompositeLoss("VeloxSeg", TRAIN_CFG)
    out = {}
    jpa.set_force_interpret(True)
    try:
        for name, dt in zip(DTYPES, (jnp.bfloat16, None)):
            lg = jax.jit(jts._loss_grads_fn(loss_obj, dt))
            for i, seed in enumerate(BATCH_SEEDS):
                x, y = batch(seed)
                loss, _, grads = lg(state, jnp.asarray(x), jnp.asarray(y),
                                    jax.random.PRNGKey(0))
                out[f"{name}/{i}/loss"] = np.float64(loss)
                for k, g in state_dict_from_jax(
                        jax.device_get(grads)).items():
                    out[f"{name}/{i}/{k}"] = g.numpy()
    finally:
        jpa.set_force_interpret(False)
    np.savez(path, **out)


def load_reference(path: str) -> dict:
    """``{(dtype, batch): (loss, {key: array})}`` of a written reference."""
    data = np.load(path)
    ref = {}
    for name in DTYPES:
        for i in range(len(BATCH_SEEDS)):
            pre = f"{name}/{i}/"
            ref[name, i] = (float(data[pre + "loss"]),
                            {k[len(pre):]: data[k] for k in data.files
                             if k.startswith(pre) and k != pre + "loss"})
    return ref


def reference_case(ref: dict, case: str) -> dict:
    """The JAX bf16 and fp32 (loss, grads) of one case: ``"step"``, the
    first batch; ``"accum"``, the two batches' mean, as
    ``train_accum_step_fn`` sums them in fp32 and divides."""
    out = {}
    for name in DTYPES:
        if case == "step":
            out[name] = ref[name, 0]
        else:
            (l0, g0), (l1, g1) = ref[name, 0], ref[name, 1]
            out[name] = ((l0 + l1) / 2,
                         {k: (g0[k] + g1[k]) / np.float32(2) for k in g0})
    return out


def port_step(case: str, compute_dtype):
    """The port's (loss, {key: fp32 gradient}) of one case on the CPU:
    ``train_step_fn`` on the first batch, or ``train_accum_step_fn`` over
    both; the gradient the optimizer was handed (``p.grad``)."""
    import torch
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.optim import build_optimizer
    from veloxseg_torch.train import train_state as tts
    model, tcfg = port_model()
    state = tts.create_train_state(model, build_optimizer(
        "adamw", {"lr": 1e-3}, model.parameters()))
    loss_obj = CompositeLoss("VeloxSeg", TRAIN_CFG,
                             num_modal=tcfg.num_modalities)
    batches = [batch(s) for s in BATCH_SEEDS]
    if case == "step":
        step = tts.train_step_fn(loss_obj, "cpu",
                                 compute_dtype=compute_dtype)
        x, y = batches[0]
    else:
        step = tts.train_accum_step_fn(loss_obj, "cpu",
                                       compute_dtype=compute_dtype)
        x = np.stack([b[0] for b in batches])
        y = np.stack([b[1] for b in batches])
    _, aux = step(state, torch.from_numpy(x), torch.from_numpy(y).long(),
                  None)
    return float(aux["loss"]), {k: p.grad.double().numpy()
                                for k, p in model.named_parameters()}


def distances(port: tuple, jax_case: dict) -> dict:
    """The port's (loss, grads) against the JAX bf16 and fp32 steps
    (``chip_measure.step_distances``)."""
    from chip_measure import step_distances
    return step_distances(port, jax_case["bf16"], jax_case["fp32"])


def jlc_gap() -> dict:
    """The JAX JLC block at one shape (C 16, groups 4, expansion 3, B 2,
    8³, the TINY-sized L0 of AutoPET-II's widths) in bf16: its XLA packed
    path against its interpret-mode Pallas kernels (``fused_jlc``), and
    the XLA path's bf16 against its fp32 output: the largest difference
    over the output's largest magnitude, and the share of the two bf16
    outputs' elements that differ."""
    import jax
    import jax.numpy as jnp
    from veloxseg_tpu.nn.conv_blocks import JLC
    from veloxseg_tpu.ops import fused_jlc
    from torch_port_helpers import normal
    blk = JLC(kernel_sizes=(1, 3, 5), groups=4, expansion_factor=3)
    x = jnp.asarray(normal((2, 8, 8, 8, 16), 7))
    params = blk.init(jax.random.PRNGKey(0), x, True)
    # seeded weights in place of the init, as the tests randomize
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(rng.standard_normal(t.shape).astype(np.float32) * 0.3)
        for t in leaves])

    def run(dtype, pallas):
        fused_jlc.set_force_interpret(pallas)
        try:
            p = jax.tree_util.tree_map(lambda t: t.astype(dtype), params)
            return np.asarray(jax.jit(lambda p, x: blk.apply(p, x, True))(
                p, x.astype(dtype)).astype(jnp.float32))
        finally:
            fused_jlc.set_force_interpret(False)

    xla16, pallas16, xla32 = (run(jnp.bfloat16, False),
                              run(jnp.bfloat16, True),
                              run(jnp.float32, False))
    scale = float(np.abs(xla32).max())
    return {"xla_vs_pallas_bf16": float(np.abs(xla16 - pallas16).max())
            / scale,
            "xla_vs_pallas_differ": float((xla16 != pallas16).mean()),
            "bf16_vs_fp32": float(np.abs(xla16 - xla32).max()) / scale}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write the reference to this .npz")
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        os.environ["XLA_FLAGS"] = \
            f"{flags} --xla_allow_excess_precision=false".strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if args.out:
        jax_reference(args.out)
    if args.report:
        import tempfile

        import torch
        path = os.path.join(tempfile.mkdtemp(), "ref.npz")
        jax_reference(path)
        ref = load_reference(path)
        for case in ("step", "accum"):
            jc = reference_case(ref, case)
            for label, dt in (("port bf16", torch.bfloat16),
                              ("port ignoring compute_dtype", None)):
                d = distances(port_step(case, dt), jc)
                print(f"{case}, {label}: " + ", ".join(
                    f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in d.items()), flush=True)
        print("JLC block, bf16: " + ", ".join(
            f"{k} {v:.3e}" for k, v in jlc_gap().items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
