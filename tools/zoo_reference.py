#!/usr/bin/env python3
"""The JAX package's zoo baselines at 32³: the parameters and eval
forwards that ``tests/test_torch_baselines_conv.py`` and
``tests/test_torch_baselines_vit.py`` hold the port's models against.

    python tools/zoo_reference.py --models UNet,MedNeXt --bf16 MedNeXt \\
        --out ref.npz
    python tools/zoo_reference.py --report --models SegFormer,UNETRpp

Each model is built by ``veloxseg_tpu.models.registry.load_model`` from
its published AutoPET-II entry (``config/models_config_autopetii.json``)
with the size keys set to the test's input size (:data:`SIZE_KEYS`: 32³,
NestedFormer's (48, 48, 32), whose published window (3, 3, 2) must divide
its 1/16 bottleneck; SlimUNETR's ``embedding_dim`` to the one bottleneck
token of a 32³ input), initialized
jitted from ``PRNGKey(0)`` with ``train=True`` as the JAX serving driver
initializes it (so UNETRpp's deep-supervision heads are in the tree), and
then every leaf is moved by seeded noise (:func:`noisy`: half the leaf's
own spread, or 0.05 where the init is a constant), so that no bias, norm,
position table or transposed-conv kernel sits at a value a wrong layout
would also reproduce; HCMA-UNet's up-projection biases are then tied
within each group of s³ (:func:`tie_hcma_up_bias`), so that they are a
reference bias repeated, as its import makes them. The eval forward
(``train=False``) runs on a seeded (2, 32, 32, 32, 2) input
(:func:`input_shape`: :data:`BATCH` for the few that need more) in
fp32 and, for the models named by ``--bf16``, with the parameters and the
input in bf16, as the speed CLI runs it; for those named by ``--f64``,
also in float64 (JAX's x64 mode; the JAX norms still take their
statistics in fp32).

Some of the models are ill-conditioned at 32³ (``--report`` prints, per
model, how far a 1e-7 relative change of the input moves the fp32
output, and, for those run in float64, the fp32 output's distance from
it): UNETRpp's, A2FSeg's and U-KAN's deepest levels are one voxel, whose
batch norms at B = 2 normalize two values, so they run at B = 4;
SegFormer's unscaled attention scores (divided by √heads, 1 at its first
stage) make its softmax steep at any batch, so it is also compared in
float64. SuperLightNet's LayerNorms over 12 channels and HCMA-UNet's over
the 2 channels of its narrowest scan branches amplify the rounding of
their inputs, which the JAX norms' fp32 statistics (one-pass sums over
32³ voxels) set: the JAX fp32 forward's distance from its float64 one is
the figure they are held by.

It runs in a process of its own with XLA's excess precision off
(``--xla_allow_excess_precision=false``, set before JAX starts), so that
each bf16 operation rounds, as the port's eager ones do, and with LLVM at
optimization level 1 (``--xla_backend_optimization_level=1``): a third
less compile CPU than the default level (the mixed file's four models:
451 against 693 CPU-s), which the test suite's time needs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPE = (2, 32, 32, 32, 2)
BATCH = {"UNETRpp": 4, "A2FSeg": 4, "U-KAN": 4}
# the models whose input is not SHAPE's 32³: NestedFormer's published
# window (3, 3, 2) must divide its 1/16 bottleneck
SPATIAL = {"NestedFormer": (48, 48, 32)}
INPUT_SEED = 5
NOISE_SEED = 6
# the entries' size keys, set to the test's input size
SIZE_KEYS = {"UNETR": {"img_size": [32, 32, 32]},
             "UNETRpp": {"patch_size": [32, 32, 32]},
             "SlimUNETR": {"embedding_dim": 1},
             "SwinUNETR": {"img_size": [32, 32, 32]},
             "VSmTrans": {"img_size": [32, 32, 32]},
             "NestedFormer": {"image_size": [48, 48, 32]},
             "HDense": {"image_size": [32, 32, 32]},
             "U-KAN": {"img_size": [32, 32, 32]},
             "HCMA-UNet": {"patch_ini": [32, 32, 32]}}
# HCMA-UNet's up-projections (``up_{u}/up``, stride (1, 2, 2, 2)[u]): a
# Dense of width O·s³ whose bias is the reference's O values each
# repeated s³ times
HCMA_UP_STRIDES = (1, 2, 2, 2)


def config(name: str) -> dict:
    """The published AutoPET-II entry of ``name`` at the test's size (the
    port's SwinUNETR also reads ``img_size``, which the JAX builder
    ignores)."""
    with open(os.path.join(ROOT, "config", "models_config_autopetii.json"),
              encoding="utf-8") as f:
        entry = dict(json.load(f)[name])
    entry.update(SIZE_KEYS.get(name, {}))
    return entry


def input_shape(name: str = "") -> tuple:
    """(B, D, H, W, 2) of ``name``: B = 2 but where :data:`BATCH` says
    more, 32³ but where :data:`SPATIAL` says otherwise."""
    return (BATCH.get(name, SHAPE[0]),) + SPATIAL.get(name, SHAPE[1:4]) \
        + SHAPE[4:]


def model_input(name: str = "") -> np.ndarray:
    """The seeded input of ``name`` (:func:`input_shape`; the first two
    samples of a larger batch are the B = 2 input's)."""
    rng = np.random.default_rng(INPUT_SEED)
    return rng.standard_normal(input_shape(name)).astype(np.float32)


def perturbed(x: np.ndarray, rel: float = 1e-7) -> np.ndarray:
    """``x`` with each element moved by a seeded relative ``rel``."""
    rng = np.random.default_rng(INPUT_SEED + 100)
    return (x * (1 + rel * rng.standard_normal(x.shape))).astype(np.float32)


def noisy(flat: dict, seed: int = NOISE_SEED) -> dict:
    """Every leaf plus N(0, s²) noise, ``s`` half the leaf's spread, or
    0.05 for a constant leaf (biases, norms, position tables, gammas)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, a in sorted(flat.items()):
        s = 0.5 * float(a.std()) if a.size > 1 and a.std() > 0 else 0.05
        out[k] = (a + s * rng.standard_normal(a.shape)).astype(np.float32)
    return out


def tie_hcma_up_bias(flat: dict) -> dict:
    """HCMA-UNet's noisy params with each up-projection bias's groups of
    s³ set to their first value, so that they lie in the reference's
    space, which ``veloxseg_torch.interop.zoo_params`` inverts (it raises
    on any other)."""
    out = dict(flat)
    for u, s in enumerate(HCMA_UP_STRIDES):
        key = f"up_{u}/up/bias"
        groups = out[key].reshape(-1, s ** 3)
        out[key] = np.repeat(groups[:, 0], s ** 3).astype(np.float32)
    return out


def nest(flat: dict) -> dict:
    """``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, a in flat.items():
        *head, last = key.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = a
    return out


def jax_reference(names, bf16, f64, path: str) -> dict:
    """Write ``{name}/params/{flax path}``, ``{name}/fp32`` and, for the
    models in ``bf16`` and ``f64``, ``{name}/bf16`` and ``{name}/fp64``
    (the outputs as float32, float64), and ``{name}/fp32_perturbed`` (the
    fp32 forward of :func:`perturbed` input) to ``path`` (if given);
    returns them. Call in a process whose XLA flags are set (``main``)."""
    import jax
    import jax.numpy as jnp
    from veloxseg_tpu.models.registry import load_model

    out = {}
    for name in names:
        x = model_input(name)
        model = load_model(name, {name: config(name)})
        variables = jax.jit(model.init, static_argnames="train")(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, *input_shape(name)[1:]), jnp.float32), train=True)
        flat = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
                for p, a in jax.tree_util.tree_flatten_with_path(
                    variables["params"])[0]}
        flat = noisy(flat)
        if name == "HCMA-UNet":
            flat = tie_hcma_up_bias(flat)
        out.update({f"{name}/params/{k}": a for k, a in flat.items()})
        apply = jax.jit(lambda p, v, m=model: m.apply({"params": p}, v,
                                                      train=False))
        params = nest(flat)
        runs = [("fp32", jnp.float32, x),
                ("fp32_perturbed", jnp.float32, perturbed(x))]
        if name in bf16:
            runs.append(("bf16", jnp.bfloat16, x))
        if name in f64:
            runs.append(("fp64", jnp.float64, x))
        for label, dt, v in runs:
            cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                          params)
            y = apply(cast, jnp.asarray(v, dt))
            out[f"{name}/{label}"] = np.asarray(
                y, np.float64 if dt == jnp.float64 else np.float32)
        print(f"{name}: {len(flat)} leaves, output "
              f"{out[f'{name}/fp32'].shape}", flush=True)
    if path:
        np.savez(path, **out)
    return out


def load_reference(path: str) -> dict:
    """``{name: {"params": {flax path: array}, "fp32": y[, "bf16": y]}}``
    of a written reference."""
    data = np.load(path)
    ref: dict = {}
    for key in data.files:
        name, rest = key.split("/", 1)
        entry = ref.setdefault(name, {"params": {}})
        if rest.startswith("params/"):
            entry["params"][rest[len("params/"):]] = data[key]
        else:
            entry[rest] = data[key]
    return ref


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", required=True,
                    help="comma list of registry names")
    ap.add_argument("--bf16", default="",
                    help="comma list of the models also run in bf16")
    ap.add_argument("--f64", default="",
                    help="comma list of the models also run in float64")
    ap.add_argument("--out", help="the .npz to write")
    ap.add_argument("--report", action="store_true",
                    help="print each model's fp32 sensitivity")
    args = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_allow_excess_precision" not in flags:
        flags += " --xla_allow_excess_precision=false"
    if "xla_backend_optimization_level" not in flags:
        flags += " --xla_backend_optimization_level=1"
    os.environ["XLA_FLAGS"] = flags.strip()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    f64 = {n for n in args.f64.split(",") if n}
    if f64:
        import jax
        jax.config.update("jax_enable_x64", True)
    names = [n for n in args.models.split(",") if n]
    out = jax_reference(names, {n for n in args.bf16.split(",") if n}, f64,
                        args.out)
    if args.report:
        for name in names:
            y, yp = out[f"{name}/fp32"], out[f"{name}/fp32_perturbed"]
            scale = np.abs(y).max()
            line = (f"{name}: a 1e-7 relative input change moves the fp32 "
                    f"output by {np.abs(yp - y).max() / scale:.3e} of its "
                    f"largest magnitude")
            if name in f64:
                own = np.abs(out[f"{name}/fp64"] - y).max() / scale
                line += f"; it lies {own:.3e} from the float64 output"
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
