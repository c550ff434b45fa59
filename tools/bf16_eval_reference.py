#!/usr/bin/env python3
"""The JAX package's eval forwards in bf16 and in fp32: the reference that
``tests/test_torch_bf16_eval.py`` holds the port's bf16 eval forwards
against, and the sizes behind its bound.

    python tools/bf16_eval_reference.py --out ref.npz   # the reference
    python tools/bf16_eval_reference.py --report        # the sizes

Two models, as the speed CLI runs them (``veloxseg_tpu/cli/speed_main.py``:
every floating parameter cast to bf16, a bf16 input): VeloxSeg at TINY with
the seeded weights of :func:`port_veloxseg`, attention and the JLC blocks
through the interpret-mode Pallas kernels whose bf16 forms the port's
kernels follow (``pwa_attention.set_force_interpret``,
``fused_jlc.set_force_interpret``: on the TPU the JLC blocks take XLA's
packed path, where Mosaic cannot lower the exact GELU, and that path rounds
elsewhere: ``tools/bf16_step_reference.py --report``); and U-RWKV at 32³
with its init parameters moved by seeded noise (:func:`jax_urwkv_params`;
WKV through ``wkv_scan``, which rounds as ``wkv_pallas`` does). Each on a batch of two,
once with the parameters and input in bf16 and once in fp32. Beside them,
the interpret-mode Pallas JLC stage-2 kernels (``_k2_fwd``, ``_k2_bwd``) on
bf16 operands (:func:`jax_stage2`), which K5f's and K5b's bf16 twins are
held to. It runs in a process of its own with XLA's excess precision off
(``--xla_allow_excess_precision=false``, set before JAX starts), so that
each bf16 operation rounds, as the port's eager ones do: with it on, XLA
drops the rounding of ``_gelu_exact``'s product before the dot of
``_k2_bwd_kernel``'s dW2.

``--report`` prints the port's bf16 and fp32 forwards' distances from the
JAX bf16 and fp32 ones (:func:`chip_measure.forward_distances`), for one
and for several intra-op threads.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

WEIGHT_SEED, WEIGHT_SCALE = 1, 0.2
URWKV_SEED, URWKV_NOISE = 3, 0.05
INPUT_SEEDS = {"veloxseg": 2, "urwkv": 4}
URWKV_SHAPE = (2, 32, 32, 32, 2)
DTYPES = ("bf16", "fp32")
# (C, E, edge) of the stage-2 cases, B = 2: AutoPET-II's L0 widths at 8³
# and a narrower level
STAGE2_CASES = ((16, 3, 8), (8, 2, 6))


def stage2_case(c: int, e: int, s: int):
    """fp32 (x, g, w1, b1, w2, b2) of one stage-2 case: x and g
    channels-last (2, s, s, s, C), w1 (C, E·C) and w2 (E·C, C) as Dense
    kernels."""
    from torch_port_helpers import normal
    hid = e * c
    return (normal((2, s, s, s, c), 51, 1.5), normal((2, s, s, s, c), 52, 1.5),
            normal((c, hid), 53, (2.0 / c) ** 0.5), normal((hid,), 54, 0.3),
            normal((hid, c), 55, (2.0 / hid) ** 0.5), normal((c,), 56, 0.3))


def jax_stage2(c: int, e: int, s: int) -> dict:
    """``_k2_fwd`` and ``_k2_bwd`` in interpret mode on the bf16 operands of
    :func:`stage2_case`, as ``jlc_block`` packs them: ``out`` and ``dx``
    (bf16 values, channels-last), and the weight gradients of the logical
    weights, ``dw1`` (C, E·C), ``db1``, ``dw2`` (E·C, C), ``db2``: the
    kernel's fp32 block-diagonal sums folded over the 8 parities in fp32."""
    import jax.numpy as jnp
    from veloxseg_tpu.ops import fused_jlc as jjlc
    from veloxseg_tpu.ops import packed_conv
    x, g, w1, b1, w2, b2 = (jnp.asarray(a).astype(jnp.bfloat16)
                            for a in stage2_case(c, e, s))
    hid = e * c
    eye = jnp.eye(8, dtype=w1.dtype)
    big1 = (w1[None, :, None, :] * eye[:, None, :, None]).reshape(
        8 * c, 8 * hid)
    big2 = (w2[None, :, None, :] * eye[:, None, :, None]).reshape(
        8 * hid, 8 * c)
    b1t = packed_conv.tile_bias(b1, 1)[None, :]
    b2t = packed_conv.tile_bias(b2, 1)[None, :]
    xp = packed_conv.pack_s2d(x)
    out = jjlc._k2_fwd(xp, big1, b1t, big2, b2t, interpret=True)
    dx, dbig1, db1t, dbig2, db2t = jjlc._k2_bwd(
        xp, big1, b1t, big2, packed_conv.pack_s2d(g), interpret=True)

    def fold(big, rows, cols):  # the diagonal blocks: the packing's VJP
        a = np.asarray(big).reshape(8, rows, 8, cols)
        return sum(a[r, :, r, :] for r in range(8))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return {"out": f32(packed_conv.unpack_s2d(out, c)),
            "dx": f32(packed_conv.unpack_s2d(dx, c)),
            "dw1": fold(dbig1, c, hid),
            "db1": np.asarray(db1t).reshape(8, hid).sum(0),
            "dw2": fold(dbig2, hid, c),
            "db2": np.asarray(db2t).reshape(8, c).sum(0)}


def veloxseg_input() -> np.ndarray:
    from torch_port_helpers import TINY, normal
    return normal((2, *TINY["input_size"], sum(TINY["in_ch"])),
                  INPUT_SEEDS["veloxseg"])


def urwkv_input() -> np.ndarray:
    from torch_port_helpers import normal
    return normal(URWKV_SHAPE, INPUT_SEEDS["urwkv"])


def port_veloxseg():
    """The port's TINY VeloxSeg with the seeded weights both sides use."""
    from torch_port_helpers import TINY, configs, randomize_
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    tcfg, _ = configs(TINY)
    model, _ = build_veloxseg(tcfg, device="cpu")
    return randomize_(model, WEIGHT_SEED, scale=WEIGHT_SCALE)


def jax_urwkv_params():
    """U-RWKV's JAX init parameters at 32³, every leaf moved by seeded
    noise (the norms' weights and biases included), as a flat
    ``{"a/b/c": array}``."""
    import jax
    import jax.numpy as jnp
    from veloxseg_tpu.models.zoo import urwkv as jurwkv
    params = jax.jit(jurwkv.URWKV(num_classes=2).init,
                     static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, *URWKV_SHAPE[1:]), jnp.float32),
        train=False)["params"]
    rng = np.random.default_rng(URWKV_SEED)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_flatten_with_path(params)[0]}
    return {k: a + URWKV_NOISE * rng.standard_normal(a.shape).astype(
        np.float32) for k, a in sorted(flat.items())}


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


def port_urwkv(flat: dict):
    """The port's U-RWKV holding the JAX parameters ``flat``."""
    from veloxseg_torch.interop.zoo_params import urwkv_state_dict_from_jax
    from veloxseg_torch.models.zoo.urwkv import URWKV
    model = URWKV(2, 2)
    model.load_state_dict(urwkv_state_dict_from_jax(nest(flat)), strict=True)
    return model.eval()


def jax_reference(path: str) -> None:
    """Write the JAX outputs (``{model}/{dtype}``) and U-RWKV's parameters
    (``urwkv_params/{path}``) to ``path``. Call in a process whose XLA flags
    are set (``main``)."""
    import jax
    import jax.numpy as jnp
    from torch_port_helpers import TINY, configs
    from veloxseg_tpu.interop.torch_import import convert_state_dict
    from veloxseg_tpu.models.zoo import urwkv as jurwkv
    from veloxseg_tpu.nn.veloxseg import VeloxSeg as JaxVeloxSeg
    from veloxseg_tpu.ops import fused_jlc as jjlc
    from veloxseg_tpu.ops import pwa_attention as jpa

    def cast(tree, dtype):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)

    _, jcfg = configs(TINY)
    vparams = convert_state_dict(port_veloxseg().state_dict())
    uflat = jax_urwkv_params()
    models = {
        "veloxseg": (JaxVeloxSeg(jcfg), vparams, veloxseg_input()),
        "urwkv": (jurwkv.URWKV(num_classes=2), nest(uflat), urwkv_input())}
    def stage2(case):
        return {"k5/{}_{}_{}/{}".format(*case, k): a
                for k, a in jax_stage2(*case).items()}

    def forward(name, dname, dt):
        model, params, x = models[name]
        y = jax.jit(lambda p, v: model.apply({"params": p}, v, train=False))(
            cast(params, dt), jnp.asarray(x, dt))
        return {f"{name}/{dname}": np.asarray(y.astype(jnp.float32))}

    out = {f"urwkv_params/{k}": a for k, a in uflat.items()}
    jpa.set_force_interpret(True)
    jjlc.set_force_interpret(True)
    try:
        # every case and forward side by side (XLA compiles without the
        # GIL); the stage-2 cases name interpret mode themselves
        with ThreadPoolExecutor() as pool:
            parts = [pool.submit(stage2, case) for case in STAGE2_CASES]
            parts += [pool.submit(forward, name, dname, dt)
                      for name in models for dname, dt in
                      zip(DTYPES, (jnp.bfloat16, jnp.float32))]
            for part in parts:
                out.update(part.result())
    finally:
        jpa.set_force_interpret(False)
        jjlc.set_force_interpret(False)
    np.savez(path, **out)


def load_reference(path: str) -> dict:
    """``{"veloxseg": {"bf16": y, "fp32": y}, "urwkv": {...},
    "urwkv_params": {path: array}, "k5": {(C, E, edge): {name: array}}}``
    of a written reference."""
    data = np.load(path)
    ref: dict = {"urwkv_params": {}, "k5": {}}
    for key in data.files:
        head, rest = key.split("/", 1)
        if head == "urwkv_params":
            ref[head][rest] = data[key]
        elif head == "k5":
            case, name = rest.split("/")
            ref[head].setdefault(tuple(int(v) for v in case.split("_")),
                                 {})[name] = data[key]
        else:
            ref.setdefault(head, {})[rest] = data[key]
    return ref


def port_forward(name: str, ref: dict, dtype):
    """The port's eval forward of ``name`` on the CPU in ``dtype``, as the
    speed CLI runs it (``model.to(dtype)``, the input in ``dtype``), as a
    float64 array."""
    import torch
    model = (port_veloxseg() if name == "veloxseg"
             else port_urwkv(ref["urwkv_params"])).to(dtype)
    x = veloxseg_input() if name == "veloxseg" else urwkv_input()
    with torch.inference_mode():
        y = model(torch.from_numpy(x).to(dtype))
    return y.double().numpy()


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
        from chip_measure import forward_distances
        path = os.path.join(tempfile.mkdtemp(), "ref.npz")
        jax_reference(path)
        ref = load_reference(path)
        for threads in (1, 2, 4):
            torch.set_num_threads(threads)
            for name in ("veloxseg", "urwkv"):
                for label, dt in (("bf16", torch.bfloat16),
                                  ("fp32", torch.float32)):
                    d = forward_distances(port_forward(name, ref, dt),
                                          ref[name]["bf16"],
                                          ref[name]["fp32"])
                    print(f"{threads} threads, {name}, port {label}: "
                          + ", ".join(f"{k} {v:.4f}" for k, v in d.items()),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
