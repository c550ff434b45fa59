"""The port's serving export (``veloxseg_torch/infer/export.py``,
``cli/export_main.py``) against the JAX package's (``tests/test_export.py``)
on the CPU.

The model is ``tests/test_export.py``'s TINY with the branch set (1, 3, 5):
the port does not port the single-kernel JLC form (``nn/conv_blocks.JLC``
raises for it), and every config of the repo has three branches. The
weights are the JAX model's own, carried over by
``interop/jax_params.state_dict_from_jax``. One symbolic-batch export must
serve B = 1 and B = 3, agree with the JAX artifact from the same weights,
hold only ``aten`` operations, load and run in a process that imports only
``torch``, serve a second state dict without a new export, and come out of
the CLI alike from a ``.pth`` and from a JAX ``.ckpt``.
"""

import json
import operator
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import randomize_
from veloxseg_torch.interop.jax_params import state_dict_from_jax
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.infer.export import (export_eval, load_artifact,
                                         save_artifact)
from veloxseg_torch.ops import portable

TINY = {
    "input_size": (16, 16, 16), "patch_size": 4, "in_ch": (1, 1),
    "n_classes": 2, "base_ch": 4, "attn_base_ch": 4,
    "conv_depths": (1, 1), "kernel_sizes": (1, 3, 5),
    "min_dim_group": (4, 4), "conv_expansion_factor": (2, 2),
    "depths": (1, 1),
    "min_big_window_sizes": ((2, 2, 2), (2, 2, 2)),
    "min_small_window_sizes": ((1, 1, 1), (1, 1, 1)),
    "min_dim_head": (4, 4), "scale_factors": (2, 2),
    "num_heads": (1, 1), "ffn_expansion_ratio": (2, 2),
    "spatial_dim": 3,
}
CHANNELS = 2
BATCHES = (1, 3)


def _json(cfg):
    return json.loads(json.dumps(cfg))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX model's params, its artifact's outputs at B = 1 and 3 on
    seeded inputs, and its params as a JAX trainer ``.ckpt``."""
    from veloxseg_tpu.core.config import VeloxSegConfig
    from veloxseg_tpu.infer.export import export_eval as jax_export
    from veloxseg_tpu.nn.veloxseg import VeloxSeg
    from veloxseg_tpu.train.checkpoint import save_checkpoint

    model = VeloxSeg(VeloxSegConfig(**TINY))
    x0 = jnp.zeros((1, *TINY["input_size"], CHANNELS), jnp.float32)
    params = jax.jit(model.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x0, train=True)["params"]
    exported = jax_export(model, params, TINY["input_size"], CHANNELS)
    rng = np.random.default_rng(7)
    xs = {b: rng.standard_normal((b, *TINY["input_size"], CHANNELS))
          .astype(np.float32) for b in BATCHES}
    outs = {b: np.asarray(exported.call(params, jnp.asarray(x)))
            for b, x in xs.items()}
    ckpt = str(tmp_path_factory.mktemp("jax_ckpt") / "val_best.ckpt")
    save_checkpoint(ckpt, params)
    return dict(params=jax.device_get(params), xs=xs, outs=outs, ckpt=ckpt)


def _port_model(state_dict=None, seed=None):
    model, _ = build_veloxseg(TINY, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    if seed is not None:
        randomize_(model, seed, scale=0.2)
    return model.eval()


@pytest.fixture(scope="module")
def artifact(jax_side, tmp_path_factory):
    """One symbolic-batch export of the port's model with the JAX weights,
    saved and loaded back."""
    model = _port_model(state_dict_from_jax(jax_side["params"]))
    path = str(tmp_path_factory.mktemp("export") / "tiny.pt2")
    save_artifact(path, export_eval(model, TINY["input_size"], CHANNELS),
                  metadata={"model_name": "tiny"})
    program, state, meta = load_artifact(path)
    return dict(model=model, path=path, program=program, state=state,
                meta=meta)


def _call(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("b", BATCHES)
def test_round_trip_serves_any_batch(artifact, jax_side, b):
    assert artifact["meta"]["model_name"] == "tiny"
    x = jax_side["xs"][b]
    got = _call(artifact["program"].module(), x)
    assert got.shape == (b, *TINY["input_size"], TINY["n_classes"])
    # the same plain operations in the same order on the same CPU
    np.testing.assert_allclose(got, _call(artifact["model"], x), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("b", BATCHES)
def test_port_artifact_matches_jax_artifact(artifact, jax_side, b):
    got = _call(artifact["program"].module(), jax_side["xs"][b])
    ref = jax_side["outs"][b]
    # tests/test_torch_model.py's TINY eval-forward parity rule: fp32 both
    # sides, sums in another order (XLA's packed convs against torch's)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def test_pinned_batch_serves_that_batch_alone(artifact, jax_side):
    program = export_eval(artifact["model"], TINY["input_size"], CHANNELS,
                          batch=3)
    x = jax_side["xs"][3]
    np.testing.assert_allclose(_call(program.module(), x),
                               _call(artifact["model"], x), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(Exception):
        _call(program.module(), jax_side["xs"][1])


def test_graph_holds_only_aten_operations(artifact):
    # the counterpart of test_export_artifact_is_pure_stablehlo: every
    # operation is an aten op; the only other calls are Python's
    # getitem (a multi-output op's results) and integer arithmetic on the
    # symbolic batch
    allowed = {operator.getitem, operator.mul, operator.add,
               operator.floordiv, operator.sub}
    kinds = set()
    for node in artifact["program"].graph.nodes:
        if node.op != "call_function":
            continue
        t = node.target
        if isinstance(t, torch._ops.OpOverload):
            assert t.namespace == "aten", t
            kinds.add(t.name().split(".")[0])
        else:
            assert t in allowed, t
    assert {"aten::einsum", "aten::softmax", "aten::conv3d"} <= kinds
    # the parameters are inputs of the program (its state dict), not
    # constants
    specs = artifact["program"].graph_signature.input_specs
    params = [s.target for s in specs if s.kind.name == "PARAMETER"]
    assert set(params) <= set(artifact["state"])
    assert set(params) == {k for k, _ in artifact["model"].named_parameters()}


def test_artifact_loads_with_torch_alone(artifact, jax_side, tmp_path):
    x = jax_side["xs"][3]
    np.save(tmp_path / "x.npy", x)
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        program = torch.export.load({artifact['path']!r})
        x = torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r}))
        with torch.no_grad():
            y = program.module()(x)
        np.save({str(tmp_path / 'y.npy')!r}, y.numpy())
        assert "veloxseg_torch" not in sys.modules
        assert not any(m.startswith(("jax", "veloxseg")) for m in sys.modules)
        print("LOADED")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "LOADED" in r.stdout, r.stderr[-3000:]
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               _call(artifact["model"], x), rtol=1e-6,
                               atol=1e-6)


def test_second_state_dict_serves_without_export(artifact, jax_side):
    other = _port_model(seed=5)
    run = artifact["program"].module()
    run.load_state_dict(other.state_dict(), strict=True)
    x = jax_side["xs"][3]
    got, want = _call(run, x), _call(other, x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(got, _call(artifact["model"], x))


def _cli_configs(tmp_path):
    paths = {}
    for name, data in (
            ("models.json", {"VeloxSeg": _json(TINY)}),
            ("train.json", {"patch_size": {
                "AutoPETII": list(TINY["input_size"])},
                "save_path": str(tmp_path)})):
        paths[name] = str(tmp_path / name)
        with open(paths[name], "w") as f:
            json.dump(data, f)
    return paths


@pytest.mark.parametrize("form", ["pth", "ckpt"])
def test_export_cli(form, jax_side, tmp_path):
    from veloxseg_torch.cli.export_main import main as export_main

    ckpt_dir = tmp_path / "save"
    ckpt_dir.mkdir()
    if form == "pth":
        torch.save(state_dict_from_jax(jax_side["params"]),
                   ckpt_dir / "val_best.pth")
    else:
        os.symlink(jax_side["ckpt"], ckpt_dir / "val_best.ckpt")
    paths = _cli_configs(tmp_path)
    out = str(tmp_path / "veloxseg.pt2")
    export_main(["--dataset_name", "AutoPETII", "--model_name", "VeloxSeg",
                 "--model_config", paths["models.json"],
                 "--train_config", paths["train.json"],
                 "--checkpoint_dir", str(ckpt_dir), "--output", out,
                 "--device", "cpu"])
    program, _, meta = load_artifact(out)
    assert meta["patch_size"] == list(TINY["input_size"])
    assert meta["channels"] == CHANNELS and meta["device"] == "cpu"
    assert meta["checkpoint"].endswith(f"val_best.{form}")
    x = jax_side["xs"][3]      # a batch never named at export
    got, ref = _call(program.module(), x), jax_side["outs"][3]
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def _meta_calls():
    """Each eval kernel's wrapper on ``meta`` tensors (no data, no card):
    K1, K4f, K5f, K6."""
    from veloxseg_torch.ops import fused_jlc, pwa_attention, wkv
    e = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    q, bias, x = e(1, 1, 2, 4, 8), e(1, 8, 8), e(1, 4, 4, 4, 4)
    ws = [e(4, 2, k, k, k) for k in (1, 3, 5)]
    return {
        "K1": (pwa_attention.window_attention, "launches",
               lambda: pwa_attention.window_attention(q, q, q, bias, 0.5)),
        "K4f": (fused_jlc.jlc_stage1, "launches",
                lambda: fused_jlc.jlc_stage1(x, ws, [e(4)] * 3, 2)),
        "K5f": (fused_jlc.jlc_stage2, "launches",
                lambda: fused_jlc.jlc_stage2(x, e(8, 4, 1, 1, 1), e(8),
                                             e(4, 8, 1, 1, 1), e(4))),
        "K6": (wkv.wkv, "launches",
               lambda: wkv.wkv(e(4), e(4), e(1, 6, 4), e(1, 6, 4)))}


@pytest.mark.parametrize("kernel", ["K1", "K4f", "K5f", "K6"])
def test_portable_scope_takes_plain_versions_on_any_device(kernel):
    # outside the scope a tensor that is neither on the CPU nor on a card
    # is refused; inside it the plain version runs, and no launch counts
    wrapper, attr, call = _meta_calls()[kernel]
    with pytest.raises(ValueError, match="unsupported device"):
        call()
    before = getattr(wrapper, attr)
    with portable.portable_scope():
        y = call()
    assert y.device.type == "meta" and getattr(wrapper, attr) == before


def test_portable_scope_is_restored_after_an_exception():
    meta = torch.empty(0, device="meta")
    assert not portable.runs_plain(meta)
    with pytest.raises(KeyError):
        with portable.portable_scope():
            assert portable.runs_plain(meta)
            raise KeyError("inside")
    assert not portable.runs_plain(meta)
    with portable.portable_scope():
        with portable.portable_scope():
            pass
        assert portable.runs_plain(meta)  # the outer scope is still active
    assert not portable.runs_plain(meta)
    assert portable.runs_plain(torch.empty(0))      # the CPU, as ever
