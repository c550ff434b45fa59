"""The port's conv baselines of the zoo (UNet, VNet, MedNeXt) against the
JAX package on the CPU, and the entry points that serve all eight zoo
models the port holds.

- The eval forward of each, at its published AutoPET-II config, with the
  JAX model's parameters (``init`` from ``PRNGKey(0)``, every leaf moved by
  seeded noise) carried across by its ``zoo_params`` function, on a seeded
  (2, 32, 32, 32, 2) input: fp32 within 1e-4 of the JAX logits' largest
  magnitude; MedNeXt (per-channel GroupNorm, exact GELU, depthwise
  transposed convs) also in bf16, held to ``chip_measure.FORWARD_BOUND``
  as ``test_torch_bf16_eval.py`` holds VeloxSeg's. The JAX side runs in a
  process of its own (``tools/zoo_reference.py``, XLA's excess precision
  off), started with this file's first test.
- MedNeXt's weights round trip: the port's state dict through the JAX
  package's ``convert_zoo_state_dict`` gives the JAX parameters bit for
  bit, every leaf.
- ``load_params`` reads a JAX ``.ckpt`` and a port ``.pth`` for each of the
  three; a model class with no checkpoint format raises.
- The blocks on odd shapes: the transposed convolution (the JAX module
  runs its kernel flipped over the dilated input) and the GroupNorm (fp32;
  bf16 bit for bit against the JAX one run op by op).
- Every one of the eight builds from all three published model configs,
  with the JAX speed CLI's parameter count, and none builds without CUDA
  unless the CPU is asked for; the speed CLI runs two of them on the CPU;
  ``FlopCounterMode`` counts transposed convolutions and the attention's
  matrix products.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_zoo_load_params,
                                assert_zoo_round_trip, jax_eval_params,
                                normal, zoo_forward, zoo_port_model)
from veloxseg_torch.models.registry import load_model
from veloxseg_torch.models.zoo import common as port_common
from veloxseg_torch.train import checkpoint as port_ckpt
from veloxseg_tpu.models.zoo import common as jax_common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import zoo_reference as zr  # noqa: E402
from chip_measure import FORWARD_BOUND, forward_distances  # noqa: E402

MODELS = ("UNet", "VNet", "MedNeXt")
BF16_MODELS = ("UNet", "VNet", "MedNeXt")
ZOO = ("UNet", "VNet", "MedNeXt", "UNETR", "SwinUNETR", "SegFormer",
       "SlimUNETR", "UNETRpp")
# the datasets' input shapes (``speed_main.INPUT_SIZE``) and config files
DATASETS = {"autopetii": (96, 96, 96, 2), "hecktor2022": (128, 128, 64, 2),
            "brats2021": (96, 96, 96, 4)}
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    path = tmp_path_factory.mktemp("zoo_conv") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "zoo_reference.py"),
         "--models", ",".join(MODELS), "--bf16", ",".join(BF16_MODELS),
         "--out", str(path)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(jax_reference_process):
    proc, path = jax_reference_process
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, out.decode(errors="replace")[-4000:]
    return zr.load_reference(str(path))


# ---------------------------------------------------------------------------
# The blocks on odd shapes

def _jax_apply(module, params, x):
    return np.asarray(module.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("c_in,c_out,k,s,p,groups,size", [
    (3, 5, 2, 2, 0, 1, (3, 5, 4)),        # UNet's, UNETR's deconvs
    (6, 6, 3, 2, 1, 6, (3, 4, 5)),        # MedNeXt's depthwise up
    (4, 3, 1, 2, 0, 1, (5, 3, 4)),        # MedNeXt's 1×1 residual up
    (5, 5, 4, 4, 0, 5, (2, 3, 1)),        # SlimUNETR's depthwise diffusion
    (4, 6, 3, 2, 1, 1, (3, 3, 5))])
def test_conv_transpose_matches_jax(c_in, c_out, k, s, p, groups, size):
    from veloxseg_torch.interop.zoo_params import _conv3d, _convT
    x = normal((2, *size, c_in), 11)
    mod = jax_common.ConvTranspose3d(c_out, k, s, padding=p, groups=groups)
    params = {"kernel": normal((k, k, k, c_in // groups, c_out), 12),
              "bias": normal((c_out,), 13)}
    want = _jax_apply(mod, params, x)
    port = port_common.ConvTranspose3d(c_in, c_out, k, s, p, groups)
    # a depthwise kernel (k, k, k, 1, C) takes the conv permutation
    tf = _conv3d if groups == c_in and c_in == c_out and groups > 1 \
        else _convT
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            tf(params["kernel"]))))
        port.bias.copy_(torch.from_numpy(params["bias"]))
        got = torch.movedim(port(torch.movedim(torch.from_numpy(x), -1, 1)),
                            1, -1).numpy()
    assert got.shape == want.shape == (2, *((n - 1) * s - 2 * p + k
                                            for n in size), c_out)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups,dtype", [(1, "fp32"), (6, "fp32"),
                                          (2, "fp32"), (1, "bf16"),
                                          (6, "bf16"), (3, "bf16")])
def test_group_norm_matches_jax(groups, dtype):
    x = normal((2, 3, 5, 4, 6), 21, 3.0) + 2.0        # channels-last
    w, b = normal((6,), 22, 0.5) + 1.0, normal((6,), 23, 0.5)
    port = port_common.GroupNorm(groups, 6)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
        port.bias.copy_(torch.from_numpy(b))
    mod = jax_common.GroupNorm(num_groups=groups)
    if dtype == "fp32":
        want = _jax_apply(mod, {"scale": w, "bias": b}, x)
        with torch.no_grad():
            got = torch.movedim(port(torch.movedim(torch.from_numpy(x), -1,
                                                   1)), 1, -1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.disable_jit():         # every bf16 operation rounds
        want = mod.apply({"params": {
            "scale": jnp.asarray(w).astype(jnp.bfloat16),
            "bias": jnp.asarray(b).astype(jnp.bfloat16)}}, x16)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(BF16)
    port = port.to(BF16)
    with torch.no_grad():
        got = torch.movedim(port(torch.movedim(
            torch.from_numpy(np.asarray(x16.astype(jnp.float32))).to(BF16),
            -1, 1)), 1, -1)
    assert torch.equal(got, want)
    # torch.nn.GroupNorm rounds once, after its affine: not the JAX one's
    lib = torch.nn.GroupNorm(groups, 6).to(BF16)
    with torch.no_grad():
        lib.weight.copy_(torch.from_numpy(w))
        lib.bias.copy_(torch.from_numpy(b))
        other = torch.movedim(lib(torch.movedim(
            torch.from_numpy(np.asarray(x16.astype(jnp.float32))).to(BF16),
            -1, 1)), 1, -1)
    assert not torch.equal(other, want)


# ---------------------------------------------------------------------------
# The entry points, for all eight

@pytest.mark.parametrize("dataset", sorted(DATASETS))
@pytest.mark.parametrize("name", ZOO)
def test_load_model_builds_from_each_published_config(name, dataset):
    from veloxseg_torch.cli.speed_main import eval_param_count
    with open(os.path.join(ROOT, "config", f"models_config_{dataset}.json"),
              encoding="utf-8") as f:
        config = json.load(f)
    shape = DATASETS[dataset]
    model = load_model(name, config, device="cpu", seed=0,
                       input_size=shape[:3])
    assert not model.training
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert eval_param_count(model) == jax_eval_params(
        name, config[name], shape)


@pytest.mark.parametrize("name", ZOO)
def test_building_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with open(os.path.join(ROOT, "config", "models_config_autopetii.json"),
              encoding="utf-8") as f:
        config = json.load(f)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(name, config)


def test_speed_cli_runs_the_zoo_on_the_cpu(tmp_path, monkeypatch, capsys):
    from veloxseg_torch.cli import speed_main
    config = {n: zr.config(n) for n in ("UNet", "SegFormer")}
    path = tmp_path / "models.json"
    path.write_text(json.dumps(config))
    monkeypatch.setitem(speed_main.INPUT_SIZE, "AutoPETII", (32, 32, 32, 2))
    monkeypatch.setattr(speed_main, "T_TIMED", 0.3)
    monkeypatch.setattr(speed_main, "MAX_BS", 1)
    results = speed_main.main(["--dataset", "AutoPETII", "--model_config",
                               str(path), "--model_list", "UNet,SegFormer",
                               "--devices", "cpu"])
    out = capsys.readouterr().out
    assert [r["model"] for r in results] == ["UNet", "SegFormer"]
    assert "not implemented yet" not in out
    for r in results:
        assert r["throughput"] > 0 and r["batch_size"] == 1
        assert r["flops"] > 0
        assert r["params"] == jax_eval_params(r["model"], config[r["model"]],
                                               (32, 32, 32, 2))
        assert f"{r['model']} cpu {r['throughput']:.2f} images/s @ batch " \
               f"size 1" in out
        assert f"FLOPS: {r['flops'] / 1e9} G" in out


def test_flop_count_covers_transposed_convs_and_attention():
    """``FlopCounterMode`` counts a transposed convolution (2 · in · out/g ·
    k³ per input voxel) and SwinUNETR's window attention (its two
    projections and the two matrix products of the scores)."""
    from veloxseg_torch.models.zoo.swin_unetr import WindowAttention
    from veloxseg_torch.utils.flops import count_flops
    conv = port_common.ConvTranspose3d(6, 4, 2, 2)
    x = torch.randn(1, 6, 3, 4, 5)
    with torch.no_grad():
        assert count_flops(conv, x) == 2 * 6 * 4 * 8 * 60
    bn, l, c, h = 3, 8, 12, 2
    attn = WindowAttention(c, h, (2, 2, 2))
    with torch.no_grad():
        n = count_flops(attn, torch.randn(bn, l, c), None)
    linear = 2 * bn * l * c * (3 * c + c)
    products = 2 * (2 * bn * h * l * l * (c // h))
    assert n == linear + products


# ---------------------------------------------------------------------------
# The forwards and the weights

@pytest.mark.parametrize("name", MODELS)
def test_fp32_forward_matches_jax(reference, name):
    want = reference[name]["fp32"]
    got = zoo_forward(zoo_port_model(name, reference), zr.model_input(name))
    assert got.shape == want.shape == (2, 32, 32, 32, 2)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * float(np.abs(want).max()), err


@pytest.mark.parametrize("name", BF16_MODELS)
def test_bf16_forward_matches_jax(reference, name):
    r16, r32 = reference[name]["bf16"], reference[name]["fp32"]
    got = zoo_forward(zoo_port_model(name, reference), zr.model_input(name),
                      BF16)
    assert got.shape == r16.shape and np.isfinite(got).all()
    d = forward_distances(got, r16, r32)
    assert d["to_bf16"] <= FORWARD_BOUND["to_bf16"], d
    assert d["to_fp32"] >= FORWARD_BOUND["to_fp32"], d
    # two-sided: the same model run in fp32 fails it
    d32 = forward_distances(zoo_forward(zoo_port_model(name, reference),
                                        zr.model_input(name)), r16, r32)
    assert d32["to_bf16"] > FORWARD_BOUND["to_bf16"], d32


def test_mednext_weights_round_trip(reference):
    assert_zoo_round_trip("MedNeXt", reference,
                          zoo_port_model("MedNeXt", reference), "MedNeXt")


@pytest.mark.parametrize("name", MODELS)
def test_load_params_reads_ckpt_and_pth(reference, name, tmp_path):
    assert_zoo_load_params(name, reference, tmp_path)


def test_load_params_refuses_a_model_without_a_format(tmp_path):
    class Other(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(2))
    path = str(tmp_path / "m.pth")
    torch.save({"w": torch.zeros(2)}, path)
    with pytest.raises(TypeError, match="no checkpoint format"):
        port_ckpt.load_params(path, Other())
