"""The port's mixed conv/MLP/state-space baselines of the zoo that close it
(A2FSeg, SuperLightNet, U-KAN, HCMA-UNet) against the JAX package on the
CPU, and the registry, which now holds the whole zoo.

- The eval forward of each, at its published AutoPET-II config with the
  size keys at 32³ (``tools/zoo_reference.py``), with the JAX model's
  parameters (``init`` from ``PRNGKey(0)``, every leaf moved by seeded
  noise; HCMA-UNet's up-projection biases tied within each group of s³)
  carried across by its ``zoo_params`` function: fp32 within 1e-5 of the
  JAX logits' largest magnitude, or, where larger, within 4× the JAX
  fp32 forward's own error: its movement under a 1e-7 relative input
  change, or its distance from its float64 forward (JAX's x64 mode; the
  JAX norms keep fp32 statistics). Both figures are printed. All four are
  ill-conditioned at 32³ (``zoo_reference.py --report``): A2FSeg's and
  U-KAN's deepest levels are one voxel, whose batch norms at B = 2
  normalize two values, so they run at B = 4, as UNETRpp does
  (``zoo_reference.BATCH``); SuperLightNet's LayerNorms over 12 channels
  and HCMA-UNet's over the 2 channels of its narrowest scan branches
  amplify the rounding of the one-pass fp32 statistics before them. The
  JAX fp32 forward lies 2.7e-5 to 3.3e-5 of the scale from its float64
  one (6.2e-4 for HCMA-UNet); the port's lies 2.7e-5 to 4.6e-5 (8.8e-4)
  from the JAX fp32 one. So the blocks are also held at 1e-5 where they
  are well-conditioned (HCMA's directional Mamba branch at a width of 64,
  SuperLightNet's THPA block), and the three without a scan in float64
  within 1e-4 (the other zoo tests' float64 bound; HCMA-UNet is not:
  the JAX function rounds its scan to fp32 in float64 too, where the
  port's keeps float64). U-KAN and HCMA-UNet also run in
  bf16, held to ``chip_measure.FORWARD_BOUND``. The JAX side runs in a
  process of its own (XLA's excess precision off), started with this
  file's first test.
- The weights round trip through the JAX package's
  ``convert_zoo_state_dict`` bit for bit, every leaf; HCMA's inverse map
  raises on an up-projection bias that does not repeat one value per
  group of s³.
- ``load_params`` reads a JAX ``.ckpt`` and a port ``.pth``; a
  reference-keyed ``.pth`` loads with exactly the keys the JAX map drops
  left out; a model class with no checkpoint format raises.
- The blocks: SuperLightNet's align-corners map resize and THPA block,
  U-KAN's B-spline basis, HCMA's directional Mamba branch along each
  axis, against the JAX functions.
- ``available_models()`` is the model set of each published config; each
  of the four builds from all three with the JAX speed CLI's parameter
  count (HCMA-UNet's less its up-projections' repeated biases), and none
  builds without CUDA unless the CPU is asked for.
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

from torch_port_helpers import (assert_zoo_dropped_keys,
                                assert_zoo_load_params,
                                assert_zoo_round_trip, jax_eval_params,
                                normal, zoo_forward, zoo_port_model)
from veloxseg_torch.interop import zoo_params
from veloxseg_torch.models.registry import available_models, load_model
from veloxseg_torch.models.zoo import hcma as port_hcma
from veloxseg_torch.models.zoo import kan as port_kan
from veloxseg_torch.models.zoo import superlightnet as port_sln
from veloxseg_torch.train import checkpoint as port_ckpt
from veloxseg_tpu.models.zoo import hcma as jax_hcma
from veloxseg_tpu.models.zoo import kan as jax_kan
from veloxseg_tpu.models.zoo import superlightnet as jax_sln

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import zoo_reference as zr  # noqa: E402
from chip_measure import FORWARD_BOUND, forward_distances  # noqa: E402

MODELS = ("A2FSeg", "SuperLightNet", "U-KAN", "HCMA-UNet")
BF16_MODELS = ("U-KAN", "HCMA-UNet")
F64_MODELS = ("A2FSeg", "SuperLightNet", "U-KAN", "HCMA-UNet")
JAX_NAMES = {"A2FSeg": "A2FSeg", "SuperLightNet": "SuperLightNet",
             "U-KAN": "UKAN", "HCMA-UNet": "HCMA"}
DROPPED = {
    "A2FSeg": ("modality_specific_models.0.conv_blocks_context.0.blocks.0."
               "instnorm.running_mean",
               "modality_specific_models.1.conv_blocks_context.5.0.blocks.0."
               "instnorm.num_batches_tracked",
               "fusion_decoder.conv_blocks_context.0.blocks.0.conv.weight",
               "fusion_decoder.td.0.weight"),
    "SuperLightNet": (),
    "U-KAN": ("block1.0.layer.fc1.grid", "dblock2.0.layer.fc3.grid",
              "encoder1.conv.1.running_var",
              "block2.0.layer.dwconv_2.bn.num_batches_tracked"),
    "HCMA-UNet": ("out.0.conv1.weight", "out.0.conv1.bias",
                  "out.2.conv1.weight"),
}
DATASETS = {"autopetii": (96, 96, 96, 2), "hecktor2022": (128, 128, 64, 2),
            "brats2021": (96, 96, 96, 4)}
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    path = tmp_path_factory.mktemp("zoo_mixed") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "zoo_reference.py"),
         "--models", ",".join(MODELS), "--bf16", ",".join(BF16_MODELS),
         "--f64", ",".join(F64_MODELS), "--out", str(path)], cwd=ROOT,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(jax_reference_process):
    proc, path = jax_reference_process
    out, _ = proc.communicate(timeout=1200)
    assert proc.returncode == 0, out.decode(errors="replace")[-4000:]
    return zr.load_reference(str(path))


# ---------------------------------------------------------------------------
# The blocks

@pytest.mark.parametrize("shape,axis,n_out", [((1, 12, 8, 3), 1, 48),
                                              ((1, 12, 8, 3), 2, 5),
                                              ((1, 6, 4), 1, 1),
                                              ((1, 96, 24), 1, 96)])
def test_superlightnet_map_resize_matches_jax(shape, axis, n_out):
    p = normal(shape, 71)
    want = np.asarray(jax_sln._resize_axis_ac(jnp.asarray(p), axis, n_out))
    got = port_sln._resize_axis(torch.from_numpy(p), axis, n_out).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_b_splines_match_jax(scale):
    """Values inside and outside the grid, and on its knots (the
    half-open interval tests)."""
    grid = jax_kan._make_grid(6, 5, 3)
    np.testing.assert_array_equal(port_kan._make_grid(6, 5, 3), grid)
    x = normal((40, 6), 72, scale)
    x[:2] = grid[0].reshape(2, 6)          # every knot
    want = np.asarray(jax_kan.b_splines(jnp.asarray(x), jnp.asarray(grid),
                                        3))
    got = port_kan.b_splines(torch.from_numpy(x), torch.from_numpy(grid),
                             3).numpy()
    assert got.shape == want.shape == (40, 6, 8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _flax_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _sub_state(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _assert_close(got, want, rel=1e-5):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


@pytest.mark.parametrize("axis", [1, 2, 3])
def test_hcma_directional_mamba_matches_jax(axis):
    """One triplane branch (VSS block with its four-direction scan, axial
    attention) at a width of 64 (a branch of HCMA's level 2), where its
    LayerNorms are well-conditioned, on an odd (6, 5, 4) volume."""
    size, c = (6, 5, 4), 64
    x = normal((2, *size, c), 81)
    mod = jax_hcma.DirectionalMamba(axis=axis, axis_len=size[axis - 1])
    params = zr.noisy(_flax_leaves(jax.jit(mod.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    want = np.asarray(jax.jit(lambda p, v: mod.apply({"params": p}, v))(
        zr.nest(params), jnp.asarray(x)))
    branch = "xyz"[axis - 1]
    sd = zoo_params.hcma_state_dict_from_jax(
        {f"down_1/tmamba/mamba_{branch}/{k}": a for k, a in params.items()})
    port = port_hcma.DirectionalMamba(c, axis, size[axis - 1]).eval()
    port.load_state_dict(_sub_state(sd, f"encoders.2.tmamba.mamba_{branch}."),
                         strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    _assert_close(got, want)


def test_superlightnet_thpa_block_matches_jax():
    x = normal((2, 8, 6, 8, 24), 82)
    mod = jax_sln.THPABlock(24)
    params = zr.noisy(_flax_leaves(mod.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), False)["params"]))
    want = np.asarray(mod.apply({"params": zr.nest(params)}, jnp.asarray(x),
                                False))
    sd = zoo_params.superlightnet_state_dict_from_jax(
        {f"repr0_0/{k}": a for k, a in params.items()})
    port = port_sln.THPABlock(24).eval()
    port.load_state_dict(_sub_state(sd, "ParallelU_Net_enc_m.repr_block_0."
                                        "0."), strict=True)
    with torch.no_grad():
        got = torch.movedim(port(torch.movedim(torch.from_numpy(x), -1, 1)),
                            1, -1).numpy()
    _assert_close(got, want)


def test_flop_count_where_a_ghpa_map_needs_no_resize():
    """At Hecktor's W = 64 SuperLightNet's deepest GHPA slices are 8 wide,
    its ``params_zy`` width: the map goes to its convs unresized, and the
    speed CLI counts the forward's operations under ``inference_mode``."""
    from veloxseg_torch.utils.flops import count_flops
    with open(os.path.join(ROOT, "config", "models_config_hecktor2022.json"),
              encoding="utf-8") as f:
        model = load_model("SuperLightNet", json.load(f), device="cpu")

    def fwd(x):
        with torch.inference_mode():
            return model(x)
    assert count_flops(fwd, torch.randn(1, 16, 16, 64, 2)) > 0


def test_hcma_inverse_raises_on_an_untied_up_bias(reference):
    flat = dict(reference["HCMA-UNet"]["params"])
    sd = zoo_params.hcma_state_dict_from_jax(zr.nest(flat))
    assert sd["decoders.1.up_transpose.bias"].shape == (128,)
    bias = flat["up_1/up/bias"].copy()
    bias[8 * 5 + 3] += 1e-3           # one value of group 5 of s³ = 8
    flat["up_1/up/bias"] = bias
    with pytest.raises(ValueError, match="not 128 values each repeated 8"):
        zoo_params.hcma_state_dict_from_jax(zr.nest(flat))


# ---------------------------------------------------------------------------
# The entry points

@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_registry_holds_every_published_model(dataset):
    with open(os.path.join(ROOT, "config", f"models_config_{dataset}.json"),
              encoding="utf-8") as f:
        assert available_models() == sorted(json.load(f))
    assert all(type(load_model(n, {n: zr.config(n)}, device="cpu"))
               in port_ckpt._FORMATS for n in MODELS)


@pytest.mark.parametrize("dataset", sorted(DATASETS))
@pytest.mark.parametrize("name", MODELS)
def test_load_model_builds_from_each_published_config(name, dataset):
    from veloxseg_torch.cli.speed_main import eval_param_count
    with open(os.path.join(ROOT, "config", f"models_config_{dataset}.json"),
              encoding="utf-8") as f:
        config = json.load(f)
    shape = DATASETS[dataset]
    model = load_model(name, config, device="cpu", seed=0,
                       input_size=shape[:3])
    assert not model.training
    # HCMA's up-projections hold the reference's O biases, which the JAX
    # Dense holds repeated s³ times
    repeated = sum(up.up_transpose.bias.numel()
                   * (up.up_transpose.stride[0] ** 3 - 1)
                   for up in getattr(model, "decoders", ()))
    assert eval_param_count(model) + repeated == jax_eval_params(
        name, config[name], shape)


@pytest.mark.parametrize("name", MODELS)
def test_building_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with open(os.path.join(ROOT, "config", "models_config_autopetii.json"),
              encoding="utf-8") as f:
        config = json.load(f)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(name, config)


def test_load_params_refuses_a_class_without_a_format(tmp_path):
    class Other(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(2))
    path = str(tmp_path / "m.ckpt")
    with open(path, "wb") as f:
        from flax import serialization
        f.write(serialization.msgpack_serialize({"params": {"w": np.zeros(
            2, np.float32)}}))
    with pytest.raises(TypeError, match="no checkpoint format for Other"):
        port_ckpt.load_params(path, Other())


# ---------------------------------------------------------------------------
# The forwards and the weights

@pytest.mark.parametrize("name", MODELS)
def test_fp32_forward_matches_jax(reference, name):
    r = reference[name]
    want = r["fp32"]
    got = zoo_forward(zoo_port_model(name, reference), zr.model_input(name))
    assert got.shape == want.shape == zr.input_shape(name)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    moved = float(np.abs(r["fp32_perturbed"] - want).max())
    own = float(np.abs(r["fp64"] - want).max())
    print(f"{name}: fp32 max abs err {err / scale:.3e} of the scale; a 1e-7 "
          f"input change moves the JAX forward by {moved / scale:.3e}, its "
          f"float64 forward lies {own / scale:.3e} from it")
    assert err <= max(1e-5 * scale, 4 * moved, 4 * own), \
        (err, scale, moved, own)


@pytest.mark.parametrize("name", [n for n in F64_MODELS if n != "HCMA-UNet"])
def test_float64_forward_matches_jax(reference, name):
    want = reference[name]["fp64"]
    got = zoo_forward(zoo_port_model(name, reference), zr.model_input(name),
                      torch.float64)
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
    d32 = forward_distances(zoo_forward(zoo_port_model(name, reference),
                                        zr.model_input(name)), r16, r32)
    assert d32["to_bf16"] > FORWARD_BOUND["to_bf16"], d32


@pytest.mark.parametrize("name", MODELS)
def test_weights_round_trip(reference, name):
    assert_zoo_round_trip(name, reference, zoo_port_model(name, reference),
                          JAX_NAMES[name])


@pytest.mark.parametrize("name", MODELS)
def test_load_params_reads_ckpt_and_pth(reference, name, tmp_path):
    assert_zoo_load_params(name, reference, tmp_path)


@pytest.mark.parametrize("name", MODELS)
def test_reference_pth_loads_without_the_dropped_keys(reference, name,
                                                      tmp_path):
    assert_zoo_dropped_keys(name, reference, JAX_NAMES[name], DROPPED[name],
                            tmp_path)
