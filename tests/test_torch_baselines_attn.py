"""The port's attention baselines of the zoo that close it (VSmTrans,
NestedFormer, HDense) against the JAX package on the CPU.

- The eval forward of each, at its published AutoPET-II config with the
  size keys at the test's input (``tools/zoo_reference.py``: 32³,
  NestedFormer (48, 48, 32), which its published window (3, 3, 2) needs),
  with the JAX model's parameters (``init`` from ``PRNGKey(0)``, every leaf
  moved by seeded noise) carried across by its ``zoo_params`` function:
  fp32 within 1e-5 of the JAX logits' largest magnitude, or within 4× the
  JAX forward's own movement under a 1e-7 relative input change where
  that is larger (``zoo_reference.py --report`` prints it; the figure is
  printed here too). VSmTrans also runs in bf16, held to
  ``chip_measure.FORWARD_BOUND``. The JAX side runs in a process of its
  own (XLA's excess precision off), started with this file's first test.
- The weights round trip through the JAX package's
  ``convert_zoo_state_dict`` bit for bit, every leaf.
- ``load_params`` reads a JAX ``.ckpt`` and a port ``.pth``; a
  reference-keyed ``.pth`` loads with exactly the keys that the JAX map
  drops left out (each such key is one the JAX map returns None for,
  every key the model holds is one it places).
- The blocks: HDense's 2× upsampling against ``jax.image.resize``,
  VSmTrans's shifted-window mask and window geometry, NestedFormer's
  relative offsets.
- Each builds from all three published model configs with the JAX speed
  CLI's parameter count, and none builds without CUDA unless the CPU is
  asked for; NestedFormer at Hecktor2022's (128, 128, 64), whose (8, 8, 4)
  bottleneck its window (3, 3, 2) does not divide, raises on both sides,
  and the speed CLI reports it as skipped.
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
from veloxseg_torch.models.registry import load_model
from veloxseg_torch.models.zoo import hdense as port_hdense
from veloxseg_torch.models.zoo import nestedformer as port_nf
from veloxseg_torch.models.zoo import vsmtrans as port_vsm
from veloxseg_tpu.models.zoo import nestedformer as jax_nf
from veloxseg_tpu.models.zoo import vsmtrans as jax_vsm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import zoo_reference as zr  # noqa: E402
from chip_measure import FORWARD_BOUND, forward_distances  # noqa: E402

MODELS = ("VSmTrans", "NestedFormer", "HDense")
BF16_MODELS = ("VSmTrans",)
JAX_NAMES = {"VSmTrans": "VSmTrans", "NestedFormer": "NestedFormer",
             "HDense": "HDense"}
# reference keys that the JAX maps drop, one or more of each kind
DROPPED = {
    "VSmTrans": ("VSmViT.layers1.0.blocks.0.attn.attns.2."
                 "relative_position_index",
                 "VSmViT.layers3.0.blocks.1.attn.norm2.running_mean",
                 "VSmViT.layers3.0.blocks.1.attn.norm2.running_var",
                 "VSmViT.layers3.0.blocks.1.attn.norm2.num_batches_tracked",
                 "out_4.weight", "out_4.bias"),
    "NestedFormer": ("fusion.modality_att.cross_attention.attention_norm."
                     "weight",
                     "fusion.modality_att.cross_attention.attention_norm."
                     "bias"),
    "HDense": (),
}
DATASETS = {"autopetii": (96, 96, 96, 2), "hecktor2022": (128, 128, 64, 2),
            "brats2021": (96, 96, 96, 4)}
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    path = tmp_path_factory.mktemp("zoo_attn") / "ref.npz"
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
    out, _ = proc.communicate(timeout=1200)
    assert proc.returncode == 0, out.decode(errors="replace")[-4000:]
    return zr.load_reference(str(path))


# ---------------------------------------------------------------------------
# The blocks

@pytest.mark.parametrize("src", [(1, 1, 1), (2, 3, 1), (3, 5, 2), (6, 6, 6)])
def test_hdense_upsample_matches_jax_resize(src):
    x = normal((2, *src, 3), 61)
    want = np.asarray(jax.image.resize(
        jnp.asarray(x), (2, *(2 * s for s in src), 3), method="trilinear"))
    got = torch.movedim(port_hdense.resize_2x(
        torch.movedim(torch.from_numpy(x), -1, 1)), 1, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("img,split", [((16, 16, 16), 1), ((8, 8, 8), 2),
                                       ((4, 4, 4), 3), ((2, 2, 2), 4),
                                       ((48, 48, 48), 1), ((6, 6, 6), 4),
                                       ((64, 64, 32), 3)])
def test_vsm_windows_and_masks_match_jax(img, split):
    for idx in range(4):
        win, shift = port_vsm.vsa_window(idx, img, split, 6)
        assert (win, shift) == jax_vsm._vsa_window(idx, img, split, 6)
        if not any(shift):
            continue
        padded = tuple(s + (w - s % w) % w for s, w in zip(img, win))
        np.testing.assert_array_equal(
            port_vsm._vsm_mask(padded, win, shift),
            jax_vsm._vsm_mask(padded, win, shift))


@pytest.mark.parametrize("window", [(3, 3, 2), (2, 2, 2), (3, 1, 2)])
def test_nestedformer_offsets_match_jax(window):
    np.testing.assert_array_equal(port_nf._rel3d_indices(window),
                                  jax_nf._rel3d_indices(window))


# ---------------------------------------------------------------------------
# The entry points

@pytest.mark.parametrize("dataset", sorted(DATASETS))
@pytest.mark.parametrize("name", MODELS)
def test_load_model_builds_from_each_published_config(name, dataset):
    from veloxseg_torch.cli.speed_main import eval_param_count
    with open(os.path.join(ROOT, "config", f"models_config_{dataset}.json"),
              encoding="utf-8") as f:
        config = json.load(f)
    shape = DATASETS[dataset]
    if (name, dataset) == ("NestedFormer", "hecktor2022"):
        # the window (3, 3, 2) does not divide the (8, 8, 4) bottleneck
        from veloxseg_torch.models.registry import CannotRunAtShape
        with pytest.raises(CannotRunAtShape, match=r"does not divide"):
            load_model(name, config, device="cpu", input_size=shape[:3])
        with pytest.raises(TypeError, match="cannot reshape"):
            jax_eval_params(name, config[name], shape)
        return
    model = load_model(name, config, device="cpu", seed=0,
                       input_size=shape[:3])
    assert not model.training
    assert eval_param_count(model) == jax_eval_params(
        name, config[name], shape)


def test_speed_cli_skips_a_model_that_cannot_run_at_the_shape(capsys):
    from veloxseg_torch.cli import speed_main
    results = speed_main.main(["--dataset", "Hecktor2022", "--model_list",
                               "NestedFormer", "--model_config",
                               os.path.join(ROOT, "config",
                                            "models_config_hecktor2022.json"),
                               "--devices", "cpu"])
    assert [(r["model"], r["device"]) for r in results] == \
        [("NestedFormer", "cpu")]
    assert "does not divide" in results[0]["skipped"]
    assert "NestedFormer: cannot run at (128, 128, 64, 2): " in \
        capsys.readouterr().out


def test_speed_cli_stops_at_any_other_builder_error(monkeypatch):
    """Only ``CannotRunAtShape`` is reported as a skip: a builder's other
    ``ValueError`` (a bad config key, a shape mismatch) stops the CLI, as
    the JAX CLI stops."""
    from veloxseg_torch.cli import speed_main
    from veloxseg_torch.models import registry

    def broken(cfg, device, seed):
        raise ValueError("a builder fault")
    registry.available_models()     # the built-in builders registered
    monkeypatch.setitem(registry._REGISTRY, "NestedFormer", broken)
    with pytest.raises(ValueError, match="a builder fault"):
        speed_main.main(["--dataset", "AutoPETII", "--model_list",
                         "NestedFormer", "--model_config",
                         os.path.join(ROOT, "config",
                                      "models_config_autopetii.json"),
                         "--devices", "cpu"])


@pytest.mark.parametrize("name", MODELS)
def test_building_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with open(os.path.join(ROOT, "config", "models_config_autopetii.json"),
              encoding="utf-8") as f:
        config = json.load(f)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(name, config)


# ---------------------------------------------------------------------------
# The forwards and the weights

def _ill_conditioning(r) -> float:
    """How far a 1e-7 relative input change moves the JAX fp32 forward,
    relative to its largest magnitude."""
    want = r["fp32"]
    return float(np.abs(r["fp32_perturbed"] - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("name", MODELS)
def test_fp32_forward_matches_jax(reference, name):
    r = reference[name]
    want = r["fp32"]
    got = zoo_forward(zoo_port_model(name, reference), zr.model_input(name))
    assert got.shape == want.shape == zr.input_shape(name)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    moved = _ill_conditioning(r) * scale
    print(f"{name}: fp32 max abs err {err / scale:.3e} of the scale; a 1e-7 "
          f"input change moves the JAX forward by {moved / scale:.3e}")
    assert err <= max(1e-5 * scale, 4 * moved), (err, scale, moved)


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
