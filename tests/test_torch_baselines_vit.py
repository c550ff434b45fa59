"""The port's windowed and ViT baselines of the zoo (UNETR, SwinUNETR,
SegFormer, SlimUNETR, UNETRpp) against the JAX package on the CPU.

- The eval forward of each, at its published AutoPET-II config with the
  size keys at 32³ (SlimUNETR's ``embedding_dim`` 1), with the JAX model's
  parameters (``init`` from ``PRNGKey(0)``, every leaf moved by seeded
  noise) carried across by its ``zoo_params`` function, on a seeded
  (2, 32, 32, 32, 2) input: fp32 within 1e-4 of the JAX logits' largest
  magnitude. Two models are ill-conditioned there
  (``tools/zoo_reference.py --report``: how far a 1e-7 relative input
  change moves the fp32 output):
  - UNETRpp's deepest level is one voxel, and at B = 2 its batch norms
    normalize two values: a 1e-7 input change moved the output by 4.6e-3
    of its scale (the port's forward, measured). It runs at B = 4 (the
    B = 2 input and two more samples), where that is 5.6e-6.
  - SegFormer's attention scores are divided by √heads (1 at its first
    stage), so its softmax is steep at any batch: the JAX forward moves by
    1.3e-4 under that change, more than the bound. It is held within 1e-4
    in float64 on both sides (JAX's x64 mode; its norms keep fp32
    statistics), and in fp32 within 4× the JAX forward's own movement.
  SwinUNETR (LayerNorm, masked window attention) also runs in bf16,
  held to ``chip_measure.FORWARD_BOUND``. The JAX side runs in a process of
  its own (``tools/zoo_reference.py``, XLA's excess precision off),
  started with this file's first test.
- The weights of SegFormer, SlimUNETR and UNETRpp round trip through the
  JAX package's ``convert_zoo_state_dict`` bit for bit, every leaf.
- ``load_params`` reads a JAX ``.ckpt`` and a port ``.pth`` for each.
- The blocks on odd shapes: SegFormer's half-pixel trilinear upsampling,
  SwinUNETR's shifted-window mask and one Swin block at sizes that pad
  and shift on some axes only, UNETR++'s EPA block.
- The serving CLI on SwinUNETR, ``--device cpu``, against the JAX CLI:
  from a JAX ``.ckpt`` that both read, and from the same weights as a
  ``.pth`` the port wrote (the JAX CLI reads no SwinUNETR ``.pth``).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_csvs_agree, assert_logits_agree,
                                assert_masks_agree, assert_zoo_load_params,
                                assert_zoo_round_trip, driver_workspace,
                                normal, run_both_drivers, zoo_forward,
                                zoo_port_model)
from veloxseg_torch.interop import zoo_params
from veloxseg_torch.models.registry import load_model
from veloxseg_torch.models.zoo import segformer3d as port_seg
from veloxseg_torch.models.zoo import swin_unetr as port_swin
from veloxseg_torch.models.zoo import unetrpp as port_upp
from veloxseg_torch.train import checkpoint as port_ckpt
from veloxseg_tpu.models.zoo import segformer3d as jax_seg
from veloxseg_tpu.models.zoo import swin_unetr as jax_swin
from veloxseg_tpu.models.zoo import unetrpp as jax_upp
from veloxseg_tpu.train.checkpoint import save_checkpoint as jax_save

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import zoo_reference as zr  # noqa: E402
from chip_measure import FORWARD_BOUND, forward_distances  # noqa: E402

MODELS = ("UNETR", "SwinUNETR", "SegFormer", "SlimUNETR", "UNETRpp")
BF16_MODELS = ("UNETR", "SwinUNETR")
F64_MODELS = ("SegFormer",)
ROUND_TRIP = {"SegFormer": "SegFormer", "SlimUNETR": "SlimUNETR",
              "UNETRpp": "UNETRpp"}
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def jax_reference_process(tmp_path_factory):
    path = tmp_path_factory.mktemp("zoo_vit") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "zoo_reference.py"),
         "--models", ",".join(MODELS), "--bf16", ",".join(BF16_MODELS),
         "--f64", ",".join(F64_MODELS), "--out", str(path)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
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
# The blocks on odd shapes

@pytest.mark.parametrize("src,dst", [((5, 6, 7), (20, 24, 28)),
                                     ((1, 1, 1), (8, 8, 8)),
                                     ((2, 3, 1), (8, 12, 4)),
                                     ((3, 5, 2), (10, 8, 7))])
def test_resize_halfpixel_matches_jax(src, dst):
    x = normal((2, *src, 3), 31)
    want = np.asarray(jax_seg._resize_halfpixel(jnp.asarray(x), dst))
    got = torch.movedim(port_seg.resize_halfpixel(
        torch.movedim(torch.from_numpy(x), -1, 1), dst), 1, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,shifted", [((16, 16, 8), True),
                                          ((8, 8, 4), True),
                                          ((9, 7, 3), True),
                                          ((12, 12, 12), True)])
def test_shift_mask_matches_jax(size, shifted):
    win, shift = port_swin.block_geometry(size, (7, 7, 7), shifted)
    padded = tuple(s + (w - s % w) % w for s, w in zip(size, win))
    np.testing.assert_array_equal(
        port_swin._shift_attn_mask(padded, win, shift),
        jax_swin._shift_attn_mask(padded, win, shift))


def _flax_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("size,shifted", [((16, 16, 8), True),
                                          ((8, 8, 4), True),
                                          ((4, 4, 2), False),
                                          ((9, 7, 3), True)])
def test_swin_block_matches_jax(size, shifted):
    """One Swin block: the window clipped, rolled, padded on some axes
    only, the mask where shifted (32×32×16 after the patch embedding: 16 ×
    16 × 8 pads the last axis, 8 × 8 × 4 shifts two axes)."""
    dim, heads = 12, 3
    x = normal((2, *size, dim), 41)
    mod = jax_swin.SwinBlock(dim, heads, shift=shifted)
    params = zr.noisy(_flax_leaves(mod.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x))["params"]))
    want = np.asarray(mod.apply({"params": zr.nest(params)}, jnp.asarray(x)))
    port = port_swin.SwinBlock(dim, heads, size, shifted=shifted).eval()
    sd = zoo_params.swin_unetr_state_dict_from_jax(
        {f"stage0_block0/{k}": a for k, a in params.items()})
    port.load_state_dict({k[len("stage0_block0."):]: v
                          for k, v in sd.items()}, strict=True)
    assert any(port.shift) == (shifted and size[0] > 7)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_epa_block_matches_jax():
    b, s, c = 2, 4, 32
    x = normal((b, s, s, s, c), 51)
    mod = jax_upp.EPABlock(s ** 3, c, 16, 4)
    params = zr.noisy(_flax_leaves(jax.jit(
        mod.init, static_argnames="deterministic")(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, jnp.asarray(x),
            deterministic=True)["params"]))
    want = np.asarray(mod.apply({"params": zr.nest(params)}, jnp.asarray(x),
                                deterministic=True))
    port = port_upp.TransformerBlock(s ** 3, c, 16, 4).eval()
    sd = zoo_params.unetrpp_state_dict_from_jax(
        {f"stage0_block0/{k}": a for k, a in params.items()})
    prefix = "unetr_pp_encoder.stages.0.0."
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = torch.movedim(port(torch.movedim(torch.from_numpy(x), -1, 1)),
                            1, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# The forwards and the weights

@pytest.mark.parametrize("name", MODELS)
def test_fp32_forward_matches_jax(reference, name):
    r = reference[name]
    want = r["fp32"]
    got = zoo_forward(zoo_port_model(name, reference), zr.model_input(name))
    assert got.shape == want.shape == (zr.BATCH.get(name, 2), 32, 32, 32, 2)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    bound = 1e-4 * scale
    if name in F64_MODELS:
        # the JAX forward's own movement under a 1e-7 relative input change
        moved = float(np.abs(r["fp32_perturbed"] - want).max())
        bound = max(bound, 4 * moved)
    assert err <= bound, (err, bound, scale)


@pytest.mark.parametrize("name", F64_MODELS)
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


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_weights_round_trip(reference, name):
    assert_zoo_round_trip(name, reference, zoo_port_model(name, reference),
                          ROUND_TRIP[name])


@pytest.mark.parametrize("name", MODELS)
def test_load_params_reads_ckpt_and_pth(reference, name, tmp_path):
    assert_zoo_load_params(name, reference, tmp_path)


# ---------------------------------------------------------------------------
# The serving CLI on SwinUNETR

@pytest.fixture(scope="module")
def swin_runs(reference, tmp_path_factory):
    from tests.make_fixtures import make_autopet_fixtures
    root = tmp_path_factory.mktemp("driver_swin")
    globs = make_autopet_fixtures(str(root / "data"), n_cases=5)
    params = zr.nest(reference["SwinUNETR"]["params"])
    jax_save(str(root / "ckpt" / "val_best.ckpt"), params, epoch=1)
    model = zoo_port_model("SwinUNETR", reference)
    port_ckpt.save_checkpoint(str(root / "pth" / "val_best.pth"), model)
    cfg = {"SwinUNETR": {"in_channels": 2, "out_channels": 2}}
    out = {}
    for form in ("ckpt", "pth"):
        ws = driver_workspace(root / f"ws_{form}", "AutoPETII", cfg,
                              (32, 32, 32), globs)
        args = ["--model_name", "SwinUNETR", "--use_hd95", "1",
                "--checkpoint_dir", str(root / form)]
        if form == "ckpt":
            out[form] = run_both_drivers(ws, args)
        else:      # the JAX CLI reads no SwinUNETR .pth: the port alone
            from veloxseg_torch.cli.test_main import main as port_main
            rows = port_main(ws["port"]["flags"] + args + ["--device", "cpu"])
            csv = [p for p in os.listdir(ws["port"]["metric"])
                   if p.endswith(".csv")]
            out[form] = {"rows": rows, "csv": open(os.path.join(
                ws["port"]["metric"], csv[0])).read()}
    return out


def test_serving_cli_swin_unetr_matches_jax(swin_runs):
    r = swin_runs["ckpt"]
    assert len(r["port"]["masks"]) == 2
    for jl, pl in zip(r["jax"]["logits"], r["port"]["logits"]):
        assert jl.shape == pl.shape == (48, 48, 32, 2)
        assert_logits_agree(jl, pl, 1e-4)
    same = []
    for jm, pm, lg in zip(r["jax"]["masks"], r["port"]["masks"],
                          r["jax"]["logits"]):
        margin = 2e-4 * float(np.abs(lg).max())
        assert assert_masks_agree(jm, pm, lg, margin) <= 0.001 * jm.size
        same.append(bool((jm == pm).all()))
    assert_csvs_agree(r["jax"]["csv"], r["port"]["csv"], same)
    # the same weights from the port's .pth: the same rows as from the .ckpt
    assert swin_runs["pth"]["csv"].splitlines()[0] == \
        r["port"]["csv"].splitlines()[0]
    for a, b in zip(swin_runs["pth"]["rows"], r["port"]["rows"]):
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in b.items() if k != "time"}


def test_swin_unetr_sizes_its_tables_by_the_input():
    """The bias tables follow the clipped windows of ``img_size``:
    ``load_model``'s ``input_size`` sets it where the entry has none."""
    cfg = {"SwinUNETR": {"in_channels": 2, "out_channels": 2}}
    for size, last in (((96, 96, 96), (6, 6, 6)), ((128, 128, 64),
                                                   (7, 7, 4))):
        model = load_model("SwinUNETR", cfg, device="cpu", input_size=size)
        assert model.stage3_block0.win == last
        table = model.stage3_block0.attn.rpb.relative_position_bias_table
        assert table.shape[0] == np.prod([2 * w - 1 for w in last])
    x = torch.randn(1, 64, 64, 32, 2)
    with torch.no_grad():
        y = load_model("SwinUNETR", cfg, device="cpu",
                       input_size=(64, 64, 32))(x)
    assert y.shape == (1, 64, 64, 32, 2) and bool(torch.isfinite(y).all())
