"""The whole training slice on the CPU: the port's ``run_train``
(``veloxseg_torch.train.trainer``, ``device="cpu"``) against the JAX
package's (``veloxseg_tpu.train.trainer``), then the port's ``val_best.pth``
served by both serving CLIs.

Both trainers resume from one JAX ``.ckpt`` (weights and an adamw state
after one optax step, epoch 0) on the same NIfTI fixtures
(``tests/make_fixtures.py``, AutoPET-II, 5 cases: 3 train, 1 val, 1 test)
at the TINY config with every dropout rate at 0, and train epochs 2 and 3
(2 steps each: 4 then 2 patches of 32³) with validation and checkpoints
every epoch. Both trainers step in bf16; the test forces both steps to
fp32 by replacing each trainer module's ``train_step_fn`` (inside the test
only; ``torch_port_helpers.run_both_trainers``), so that these tests hold
the loop and not bf16 rounding (``test_torch_bf16.py`` holds the bf16
step); both steps are wrapped to record each iteration's loss.

Tolerances, from the one-step tests (``test_torch_train_step.py``): each
iteration's loss 1e-4 relative (the one-step test's 1e-5, with room for
the weights' drift over 4 steps); the epoch dice means 2e-3 absolute (an
argmax over 32³ patches, where a voxel whose two logits nearly tie may
fall either way); the final weights element by element, split by the JAX
run's gradients (``torch_port_helpers.assert_adamw_weights_close``):
within 0.25·lr where the gradient is real, within 2·4·lr·1.1 where it is
rounding noise, which Adam scales to a step of up to lr either way on
each side. The CSVs of the two serving CLIs as ``test_torch_driver.py``
holds them. The same two trainers on BraTS (four-modality fixtures with
labels 0-3, 5 cases; one 4-channel modality, 4 classes): the BraTS
profile (no foreground crop, labels kept multi-class) and its validation
by ``brats_dice`` (avg, ET, TC, WT), to the same tolerances. Also, on the
port alone, stepping in bf16: its options (``steps_per_dispatch`` against
the plain loop bit for bit, ``grad_accum``, ``async_checkpoint``,
``profile_dir``), and what it refuses. About 175 s alone.
"""

import argparse
import os
import re

import jax
import numpy as np
import pytest
import torch

import veloxseg_torch.train.trainer as ttrainer
from tests.make_fixtures import make_autopet_fixtures, make_brats_fixtures
from torch_port_helpers import (TINY_JSON, assert_adamw_weights_close,
                                assert_csvs_agree, assert_masks_agree,
                                driver_workspace,
                                jax_compile_cache, jax_resume_checkpoint,
                                jax_zoo_resume_checkpoint,
                                run_both_drivers, run_both_trainers,
                                tiny_train_config)
from veloxseg_torch.interop.jax_params import state_dict_from_jax

MODEL = dict(TINY_JSON, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
             drop_path=0.0)
# BraTS: one 4-channel modality, labels 0-3
BRATS_MODEL = dict(MODEL, in_ch=[4], n_classes=4)
LR = 2.5e-4
STEPS = 4


def _train_config(globs, save_path):
    return dict(tiny_train_config("AutoPETII", globs, LR),
                save_path=save_path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    globs = make_autopet_fixtures(str(root / "data"), n_cases=5)
    ckpt = jax_resume_checkpoint(root / "start" / "run" / "0.ckpt", MODEL,
                                 seed=21, lr=LR)
    with jax_compile_cache(root / "jax_cache"):
        out = run_both_trainers(root, "AutoPETII", {"VeloxSeg": MODEL},
                                _train_config(globs, None), ckpt)
        ws = driver_workspace(root / "serve", "AutoPETII",
                              {"VeloxSeg": MODEL}, (32, 32, 32), globs)
        out["serve"] = run_both_drivers(
            ws, ["--model_name", "VeloxSeg", "--use_hd95", "1",
                 "--checkpoint_dir", out["port"]["save_path"]])
    return out


def test_losses_match_jax(runs):
    got, want = runs["port"]["losses"], runs["jax"]["losses"]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the logs print the same iterations, the loss to 4 decimals
    pat = re.compile(r"train (\d+)/3 (\d+)/2 Training Loss:([\d.]+)")
    lines = {s: pat.findall(runs[s]["log"]) for s in ("jax", "port")}
    assert [l[:2] for l in lines["port"]] == [l[:2] for l in lines["jax"]] \
        == [("2", "0"), ("2", "1"), ("3", "0"), ("3", "1")]
    for p, j in zip(lines["port"], lines["jax"]):
        assert abs(float(p[2]) - float(j[2])) <= 1e-4 * float(j[2]) + 1e-4


def test_best_dice_and_checkpoints_match_jax(runs):
    port, ref = runs["port"], runs["jax"]
    assert port["best_train_dice"] == pytest.approx(ref["best_train_dice"],
                                                    abs=2e-3)
    assert port["best_val_dice"] == pytest.approx(ref["best_val_dice"],
                                                  abs=2e-3)
    assert 0.0 < port["best_val_dice"] <= 1.0
    stems = {s: sorted(os.path.splitext(f)[0] for f in
                       os.listdir(runs[s]["save_path"])
                       if f.endswith((".pth", ".ckpt")))
             for s in ("jax", "port")}
    assert stems["port"] == stems["jax"] == ["1", "2", "train_best",
                                             "val_best"]
    assert "Resumed from" in port["log"] and "at epoch 1" in port["log"]
    # the trainer steps in bf16 (the fixture forces its step to fp32)
    assert "steps in bfloat16" in port["log"]
    assert "epoch 3 split:" in port["log"]
    payload = torch.load(os.path.join(port["save_path"], "2.pth"),
                         weights_only=True)
    assert payload["epoch"] == 2
    steps = {float(s["step"]) for s in
             payload["optimizer"]["state"].values()}
    assert steps == {1.0 + STEPS}


def test_final_weights_match_jax(runs):
    got = runs["port"]["state"].model.state_dict()
    ref = state_dict_from_jax(jax.device_get(runs["jax"]["state"].params))
    n = assert_adamw_weights_close(got, ref, runs["jax_grad_max"], LR,
                                   STEPS)
    assert n["real"] > 0.3 * (n["real"] + n["noise"]), n


def test_served_val_best_csvs_agree(runs):
    r = runs["serve"]
    assert len(r["port"]["masks"]) == len(r["jax"]["masks"]) == 2
    for jm, pm, lg in zip(r["jax"]["masks"], r["port"]["masks"],
                          r["jax"]["logits"]):
        assert_masks_agree(jm, pm, lg)
    same = [bool((jm == pm).all()) for jm, pm in
            zip(r["jax"]["masks"], r["port"]["masks"])]
    assert_csvs_agree(r["jax"]["csv"], r["port"]["csv"], same)
    assert "val_best.pth" in r["port"]["log"]


@pytest.fixture(scope="module")
def brats_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_brats")
    globs = make_brats_fixtures(str(root / "data"), n_cases=5)
    ckpt = jax_resume_checkpoint(root / "start" / "run" / "0.ckpt",
                                 BRATS_MODEL, seed=31, lr=LR)
    with jax_compile_cache(root / "jax_cache"):
        return run_both_trainers(root, "BraTS2021",
                                 {"VeloxSeg": BRATS_MODEL},
                                 tiny_train_config("BraTS2021", globs, LR),
                                 ckpt)


def test_brats_losses_and_dice_match_jax(brats_runs):
    port, ref = brats_runs["port"], brats_runs["jax"]
    assert len(port["losses"]) == len(ref["losses"]) == STEPS
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
    for key in ("best_train_dice", "best_val_dice"):
        assert port[key] == pytest.approx(ref[key], abs=2e-3), key
    # validation reports BraTS's regions, in the JAX order
    pat = re.compile(r"validation epoch (\d): avg:([\d.]+) et:([\d.]+) "
                     r"tc:([\d.]+) wt:([\d.]+)")
    got, want = pat.findall(port["log"]), pat.findall(ref["log"])
    assert [g[0] for g in got] == [w[0] for w in want] == ["2", "3"]
    for g, w in zip(got, want):
        for a, b in zip(g[1:], w[1:]):
            assert abs(float(a) - float(b)) <= 2e-3
    assert port["best_val_dice"] == pytest.approx(
        max(float(g[1]) for g in got), abs=1e-4)


def test_brats_final_weights_match_jax(brats_runs):
    got = brats_runs["port"]["state"].model.state_dict()
    ref = state_dict_from_jax(jax.device_get(
        brats_runs["jax"]["state"].params))
    n = assert_adamw_weights_close(got, ref, brats_runs["jax_grad_max"],
                                   LR, STEPS)
    assert n["real"] > 0.3 * (n["real"] + n["noise"]), n


# U-RWKV at its published AutoPET-II config: WKV's backward (K6b's plain
# sweeps on the CPU) under the trainer
URWKV = {"input_channel": 2, "num_classes": 2}


@pytest.fixture(scope="module")
def urwkv_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_urwkv")
    globs = make_autopet_fixtures(str(root / "data"), n_cases=5)
    ckpt = jax_zoo_resume_checkpoint(root / "start" / "run" / "0.ckpt",
                                     "U-RWKV", URWKV, (32, 32, 32), seed=41,
                                     lr=LR)
    with jax_compile_cache(root / "jax_cache"):
        return run_both_trainers(root, "AutoPETII", {"U-RWKV": URWKV},
                                 tiny_train_config("AutoPETII", globs, LR),
                                 ckpt, model_name="U-RWKV")


def test_urwkv_losses_and_dice_match_jax(urwkv_runs):
    port, ref = urwkv_runs["port"], urwkv_runs["jax"]
    assert len(port["losses"]) == len(ref["losses"]) == STEPS
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
    for key in ("best_train_dice", "best_val_dice"):
        assert port[key] == pytest.approx(ref[key], abs=2e-3), key
    assert "Resumed from" in port["log"] and "at epoch 1" in port["log"]
    stems = sorted(os.path.splitext(f)[0] for f in
                   os.listdir(port["save_path"]) if f.endswith(".pth"))
    assert stems == ["1", "2", "train_best", "val_best"]


def test_urwkv_final_weights_match_jax(urwkv_runs):
    got = urwkv_runs["port"]["state"].model.state_dict()
    ref = urwkv_runs["state_map"](jax.device_get(
        urwkv_runs["jax"]["state"].params))
    n = assert_adamw_weights_close(got, ref, urwkv_runs["jax_grad_max"],
                                   LR, STEPS)
    assert n["real"] > 0.3 * (n["real"] + n["noise"]), n


@pytest.mark.parametrize("case", ["no_cuda", "mesh", "distributed",
                                  "model"])
def test_run_train_refuses(tmp_path, case):
    """Without a card the default device raises, in ``run_train`` and in
    the CLI; ``--mesh``, ``--distributed`` and a model the port does not
    train yet (UNETRpp, whose train forward adds deep supervision) raise,
    naming the ROADMAP item that ports them."""
    from veloxseg_torch.cli.train_main import main
    args = argparse.Namespace(dataset_name="AutoPETII",
                              model_name="VeloxSeg", mesh=None,
                              distributed=None)
    if case == "no_cuda":
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrainer.run_train(args, {}, {"VeloxSeg": MODEL})
        (tmp_path / "t.json").write_text("{}")
        (tmp_path / "m.json").write_text('{"VeloxSeg": {}}')
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--dataset_name", "AutoPETII", "--model_name", "VeloxSeg",
                  "--train_config", str(tmp_path / "t.json"),
                  "--model_config", str(tmp_path / "m.json")])
        return
    if case == "model":
        args.model_name = "UNETRpp"
    else:
        setattr(args, case, "auto")
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item"):
        ttrainer.run_train(args, {}, {"VeloxSeg": MODEL, "UNETRpp": {}},
                           device="cpu")


@pytest.mark.parametrize("name", ["U-RWKV", "UNet", "MedNeXt", "SwinUNETR",
                                  "U-KAN"])
def test_cli_trains_zoo_model(fixture_globs, tmp_path, name):
    """``cli.train_main`` accepts the five zoo models the port trains, at
    their published AutoPET-II configs: it builds the model (SwinUNETR at
    the patch), its loss branch and its bf16 step, and runs an epoch count
    of 0 to its end (the seven that draw in training: in
    ``test_torch_zoo_train_dropout.py``); the four others raise
    (``test_run_train_refuses``)."""
    import json
    from veloxseg_torch.cli.train_main import main
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "config",
            "models_config_autopetii.json")) as f:
        published = json.load(f)
    tc = dict(_train_config(fixture_globs, str(tmp_path / "save")),
              epochs=0)
    (tmp_path / "t.json").write_text(json.dumps(tc))
    (tmp_path / "m.json").write_text(json.dumps(published))
    res = main(["--dataset_name", "AutoPETII", "--model_name", name,
                "--train_config", str(tmp_path / "t.json"),
                "--model_config", str(tmp_path / "m.json"),
                "--device", "cpu", "--num_workers", "1"])
    assert name in ttrainer.TRAINABLE
    assert res["state"].step == 0
    assert not hasattr(res["state"].model, "cfg")  # not VeloxSeg's config
    log = [f for f in os.listdir(res["save_path"]) if f.endswith(".log")]
    with open(os.path.join(res["save_path"], log[0])) as f:
        assert "steps in bfloat16" in f.read()


@pytest.fixture(scope="module")
def fixture_globs(tmp_path_factory):
    return make_autopet_fixtures(str(tmp_path_factory.mktemp("opts")),
                                 n_cases=5)


def _port_run(globs, root, **over):
    """One epoch of the port's ``run_train`` on the CPU at TINY, batch_size
    1 (three loader batches of 2 patches), from seeded weights."""
    args = argparse.Namespace(dataset_name="AutoPETII", model_name="VeloxSeg",
                              checkpoint_path=None, num_workers=2,
                              model_index=None, select_modal=None)
    tc = dict(_train_config(globs, str(root / "save")), epochs=1,
              batch_size=1, **over)
    res = ttrainer.run_train(args, tc, {"VeloxSeg": MODEL}, device="cpu")
    log = [f for f in os.listdir(res["save_path"]) if f.endswith(".log")]
    with open(os.path.join(res["save_path"], log[0])) as f:
        res["log"] = f.read()
    return res


def test_trainer_options(fixture_globs, tmp_path):
    """``steps_per_dispatch`` 2 is accepted and logged, and runs the plain
    loop's steps, ending at the same weights bit for bit; ``grad_accum`` 2
    makes one update of the
    first two batches and logs it as one iteration; ``async_checkpoint``
    writes the same files; ``profile_dir`` writes a trace."""
    plain = _port_run(fixture_globs, tmp_path / "plain")
    multi = _port_run(fixture_globs, tmp_path / "multi",
                      steps_per_dispatch=2, async_checkpoint=True,
                      profile_dir=str(tmp_path / "trace"))
    for (k, a), b in zip(plain["state"].model.state_dict().items(),
                         multi["state"].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert plain["state"].step == multi["state"].step == 3
    pat = re.compile(r"Training Loss:([\d.]+)")
    assert pat.findall(plain["log"]) == pat.findall(multi["log"])
    assert "steps_per_dispatch: 2" in multi["log"]
    assert sorted(os.listdir(multi["save_path"])) == sorted(
        os.listdir(plain["save_path"]))
    assert os.listdir(tmp_path / "trace")
    accum = _port_run(fixture_globs, tmp_path / "accum", grad_accum=2)
    assert accum["state"].step == 2
    assert len(pat.findall(accum["log"])) == 2
    with pytest.raises(ValueError, match="mutually exclusive"):
        _port_run(fixture_globs, tmp_path / "both", grad_accum=2,
                  steps_per_dispatch=2)


@pytest.mark.parametrize("device,gpu_id,want", [
    ("cpu", "0", "cpu"), ("cpu", "3", "cpu"), ("cuda", "1", RuntimeError),
    ("cuda", "0,1", ValueError)])
def test_cli_device(device, gpu_id, want):
    """``--gpu_id`` picks the card under ``--device cuda`` and raises when
    it is not one index; the CPU ignores it."""
    from veloxseg_torch.utils.device import cli_device
    if want is RuntimeError and torch.cuda.is_available():
        pytest.skip("a card is present")
    if isinstance(want, str):
        assert cli_device(device, gpu_id) == torch.device(want)
    else:
        with pytest.raises(want):
            cli_device(device, gpu_id)
