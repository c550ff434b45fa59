"""The port's serving CLI (``veloxseg_torch.cli.test_main``, run with
``--device cpu``) against the JAX package's (``veloxseg_tpu.cli.test_main``)
on the CPU, AutoPET-II: the same NIfTI fixtures (``tests/make_fixtures.py``)
and the same checkpoint file, read by both drivers. Cases: a JAX ``.ckpt``
(a full training payload) with ``--use_hd95 1``; the same weights as a
reference-keyed ``.pth``; the host-summed sliding window
(``CPU_STITCH_THRESHOLD`` lowered in both drivers). ``--mesh`` raises in
the port. The TINY config of ``tests/test_cli_e2e.py`` at a 32³ ROI over
48 × 48 × 32 volumes: 4 tiles in two calls of 3, the second ragged."""

import os

import numpy as np
import optax
import pytest
import torch

from tests.make_fixtures import make_autopet_fixtures
from torch_port_helpers import (TINY_JSON, assert_csvs_agree,
                                assert_logits_agree, assert_masks_agree,
                                driver_workspace, jax_compile_cache,
                                randomize_, run_both_drivers)
from veloxseg_torch.cli.test_main import main as port_main
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.train.checkpoint import save_checkpoint

CASES = ("ckpt", "pth", "stitch")


def reference_pth(model: torch.nn.Module) -> dict:
    """The model's weights as the reference trainer saves them: wrapped
    under ``"model"``, DDP-prefixed, with the position-index buffers the
    reference keeps in its state dict."""
    sd = dict(model.state_dict())
    sd.update({n: b for n, b in model.named_buffers()
               if n.endswith("relative_position_index")})
    return {"model": {f"module.{k}": v for k, v in sd.items()},
            "epoch": 5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver_autopet")
    globs = make_autopet_fixtures(str(root / "data"), n_cases=5)
    model, _ = build_veloxseg(TINY_JSON, device="cpu")
    randomize_(model, seed=11, scale=0.3)
    params = convert_state_dict(model.state_dict())
    save_checkpoint(str(root / "ckpt" / "val_best.ckpt"), params,
                    optax.adamw(1e-3).init(params), epoch=3,
                    best_val_dice=0.25)
    os.makedirs(root / "pth")
    torch.save(reference_pth(model), str(root / "pth" / "val_best.pth"))
    ws = driver_workspace(root, "AutoPETII", {"VeloxSeg": TINY_JSON},
                          (32, 32, 32), globs)
    args = ["--model_name", "VeloxSeg", "--sw_batch_size", "3",
            "--use_hd95", "1", "--checkpoint_dir"]
    with jax_compile_cache(root / "jax_cache"):
        out = {
            "ckpt": run_both_drivers(ws, args + [str(root / "ckpt")]),
            "pth": run_both_drivers(ws, args + [str(root / "pth")]),
            "stitch": run_both_drivers(ws, args + [str(root / "ckpt")],
                                       stitch_threshold=1000),
        }
    out["ws"] = ws
    return out


@pytest.mark.parametrize("case", CASES)
def test_logits_match_jax(runs, case):
    r = runs[case]
    for jl, pl in zip(r["jax"]["logits"], r["port"]["logits"]):
        assert jl.shape == pl.shape == (48, 48, 32, 2)
        # the TINY forward's tolerance (test_torch_model.py)
        assert_logits_agree(jl, pl, 1e-5)


@pytest.mark.parametrize("case", CASES)
def test_masks_agree_but_near_ties(runs, case):
    r = runs[case]
    assert len(r["port"]["masks"]) == len(r["jax"]["masks"]) == 2
    for jm, pm, lg in zip(r["jax"]["masks"], r["port"]["masks"],
                          r["jax"]["logits"]):
        assert assert_masks_agree(jm, pm, lg) <= 0.001 * jm.size
        # both classes predicted: the metrics are not degenerate
        assert 0 < pm.mean() < 1


@pytest.mark.parametrize("case", CASES)
def test_csv_matches_jax(runs, case):
    r = runs[case]
    same = [bool((jm == pm).all()) for jm, pm in
            zip(r["jax"]["masks"], r["port"]["masks"])]
    assert_csvs_agree(r["jax"]["csv"], r["port"]["csv"], same)
    header = r["port"]["csv"].splitlines()[0]
    assert header == ("name,fp_rate,fn_rate,precision,recall,f1,iou,dice,"
                      "time,hd95")
    assert [row["name"] for row in r["port"]["rows"]] == [
        "case003.nii.gz", "case004.nii.gz"]


def test_pth_serves_as_the_ckpt(runs):
    # one set of weights in two files: the same masks and metrics
    for side in ("jax", "port"):
        a, b = runs["ckpt"][side], runs["pth"][side]
        for ma, mb in zip(a["masks"], b["masks"]):
            np.testing.assert_array_equal(ma, mb)
        for ra, rb in zip(a["rows"], b["rows"]):
            assert {k: v for k, v in ra.items() if k != "time"} == \
                {k: v for k, v in rb.items() if k != "time"}


def test_stitch_sums_on_the_host(runs):
    assert runs["stitch"]["port"]["stitched"] == [True, True]
    assert runs["stitch"]["jax"]["stitched"] == [True, True]
    assert runs["ckpt"]["port"]["stitched"] == [False, False]
    # the same float32 adds in the same tile order, on the host
    for la, lb in zip(runs["ckpt"]["port"]["logits"],
                      runs["stitch"]["port"]["logits"]):
        np.testing.assert_array_equal(la, lb)


def test_log_lines(runs):
    log = runs["ckpt"]["port"]["log"]
    assert "Loading checkpoint" in log and "val_best.ckpt" in log
    for name in ("case003.nii.gz: Dice", "case004.nii.gz: Dice",
                 "Mean metrics:", "Wrote "):
        assert name in log
    assert " | s: read " in log and " hd95 " in log


@pytest.mark.parametrize("flag,value", [("--mesh", "data=2"),
                                        ("--distributed", "auto")])
def test_multi_device_flags_raise(runs, flag, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_main(runs["ws"]["port"]["flags"] + [
            "--model_name", "VeloxSeg", flag, value, "--device", "cpu"])
