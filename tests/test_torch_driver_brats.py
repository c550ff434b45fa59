"""The port's serving CLI against the JAX package's on the CPU, BraTS2021
(four MR sequences stacked as one 4-channel input, 4 classes): the ET, TC
and WT dice and HD95 columns, and ``--specific_sample``'s NIfTIs (inputs,
prediction and the three region masks). Same fixtures
(``tests/make_fixtures.make_brats_fixtures``) and the same JAX ``.ckpt``
for both drivers; the TINY config of ``tests/test_cli_e2e.py`` with
``in_ch`` [4] and 4 classes."""

import os

import numpy as np
import pytest

from tests.make_fixtures import make_brats_fixtures
from torch_port_helpers import (TINY_JSON, assert_csvs_agree,
                                assert_logits_agree, assert_masks_agree,
                                driver_workspace, jax_compile_cache,
                                randomize_, run_both_drivers)
from veloxseg_torch.data.nifti import load_nifti
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.train.checkpoint import save_checkpoint

BRATS_JSON = dict(TINY_JSON, in_ch=[4], n_classes=4)
REGIONS = {"et": (3,), "tc": (1, 3), "wt": (1, 2, 3)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver_brats")
    globs = make_brats_fixtures(str(root / "data"), n_cases=4)
    model, _ = build_veloxseg(BRATS_JSON, device="cpu")
    randomize_(model, seed=12, scale=0.3)
    save_checkpoint(str(root / "ckpt" / "val_best.ckpt"),
                    convert_state_dict(model.state_dict()))
    ws = driver_workspace(root, "BraTS2021", {"VeloxSeg": BRATS_JSON},
                          (32, 32, 32), globs)
    args = ["--model_name", "VeloxSeg", "--checkpoint_dir",
            str(root / "ckpt")]
    with jax_compile_cache(root / "jax_cache"):
        out = {"csv": run_both_drivers(ws, args + ["--use_hd95", "1"]),
               "sample": run_both_drivers(ws, args + ["--specific_sample",
                                                      "1"])}
    out["ws"] = ws
    return out


def test_logits_match_jax(runs):
    for run in ("csv", "sample"):
        r = runs[run]
        for jl, pl in zip(r["jax"]["logits"], r["port"]["logits"]):
            assert jl.shape == pl.shape == (48, 48, 32, 4)
            # the TINY forward's tolerance (test_torch_model.py)
            assert_logits_agree(jl, pl, 1e-5)


def test_masks_agree_but_near_ties(runs):
    r = runs["csv"]
    assert len(r["port"]["masks"]) == 2
    for jm, pm, lg in zip(r["jax"]["masks"], r["port"]["masks"],
                          r["jax"]["logits"]):
        assert assert_masks_agree(jm, pm, lg) <= 0.001 * jm.size
        # every class is predicted somewhere: each region is non-empty
        assert set(np.unique(pm)) == {0, 1, 2, 3}


def test_csv_matches_jax(runs):
    r = runs["csv"]
    same = [bool((jm == pm).all()) for jm, pm in
            zip(r["jax"]["masks"], r["port"]["masks"])]
    assert_csvs_agree(r["jax"]["csv"], r["port"]["csv"], same)
    assert r["port"]["csv"].splitlines()[0] == (
        "name,dice_avg,dice_et,dice_tc,dice_wt,time,hd95_avg,hd95_et,"
        "hd95_tc,hd95_wt")
    assert [row["name"] for row in r["port"]["rows"]] == [
        "BraTS002_seg.nii.gz", "BraTS003_seg.nii.gz"]
    assert "BraTS003_seg.nii.gz: Avg" in r["port"]["log"]


def test_specific_sample_writes_no_csv(runs):
    r = runs["sample"]
    assert r["port"]["rows"] == r["jax"]["rows"] == []
    assert r["port"]["csv"] is None and r["jax"]["csv"] is None
    assert "Saved prediction for BraTS003_seg.nii.gz" in r["port"]["log"]


@pytest.mark.parametrize("kind", ["flair", "t1", "t1ce", "t2", "pred",
                                  "et", "tc", "wt"])
def test_specific_sample_niftis(runs, kind):
    ws = runs["ws"]
    name = f"BraTS003_seg_{kind}.nii.gz"
    port = load_nifti(os.path.join(ws["port"]["pred"], name))
    ref = load_nifti(os.path.join(ws["jax"]["pred"], name))
    assert port.shape == ref.shape == (48, 48, 32)
    assert port.spacing == ref.spacing
    np.testing.assert_array_equal(port.affine, ref.affine)
    if kind in ("flair", "t1", "t1ce", "t2"):
        np.testing.assert_array_equal(port.data, ref.data)
        return
    logits = runs["sample"]["jax"]["logits"][0]
    pred = load_nifti(os.path.join(ws["port"]["pred"],
                                   "BraTS003_seg_pred.nii.gz")).data
    if kind == "pred":
        assert_masks_agree(ref.data, port.data, logits)
    else:
        np.testing.assert_array_equal(port.data,
                                      np.isin(pred, REGIONS[kind]))
        # the JAX region mask differs only where its prediction does
        jpred = load_nifti(os.path.join(ws["jax"]["pred"],
                                        "BraTS003_seg_pred.nii.gz")).data
        assert ((port.data != ref.data) <= (pred != jpred)).all()
