"""The port's cross-dataset CLI (``veloxseg_torch/cli/extern_main.py``)
against the JAX package's (``veloxseg_tpu/cli/extern_main.py``) on the same
NIfTI files and checkpoints, on the CPU.

- ``resample_to_spacing`` equal bit for bit (trilinear and nearest,
  volumes off the training spacing and one on it).
- Both branches, each run by both CLIs: 3-D single-channel cases at a
  spacing unlike the training spacing (images and labels resampled, each
  case repeated to the model's two input channels) with a comma list of
  two checkpoints, and 4-channel MSD-style cases z-scored per volume
  (``--normalize_intensity 1``) with a BraTS-shaped model. The blended
  logits agree within 1e-5 of their scale (the eval forward's parity
  rule), the masks but where JAX's top-2 margin is below 1e-4, and the
  CSVs have the same file name, columns and rows, every metric within
  1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import (TINY_JSON, assert_logits_agree,
                                assert_masks_agree, randomize_, read_csv)
from veloxseg_torch.cli import extern_main as port_extern
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_tpu.cli import extern_main as jax_extern
from veloxseg_tpu.data.nifti import save_nifti

BRATS_JSON = dict(TINY_JSON, in_ch=[4], n_classes=4)


# spacings off the 2 mm target (shrinking, growing, both), and one within
# 1e-3 of it on every axis (returned as it is)
SPACINGS = [(1.5, 1.2, 3.0), (2.5, 4.0, 2.2), (0.8, 0.8, 1.0),
            (2.0, 2.0, 2.0005)]


@pytest.mark.parametrize("shape", [(21, 18, 11), (16, 16, 16)])
@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("order", [0, 1])
def test_resample_to_spacing_is_the_jax_one(order, spacing, shape):
    rng = np.random.default_rng(order)
    vol = rng.standard_normal(shape).astype(np.float32)
    if order == 0:
        vol = (vol > 0.5).astype(np.int32)
    got = port_extern.resample_to_spacing(vol, spacing, (2.0, 2.0, 2.0),
                                          order)
    want = jax_extern.resample_to_spacing(vol, spacing, (2.0, 2.0, 2.0),
                                          order)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _blob_case(rng, shape):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    c = [s // 2 for s in shape]
    lab = (((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
           < (min(shape) // 3) ** 2).astype(np.int16)
    img = rng.standard_normal(shape).astype(np.float32) + 2.0 * lab
    return img, lab


def _workspace(root, model_json, cases, spacing, checkpoints):
    """The images, labels, checkpoints and the three configs of one run."""
    os.makedirs(root / "img")
    os.makedirs(root / "lab")
    rng = np.random.default_rng(11)
    for i in range(cases[0]):
        img, lab = _blob_case(rng, cases[1])
        if cases[2] > 1:    # MSD-style: the modalities on a fourth axis
            img = np.stack([img * (j + 1) + j for j in range(cases[2])], -1)
        save_nifti(str(root / "img" / f"case{i}.nii.gz"), img, spacing)
        save_nifti(str(root / "lab" / f"case{i}.nii.gz"), lab, spacing)
    paths = []
    for seed in checkpoints:
        model, _ = build_veloxseg(model_json, device="cpu")
        randomize_(model, seed, scale=0.3)
        paths.append(str(root / f"ckpt{seed}.pth"))
        torch.save(model.state_dict(), paths[-1])
    cfgs = {
        "train.json": {"patch_size": {"AutoPETII": [32, 32, 32]},
                       "spacing": {"AutoPETII": [2.0, 2.0, 2.0]},
                       "dataset_path": {"Extern": {
                           "data_path": str(root / "img" / "*.nii.gz"),
                           "label_path": str(root / "lab" / "*.nii.gz")}}},
        "models.json": {"VeloxSeg": model_json},
    }
    for side in ("jax", "port"):
        cfgs[f"test_{side}.json"] = {
            "result_metric_path": str(root / side),
            "sliding_window": {"overlap": 0.25}}
    for name, data in cfgs.items():
        (root / name).write_text(json.dumps(data))
    return ["--dataset_name", "Extern", "--train_dataset", "AutoPETII",
            "--model_name", "VeloxSeg", "--checkpoints", ",".join(paths),
            "--train_config", str(root / "train.json"),
            "--model_config", str(root / "models.json")]


def _run_both(root, flags):
    """Both CLIs on the same flags; the blended logits each computed."""
    import veloxseg_torch.infer.sliding_window as tsw
    import veloxseg_tpu.infer.sliding_window as jsw
    logits = {"jax": [], "port": []}

    def spy(mod, side):
        inner = mod.sliding_window_inference

        def wrapped(*a, **kw):
            res = inner(*a, **kw)
            logits[side].append(np.asarray(res[0]))
            return res
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsw, "sliding_window_inference", spy(jsw, "jax"))
        mp.setattr(tsw, "sliding_window_inference", spy(tsw, "port"))
        jax_extern.main(flags + ["--test_config",
                                 str(root / "test_jax.json")])
        rows = port_extern.main(flags + ["--test_config",
                                         str(root / "test_port.json"),
                                         "--device", "cpu"])
    csvs = {side: (root / side / "extern_Extern_VeloxSeg.csv").read_text()
            for side in ("jax", "port")}
    return logits, csvs, rows


def _assert_agree(logits, csvs, n_rows):
    assert len(logits["jax"]) == len(logits["port"]) == n_rows
    for jl, pl in zip(logits["jax"], logits["port"]):
        assert jl.shape == pl.shape
        assert_logits_agree(jl, pl, 1e-5)
        assert_masks_agree(jl.argmax(-1), pl.argmax(-1), jl)
    jh, jrows = read_csv(csvs["jax"])
    ph, prows = read_csv(csvs["port"])
    assert ph == jh and jh[:2] == ["checkpoint", "name"]
    assert jh[-1] == "time" and "dice" in jh
    assert len(prows) == len(jrows) == n_rows
    for jr, pr in zip(jrows, prows):
        assert pr[:2] == jr[:2]
        for col, a, b in zip(jh[2:-1], jr[2:-1], pr[2:-1]):
            assert abs(float(a) - float(b)) <= 1e-4, (col, a, b)


def test_extern_resamples_like_jax(tmp_path):
    # 2 cases of (36, 40, 14) at (1.5, 1.5, 3.0) mm against a 2 mm training
    # spacing: resampled to (27, 30, 21); two checkpoints
    flags = _workspace(tmp_path, TINY_JSON, (2, (36, 40, 14), 1),
                       (1.5, 1.5, 3.0), (1, 2))
    logits, csvs, rows = _run_both(tmp_path, flags)
    assert logits["port"][0].shape == (27, 30, 21, 2)
    _assert_agree(logits, csvs, 4)
    assert [r["checkpoint"] for r in rows] == ["ckpt1.pth"] * 2 + \
        ["ckpt2.pth"] * 2


def test_extern_zscore_branch_like_jax(tmp_path):
    # 2 MSD-style cases of (30, 28, 24, 4), z-scored per volume
    flags = _workspace(tmp_path, BRATS_JSON, (2, (30, 28, 24), 4),
                       (1.0, 1.0, 1.0), (3,))
    logits, csvs, _ = _run_both(tmp_path, flags + ["--normalize_intensity",
                                                   "1"])
    assert logits["port"][0].shape == (30, 28, 24, 4)
    _assert_agree(logits, csvs, 2)
