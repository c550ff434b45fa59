"""The port's serving CLI against the JAX package's on the CPU for the
other models it serves: VeloxSeg with the Hecktor2022 profile
(anisotropic 64 × 64 × 32 ROI and windows, volumes smaller than the ROI,
so every tile is padded) and U-RWKV on AutoPET-II volumes from a JAX
``.ckpt`` holding a bare params tree. Same fixtures and checkpoint file
for both drivers; ``--use_hd95 1``."""

import numpy as np
import pytest
import torch
from flax import serialization

from tests.make_fixtures import make_autopet_fixtures
from torch_port_helpers import (HECKTOR_TINY, TINY_JSON, TIE_MARGIN,
                                assert_csvs_agree, assert_logits_agree,
                                assert_masks_agree, driver_workspace,
                                randomize_, run_both_drivers)
from veloxseg_torch.models.registry import load_model
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.interop.zoo_import import convert_zoo_state_dict
from veloxseg_tpu.train.checkpoint import save_checkpoint

HECKTOR_JSON = dict(
    TINY_JSON, input_size=list(HECKTOR_TINY["input_size"]),
    min_big_window_sizes=[list(w) for w in
                          HECKTOR_TINY["min_big_window_sizes"]])
URWKV_JSON = {"input_channel": 2, "num_classes": 2}
CASES = ("hecktor", "urwkv")
# each model's forward tolerance against JAX, relative to the logits' max:
# VeloxSeg's (test_torch_model.py), and U-RWKV's (test_torch_urwkv.py:
# ~40 convs and batch norms in fp32, where JAX itself is off a float64 run
# by 1.4e-4 of the max, the port by 0.4e-4)
FORWARD_TOL = {"hecktor": 1e-5, "urwkv": 3e-4}


def tie_margin(case, logits):
    """VeloxSeg: the near-tie margin of 1e-4. U-RWKV: a flip needs the two
    logits' difference to move by its margin, so twice the forward
    tolerance of one logit."""
    if case == "hecktor":
        return TIE_MARGIN
    return 2 * FORWARD_TOL[case] * float(np.abs(logits).max())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("driver_models")
    globs = make_autopet_fixtures(str(root / "data"), n_cases=5)
    out = {}

    model, _ = build_veloxseg(HECKTOR_JSON, device="cpu")
    randomize_(model, seed=13, scale=0.3)
    save_checkpoint(str(root / "hecktor" / "val_best.ckpt"),
                    convert_state_dict(model.state_dict()))
    ws = driver_workspace(root / "hk", "Hecktor2022",
                          {"VeloxSeg": HECKTOR_JSON}, (64, 64, 32), globs)
    out["hecktor"] = run_both_drivers(ws, [
        "--model_name", "VeloxSeg", "--use_hd95", "1", "--checkpoint_dir",
        str(root / "hecktor")])

    # U-RWKV: its seeded init with every weight moved off it
    urwkv = load_model("U-RWKV", {"U-RWKV": URWKV_JSON}, device="cpu",
                       seed=0)
    rng = np.random.default_rng(14)
    with torch.no_grad():
        for p in urwkv.parameters():
            p.add_(torch.from_numpy((0.05 * rng.standard_normal(
                tuple(p.shape))).astype(np.float32)))
    params = convert_zoo_state_dict("URWKV", urwkv.state_dict())
    (root / "urwkv").mkdir()
    (root / "urwkv" / "val_best.ckpt").write_bytes(
        serialization.msgpack_serialize(params))
    ws = driver_workspace(root / "ur", "AutoPETII", {"U-RWKV": URWKV_JSON},
                          (32, 32, 32), globs)
    out["urwkv"] = run_both_drivers(ws, [
        "--model_name", "U-RWKV", "--use_hd95", "1", "--checkpoint_dir",
        str(root / "urwkv")])
    return out


@pytest.mark.parametrize("case", CASES)
def test_logits_match_jax(runs, case):
    r = runs[case]
    for jl, pl in zip(r["jax"]["logits"], r["port"]["logits"]):
        assert jl.shape == pl.shape == (48, 48, 32, 2)
        assert_logits_agree(jl, pl, FORWARD_TOL[case])


@pytest.mark.parametrize("case", CASES)
def test_masks_agree_but_near_ties(runs, case):
    r = runs[case]
    assert len(r["port"]["masks"]) == 2
    for jm, pm, lg in zip(r["jax"]["masks"], r["port"]["masks"],
                          r["jax"]["logits"]):
        assert assert_masks_agree(jm, pm, lg, tie_margin(case, lg)) \
            <= 0.001 * jm.size
        assert 0 < pm.mean() < 1


@pytest.mark.parametrize("case", CASES)
def test_csv_matches_jax(runs, case):
    r = runs[case]
    same = [bool((jm == pm).all()) for jm, pm in
            zip(r["jax"]["masks"], r["port"]["masks"])]
    assert_csvs_agree(r["jax"]["csv"], r["port"]["csv"], same)
    assert r["port"]["csv"].splitlines()[0].endswith(",dice,time,hd95")
