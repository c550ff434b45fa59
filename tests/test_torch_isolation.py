"""The port stands alone: ``veloxseg_torch`` and ``chip_smoke.py`` load
nothing of JAX, Flax, msgpack, pandas or ``veloxseg_tpu`` (the eval
forward, a train step, the 128³ flagship's long-window attention, a U-RWKV
forward and the serving CLI, from a JAX-written ``.ckpt`` and a ``.pth``,
then the export, preprocess and extern CLIs, and the eight zoo baselines'
builds and a SegFormer forward, run with those imports blocked), and the entry points refuse to run quietly on the CPU when CUDA
is absent."""

import argparse
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "msgpack", "pandas",
                 "veloxseg_tpu"):
        sys.modules[name] = None            # any import of these fails
    import torch
    import veloxseg_torch
    mods = [m.name for m in pkgutil.walk_packages(
        veloxseg_torch.__path__, "veloxseg_torch.")]
    for m in mods:
        importlib.import_module(m)
    sys.path.insert(0, {root!r})
    import chip_smoke                       # imports only; main() not run
    from veloxseg_torch.core.config import VeloxSegConfig
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    cfg = VeloxSegConfig(input_size=(32, 32, 32), base_ch=8, attn_base_ch=8,
                         depths=(1, 1, 1, 1),
                         min_big_window_sizes=((2, 2, 2), (2, 2, 2),
                                               (2, 2, 2), (1, 1, 1)))
    model, _ = build_veloxseg(cfg, device="cpu")
    with torch.no_grad():
        y = model(torch.randn(1, 32, 32, 32, 2))
    assert y.shape == (1, 32, 32, 32, 2) and bool(torch.isfinite(y).all())
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.optim import build_optimizer
    from veloxseg_torch.train.train_state import (create_train_state,
                                                  train_step_fn)
    state = create_train_state(model, build_optimizer(
        "adamw", {{"lr": 2.5e-4, "weight_decay": 0.01}}, model.parameters()))
    step = train_step_fn(CompositeLoss("VeloxSeg", {{
        "deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
        "Feature_Loss_weight": 2.0}}, num_modal=cfg.num_modalities),
        device="cpu")
    x = torch.randn(1, 32, 32, 32, 2)
    _, aux = step(state, x, (x[..., 0] > 0).long(),
                  torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(aux["loss"]))
    # the 128³ flagship builds; its level-1 attention path (K3's plain
    # version on the CPU) and a U-RWKV forward from the registry run
    from veloxseg_torch.core.config import flagship_config
    from veloxseg_torch.ops.pwa_attention import window_attention_train
    build_veloxseg(flagship_config(), device="cpu")
    q = torch.randn(1, 1, 1, 8, 1024, requires_grad=True)
    out = window_attention_train(q, q, q, torch.zeros(1, 1024, 1024),
                                 torch.tensor([1, 0], dtype=torch.int32),
                                 0.35, 0.1)
    out.sum().backward()
    from veloxseg_torch.models.registry import load_model
    urwkv = load_model("U-RWKV", {{"U-RWKV": {{"input_channel": 2,
                                               "num_classes": 2}}}},
                       device="cpu")
    with torch.no_grad():
        y = urwkv(torch.randn(2, 16, 16, 16, 2))
    assert y.shape == (2, 16, 16, 16, 2) and bool(torch.isfinite(y).all())
    # the serving CLI over NIfTI volumes written by the port, from the
    # JAX-written .ckpt and from the same weights as a .pth
    import json, os
    import numpy as np
    from veloxseg_torch.cli.test_main import main as serve
    from veloxseg_torch.data.nifti import load_nifti, save_nifti
    from veloxseg_torch.train.checkpoint import load_params
    work = {work!r}
    rng = np.random.default_rng(0)
    for i in range(2):
        pet = rng.standard_normal((40, 36, 32)).astype(np.float32)
        save_nifti(os.path.join(work, f"c{{i}}_0000.nii.gz"), pet)
        save_nifti(os.path.join(work, f"c{{i}}_0001.nii.gz"), -pet)
        save_nifti(os.path.join(work, f"c{{i}}.nii.gz"),
                   (pet > 1).astype(np.int16))
    tiny = json.load(open(os.path.join(work, "model.json")))
    model = load_params(os.path.join(work, "ckpt", "val_best.ckpt"),
                        build_veloxseg(tiny["VeloxSeg"], device="cpu")[0])
    os.makedirs(os.path.join(work, "pth"))
    torch.save(model.state_dict(), os.path.join(work, "pth", "val_best.pth"))
    glob_of = lambda p: os.path.join(work, p)
    for name, cfg in (
            ("train.json", {{"patch_size": {{"AutoPETII": [32, 32, 32]}},
                            "train_rate": 0, "val_rate": 0,
                            "dataset_path": {{"AutoPETII": {{
                                "ct_path": glob_of("c*_0001.nii.gz"),
                                "pet_path": glob_of("c*_0000.nii.gz"),
                                "label_path": glob_of("c?.nii.gz")}}}}}}),
            ("test.json", {{"result_metric_path": glob_of("metric"),
                           "sliding_window": {{"overlap": 0.25}}}})):
        json.dump(cfg, open(os.path.join(work, name), "w"))
    rows = [serve(["--dataset_name", "AutoPETII", "--model_name",
                   "VeloxSeg", "--use_hd95", "1", "--device", "cpu",
                   "--checkpoint_dir", os.path.join(work, sub)]
                  + [f"--{{k}}_config={{os.path.join(work, k + '.json')}}"
                     for k in ("model", "train", "test")])
            for sub in ("ckpt", "pth")]
    assert [r["name"] for r in rows[0]] == ["c0.nii.gz", "c1.nii.gz"]
    strip = lambda rs: [{{k: v for k, v in r.items() if k != "time"}}
                        for r in rs]
    assert strip(rows[0]) == strip(rows[1])
    assert all(0 <= r["dice"] <= 1 for r in rows[0])
    csv_text = open(os.path.join(work, "metric",
                                 "AutoPETII_VeloxSeg.csv")).read()
    assert csv_text.startswith("name,fp_rate,fn_rate,precision,recall,"
                               "f1,iou,dice,time,hd95")
    # the export, extern and preprocess entry points on the same files
    from veloxseg_torch.cli.export_main import main as export
    from veloxseg_torch.cli.extern_main import main as extern
    from veloxseg_torch.cli.preprocess_main import main as preprocess
    from veloxseg_torch.infer.export import load_artifact
    art = glob_of("tiny.pt2")
    export(["--dataset_name", "AutoPETII", "--model_name", "VeloxSeg",
            "--device", "cpu", "--checkpoint_dir", glob_of("ckpt"),
            "--output", art, "--model_config", glob_of("model.json"),
            "--train_config", glob_of("train.json")])
    program, _, meta = load_artifact(art)
    with torch.no_grad():
        y = program.module()(torch.randn(3, 32, 32, 32, 2))
    assert y.shape == (3, 32, 32, 32, 2) and meta["device"] == "cpu"
    stats = preprocess(["normalize-ctpet", "--ct_glob",
                        glob_of("c*_0001.nii.gz"), "--pet_glob",
                        glob_of("c*_0000.nii.gz"), "--label_glob",
                        glob_of("c?.nii.gz"), "--out_dir", glob_of("norm")])
    assert stats["std"] > 0
    train = json.load(open(glob_of("train.json")))
    train["spacing"] = {{"AutoPETII": [1.5, 1.0, 1.0]}}
    train["dataset_path"]["Extern"] = {{
        "data_path": glob_of("norm/c*_0000.nii.gz"),
        "label_path": glob_of("norm/c?.nii.gz")}}
    json.dump(train, open(glob_of("train_ext.json"), "w"))
    rows = extern(["--dataset_name", "Extern", "--train_dataset",
                   "AutoPETII", "--model_name", "VeloxSeg", "--checkpoints",
                   glob_of("pth/val_best.pth"), "--device", "cpu",
                   "--train_config", glob_of("train_ext.json"),
                   "--model_config", glob_of("model.json"),
                   "--test_config", glob_of("test.json")])
    assert len(rows) == 2 and all(0 <= r["dice"] <= 1 for r in rows)
    # the fifteen zoo baselines build from the published config, and one
    # runs a forward
    zoo = json.load(open(os.path.join({root!r}, "config",
                                      "models_config_autopetii.json")))
    for name in ("UNet", "VNet", "MedNeXt", "UNETR", "SwinUNETR",
                 "SegFormer", "SlimUNETR", "UNETRpp", "VSmTrans",
                 "NestedFormer", "A2FSeg", "HDense", "SuperLightNet",
                 "U-KAN", "HCMA-UNet"):
        load_model(name, zoo, device="cpu")
    with torch.no_grad():
        y = load_model("SegFormer", zoo, device="cpu")(
            torch.randn(1, 32, 32, 32, 2))
    assert y.shape == (1, 32, 32, 32, 2) and bool(torch.isfinite(y).all())
    bad = sorted(n for n, m in sys.modules.items() if m is not None and
                 n.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                     "pandas", "veloxseg_tpu"))
    assert not bad, bad
    print("ISOLATED", len(mods))
""")


def _run(code, cwd=ROOT, args=()):
    # two intra-op threads, as torch_port_helpers sets in the test workers:
    # one per core would crowd the other workers' wall-clock tests
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args, "-c", code] if code
                          else [sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_nothing_of_jax(tmp_path):
    # the .ckpt is written here, by the JAX package's trainer code, and
    # read there without flax
    from tests.torch_port_helpers import TINY_JSON, randomize_
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    from veloxseg_tpu.interop.torch_import import convert_state_dict
    from veloxseg_tpu.train.checkpoint import save_checkpoint
    model, _ = build_veloxseg(TINY_JSON, device="cpu")
    randomize_(model, seed=31, scale=0.3)
    save_checkpoint(str(tmp_path / "ckpt" / "val_best.ckpt"),
                    convert_state_dict(model.state_dict()))
    (tmp_path / "model.json").write_text(json.dumps(
        {"VeloxSeg": TINY_JSON}))
    r = _run(_ISOLATED.format(root=ROOT, work=str(tmp_path)))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED" in r.stdout
    assert int(r.stdout.split("ISOLATED")[1].split()[0]) >= 50


def test_entry_points_default_to_cuda(tmp_path):
    from veloxseg_torch.core.config import VeloxSegConfig
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_veloxseg(VeloxSegConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_veloxseg(VeloxSegConfig(), device="cuda")
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.train_state import train_step_fn
    loss = CompositeLoss("VeloxSeg", {
        "deep_Loss_weight": [1], "RC_Loss_weight": 0.5,
        "Feature_Loss_weight": 2.0}, num_modal=VeloxSegConfig().num_modalities)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_step_fn(loss)
    from veloxseg_torch.models.registry import load_model
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model("U-RWKV", {"U-RWKV": {"input_channel": 2}})
    from veloxseg_torch.infer.driver import run_inference
    args = argparse.Namespace(dataset_name="AutoPETII", model_name="VeloxSeg")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_inference(args, {}, {}, {})
    from veloxseg_torch.cli.test_main import main
    for name in ("train", "model", "test"):
        (tmp_path / f"{name}.json").write_text("{}")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--dataset_name", "AutoPETII", "--model_name", "VeloxSeg"]
             + [f"--{n}_config={tmp_path / (n + '.json')}"
                for n in ("train", "model", "test")])
    from veloxseg_torch.cli.export_main import main as export
    with pytest.raises(RuntimeError, match="CUDA"):
        export(["--dataset_name", "AutoPETII", "--model_name", "VeloxSeg",
                "--output", str(tmp_path / "x.pt2")]
               + [f"--{n}_config={tmp_path / (n + '.json')}"
                  for n in ("train", "model")])
    from veloxseg_torch.cli.extern_main import main as extern
    with pytest.raises(RuntimeError, match="CUDA"):
        extern(["--dataset_name", "X", "--train_dataset", "AutoPETII",
                "--model_name", "VeloxSeg", "--checkpoints", "x.pth"]
               + [f"--{n}_config={tmp_path / (n + '.json')}"
                  for n in ("train", "model", "test")])


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(None, args=(os.path.join(ROOT, "chip_smoke.py"),))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    # alone in an empty directory, without the repo, it fails as well
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
