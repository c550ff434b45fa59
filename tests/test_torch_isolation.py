"""The port stands alone: ``veloxseg_torch`` and ``chip_smoke.py`` load
nothing of JAX, Flax or ``veloxseg_tpu`` (the eval forward and a train
step run with those imports blocked), and the entry points refuse to run
quietly on the CPU when CUDA is absent."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "veloxseg_tpu"):
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
    step = train_step_fn(CompositeLoss({{
        "deep_Loss_weight": [1, 1, 1, 1], "RC_Loss_weight": 0.5,
        "Feature_Loss_weight": 2.0}}, cfg), device="cpu")
    x = torch.randn(1, 32, 32, 32, 2)
    _, aux = step(state, x, (x[..., 0] > 0).long(),
                  torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(aux["loss"]))
    bad = sorted(n for n, m in sys.modules.items() if m is not None and
                 n.split(".")[0] in ("jax", "jaxlib", "flax", "veloxseg_tpu"))
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


def test_port_imports_nothing_of_jax():
    r = _run(_ISOLATED.format(root=ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED" in r.stdout
    assert int(r.stdout.split("ISOLATED")[1].split()[0]) >= 26


def test_entry_points_default_to_cuda():
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
    loss = CompositeLoss({"deep_Loss_weight": [1], "RC_Loss_weight": 0.5,
                          "Feature_Loss_weight": 2.0}, VeloxSegConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_step_fn(loss)


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
