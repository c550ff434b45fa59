"""The port stands alone: ``veloxseg_torch`` and ``chip_smoke.py`` load
nothing of JAX, Flax or ``veloxseg_tpu``, and the entry points refuse to
run quietly on the CPU when CUDA is absent."""

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
    bad = sorted(n for n, m in sys.modules.items() if m is not None and
                 n.split(".")[0] in ("jax", "jaxlib", "flax", "veloxseg_tpu"))
    assert not bad, bad
    print("ISOLATED", len(mods))
""")


def _run(code, cwd=ROOT, args=()):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, *args, "-c", code] if code
                          else [sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_nothing_of_jax():
    r = _run(_ISOLATED.format(root=ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED" in r.stdout
    assert int(r.stdout.split("ISOLATED")[1].split()[0]) >= 20


def test_entry_points_default_to_cuda():
    from veloxseg_torch.core.config import VeloxSegConfig
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_veloxseg(VeloxSegConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_veloxseg(VeloxSegConfig(), device="cuda")


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
