"""The port's offline preprocessing CLI
(``veloxseg_torch/cli/preprocess_main.py``) against the JAX package's
(``veloxseg_tpu/cli/preprocess_main.py``) on the same NIfTI files
(``tests/make_fixtures.py``), on the CPU.

Every output NIfTI is the JAX CLI's byte for byte once decompressed (the
gzip header carries the time of writing); the pooled CT statistics are
equal; ``register`` without ``antspyx`` warns and writes nothing, in both.
"""

import gzip
import os
from glob import glob

import numpy as np
import pytest

from tests.make_fixtures import make_autopet_fixtures, make_brats_fixtures
from veloxseg_torch.cli import preprocess_main as port_prep
from veloxseg_tpu.cli import preprocess_main as jax_prep


def _outputs(folder):
    """{path relative to folder: decompressed bytes} of every NIfTI."""
    out = {}
    for f in sorted(glob(os.path.join(folder, "**", "*.nii.gz"),
                         recursive=True)):
        with gzip.open(f, "rb") as fh:
            out[os.path.relpath(f, folder)] = fh.read()
    return out


def _stats_line(text):
    return next(line for line in text.splitlines()
                if line.startswith("CT foreground stats:"))


@pytest.fixture(scope="module")
def ctpet(tmp_path_factory):
    """normalize-ctpet by both CLIs over 4 AutoPET-style cases."""
    root = tmp_path_factory.mktemp("ctpet")
    globs = make_autopet_fixtures(str(root / "raw"), n_cases=4,
                                  shape=(24, 20, 16), seed=3)
    args = ["normalize-ctpet", "--ct_glob", globs["ct_path"], "--pet_glob",
            globs["pet_path"], "--label_glob", globs["label_path"]]
    import contextlib
    import io
    logs = {}
    for side, fn in (("jax", jax_prep.main), ("port", port_prep.main)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = fn(args + ["--out_dir", str(root / side)])
        logs[side] = (buf.getvalue(), ret)
    return root, logs


@pytest.mark.parametrize("kind", ["_0000", "_0001", "label"])
def test_normalize_ctpet_writes_the_jax_bytes(ctpet, kind):
    root, _ = ctpet
    jax_out, port_out = _outputs(root / "jax"), _outputs(root / "port")
    assert sorted(port_out) == sorted(jax_out)
    names = [n for n in jax_out
             if (kind in n if kind != "label" else "_000" not in n)]
    assert len(names) == 4
    for n in names:
        assert port_out[n] == jax_out[n], n


def test_normalize_ctpet_ct_statistics_equal(ctpet):
    _, logs = ctpet
    assert _stats_line(logs["port"][0]) == _stats_line(logs["jax"][0])
    stats = logs["port"][1]
    assert set(stats) == {"mean", "median", "std", "min", "max",
                          "percentile_99_5", "percentile_00_5"}
    assert stats["percentile_00_5"] <= stats["median"] \
        <= stats["percentile_99_5"]


def test_normalize_mri_writes_the_jax_bytes(tmp_path):
    globs = make_brats_fixtures(str(tmp_path / "raw"), n_cases=2,
                                shape=(20, 18, 16), seed=4)
    case_glob = os.path.join(os.path.dirname(os.path.dirname(
        globs["label_path"])), "*", "*.nii.gz")
    for side, fn in (("jax", jax_prep.main), ("port", port_prep.main)):
        fn(["normalize-mri", "--case_glob", case_glob, "--out_dir",
            str(tmp_path / side)])
    jax_out, port_out = _outputs(tmp_path / "jax"), _outputs(tmp_path / "port")
    assert len(jax_out) == 10 and sorted(port_out) == sorted(jax_out)
    for n in jax_out:
        assert port_out[n] == jax_out[n], n
    # the labels are remapped 4 → 3 (the fixtures carry 1, 2, 3)
    from veloxseg_torch.data.nifti import load_nifti
    seg = [n for n in port_out if n.endswith("_seg.nii.gz")]
    for n in seg:
        lab = load_nifti(str(tmp_path / "port" / n)).data
        assert set(np.unique(lab)) <= {0, 1, 2, 3}


def test_register_without_antspyx_warns_and_writes_nothing(tmp_path,
                                                           capsys):
    try:
        import ants  # noqa: F401
        pytest.skip("antspyx is installed: registration runs")
    except ImportError:
        pass
    globs = make_autopet_fixtures(str(tmp_path / "raw"), n_cases=1,
                                  shape=(8, 8, 8), seed=5)
    said = {}
    for side, fn in (("jax", jax_prep.main), ("port", port_prep.main)):
        fn(["register", "--pet_glob", globs["pet_path"], "--ct_glob",
            globs["ct_path"], "--out_dir", str(tmp_path / side)])
        said[side] = capsys.readouterr().out
        assert not (tmp_path / side).exists()
    assert said["port"] == said["jax"]
    assert said["port"].startswith("WARNING: antspyx not available")
