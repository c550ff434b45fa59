"""The serving CLI's host-side modules in the port against ``veloxseg_tpu``
on the CPU, on seeded numpy inputs: NIfTI reading and writing, the
metrics (binary, BraTS regions, HD95), the modality and file-group
helpers, the flax ``.ckpt`` reader and ``load_params`` (``.ckpt`` and
reference-keyed ``.pth``), the host-summed sliding window and the CSV the
driver writes."""

import glob
import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from flax import serialization

from tests.make_fixtures import make_autopet_fixtures
from torch_port_helpers import TINY_JSON, normal, randomize_
from veloxseg_torch.data import nifti as tnifti
from veloxseg_torch.infer import driver as tdriver
from veloxseg_torch.infer.sliding_window import sliding_window_inference
from veloxseg_torch.interop.jax_params import state_dict_from_jax
from veloxseg_torch.models.registry import load_model
from veloxseg_torch.nn.veloxseg import build_veloxseg
from veloxseg_torch.train import hd95 as thd95
from veloxseg_torch.train import metrics as tmetrics
from veloxseg_torch.train.checkpoint import load_params
from veloxseg_torch.train.flax_msgpack import msgpack_restore
from veloxseg_torch.train.metrics_brats import brats_dice
from veloxseg_torch.utils import runtime as truntime
from veloxseg_tpu.data import nifti as jnifti
from veloxseg_tpu.infer import sliding_window as jsw
from veloxseg_tpu.interop.torch_import import convert_state_dict
from veloxseg_tpu.train import hd95 as jhd95
from veloxseg_tpu.train import metrics as jmetrics
from veloxseg_tpu.train import metrics_brats as jbrats
from veloxseg_tpu.train.checkpoint import build_payload, save_checkpoint
from veloxseg_tpu.utils import runtime as jruntime

# ---------------------------------------------------------------------------
# NIfTI


def _assert_same_image(a, b):
    assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
    np.testing.assert_array_equal(a.data, b.data)
    assert a.spacing == b.spacing
    np.testing.assert_array_equal(a.affine, b.affine)


def test_nifti_reads_fixtures_as_jax(tmp_path):
    globs = make_autopet_fixtures(str(tmp_path), n_cases=2,
                                  shape=(12, 10, 8))
    paths = sorted(p for g in globs.values() for p in glob.glob(g))
    assert len(paths) == 6
    for p in paths:
        got, ref = tnifti.load_nifti(p), jnifti.load_nifti(p)
        assert got.shape == (12, 10, 8)
        _assert_same_image(got, ref)


def _handmade(path, endian, data, slope, inter, sform):
    """A NIfTI-1 file written field by field in ``endian`` byte order."""
    codes = {np.dtype(np.int16): 4, np.dtype(np.float32): 16,
             np.dtype(np.uint8): 2}
    hdr = bytearray(348)
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into(endian + "h", hdr, 70, codes[data.dtype])
    struct.pack_into(endian + "8f", hdr, 76, 1.0, 1.5, -2.0, 3.0, 1, 1, 1,
                     1)
    struct.pack_into(endian + "f", hdr, 108, 352.0)
    struct.pack_into(endian + "2f", hdr, 112, slope, inter)
    struct.pack_into(endian + "h", hdr, 254, sform)
    struct.pack_into(endian + "12f", hdr, 280, 1.5, 0, 0, 10, 0, 2, 0, 20,
                     0, 0, 3, 30)
    hdr[344:348] = b"n+1\x00"
    body = data.astype(data.dtype.newbyteorder(endian)).tobytes(order="F")
    with open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4 + body)


@pytest.mark.parametrize("endian,dtype,slope,inter,sform", [
    ("<", np.int16, 1.0, 0.0, 1),
    (">", np.int16, 1.0, 0.0, 1),
    (">", np.float32, 2.5, -1.0, 0),
    ("<", np.int16, 0.5, 3.0, 0),
    ("<", np.uint8, 1.0, 4.0, 1),
])
def test_nifti_headers_as_jax(tmp_path, endian, dtype, slope, inter, sform):
    rng = np.random.default_rng(0)
    data = (rng.standard_normal((5, 4, 3)) * 50 + 60).astype(dtype)
    path = str(tmp_path / "img.nii")
    _handmade(path, endian, data, slope, inter, sform)
    got, ref = tnifti.load_nifti(path), jnifti.load_nifti(path)
    _assert_same_image(got, ref)
    assert got.spacing == (1.5, 2.0, 3.0)
    # the file holds X fastest (Fortran order), as NIfTI stores it
    scaled = data.astype(np.float32)
    if slope not in (0.0, 1.0):
        scaled = scaled * slope + inter
    elif inter != 0.0:
        scaled = scaled + inter
    np.testing.assert_array_equal(got.data, scaled)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8,
                                   np.float64, np.int32])
def test_save_nifti_bytes_as_jax(tmp_path, dtype):
    data = (normal((7, 6, 5), seed=1) * 20).astype(dtype)
    affine = np.array([[2.0, 0, 0, 1], [0, 2.0, 0, 2], [0, 0, 3.0, 3],
                       [0, 0, 0, 1]])
    for mod, name in ((tnifti, "port"), (jnifti, "jax")):
        mod.save_nifti(str(tmp_path / f"{name}.nii.gz"), data,
                       (2.0, 2.0, 3.0), affine)
    raw = {n: gzip.open(str(tmp_path / f"{n}.nii.gz")).read()
           for n in ("port", "jax")}
    assert raw["port"] == raw["jax"]
    back = tnifti.load_nifti(str(tmp_path / "port.nii.gz"))
    np.testing.assert_array_equal(back.data, data.astype(np.float32))
    assert back.spacing == (2.0, 2.0, 3.0)

# ---------------------------------------------------------------------------
# Metrics


def _masks(seed, shape=(2, 9, 8, 7), classes=2, p_empty=False):
    rng = np.random.default_rng(seed)
    gt = rng.integers(0, classes, shape).astype(np.int32)
    pred = rng.integers(0, classes, shape).astype(np.int32)
    if p_empty:
        pred[0] = 0
    return gt, pred


def _close(got: dict, ref: dict, tol=1e-6):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 or k.endswith("_pix"), k
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("seed,empty", [(0, False), (1, True)])
def test_segmentation_metrics_as_jax(seed, empty):
    gt, pred = _masks(seed, p_empty=empty)
    _close(tmetrics.segmentation_metrics(torch.from_numpy(gt),
                                         torch.from_numpy(pred)),
           jmetrics.segmentation_metrics(jnp.asarray(gt), jnp.asarray(pred)))


@pytest.mark.parametrize("classes", [2, 4])
def test_pred_from_logits_as_jax(classes):
    logits = np.round(normal((2, 6, 5, 4, classes), seed=2), 1)
    logits[0, 0, 0, 0] = 0.5            # an exact tie: the first class wins
    got = tmetrics.pred_from_logits(torch.from_numpy(logits))
    ref = jmetrics.pred_from_logits(jnp.asarray(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got[0, 0, 0, 0]) == 0


def test_deep_metrics_as_jax():
    outs = [normal((1, 6, 5, 4, 2), seed=s) for s in (3, 4)]
    labels = (normal((1, 6, 5, 4), seed=5) > 0).astype(np.int32)
    got = tmetrics.deep_metrics([torch.from_numpy(o) for o in outs],
                                torch.from_numpy(labels))
    ref = jmetrics.deep_metrics([jnp.asarray(o) for o in outs],
                                jnp.asarray(labels))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("seed", [6, 7])
def test_brats_dice_as_jax(seed):
    gt, pred = _masks(seed, classes=4)
    pred[1] = np.where(pred[1] == 3, 0, pred[1])       # ET absent in one
    _close(brats_dice(torch.from_numpy(pred), torch.from_numpy(gt)),
           jbrats.brats_dice(jnp.asarray(pred), jnp.asarray(gt)))


def _blob(seed, shape=(20, 18, 16), classes=(1,)):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    out = np.zeros(shape, np.int32)
    for c in classes:
        center = rng.integers(5, 11, 3)
        r = rng.integers(3, 6)
        out[(zz - center[0]) ** 2 + (yy - center[1]) ** 2
            + (xx - center[2]) ** 2 < r ** 2] = c
    return out


@pytest.mark.parametrize("case", ["blobs", "empty_pred", "empty_gt"])
def test_hd95_as_jax(case):
    gt, pred = _blob(8), _blob(9)
    if case == "empty_pred":
        pred[:] = 0
    if case == "empty_gt":
        gt[:] = 0
    spacing = (2.03642, 2.03642, 3.0)
    got = thd95.get_hausdorff(gt, pred, spacing)
    ref = jhd95.get_hausdorff(gt, pred, spacing)
    if case == "blobs":
        assert got == ref and np.isfinite(got) and got > 0
        assert thd95.hd95(pred, gt, spacing) == jhd95.hd95(pred, gt,
                                                           spacing)
    else:
        assert np.isnan(got) and np.isnan(ref)


def test_brats_hd95_as_jax():
    gt, pred = _blob(10, classes=(2, 1, 3)), _blob(11, classes=(1, 2))
    got = thd95.brats_hd95(pred, gt, (1.0, 1.0, 1.0))
    ref = jhd95.brats_hd95(pred, gt, (1.0, 1.0, 1.0))
    assert np.isnan(got["et"]) and np.isnan(ref["et"])  # no ET predicted
    for k in ("tc", "wt"):
        assert got[k] == ref[k] and np.isfinite(got[k])

# ---------------------------------------------------------------------------
# Modality selection and file groups (tests/test_runtime_helpers.py)


_RUNTIME_CASES = [
    ("resolve_modal_index", (None, 3)),
    ("resolve_modal_index", (1, 2)),
    ("resolve_modal_index", ("0", 2)),
    ("resolve_modal_index", (None, 0)),
    ("resolve_modal_index", (2, 2)),
    ("resolve_modal_index", ("x", 2)),
    ("expected_input_channels", ("VeloxSeg", {"VeloxSeg": {"in_ch": [1, 1]}})),
    ("expected_input_channels", ("UNet", {"UNet": {"in_channels": 2}})),
    ("expected_input_channels", ("Other", {"Other": {"model_num": 4}})),
    ("expected_input_channels", ("U-RWKV", {"U-RWKV":
                                            {"input_channel": 4}})),
    ("expected_input_channels", ("NoInfo", {"NoInfo": {"foo": 1}})),
    ("expected_input_channels", ("Missing", {})),
    ("validate_selected_modal", ("VeloxSeg", {"VeloxSeg": {"in_ch": [1, 1]}},
                                 2, None)),
    ("validate_selected_modal", ("VeloxSeg", {"VeloxSeg": {"in_ch": [1]}},
                                 2, 0)),
    ("validate_selected_modal", ("VeloxSeg", {"VeloxSeg": {"in_ch": [1, 1]}},
                                 2, 0)),
    ("select_modal_items", (["a", "b"], [1, 0])),
    ("select_modal_items", (["a"], [1, 0])),
    ("select_modal_items", (["a", "b"], [0, 0])),
    ("validate_file_groups", ("ds", {"ct": ["a"], "pet": ["b"],
                                     "label": ["c"]})),
    ("validate_file_groups", ("ds", {"ct": [], "pet": ["b"]})),
    ("validate_file_groups", ("ds", {"ct": ["a"], "pet": ["b", "c"]})),
]


def _outcome(fn, args):
    try:
        return "ok", fn(*args)
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("name,args", _RUNTIME_CASES)
def test_runtime_helpers_as_jax(name, args):
    assert _outcome(getattr(truntime, name), args) == \
        _outcome(getattr(jruntime, name), args)

# ---------------------------------------------------------------------------
# The .ckpt reader and load_params


def _same_tree(a, b, path=""):
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)
        assert getattr(a, "dtype", None) == getattr(b, "dtype", None), path


@pytest.fixture(scope="module")
def tiny():
    """A TINY VeloxSeg with seeded weights and its JAX params tree."""
    model, _ = build_veloxseg(TINY_JSON, device="cpu")
    randomize_(model, seed=21, scale=0.3)
    return model, convert_state_dict(model.state_dict())


def test_reader_on_params_tree(tiny):
    _, params = tiny
    data = serialization.msgpack_serialize(
        serialization.to_state_dict(params))
    _same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_on_full_payload(tiny):
    _, params = tiny
    opt = optax.adamw(1e-3)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(np.ones_like, params)
    _, state = opt.update(grads, state, params)          # count 1
    payload = build_payload(params, state, epoch=7, best_train_dice=0.5,
                            best_val_dice=0.25,
                            scheduler_state={"step": 3, "lr": 1e-4})
    data = serialization.msgpack_serialize(payload)
    got = msgpack_restore(data)
    _same_tree(got, serialization.msgpack_restore(data))
    assert got["epoch"] == 7 and got["best_val_dice"] == 0.25


def test_reader_on_scalars_and_types():
    tree = {"i8": np.int8(-3), "i32": np.int32(70000), "u64": np.uint64(5),
            "f32": np.float32(0.5), "f64": np.float64(-2.25), "b": True,
            "n": None, "neg": -40000, "big": 2 ** 40, "s": "x" * 300,
            "by": b"\x00\xff" * 200, "l": list(range(20)),
            "m": {str(i): i for i in range(20)}, "f": 1.5,
            "e": np.zeros((0, 3), np.int64),
            "a": normal((4, 3, 2), seed=22).astype(np.float64)}
    data = serialization.msgpack_serialize(tree)
    _same_tree(msgpack_restore(data), serialization.msgpack_restore(data))


def test_reader_refuses_what_it_does_not_read(monkeypatch):
    big = np.arange(100, dtype=np.float32)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    chunked = serialization.msgpack_serialize({"w": big})
    monkeypatch.undo()
    with pytest.raises(ValueError, match="chunked"):
        msgpack_restore(chunked)
    with pytest.raises(ValueError, match="bfloat16"):
        msgpack_restore(serialization.msgpack_serialize(
            {"w": np.asarray(jnp.ones(3, jnp.bfloat16))}))
    data = serialization.msgpack_serialize({"w": big})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(data[:-5])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(data + b"\x00")


def _forward(model):
    x = torch.from_numpy(normal((1, 32, 32, 32, 2), seed=23))
    with torch.no_grad():
        return model(x)


def _fresh():
    return build_veloxseg(TINY_JSON, device="cpu", seed=5)[0]


def test_load_params_from_ckpt(tiny, tmp_path):
    model, params = tiny
    ref = _fresh()
    ref.load_state_dict(state_dict_from_jax(params))
    # a full training payload and a bare params tree
    save_checkpoint(str(tmp_path / "full.ckpt"), params,
                    optax.adam(1e-3).init(params), epoch=2)
    (tmp_path / "bare.ckpt").write_bytes(serialization.msgpack_serialize(
        serialization.to_state_dict(params)))
    for name in ("full.ckpt", "bare.ckpt"):
        got = load_params(str(tmp_path / name), _fresh())
        torch.testing.assert_close(_forward(got), _forward(ref), rtol=0,
                                   atol=0)
    torch.testing.assert_close(_forward(ref), _forward(model), rtol=0,
                               atol=0)


def test_load_params_from_pth(tiny, tmp_path):
    model, params = tiny
    ref = _fresh()
    ref.load_state_dict(state_dict_from_jax(params))
    sd = dict(model.state_dict())
    index = {n: b for n, b in model.named_buffers()
             if n.endswith("relative_position_index")}
    assert index                    # the reference keeps them: dropped
    forms = {"bare.pth": dict(sd, **index),
             "wrapped.pth": {"model": {f"module.{k}": v for k, v in
                                       dict(sd, **index).items()},
                             "epoch": 3, "best_val_dice": np.float64(0.5)}}
    for name, payload in forms.items():
        torch.save(payload, str(tmp_path / name))
        got = load_params(str(tmp_path / name), _fresh())
        torch.testing.assert_close(_forward(got), _forward(ref), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("change", ["unknown", "missing", "shape"])
def test_pth_is_strict(tiny, tmp_path, change):
    model, _ = tiny
    sd = dict(model.state_dict())
    key = next(iter(sd))
    if change == "unknown":
        sd["encoder.mystery.weight"] = torch.zeros(2)
    elif change == "missing":
        del sd[key]
    else:
        sd[key] = torch.zeros(3, 1)
    torch.save(sd, str(tmp_path / "bad.pth"))
    with pytest.raises(RuntimeError, match="state_dict"):
        load_params(str(tmp_path / "bad.pth"), _fresh())


def test_urwkv_pth_drops_what_jax_drops(tmp_path):
    cfg = {"U-RWKV": {"input_channel": 2, "num_classes": 2}}
    model = load_model("U-RWKV", cfg, device="cpu", seed=1)
    sd = dict(model.state_dict())
    # dead parameters and batch-norm statistics of a reference checkpoint
    extra = {"e1.pwconv.weight": torch.zeros(3), "outconv.bias":
             torch.zeros(2), "bx4rwkv.allinone_spa.gamma2": torch.zeros(1),
             "bx4rwkv.allinone_spa.ln2.weight": torch.zeros(4),
             "stem.1.running_mean": torch.zeros(4),
             "stem.1.num_batches_tracked": torch.zeros((), dtype=torch.long)}
    torch.save(dict(sd, **extra), str(tmp_path / "u.pth"))
    got = load_params(str(tmp_path / "u.pth"),
                      load_model("U-RWKV", cfg, device="cpu", seed=2))
    for k, v in got.state_dict().items():
        assert torch.equal(v, sd[k]), k
    torch.save(dict(sd, **{"e9.conv.weight": torch.zeros(1)}),
               str(tmp_path / "bad.pth"))
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_params(str(tmp_path / "bad.pth"), got)


def test_orbax_directory_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_params(str(tmp_path), _fresh())

# ---------------------------------------------------------------------------
# The host-summed sliding window and the driver's CSV


@pytest.mark.parametrize("shape,sw", [((1, 40, 36, 20, 2), 3),
                                      ((2, 24, 20, 12, 2), 2)])
def test_cpu_accumulate_as_jax(shape, sw):
    w = normal((2, 3), seed=24)
    ramp = normal((16, 16, 16, 1), seed=25)
    x = normal(shape, seed=26)
    roi = (16, 16, 16)
    got = sliding_window_inference(
        x, roi, lambda t: t @ torch.from_numpy(w) + torch.from_numpy(ramp),
        sw_batch_size=sw, device="cpu", cpu_accumulate=True)
    dev = sliding_window_inference(
        x, roi, lambda t: t @ torch.from_numpy(w) + torch.from_numpy(ramp),
        sw_batch_size=sw, device="cpu")
    ref = jsw.sliding_window_inference(
        jnp.asarray(x), roi, sw_batch_size=sw, overlap=0.25,
        predictor=lambda t: t @ jnp.asarray(w) + jnp.asarray(ramp),
        mode="constant", cpu_accumulate=True)
    assert got.shape == dev.shape == ref.shape == (*shape[:-1], 3)
    # the same float32 adds in the same tile order
    np.testing.assert_array_equal(got.numpy(), dev.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_csv_as_pandas_writes_it(tmp_path):
    rows = [{"name": "a.nii.gz", "dice": 0.1 + 0.2, "time": 1e-05,
             "hd95": float("nan")},
            {"name": "b,c.nii.gz", "dice": np.float32(0.3).item(),
             "time": 12.0, "hd95": 2.5}]
    tdriver._write_csv(str(tmp_path / "port.csv"), rows)
    pd.DataFrame(rows).to_csv(str(tmp_path / "pandas.csv"), index=False)
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "pandas.csv").read_text()
    means = tdriver._means(rows)
    assert "hd95  2.500000" in means and "dice  " in means
