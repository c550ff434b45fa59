"""The port's data pipeline (``veloxseg_torch.data``) against the JAX
package's (``veloxseg_tpu.data``) on the CPU: the same NIfTI fixtures
(``tests/make_fixtures.py``) and the same seeds give the same arrays, bit
for bit (tolerance 0: both sides run the same numpy, scipy and native
code on the same draws).

Loaders: AutoPET-II with the foreground crop and the rotation, Hecktor
without the crop, BraTS with four modalities and labels 0-3 (not made
binary), each with the dataset cache on and off, ``drop_last``, and
``select_modal``; two epochs each, so the second epoch reads the cache.
Transforms: each function on seeded arrays. The native library the port
builds from ``native/`` against scipy, and its NIfTI reader against the
Python one. About 10 s alone here.
"""

import math

import numpy as np
import pytest
import torch
from scipy import ndimage

from tests.make_fixtures import make_autopet_fixtures, make_brats_fixtures
from veloxseg_torch.data import dataset as tds
from veloxseg_torch.data import native_ops as tnative
from veloxseg_torch.data import nifti_fast as tfast
from veloxseg_torch.data import transforms as ttf
from veloxseg_torch.data.prefetch import device_put, prefetch_to_device
from veloxseg_tpu.data import dataset as jds
from veloxseg_tpu.data import nifti_fast as jfast
from veloxseg_tpu.data import transforms as jtf

# (profile, loader options): modality keys, foreground crop, binary labels
LOADERS = {
    "autopet": (("ct", "pet"), True, True, {}),
    "autopet_nocache": (("ct", "pet"), True, True, {"cache": False}),
    "autopet_drop_last": (("ct", "pet"), True, True, {"drop_last": True}),
    "autopet_select_pet": (("ct", "pet"), True, True,
                           {"modal_index": [0, 1]}),
    "hecktor": (("ct", "pet"), False, True, {}),
    "brats": (("flair", "t1", "t1ce", "t2"), False, False, {}),
    "brats_nocache": (("flair", "t1", "t1ce", "t2"), False, False,
                      {"cache": False}),
}


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    pet = make_autopet_fixtures(str(root / "autopet"), n_cases=5)
    brats = make_brats_fixtures(str(root / "brats"), n_cases=4)
    return {
        "autopet": {"ct": pet["ct_path"], "pet": pet["pet_path"],
                    "label": pet["label_path"]},
        "brats": {m: brats[f"{m}_path"] for m in ("flair", "t1", "t1ce",
                                                  "t2")}
        | {"label": brats["label_path"]},
    }


def _loader(pkg, files, keys, crop, binary, opts, train):
    make = pkg.default_train_transform if train \
        else pkg.default_val_transform
    kw = dict(rotate_prob=0.5, range_z=math.radians(15)) if train else {}
    return pkg.PatchLoader(
        files, keys, make((24, 24, 24), num_samples=2,
                          use_foreground_crop=crop, **kw),
        batch_size=2, num_samples=2, num_workers=3, shuffle=train,
        seed=7, binary_label=binary,
        **dict({"cache": True}, **opts))


@pytest.mark.parametrize("name", sorted(LOADERS))
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_loader_batches_equal_jax(fixtures, name, train):
    keys, crop, binary, opts = LOADERS[name]
    patterns = fixtures["brats" if name.startswith("brats") else "autopet"]
    dataset = "BraTS2021" if name.startswith("brats") else "AutoPETII"
    files = tds.SegmentationDataset.from_globs(patterns, dataset).files
    jfiles = jds.SegmentationDataset.from_globs(patterns, dataset).files
    assert files == jfiles
    port = _loader(tds, files, keys, crop, binary, opts, train)
    ref = _loader(jds, files, keys, crop, binary, opts, train)
    assert len(port) == len(ref)
    try:
        for _ in range(2):          # the second epoch reads the cache
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            for (x, y), (rx, ry) in zip(got, want):
                assert x.dtype == rx.dtype and y.dtype == ry.dtype
                np.testing.assert_array_equal(x, rx)
                np.testing.assert_array_equal(y, ry)
    finally:
        port.close()
    n_mod = sum(opts.get("modal_index", [1] * len(keys)))
    assert got[0][0].shape == (4, 24, 24, 24, n_mod)
    labels = np.unique(np.concatenate([y.ravel() for _, y in got]))
    assert set(labels) <= ({0, 1} if binary else {0, 1, 2, 3})
    if not binary:
        assert labels.max() > 1
    if opts.get("drop_last"):
        assert all(x.shape[0] == 4 for x, _ in got)


def test_split_equals_jax(fixtures):
    port = tds.SegmentationDataset.from_globs(fixtures["autopet"],
                                              "AutoPETII")
    ref = jds.SegmentationDataset.from_globs(fixtures["autopet"], "AutoPETII")
    assert port.split(0.6, 0.2) == ref.split(0.6, 0.2)
    assert [len(p) for p in port.split(0.6, 0.2)] == [3, 1, 1]


@pytest.mark.parametrize("fg", [True, False], ids=["fg", "no_fg"])
def test_transforms_equal_jax(fg):
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((30, 20, 12)).astype(np.float32)
    label = np.zeros((30, 20, 12), np.int32)
    if fg:
        label[10:16, 5:12, 3:9] = 1
    src = vol.copy()
    src[:4] = src.min()
    np.testing.assert_array_equal(
        np.stack(ttf.crop_foreground([vol, label], source=src)[:1]),
        np.stack(jtf.crop_foreground([vol, label], source=src)[:1]))
    np.testing.assert_array_equal(ttf._pad_to_at_least(vol, (32, 24, 8)),
                                  jtf._pad_to_at_least(vol, (32, 24, 8)))
    np.testing.assert_array_equal(ttf.fg_flat_indices(label),
                                  jtf.fg_flat_indices(label))
    for seed in range(3):
        got = ttf.rand_crop_by_pos_neg_label(
            [vol], label, (16, 16, 16), num_samples=3,
            rng=np.random.default_rng(seed))
        want = jtf.rand_crop_by_pos_neg_label(
            [vol], label, (16, 16, 16), num_samples=3,
            rng=np.random.default_rng(seed))
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
        got = ttf.rand_rotate_z([vol], label, 0.3, prob=1.0,
                                rng=np.random.default_rng(seed))
        want = jtf.rand_rotate_z([vol], label, 0.3, prob=1.0,
                                 rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got[0][0], want[0][0])
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(ttf.normalize_pet_zscore(vol),
                                  jtf.normalize_pet_zscore(vol))
    stats = jtf.ct_global_statistics(vol.ravel())
    assert ttf.ct_global_statistics(vol.ravel()) == stats
    np.testing.assert_array_equal(ttf.normalize_ct_global(vol, stats),
                                  jtf.normalize_ct_global(vol, stats))
    lab4 = rng.integers(0, 5, (6, 6, 6))
    np.testing.assert_array_equal(ttf.remap_brats_label(lab4),
                                  jtf.remap_brats_label(lab4))


def test_native_rotation_matches_scipy():
    """The port's build of ``native/rotate_native.cpp`` against
    ``scipy.ndimage.rotate``: the JAX package's tolerance for its own
    library (``tests/test_data.py``), 2e-6 at order 1, exact at order 0
    and on integer labels."""
    assert tfast.native_lib() is not None, tfast.native_status()
    rng = np.random.default_rng(4)
    for shape in ((17, 23, 9), (24, 24, 24)):
        v = rng.standard_normal(shape).astype(np.float32)
        for arr in (v, np.asfortranarray(v)):
            for rad in (-0.63, 0.015, 0.8):
                for order in (0, 1):
                    got = tnative.rotate_axes01(arr, rad, order)
                    want = ndimage.rotate(arr, math.degrees(rad),
                                          axes=(0, 1), reshape=False,
                                          order=order, mode="nearest")
                    np.testing.assert_allclose(got, want, atol=2e-6)
    lab = (rng.random((24, 24, 24)) > 0.8).astype(np.int32) * 3
    got = tnative.rotate_axes01(lab, 0.4, 0)
    assert got.dtype == lab.dtype
    np.testing.assert_array_equal(got, ndimage.rotate(
        lab, math.degrees(0.4), axes=(0, 1), reshape=False, order=0,
        mode="nearest"))
    # what the library refuses, scipy takes
    assert tnative.rotate_axes01(lab, 0.4, 1) is None
    assert tnative.rotate_axes01(v[..., 0], 0.4, 1) is None
    assert "native" in tfast.native_status()


def test_native_reader_equals_jax_and_python(fixtures):
    import glob
    from veloxseg_torch.data.nifti import load_nifti
    for path in sorted(glob.glob(fixtures["brats"]["label"]))[:2] + \
            sorted(glob.glob(fixtures["autopet"]["ct"]))[:2]:
        got = tfast.load_nifti_fast(path)
        want = jfast.load_nifti_fast(path)
        slow = load_nifti(path)
        assert got.data.dtype == np.float32
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.data, slow.data)
        assert got.spacing == want.spacing


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_order_and_device_put(size):
    batches = [(np.full((2, 3), i, np.float32), np.full((2,), i, np.int32))
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), size=size, device="cpu"))
    assert len(got) == 5
    for i, (x, y) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
        assert y.dtype == torch.int32
        assert bool((x == i).all()) and bool((y == i).all())
    x = device_put(np.asfortranarray(np.ones((3, 4), np.float32)), "cpu")
    assert x.is_contiguous() and x.shape == (3, 4)
