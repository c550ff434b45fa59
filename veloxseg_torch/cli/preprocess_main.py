"""Offline preprocessing CLI: ``python -m veloxseg_torch.cli.preprocess_main``
(``veloxseg_tpu/cli/preprocess_main.py``, the reference's ``preprocess/``).

Host work in numpy in both packages; it takes no device.

- ``normalize-ctpet``: PET global z-score per volume, and CT clipped to
  the dataset-pooled foreground [p0.5, p99.5] and z-scored with the pooled
  statistics (``normalization_CT_PET.py``); labels copied as int16.
- ``normalize-mri``: per-volume z-score of each modality and the BraTS
  label remap 4 → 3 (``normalization_MRI.py``).
- ``register``: PET → CT affine registration through ANTs
  (``registration.py:21-74``) where ``antspyx`` imports; where it does not
  (as on the GPU machine), it warns and writes nothing: the volumes are
  taken as co-registered, as the JAX package takes them.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np

from ..data.nifti import load_nifti, save_nifti
from ..data.transforms import (ct_global_statistics, normalize_ct_global,
                               normalize_pet_zscore, remap_brats_label)


def normalize_ctpet(ct_glob, pet_glob, label_glob, out_dir) -> dict:
    """Normalize the CT/PET cases of the globs into ``out_dir``; returns the
    pooled CT foreground statistics (also printed)."""
    cts = sorted(glob(ct_glob))
    pets = sorted(glob(pet_glob))
    labels = sorted(glob(label_glob))
    os.makedirs(out_dir, exist_ok=True)

    # Pass 1: pooled CT foreground voxels + PET z-score.
    fg = []
    for ct_f, pet_f, lab_f in zip(cts, pets, labels):
        ct = load_nifti(ct_f)
        lab = load_nifti(lab_f)
        mask = lab.data > 0
        if mask.any():
            fg.append(ct.data[mask].ravel())
        pet = load_nifti(pet_f)
        save_nifti(os.path.join(out_dir, os.path.basename(pet_f)),
                   normalize_pet_zscore(pet.data), pet.spacing, pet.affine)
        save_nifti(os.path.join(out_dir, os.path.basename(lab_f)),
                   lab.data.astype(np.int16), lab.spacing, lab.affine)
    stats = ct_global_statistics(np.concatenate(fg) if fg else
                                 np.zeros(1, np.float32))
    print("CT foreground stats:", stats)

    # Pass 2: CT normalization with pooled stats.
    for ct_f in cts:
        ct = load_nifti(ct_f)
        save_nifti(os.path.join(out_dir, os.path.basename(ct_f)),
                   normalize_ct_global(ct.data, stats), ct.spacing,
                   ct.affine)
    print(f"normalized {len(cts)} cases -> {out_dir}")
    return stats


def normalize_mri(case_glob, out_dir):
    files = sorted(glob(case_glob))
    os.makedirs(out_dir, exist_ok=True)
    for f in files:
        img = load_nifti(f)
        base = os.path.basename(f)
        case_dir = os.path.join(out_dir,
                                os.path.basename(os.path.dirname(f)))
        os.makedirs(case_dir, exist_ok=True)
        if base.endswith("seg.nii.gz") or base.endswith("seg.nii"):
            out = remap_brats_label(img.data.astype(np.int16))
        else:
            out = normalize_pet_zscore(img.data)
        save_nifti(os.path.join(case_dir, base), out, img.spacing,
                   img.affine)
    print(f"normalized {len(files)} volumes -> {out_dir}")


def register(pet_glob, ct_glob, out_dir):
    try:
        import ants
    except ImportError:
        print("WARNING: antspyx not available in this image — affine "
              "registration is skipped; volumes are assumed co-registered "
              "(the reference datasets ship pre-registered).")
        return
    # affine PET → CT, as the reference's registration.py
    pets = sorted(glob(pet_glob))
    cts = sorted(glob(ct_glob))
    os.makedirs(out_dir, exist_ok=True)
    for pet_f, ct_f in zip(pets, cts):
        fixed = ants.image_read(ct_f)
        moving = ants.image_read(pet_f)
        tx = ants.registration(fixed, moving, type_of_transform="Affine")
        out = ants.apply_transforms(fixed, moving,
                                    transformlist=tx["fwdtransforms"])
        ants.image_write(out, os.path.join(out_dir,
                                           os.path.basename(pet_f)))
    print(f"registered {len(pets)} volumes -> {out_dir}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("normalize-ctpet")
    p.add_argument("--ct_glob", required=True)
    p.add_argument("--pet_glob", required=True)
    p.add_argument("--label_glob", required=True)
    p.add_argument("--out_dir", required=True)

    p = sub.add_parser("normalize-mri")
    p.add_argument("--case_glob", required=True)
    p.add_argument("--out_dir", required=True)

    p = sub.add_parser("register")
    p.add_argument("--pet_glob", required=True)
    p.add_argument("--ct_glob", required=True)
    p.add_argument("--out_dir", required=True)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "normalize-ctpet":
        return normalize_ctpet(args.ct_glob, args.pet_glob, args.label_glob,
                               args.out_dir)
    if args.cmd == "normalize-mri":
        return normalize_mri(args.case_glob, args.out_dir)
    return register(args.pet_glob, args.ct_glob, args.out_dir)


if __name__ == "__main__":
    main()
