"""Whole-volume inference driver: ``veloxseg_tpu/infer/driver.py:63-201``
on PyTorch.

The same steps as the JAX driver (reference ``utils/inference_petct.py``
for AutoPET-II and Hecktor2022, ``utils/inference_brats.py`` for
BraTS2021):

- the test split is the last 20% of the sorted file lists
  (``inference_petct.py:76``); ``--specific_sample`` picks one case of it;
- sliding-window prediction with the config's overlap and constant
  blending; volumes over ``CPU_STITCH_THRESHOLD`` voxels sum their tiles on
  the host (``inference_petct.py:213-222``);
- per case FP/FN rate, precision, recall, F1, IoU and Dice (BraTS: ET, TC
  and WT dice), optionally HD95 with the label's spacing, and the seconds
  from reading the case to its prediction, into
  ``<result_metric_path>/<dataset>_<model>.csv`` (``:249-257``);
- ``--specific_sample`` writes the inputs and the prediction as NIfTI
  instead (``:197-206, 244-246``; BraTS also its region masks,
  ``inference_brats.py:221-251``).

The model, the argmax and the metrics run on ``device``; HD95 and the file
I/O on the host. One process: ``--mesh`` and ``--distributed`` raise.
Any model of the port's registry serves: VeloxSeg, U-RWKV and eight
baselines of the zoo. The sliding window groups ``--sw_batch_size`` tiles
per call as the JAX driver does, so the models with batch-statistics norms
(VNet, SegFormer, SlimUNETR, UNETRpp, U-RWKV) normalize the same tiles
together.
"""

from __future__ import annotations

import csv
import math
import os
import time
from datetime import datetime
from glob import glob
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..data.nifti import load_nifti, save_nifti
from ..models.registry import load_model
from ..train.checkpoint import load_params
from ..train.hd95 import brats_hd95, get_hausdorff
from ..train.metrics import segmentation_metrics
from ..train.metrics_brats import brats_dice
from ..train.trainer import PROFILES
from ..utils.device import resolve_device
from ..utils.logger import get_logger
from ..utils.runtime import validate_selected_modal
from .sliding_window import sliding_window_inference

CPU_STITCH_THRESHOLD = 500 * 500 * 1000  # voxels (reference parity)


def _resolve_checkpoint(args, train_config) -> str:
    if getattr(args, "checkpoint_dir", None):
        ckpt_dir = args.checkpoint_dir
    else:
        index = (f"_{args.model_index}"
                 if getattr(args, "model_index", None) else "")
        date = args.train_date or datetime.now().strftime("%m_%d")
        ckpt_dir = os.path.join(train_config["save_path"],
                                args.dataset_name, args.model_name,
                                date + index)
    name = getattr(args, "checkpoint_index", "val_best") or "val_best"
    for suffix in (".ckpt", ".pth", ""):
        path = os.path.join(ckpt_dir, f"{name}{suffix}")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"No checkpoint named {name}[.ckpt] under {ckpt_dir}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _csv_field(value) -> str:
    """A cell as ``DataFrame.to_csv`` writes it: NaN and None empty, floats
    by ``repr``."""
    if value is None or (isinstance(value, float) and math.isnan(value)):
        return ""
    return value if isinstance(value, str) else repr(float(value))


def _write_csv(path: str, rows: List[Dict]) -> None:
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_csv_field(row.get(c)) for c in columns])


def _means(rows: List[Dict]) -> str:
    """Column means over the numeric columns, NaN skipped (pandas'
    ``mean(numeric_only=True)``), one ``name value`` line each."""
    columns = [c for c in dict.fromkeys(k for row in rows for k in row)
               if c != "name"]
    width = max(len(c) for c in columns)
    lines = []
    for c in columns:
        vals = [row[c] for row in rows
                if c in row and not math.isnan(row[c])]
        mean = sum(vals) / len(vals) if vals else float("nan")
        lines.append(f"{c:<{width}}  {mean:.6f}")
    return "\n".join(lines)


def run_inference(args, train_config: dict, model_config: dict,
                  test_config: dict,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> List[Dict]:
    """Serve the test split of ``args.dataset_name`` with the checkpoint
    the arguments name; write the metrics CSV (or, with
    ``--specific_sample``, the NIfTIs) and the log.

    Returns the CSV's rows as a list of dicts (the JAX driver returns them
    as a DataFrame); empty under ``--specific_sample``. ``device`` defaults
    to ``"cuda"`` and raises without CUDA unless ``"cpu"`` is asked for.
    """
    for flag in ("mesh", "distributed"):
        if getattr(args, flag, None):
            raise NotImplementedError(
                f"--{flag}: the port serves on one device "
                "(multi-GPU: ROADMAP.md §1 item 5)")
    dev = resolve_device(device)
    profile = PROFILES[args.dataset_name]
    metric_dir = test_config.get("result_metric_path", "./result/metric")
    logger = get_logger(os.path.join(
        metric_dir, f"test_{args.dataset_name}_{args.model_name}.log"))

    modal_index = validate_selected_modal(
        args.model_name, model_config,
        raw_modal_count=profile.raw_modal_count,
        select_modal=getattr(args, "select_modal", None))

    # Files: last 20% of the sorted list.
    paths = train_config["dataset_path"][args.dataset_name]
    groups = {name: sorted(glob(paths[k]))
              for k, name in zip(profile.glob_keys, profile.modality_names)}
    labels = sorted(glob(paths["label_path"]))
    n = len(labels)
    lo = int((train_config["train_rate"] + train_config["val_rate"]) * n)
    test_idx = list(range(lo, n))
    specific = getattr(args, "specific_sample", None)
    if specific is not None:
        test_idx = [lo + int(specific)]

    # every model builds from its config entry (its own input-channel key,
    # where the JAX driver reads ``in_ch``, 73, for its init example);
    # SwinUNETR's bias tables are sized by the patch (``load_model``)
    patch_size = train_config["patch_size"][args.dataset_name]
    model = load_model(args.model_name, model_config, device=dev,
                       input_size=patch_size)
    ckpt_path = _resolve_checkpoint(args, train_config)
    logger.info(f"Loading checkpoint {ckpt_path}")
    load_params(ckpt_path, model)

    overlap = test_config.get("sliding_window", {}).get("overlap", 0.25)
    use_hd95 = bool(getattr(args, "use_hd95", 0))
    rows: List[Dict] = []
    pred_dir = test_config.get("result_pred_path", "./result/prediction")
    for i in test_idx:
        t0 = time.perf_counter()
        vols = [load_nifti(groups[k][i])
                for k, on in zip(profile.modality_names, modal_index)
                if on]
        label_img = load_nifti(labels[i])
        label = label_img.data.astype(np.int32)
        x = np.stack([v.data.astype(np.float32) for v in vols], axis=-1)
        volume_name = os.path.basename(labels[i])
        t_read = time.perf_counter()

        big = int(np.prod(x.shape[:-1])) > CPU_STITCH_THRESHOLD
        logits = sliding_window_inference(
            x[None], patch_size, model,
            sw_batch_size=getattr(args, "sw_batch_size", 4),
            overlap=overlap, mode="constant", device=dev,
            cpu_accumulate=big)
        _sync(dev)
        t_window = time.perf_counter()
        # first maximum wins, as np.argmax
        pred_dev = torch.argmax(logits[0], dim=-1).to(torch.int32)
        pred = pred_dev.cpu().numpy()
        del logits
        t_pred = time.perf_counter()
        elapsed = t_pred - t0

        if specific is not None:
            os.makedirs(pred_dir, exist_ok=True)
            base = volume_name.replace(".nii.gz", "").replace(".nii", "")
            for (k, on), v in zip(
                    zip(profile.modality_names, modal_index), vols):
                if on:
                    save_nifti(os.path.join(pred_dir, f"{base}_{k}.nii.gz"),
                               v.data, v.spacing, v.affine)
            save_nifti(os.path.join(pred_dir, f"{base}_pred.nii.gz"),
                       pred.astype(np.int16), label_img.spacing,
                       label_img.affine)
            if not profile.binary_label:
                for rname, mask in (("et", pred == 3),
                                    ("tc", (pred == 1) | (pred == 3)),
                                    ("wt", pred != 0)):
                    save_nifti(
                        os.path.join(pred_dir, f"{base}_{rname}.nii.gz"),
                        mask.astype(np.int16), label_img.spacing,
                        label_img.affine)
            logger.info(f"Saved prediction for {volume_name}")
            continue

        spacing = label_img.spacing[:3]
        if profile.binary_label:
            lab = (label != 0).astype(np.int32)
            m = {k: float(v) for k, v in segmentation_metrics(
                torch.from_numpy(lab[None]).to(dev), pred_dev[None]).items()}
            row = {"name": volume_name, **m, "time": elapsed}
            t_metrics = time.perf_counter()
            if use_hd95:
                row["hd95"] = get_hausdorff(lab, (pred != 0).astype(int),
                                            spacing)
            text = (f"{volume_name}: Dice {m['dice']:.4f} IoU "
                    f"{m['iou']:.4f} ({elapsed:.1f}s)")
        else:
            d = {k: float(v) for k, v in brats_dice(
                pred_dev[None], torch.from_numpy(label[None]).to(dev)
            ).items()}
            row = {"name": volume_name,
                   **{f"dice_{k}": v for k, v in d.items()},
                   "time": elapsed}
            t_metrics = time.perf_counter()
            if use_hd95:
                h = brats_hd95(pred, label, spacing)
                row.update({f"hd95_{k}": v for k, v in h.items()})
            text = (f"{volume_name}: Avg {d['avg']:.4f} ET {d['et']:.4f} "
                    f"TC {d['tc']:.4f} WT {d['wt']:.4f} ({elapsed:.1f}s)")
        t_hd95 = time.perf_counter()
        logger.info(
            f"{text} | s: read {t_read - t0:.4f} window "
            f"{t_window - t_read:.4f} argmax {t_pred - t_window:.4f} "
            f"metrics {t_metrics - t_pred:.4f} hd95 {t_hd95 - t_metrics:.4f}")
        rows.append(row)

    if rows:
        os.makedirs(metric_dir, exist_ok=True)
        out_csv = os.path.join(
            metric_dir, f"{args.dataset_name}_{args.model_name}.csv")
        _write_csv(out_csv, rows)
        logger.info("Mean metrics:\n" + _means(rows))
        logger.info(f"Wrote {out_csv}")
    return rows
