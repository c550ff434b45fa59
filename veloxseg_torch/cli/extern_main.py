"""Cross-dataset inference CLI: ``python -m veloxseg_torch.cli.extern_main``
(``veloxseg_tpu/cli/extern_main.py``, the reference's
``utils/inference_extern_mri.py``, on PyTorch).

Evaluates checkpoints trained on one dataset (``--train_dataset``) on
another (``--dataset_name``): each volume is resampled to the training
spacing (``Spacingd``: trilinear for images, nearest for labels; host work
in scipy, as in the JAX package) or, with ``--normalize_intensity 1``,
z-scored per volume for MSD-style raw data (``NormalizeIntensityd``); a
3-D volume is repeated to the model's input channels. Then the port's
sliding window (constant blending, the test config's overlap; volumes over
``driver.CPU_STITCH_THRESHOLD`` voxels summed on the host) and the
binary metrics of ``train/metrics`` on the device, as
``infer/driver.py`` runs them. ``--checkpoints`` is a comma list (``.pth``
or the JAX trainer's ``.ckpt``); the rows of all of them go to
``<result_metric_path>/extern_<dataset>_<model>.csv`` (the JAX CLI's file
name and columns), and each case's seconds of read, resample, window and
metrics to the log. ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from glob import glob

import numpy as np
from scipy import ndimage


def resample_to_spacing(vol: np.ndarray, spacing, target_spacing,
                        order: int) -> np.ndarray:
    """``vol`` zoomed from ``spacing`` to ``target_spacing`` (spline
    ``order``: 1 trilinear, 0 nearest; edges by ``nearest``), unchanged
    where every factor is within 1e-3 of 1."""
    factors = [s / t for s, t in zip(spacing, target_spacing)]
    if all(abs(f - 1.0) < 1e-3 for f in factors):
        return vol
    return ndimage.zoom(vol, factors, order=order, mode="nearest")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_name", required=True,
                        help="external dataset key in the train config")
    parser.add_argument("--train_dataset", required=True,
                        help="dataset the checkpoints were trained on")
    parser.add_argument("--model_name", required=True)
    parser.add_argument("--checkpoints", required=True,
                        help="comma-separated checkpoint paths")
    parser.add_argument("--train_config", required=True)
    parser.add_argument("--model_config", required=True)
    parser.add_argument("--test_config", required=True)
    parser.add_argument("--normalize_intensity", type=int, default=0,
                        help="1 = per-volume z-score (MSD2019 parity)")
    parser.add_argument("--sw_batch_size", type=int, default=4)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="'cuda' (default; raises without a card) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.train_config) as f:
        train_config = json.load(f)
    with open(args.model_config) as f:
        model_config = json.load(f)
    with open(args.test_config) as f:
        test_config = json.load(f)

    import torch

    from ..data.nifti import load_nifti
    from ..infer.driver import CPU_STITCH_THRESHOLD, _sync, _write_csv
    from ..infer.sliding_window import sliding_window_inference
    from ..models.registry import load_model
    from ..train.checkpoint import load_params
    from ..train.metrics import segmentation_metrics
    from ..utils.device import cli_device
    from ..utils.logger import get_logger

    dev = cli_device(args.device)
    out_dir = test_config.get("result_metric_path", "./result/metric")
    logger = get_logger(os.path.join(
        out_dir, f"extern_{args.dataset_name}_{args.model_name}.log"))

    ds_paths = train_config["dataset_path"][args.dataset_name]
    data_glob = ds_paths.get("data_path") or ds_paths.get("pet_path")
    images = sorted(glob(data_glob))
    labels = sorted(glob(ds_paths["label_path"]))

    patch_size = train_config["patch_size"][args.train_dataset]
    target_spacing = train_config["spacing"][args.train_dataset]
    overlap = test_config.get("sliding_window", {}).get("overlap", 0.25)
    in_ch = model_config[args.model_name].get("in_ch", [1, 1])
    n_in = sum(in_ch) if isinstance(in_ch, (list, tuple)) else in_ch

    model = load_model(args.model_name, model_config, device=dev)
    all_rows = []
    for ckpt in args.checkpoints.split(","):
        ckpt = ckpt.strip()
        load_params(ckpt, model)
        logger.info(f"=== checkpoint {ckpt} ===")
        for img_f, lab_f in zip(images, labels):
            t0 = time.time()
            img = load_nifti(img_f)
            lab = load_nifti(lab_f)
            vol = img.data.astype(np.float32)
            labd = lab.data.astype(np.int32)
            t_read = time.time()
            if args.normalize_intensity:
                vol = (vol - vol.mean()) / max(float(vol.std()), 1e-8)
            else:
                vol = resample_to_spacing(vol, img.spacing[:3],
                                          target_spacing, order=1)
                labd = resample_to_spacing(labd, lab.spacing[:3],
                                           target_spacing, order=0)
            x = np.repeat(vol[..., None], n_in, axis=-1) if vol.ndim == 3 \
                else vol
            t_resample = time.time()
            big = int(np.prod(x.shape[:-1])) > CPU_STITCH_THRESHOLD
            logits = sliding_window_inference(
                x[None], patch_size, model, sw_batch_size=args.sw_batch_size,
                overlap=overlap, mode="constant", device=dev,
                cpu_accumulate=big)
            # first maximum wins, as np.argmax
            pred = torch.argmax(logits[0], dim=-1)
            _sync(dev)
            del logits
            t_window = time.time()
            lab_t = torch.from_numpy((labd != 0).astype(np.int32)[None])
            m = {k: float(v) for k, v in segmentation_metrics(
                lab_t.to(pred.device),
                (pred != 0).to(torch.int32)[None]).items()}
            t_end = time.time()
            row = {"checkpoint": os.path.basename(ckpt),
                   "name": os.path.basename(lab_f), **m,
                   "time": t_end - t0}
            all_rows.append(row)
            logger.info(
                f"{row['name']}: dice {m['dice']:.4f} | s: read "
                f"{t_read - t0:.4f} resample {t_resample - t_read:.4f} "
                f"window {t_window - t_resample:.4f} metrics "
                f"{t_end - t_window:.4f} | shape {tuple(x.shape)}")

    os.makedirs(out_dir, exist_ok=True)
    out_csv = os.path.join(
        out_dir, f"extern_{args.dataset_name}_{args.model_name}.csv")
    _write_csv(out_csv, all_rows)
    logger.info(f"Wrote {out_csv}")
    return all_rows


if __name__ == "__main__":
    main()
