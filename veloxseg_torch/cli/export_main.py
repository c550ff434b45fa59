"""Serving export CLI: ``python -m veloxseg_torch.cli.export_main``.

The flags of ``veloxseg_tpu/cli/export_main.py:13-40``, with
``--platforms`` replaced by ``--device`` (default ``cuda``; ``cpu`` for a
CPU artifact): the artifact is traced per device, as the JAX one is lowered
per platform list. The weights come from the checkpoint the flags name
(``infer/driver._resolve_checkpoint``: ``.pth``, or the JAX trainer's
``.ckpt``, through ``train/checkpoint.load_params``). Writes one
``torch.export`` artifact (:mod:`..infer.export`) with the metadata: model
and dataset, the input's layout, patch size and channels, the checkpoint
and the device. Load it with ``torch.export.load`` alone, or with
:func:`veloxseg_torch.infer.export.load_artifact`.
"""

from __future__ import annotations

import argparse
import json
import os

SUPPORTED_DATASETS = ("AutoPETII", "Hecktor2022", "BraTS2021")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_name", type=str, required=True,
                        choices=SUPPORTED_DATASETS)
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--model_config", type=str, required=True)
    parser.add_argument("--train_config", type=str, required=True)
    parser.add_argument("--train_date", type=str, default=None)
    parser.add_argument("--model_index", type=str, default=None)
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--checkpoint_index", type=str, default="val_best")
    parser.add_argument("--output", type=str, required=True,
                        help="artifact file to write (e.g. model.pt2)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="'cuda' (default; raises without a card) or 'cpu': the device "
             "the artifact is traced for and runs on")
    parser.add_argument(
        "--batch", type=int, default=None,
        help="pin the batch dimension; default: symbolic (any batch)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.train_config, "r", encoding="utf-8") as f:
        train_config = json.load(f)
    with open(args.model_config, "r", encoding="utf-8") as f:
        model_config = json.load(f)

    from ..infer.driver import _resolve_checkpoint
    from ..infer.export import export_eval, save_artifact
    from ..models.registry import load_model
    from ..train.checkpoint import load_params
    from ..utils.device import cli_device

    dev = cli_device(args.device)
    model = load_model(args.model_name, model_config, device=dev)
    patch_size = train_config["patch_size"][args.dataset_name]
    in_ch = model_config[args.model_name].get("in_ch", [1, 1])
    channels = sum(in_ch) if isinstance(in_ch, (list, tuple)) else in_ch

    ckpt_path = _resolve_checkpoint(args, train_config)
    load_params(ckpt_path, model)
    program = export_eval(model, patch_size, channels, batch=args.batch)
    save_artifact(args.output, program, metadata={
        "model_name": args.model_name,
        "dataset_name": args.dataset_name,
        "layout": "(B, D, H, W, C) float32 in; (B, D, H, W, n_classes) "
                  "logits out",
        "patch_size": list(patch_size),
        "channels": channels,
        "batch": args.batch,
        "checkpoint": os.path.abspath(ckpt_path),
        "device": str(dev),
    })
    print(f"wrote {args.output} "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB, device={dev})")
    return args.output


if __name__ == "__main__":
    main()
