"""Training CLI: ``python -m veloxseg_torch.cli.train_main``.

The flags of ``veloxseg_tpu/cli/train_main.py`` (the reference
``run_train.py:6-31``) and ``--device`` (default ``cuda``; ``cpu`` runs every
kernel's plain PyTorch version); ``--gpu_id`` picks the card. ``--mesh``
and ``--distributed`` are accepted as flags and raise in the trainer: the
port trains on one device.
"""

from __future__ import annotations

import argparse
import json

SUPPORTED_DATASETS = ("AutoPETII", "Hecktor2022", "BraTS2021")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_name", type=str, required=True,
                        choices=SUPPORTED_DATASETS, help="dataset name")
    parser.add_argument("--model_name", type=str, required=True,
                        help="model name")
    parser.add_argument("--train_config", type=str, required=True,
                        help="train_config path")
    parser.add_argument("--model_config", type=str, required=True,
                        help="model_config path")
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="checkpoint path (.pth, or a JAX .ckpt)")
    parser.add_argument("--gpu_id", type=str, default="0",
                        help="the card's index under --device cuda")
    parser.add_argument("--num_workers", type=int, default=8,
                        help="number of threads for data loading")
    parser.add_argument("--model_index", type=str, default=None,
                        help="Markdown index of the model")
    parser.add_argument("--select_modal", type=int, default=None)
    parser.add_argument(
        "--mesh", type=str, default=None,
        help="SPMD device mesh of the JAX package; not ported (raises)")
    parser.add_argument(
        "--distributed", type=str, default=None,
        help="multi-host runtime of the JAX package; not ported (raises)")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="'cuda' (default; raises without a card) or 'cpu'")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.train_config, "r", encoding="utf-8") as f:
        train_config = json.load(f)
    with open(args.model_config, "r", encoding="utf-8") as f:
        model_config = json.load(f)
    from ..train.trainer import run_train
    from ..utils.device import cli_device
    return run_train(args, train_config, model_config,
                     device=cli_device(args.device, args.gpu_id))


if __name__ == "__main__":
    main()
