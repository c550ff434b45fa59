#!/usr/bin/env python3
"""The smallest size at which ``chip_smoke.py``'s zoo train-step rule holds,
per model, on one card.

    python3 tools/zoo_train_sizes.py --models VNet,HCMA-UNet --sizes 32,64 \
        [--factor] [--moved]

For each model and each size, smallest first, it runs
``chip_smoke.zoo_train_steps`` (one train step card against CPU in fp32,
with the float64 step as the yardstick, and in bf16 against the CPU's bf16
step by ``STEP_BOUND``; ``--factor``: in factor mode, and ``--moved``:
each bound also allowing 4x the card's movement under a 1e-7 input
change, as phase [22] runs the models that draw in training) and prints
the step's line, or the failure with the worst tensor's share of its
tolerance, and last each
model's smallest size that passed. A size ``s`` is an ``s``³ input, but
NestedFormer's (1.5·s, 1.5·s, s): its window (3, 3, 2) must divide its
1/16 bottleneck. Models without a port kernel only (U-RWKV's K6 counts are
not set up here).
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def size_of(name: str, s: int) -> tuple:
    return (s * 3 // 2, s * 3 // 2, s) if name == "NestedFormer" \
        else (s, s, s)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", required=True, help="comma list")
    ap.add_argument("--sizes", default="32,64", help="comma list, smallest "
                    "first")
    ap.add_argument("--factor", action="store_true",
                    help="the steps in factor mode (phase [22]'s)")
    ap.add_argument("--moved", action="store_true",
                    help="each bound also allows 4x the card's movement "
                         "under a 1e-7 input change (phase [22]'s)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    import chip_smoke
    from veloxseg_torch.core.config import load_json_config

    if not torch.cuda.is_available():
        print("zoo_train_sizes: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    models = load_json_config(os.path.join(
        ROOT, "config", "models_config_autopetii.json"))
    smallest = {}
    for name in args.models.split(","):
        for s in (int(v) for v in args.sizes.split(",")):
            size = size_of(name, s)
            try:
                chip_smoke.zoo_train_steps(
                    card, lambda: None, lambda: {}, models, names=(name,),
                    sizes={name: size}, tag="sizes", factor=args.factor,
                    moved=args.moved)
            except AssertionError as e:
                print(f"[sizes] {name} at {size}: fails: {e}", flush=True)
                continue
            except Exception:
                traceback.print_exc()
                print(f"[sizes] {name} at {size}: error", flush=True)
                continue
            finally:
                torch.cuda.empty_cache()
            smallest[name] = size
            break
    print(f"[sizes] smallest size that passed: {smallest}", flush=True)
    return 0 if len(smallest) == len(args.models.split(",")) else 1


if __name__ == "__main__":
    sys.exit(main())
