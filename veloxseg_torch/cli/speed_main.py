"""Throughput CLI: ``python -m veloxseg_torch.cli.speed_main``.

The protocol of ``veloxseg_tpu/cli/speed_main.py`` (the reference
``speed_test.py``): per model, find the largest batch by doubling up to
``MAX_BS``, then time the eval forward in bf16 (the model cast with
``model.to(torch.bfloat16)``, a bf16 input, under
``torch.inference_mode()``) as the median images/s of 3 fenced windows of
``T_TIMED / 3`` seconds (:mod:`..utils.benchmarking`), and report the
parameter count and the operations per image at batch 1
(:mod:`..utils.flops`: ``FlopCounterMode`` with the kernels' own counts,
in place of XLA's ``cost_analysis``, which also counts elementwise work).

``--devices`` is a comma list of ``default`` (the card) and ``cpu`` (every
kernel's plain version); the default is the card alone, and asking for it
without one raises. The port's registry holds VeloxSeg, U-RWKV and the
fifteen baselines of the zoo, so every model of a published config runs
(built for the dataset's shape); a model it lacked would print the JAX
CLI's "not implemented yet, skipping" line. The zoo's operations are all
library calls (convolutions, transposed convolutions, the attention's
matrix products, HCMA-UNet's scan), which ``FlopCounterMode`` counts:
the scan's elementwise products are not counted, as XLA's
``cost_analysis`` would count them. HCMA-UNet's Params are the
reference's: its up-projections hold O biases where the JAX module holds
them repeated O·s³ times (1,568 fewer at the published widths).

Two differences from the JAX CLI, on purpose: :func:`find_max_batch_size`
stops only at ``torch.cuda.OutOfMemoryError``. Any other error (a kernel
that does not build or launch) propagates, where JAX's bare ``except``
would report it as "does not fit at batch 1"; so does an error of the
operation count. And a model whose builder refuses the shape with
:class:`..models.registry.CannotRunAtShape` (NestedFormer at Hecktor2022:
its window does not divide its bottleneck) is reported as skipped, with
the reason, in the results and on a line of its own, where the JAX CLI
stops in the model's ``init``; any other error of a builder propagates.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional, Sequence

import torch

from ..utils.benchmarking import fence, median_rate
from ..utils.device import resolve_device
from ..utils.flops import count_flops

INPUT_SIZE = {
    "AutoPETII": (96, 96, 96, 2),
    "Hecktor2022": (128, 128, 64, 2),
    "BraTS2021": (96, 96, 96, 4),
}
T_TIMED = 12.0
PROBE_ITERS = 20   # each window's probe dispatches (twice, before it)
MAX_BS = 16
SKIP = ()  # every model of the port's registry runs


def eval_param_count(model: torch.nn.Module) -> int:
    """The parameters of the eval model, as the JAX CLI counts those of
    ``model.init(..., train=False)``: a model's ``TRAIN_ONLY`` submodules
    (VeloxSeg's reconstruction teachers) are not counted."""
    skip = getattr(model, "TRAIN_ONLY", ())
    return sum(p.numel() for n, p in model.named_parameters()
               if n.split(".")[0] not in skip)


def find_max_batch_size(fwd: Callable, input_shape: Sequence[int],
                        dtype: torch.dtype, device: torch.device) -> int:
    """The largest batch of 1, 2, 4, … up to ``MAX_BS`` whose forward runs;
    0 when batch 1 runs out of card memory. Only
    ``torch.cuda.OutOfMemoryError`` stops the doubling."""
    max_bs, bs = 0, 1
    while bs <= MAX_BS:
        try:
            fence(fwd(torch.zeros((bs, *input_shape), dtype=dtype,
                                  device=device)))
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            break
        max_bs = bs
        bs *= 2
    return max_bs


def bench_model(name: str, model_config: dict, input_shape: Sequence[int],
                device: torch.device) -> Optional[dict]:
    """Time ``name``'s bf16 eval forward on ``device``; the result dict,
    ``{"model", "skipped": reason}`` where the model cannot be built for
    the shape, or None where batch 1 does not fit."""
    from ..models.registry import CannotRunAtShape, load_model
    try:
        model = load_model(name, model_config, device=device, seed=0,
                           input_size=input_shape[:3])
    except CannotRunAtShape as e:
        print(f"{name}: cannot run at {tuple(input_shape)}: {e}, skipping")
        return {"model": name, "skipped": str(e)}
    n_params = eval_param_count(model)
    dtype = torch.bfloat16
    model = model.to(dtype)

    def fwd(x):
        with torch.inference_mode():
            return model(x)

    bs = find_max_batch_size(fwd, input_shape, dtype, device)
    if bs == 0:
        print(f"{name}: does not fit at batch 1")
        return None
    x = torch.randn((bs, *input_shape), generator=torch.Generator()
                    .manual_seed(2)).to(device=device, dtype=dtype)
    throughput = median_rate(lambda: fwd(x), bs, windows=3,
                             seconds=T_TIMED / 3, probe_iters=PROBE_ITERS)
    flops = count_flops(fwd, x[:1])        # per image, at batch 1
    print(f"{name} {device.type} {throughput:.2f} images/s @ batch size "
          f"{bs}")
    print(f"Params {n_params / 1e6} M")
    print(f"FLOPS: {flops / 1e9} G")
    print(f"Achieved: {flops * throughput / 1e12:.2f} TFLOP/s")
    return {"model": name, "throughput": throughput, "batch_size": bs,
            "params": n_params, "flops": flops}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True,
                        choices=list(INPUT_SIZE))
    parser.add_argument("--model_list", type=str, default=None)
    parser.add_argument("--model_config", type=str, default=None,
                        help="model config JSON (defaults to config/"
                             "models_config_<dataset>.json)")
    parser.add_argument("--devices", type=str, default="default",
                        help="comma list of {default, cpu}: default is the "
                             "card (raises without one); 'default,cpu' adds "
                             "a pass on the CPU")
    args = parser.parse_args(argv)

    cfg_path = args.model_config or os.path.join(
        "config", f"models_config_{args.dataset.lower()}.json")
    with open(cfg_path, "r", encoding="utf-8") as f:
        config = json.load(f)
    keys = ([k.strip() for k in args.model_list.split(",")]
            if args.model_list else list(config))

    devices = []
    for d in (d.strip() for d in args.devices.split(",")):
        if d == "default":
            devices.append((d, resolve_device(None)))
        elif d == "cpu":
            devices.append((d, torch.device("cpu")))
        else:
            raise ValueError(f"unknown device {d!r} (use default/cpu)")

    from ..models.registry import available_models
    results = []
    for tag, device in devices:
        for name in keys:
            if name in SKIP:
                continue
            if name not in available_models():
                print(f"{name}: not implemented yet, skipping")
                continue
            res = bench_model(name, config, INPUT_SIZE[args.dataset], device)
            if res:
                res["device"] = tag
                results.append(res)
    return results


if __name__ == "__main__":
    main()
