#!/usr/bin/env python3
"""Where a forward, or a train step, of the PyTorch port spends its time
on one GPU.

    python3 tools/profile_torch_eval.py [--batch 4] [--train] [--out DIR]

Builds the AutoPET-II VeloxSeg (``config/models_config_autopetii.json``)
at full width with seeded weights on the card and runs, on a seeded
(batch, 96, 96, 96, 2) input, the eval forward (batch 4 is one
sliding-window batch) or, with ``--train``, the train step as published
(dropout on; ``config/train_config_bs4.json``: AdamW, batch 2 by default)
with labels that threshold the PET channel. It prints, per forward or
step: the wall time (host clock around iterations ended by a
synchronize), the device time summed by ``torch.profiler``, the device's
idle share (1 − device time / wall time), the device operations, the
device time by kernel family and the kernels by device time. The JSON
goes to ``<out>/profile_torch_{eval,train}_b<batch>.json`` (default
``runs``). Needs CUDA; fp32, TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# substrings of the port's own kernel names (csrc/*.cu)
PORT_KERNELS = ("pwa_attention_kernel", "pwa_attention_bwd_kernel",
                "dbias_reduce", "jlc_branch_conv", "plane_stats_kernel",
                "jlc_stage1_apply", "jlc_stage1_bwd_planes",
                "jlc_channel_mlp", "jlc_mlp_bwd_tiles",
                "jlc_stage2_bwd_planes", "mlp_partials_reduce")

# (family, substrings of the kernel names), first match wins
FAMILIES = (
    ("K1/K2f attention (pwa_attention_kernel)", ("pwa_attention_kernel",)),
    ("K2b attention backward", ("pwa_attention_bwd_kernel", "dbias_reduce")),
    ("K4f/K4b branch conv (jlc_branch_conv)", ("jlc_branch_conv",)),
    ("K4f/K4b/K5f/K5b IN statistics", ("plane_stats_kernel",)),
    ("K4f apply", ("jlc_stage1_apply",)),
    ("K4b planes", ("jlc_stage1_bwd_planes",)),
    ("K5f MLP", ("jlc_channel_mlp",)),
    ("K5b", ("jlc_mlp_bwd_tiles", "jlc_stage2_bwd_planes",
             "mlp_partials_reduce")),
    ("optimizer (foreach AdamW)", ("multi_tensor", "foreach")),
    ("cuDNN/cuBLAS convs and GEMMs", ("conv", "cudnn", "xmma", "gemm",
                                      "cutlass", "sm90_", "implicit",
                                      "dgrad", "wgrad", "nchw", "nhwc")),
    ("PyTorch reductions", ("reduce", "softmax", "norm")),
    ("PyTorch elementwise", ("elementwise", "index", "cat", "where")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_eval: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.nn.veloxseg import build_veloxseg

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=None,
                    help="default 4 (eval) or the train config's 2")
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs"))
    args = ap.parse_args()
    iters = 5

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_json_config(os.path.join(
        ROOT, "config", "models_config_autopetii.json"))["VeloxSeg"]
    train_cfg = load_json_config(os.path.join(
        ROOT, "config", "train_config_bs4.json"))
    batch = args.batch or (train_cfg["batch_size"] if args.train else 4)
    model, _ = build_veloxseg(cfg, device="cuda", seed=0)
    x = torch.randn(batch, 96, 96, 96, 2,
                    generator=torch.Generator().manual_seed(1)).cuda()

    if args.train:
        from veloxseg_torch.train.loss import CompositeLoss
        from veloxseg_torch.train.optim import build_optimizer
        from veloxseg_torch.train.train_state import (create_train_state,
                                                      train_step_fn)
        opt = train_cfg["optimizer"]
        state = create_train_state(model, build_optimizer(
            opt["optimizer_type"], opt["optimizer_args"],
            model.parameters()))
        train_step = train_step_fn(CompositeLoss(train_cfg, model.cfg))
        y = (x[..., 0] > 1.0).long()
        gen = torch.Generator(device="cuda").manual_seed(2)

        def run():
            train_step(state, x, y, gen)
        grad_mode = torch.enable_grad
    else:
        def run():
            model(x)
        grad_mode = torch.inference_mode

    with grad_mode():
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()

    # device-side rows only (kernels, memcpy, memset): a CPU op's row
    # repeats the device time of the kernels it launched, and a user
    # annotation's GPU range (``Optimizer.step#AdamW.step``) that of the
    # kernels inside it
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count / iters,
             e.self_device_time_total / iters)
            for e in prof.key_averages() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("Optimizer.", "ProfilerStep"))]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3
    port_ms = sum(r[2] for r in rows
                  if any(k in r[0] for k in PORT_KERNELS)) / 1e3
    launches = sum(r[1] for r in rows)
    fams = {}
    for name, count, us in rows:
        f = fams.setdefault(family(name), [0.0, 0.0])
        f[0] += count
        f[1] += us / 1e3
    unit = "step" if args.train else "forward"
    kind = "train" if args.train else "eval"
    print(f"card: {card}")
    print(f"{kind} batch {batch}: wall {wall_ms:.3f} ms/{unit} | device "
          f"{device_ms:.3f} ms/{unit} ({launches:.0f} operations) | "
          f"idle share {1 - device_ms / wall_ms:.3f} | port kernels "
          f"{port_ms:.3f} ms, other {device_ms - port_ms:.3f} ms")
    for fam, (count, ms) in sorted(fams.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ms:9.3f} ms  x{count:6.1f}  {fam}")
    for name, count, us in rows[:25]:
        print(f"  {us:10.1f} us  x{count:5.1f}  {name[:90]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_torch_{kind}_b{batch}.json"),
              "w") as f:
        json.dump(dict(card=card, kind=kind, batch=batch, wall_ms=wall_ms,
                       device_ms=device_ms, port_kernels_ms=port_ms,
                       operations=launches,
                       idle_share=1 - device_ms / wall_ms,
                       families={k: dict(per_unit=c, device_ms=m)
                                 for k, (c, m) in fams.items()},
                       rows=[dict(name=n, per_unit=c, device_us=u)
                             for n, c, u in rows]), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
