#!/usr/bin/env python3
"""Where a forward of the PyTorch port spends its time on one GPU.

    python3 tools/profile_torch_eval.py [--batch 4] [--out DIR]

Builds the AutoPET-II VeloxSeg (``config/models_config_autopetii.json``)
at full width with seeded weights on the card and runs the eval forward on
a seeded (batch, 96, 96, 96, 2) input (batch 4 is one sliding-window
batch). It prints, per forward: the wall time (host clock around
forwards ended by a synchronize), the device kernel time summed by
``torch.profiler``, the device's idle share (1 − kernel time / wall
time), and the kernels by device time. The JSON goes to
``<out>/profile_torch_eval_b<batch>.json`` (default ``runs``). Needs CUDA;
fp32, TF32 off.
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
PORT_KERNELS = ("pwa_attention_kernel", "jlc_branch_conv",
                "plane_stats_kernel", "jlc_stage1_apply", "jlc_channel_mlp")


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
    ap.add_argument("--batch", type=int, default=4)
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
    model, _ = build_veloxseg(cfg, device="cuda", seed=0)
    x = torch.randn(args.batch, 96, 96, 96, 2,
                    generator=torch.Generator().manual_seed(1)).cuda()

    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()

    # device-side rows only (kernels, memcpy, memset): a CPU op's row
    # repeats the device time of the kernels it launched
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count / iters,
             e.self_device_time_total / iters)
            for e in prof.key_averages() if e.device_type == cuda]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows) / 1e3
    port_ms = sum(r[2] for r in rows
                  if any(k in r[0] for k in PORT_KERNELS)) / 1e3
    launches = sum(r[1] for r in rows)
    print(f"card: {card}")
    print(f"batch {args.batch}: wall {wall_ms:.3f} ms/forward | device "
          f"kernels {device_ms:.3f} ms/forward ({launches:.0f} kernels) | "
          f"idle share {1 - device_ms / wall_ms:.3f} | port kernels "
          f"{port_ms:.3f} ms, other kernels {device_ms - port_ms:.3f} ms")
    for name, count, us in rows[:25]:
        print(f"  {us:10.1f} us  x{count:5.1f}  {name[:90]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_torch_eval_b{args.batch}.json"),
              "w") as f:
        json.dump(dict(card=card, batch=args.batch, wall_ms=wall_ms,
                       device_ms=device_ms, port_kernels_ms=port_ms,
                       kernels_per_forward=launches,
                       idle_share=1 - device_ms / wall_ms,
                       rows=[dict(name=n, per_forward=c, device_us=u)
                             for n, c, u in rows]), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
