#!/usr/bin/env python3
"""Where a forward, or a train step, of the PyTorch port spends its time
on one GPU.

    python3 tools/profile_torch_eval.py [--model autopet|flagship|urwkv|NAME]
        [--batch N] [--train] [--bf16] [--out DIR]

Builds the model at full width with seeded weights on the card: the
AutoPET-II VeloxSeg (``config/models_config_autopetii.json``, 96³), the
128³ flagship of bench.py (``core/config.flagship_config``), AutoPET-II's
U-RWKV (96³, eval only), or any other model of the port's registry by its
name (``SwinUNETR``, ``UNETR``, ...: AutoPET-II's entry at 96³, eval
only). It runs, on a seeded (batch, size³, 2) input, the
eval forward (batch 4 by default: one sliding-window batch) or, with
``--train``, the train step (dropout at the config's rates;
``config/train_config_bs4.json``'s loss weights and AdamW, which bench.py
uses too; batch 2 by default, 16 for the flagship, bench.py's; in fp32,
or with ``--bf16`` in bf16 as the trainer steps) with labels
that threshold the PET channel. ``--bf16`` without ``--train`` runs the
eval forward as the speed CLI does: the model cast to bf16, a bf16 input. It prints, per forward or
step: the wall time (host clock around iterations ended by a
synchronize), the device time summed by ``torch.profiler``, the device's
idle share (1 − device time / wall time), the device operations, the
device time by kernel family, the device span of each of the port's
profiler ranges (:data:`RANGES`: HCMA-UNet's selective scan), the peak
memory allocated (``torch.cuda.max_memory_allocated`` over the warm-up
runs), the kernels by device time and the
library's convolutions (forward and backward) by input shapes. The JSON
goes to ``<out>/profile_torch_<model>_{eval,eval_bf16,train,train_bf16}_b<batch>.json``
(default ``runs``). Needs CUDA; TF32 off.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from chip_measure import card as card_line

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# substrings of the port's own kernel names (csrc/*.cu)
PORT_KERNELS = ("pwa_train_fwd", "pwa_bwd_",
                "pwa_long_", "wkv_kernel", "jlc_branch_conv", "jlc_conv_stats",
                "jlc_branch_wgrad", "jlc_wgrad_reduce", "plane_stats_kernel",
                "jlc_stage1_apply", "jlc_stage1_bwd_planes",
                "jlc_stage2_mlp", "jlc_stage2_sum", "jlc_mlp_bwd_tiles",
                "jlc_stage2_bwd_planes")

# the port's profiler ranges (record_function), reported by device span
RANGES = ("selective_scan",)

# (family, substrings of the kernel names), first match wins: the port's
# own kernels come before the library families, whose substrings ("conv",
# "wgrad", "reduce") their names also hold
FAMILIES = (
    # K1 is the train forward's instance <T, Cqk, Cv, DROP, LSE, LDG,
    # ROUND> with neither dropout nor lse (a key of several substrings
    # needs them all)
    ("K1 eval attention (pwa_train_fwd, no dropout, no lse)",
     (("pwa_train_fwd", "false, false, true, false>"),
      ("pwa_train_fwd", "false, false, false, false>"))),
    ("K2f/K3f train attention forward", ("pwa_train_fwd",)),
    ("K2b attention backward", ("pwa_bwd_",)),
    ("K3b long-window attention backward", ("pwa_long_bwd",)),
    ("K6 WKV recurrence", ("wkv_kernel",)),
    ("K4f/K4b branch conv (jlc_branch_conv)", ("jlc_branch_conv",)),
    ("K4b branch wgrad (jlc_branch_wgrad)", ("jlc_branch_wgrad",
                                              "jlc_wgrad_reduce")),
    ("K4f/K4b/K5f/K5b IN statistics", ("plane_stats_kernel",
                                       "jlc_conv_stats")),
    ("K4f apply", ("jlc_stage1_apply",)),
    ("K4b planes", ("jlc_stage1_bwd_planes",)),
    ("K5f MLP", ("jlc_stage2_mlp", "jlc_stage2_sum")),
    ("K5b", ("jlc_mlp_bwd_tiles", "jlc_stage2_bwd_planes")),
    ("optimizer (foreach AdamW)", ("multi_tensor", "foreach")),
    ("cuDNN convolutions", ("conv", "cudnn", "implicit", "fprop", "dgrad",
                            "wgrad", "nchw", "nhwc")),
    ("cuBLAS GEMMs (linear layers, attention products)",
     ("gemm", "cutlass", "xmma", "sm90_", "nvjet")),
    ("softmax (attention)", ("softmax",)),
    ("PyTorch reductions (norms)", ("reduce", "norm")),
    ("PyTorch elementwise", ("elementwise", "index", "cat", "where")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(all(p.lower() in low for p in ((k,) if isinstance(k, str)
                                              else k)) for k in keys):
            return fam
    return "other"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_eval: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile

    from veloxseg_torch.core.config import flagship_config, load_json_config
    from veloxseg_torch.models.registry import load_model
    from veloxseg_torch.nn.veloxseg import build_veloxseg

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="autopet",
                    help="autopet, flagship, urwkv or a registry name")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 4 (eval) or the train config's 2")
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    ap.add_argument("--bf16", action="store_true",
                    help="in bf16: the train step's compute_dtype, or the "
                         "eval model and input cast")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs"))
    args = ap.parse_args()
    iters = 5

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = load_json_config(os.path.join(
        ROOT, "config", "models_config_autopetii.json"))
    train_cfg = load_json_config(os.path.join(
        ROOT, "config", "train_config_bs4.json"))
    veloxseg = args.model in ("autopet", "flagship")
    if args.train and not veloxseg:
        ap.error(f"{args.model} is profiled in eval only")
    size = 128 if args.model == "flagship" else 96
    batch = args.batch or (4 if not args.train else
                           16 if args.model == "flagship"
                           else train_cfg["batch_size"])
    if not veloxseg:
        name = "U-RWKV" if args.model == "urwkv" else args.model
        model = load_model(name, models, device="cuda", seed=0,
                           input_size=(size,) * 3)
    else:
        model, _ = build_veloxseg(
            flagship_config() if args.model == "flagship"
            else models["VeloxSeg"], device="cuda", seed=0)
    x = torch.randn(batch, size, size, size, 2,
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
        train_step = train_step_fn(
            CompositeLoss("VeloxSeg", train_cfg,
                          num_modal=model.cfg.num_modalities),
            compute_dtype=torch.bfloat16 if args.bf16 else None)
        y = (x[..., 0] > 1.0).long()
        gen = torch.Generator(device="cuda").manual_seed(2)

        def run():
            train_step(state, x, y, gen)
        grad_mode = torch.enable_grad
    else:
        if args.bf16:
            model, x = model.to(torch.bfloat16), x.to(torch.bfloat16)

        def run():
            model(x)
        grad_mode = torch.inference_mode

    with grad_mode():
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
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
    # the device spans of the port's own profiler ranges (``selective_scan``)
    ranges = {e.key: e.device_time_total / iters / 1e3
              for e in prof.key_averages() if e.device_type == cuda
              and getattr(e, "is_user_annotation", False)
              and e.key in RANGES}
    device_ms = sum(r[2] for r in rows) / 1e3
    port_ms = sum(r[2] for r in rows
                  if any(k in r[0] for k in PORT_KERNELS)) / 1e3
    launches = sum(r[1] for r in rows)
    fams = {}
    for name, count, us in rows:
        f = fams.setdefault(family(name), [0.0, 0.0])
        f[0] += count
        f[1] += us / 1e3
    # the library's convolutions by input shapes: the device time of the
    # kernels each aten call launched (forward, and backward with its mask)
    convs = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::convolution", "aten::convolution_backward"):
            dev_us = getattr(e, "device_time_total", None)
            if dev_us is None:
                dev_us = e.cuda_time_total
            convs.append((e.key, e.count / iters, dev_us / iters,
                          [list(s) for s in e.input_shapes[:3]]))
    convs.sort(key=lambda r: -r[2])
    unit = "step" if args.train else "forward"
    kind = ("train" if args.train else "eval") + ("_bf16" if args.bf16
                                                   else "")
    print(f"card: {card}")
    print(f"{args.model} {size}³ {kind} batch {batch}: wall {wall_ms:.3f} "
          f"ms/{unit} | device {device_ms:.3f} ms/{unit} ({launches:.0f} "
          f"operations) | "
          f"idle share {1 - device_ms / wall_ms:.3f} | port kernels "
          f"{port_ms:.3f} ms, other {device_ms - port_ms:.3f} ms")
    for fam, (count, ms) in sorted(fams.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ms:9.3f} ms  x{count:6.1f}  {fam}")
    for key, ms in ranges.items():
        print(f"  range {key}: {ms:.3f} ms/{unit} on the device, "
              f"{ms / device_ms:.3f} of the device time")
    print(f"  peak memory allocated {peak_gb:.3f} GB (the warm-up runs)")
    for name, count, us in rows[:25]:
        print(f"  {us:10.1f} us  x{count:5.1f}  {name[:90]}")
    print("library convolutions by shapes (grad_output or input, input or "
          "weight, weight):")
    for key, count, us, shapes in convs[:15]:
        print(f"  {us:10.1f} us  x{count:5.1f}  {key} {shapes}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_torch_{args.model}_{kind}_"
                           f"b{batch}.json"), "w") as f:
        json.dump(dict(card=card, model=args.model, kind=kind, batch=batch,
                       wall_ms=wall_ms,
                       device_ms=device_ms, port_kernels_ms=port_ms,
                       operations=launches, ranges=ranges,
                       peak_allocated_gb=peak_gb,
                       idle_share=1 - device_ms / wall_ms,
                       families={k: dict(per_unit=c, device_ms=m)
                                 for k, (c, m) in fams.items()},
                       rows=[dict(name=n, per_unit=c, device_us=u)
                             for n, c, u in rows],
                       convolutions=[dict(op=k, per_unit=c, device_us=u,
                                          shapes=sh)
                                     for k, c, u, sh in convs]), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
