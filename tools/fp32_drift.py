#!/usr/bin/env python3
"""How far a model's fp32 eval forward lies from its float64 one, on the
card and on the CPU, and which module puts the distance there.

    python3 tools/fp32_drift.py [--model HCMA-UNet] [--seed 7]
        [--input case|random] [--batch 1] [--variants] [--out DIR]

Builds ``--model`` at its AutoPET-II entry (96³) with seeded weights, as
``chip_smoke.py``'s serving phase does (``--seed 7``), and one input:
``case`` is the serving phase's synthetic (96, 96, 80) AutoPET-II case
(``chip_smoke.blob_volume``, seed 44) with the sliding window's symmetric
zero padding to 96³ (the distances cover the whole padded tile, where
the window crops 8 voxels off each side of W); ``random`` is a seeded
normal (batch, 96³, 2). The reference is the CPU's float64 forward. It
prints:

- each forward's distance from that reference (max, 99.99th and 50th
  percentiles of |y − y64|, the voxels whose argmax differs): the CPU in
  fp32, the card in float64, and the card in fp32 with cuDNN as PyTorch
  sets it (heuristic algorithms), deterministic, benchmarked, and off
  (PyTorch's own convolutions);
- with ``--variants``: the same distances with the grouped strided 3-D
  convolutions (groups > 1, stride > 1) run three ways (cuDNN on a
  channels-last copy, as on the channels-last view the port passed them
  before; cuDNN on a contiguous NCDHW copy, as the port passes HCMA-UNet's
  now; PyTorch's own convolution, cuDNN off for them alone), each one's local
  error, and the bf16 batch-16 forward's CUDA-event ms in each way (the
  speed CLI's form);
- per module, its local error: the module fed the float64 forward's own
  input to it, rounded to fp32, against that forward's output, relative
  to the output's largest value, on the CPU, on the card and on the card
  without cuDNN; the modules whose card error exceeds the CPU's most,
  and those whose card error is largest.

The JSON goes to ``<out>/fp32_drift_<model>_<input>.json`` (default
``runs``). Needs CUDA; TF32 off.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from chip_measure import card as card_line  # noqa: E402

SHAPE = (96, 96, 96)
CASE = (96, 96, 80)

# cuDNN settings of the card's fp32 forwards: (enabled, deterministic,
# benchmark)
CUDNN = {"heuristic": (True, False, False),
         "deterministic": (True, True, False),
         "benchmark": (True, False, True),
         "off": (False, False, False)}


@contextlib.contextmanager
def cudnn(name):
    import torch
    b = torch.backends.cudnn
    before = (b.enabled, b.deterministic, b.benchmark)
    b.enabled, b.deterministic, b.benchmark = CUDNN[name]
    try:
        yield
    finally:
        b.enabled, b.deterministic, b.benchmark = before


# how the grouped strided convolutions run (``--variants``)
VARIANTS = ("channels_last", "ncdhw", "native")


@contextlib.contextmanager
def strided_convs(model, variant):
    """Run ``model``'s grouped strided ``nn.Conv3d`` s as ``variant``: on
    a channels-last copy of their input (``channels_last``), on a
    contiguous NCDHW copy (``ncdhw``) or with cuDNN off for them alone
    (``native``)."""
    import torch
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv3d)
             and m.groups > 1 and max(m.stride) > 1]
    for m in convs:
        orig = type(m).forward.__get__(m)
        if variant == "channels_last":
            m.forward = lambda x, orig=orig: orig(
                x.contiguous(memory_format=torch.channels_last_3d))
        elif variant == "ncdhw":
            m.forward = lambda x, orig=orig: orig(x.contiguous())
        elif variant == "native":
            def native(x, orig=orig):
                with torch.backends.cudnn.flags(enabled=False):
                    return orig(x)
            m.forward = native
    try:
        yield [n for n, m in model.named_modules() if m in convs]
    finally:
        for m in convs:
            m.__dict__.pop("forward", None)


def make_input(kind, batch):
    """(batch, 96³, 2) fp32 on the CPU."""
    import numpy as np
    import torch
    if kind == "random":
        return torch.randn(batch, *SHAPE, 2,
                           generator=torch.Generator().manual_seed(19))
    sys.path.insert(0, ROOT)
    from chip_smoke import blob_volume
    rng = np.random.default_rng(44)
    vol, label = blob_volume(rng, CASE)
    ct = (rng.standard_normal(CASE).astype(np.float32) * 0.2
          + label.astype(np.float32) * 1.5)
    x = np.stack([ct, vol], axis=-1)
    pad = [((r - s) // 2, r - s - (r - s) // 2)
           for r, s in zip(SHAPE, CASE)] + [(0, 0)]
    x = np.pad(x, pad)[None]
    return torch.from_numpy(np.repeat(x, batch, axis=0))


def distance(y, ref):
    import torch
    d = (y.double().cpu() - ref).abs().flatten()
    q = torch.quantile(d[torch.randperm(
        d.numel(), generator=torch.Generator().manual_seed(0))[:1 << 24]],
        torch.tensor([0.5, 0.9999], dtype=d.dtype))
    flips = int((y.cpu().argmax(-1) != ref.argmax(-1)).sum())
    return dict(max=float(d.max()), p9999=float(q[1]), p50=float(q[0]),
                flips=flips)


def tensors(v):
    import torch
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in tensors(x)]
    return []


def capture(model, x):
    """Run ``model`` on ``x``; per named module, its (args, outputs), on
    the CPU."""
    import torch
    seen, hooks = {}, []
    for name, m in model.named_modules():
        if not name:
            continue

        def hook(mod, args, out, name=name):
            if name not in seen:
                seen[name] = ([a.detach().cpu() if isinstance(a, torch.Tensor)
                               else a for a in args],
                              [t.detach().cpu() for t in tensors(out)])
        hooks.append(m.register_forward_hook(hook))
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def local_errors(model, seen, dev):
    """Per module of ``seen``: max |f32(args) − out64| / max |out64|."""
    import torch
    mods = dict(model.named_modules())
    errs = {}
    for name, (args, outs) in seen.items():
        a = [t.to(dev, torch.float32) if isinstance(t, torch.Tensor) else t
             for t in args]
        got = tensors(mods[name](*a))
        err = 0.0
        for g, o in zip(got, outs):
            scale = float(o.abs().max()) or 1.0
            err = max(err, float((g.double().cpu() - o).abs().max()) / scale)
        errs[name] = err
        del a, got
    return errs


def variants(card32, cpu32, card64, x, ref, dev, card, args):
    """The forward's distance, the grouped strided convolutions' local
    errors and the bf16 batch-16 forward's ms, per :data:`VARIANTS`."""
    import torch
    from chip_measure import cuda_ms
    out = {}
    seen = capture(card64, x.double().to(dev))
    xb = make_input(args.input, 16).to(dev, torch.bfloat16)
    card16 = copy.deepcopy(card32).to(torch.bfloat16)
    for v in VARIANTS:
        with strided_convs(card32, v) as names, \
                strided_convs(card16, v):
            d = distance(card32(x.to(dev)), ref)
            local = local_errors(card32, {n: seen[n] for n in names}, dev)
            ms = cuda_ms(lambda: card16(xb), 3)
        out[v] = dict(forward=d, local=local, bf16_b16_ms=ms)
        print(f"{card} | {args.model} {args.input} B={args.batch} | grouped "
              f"strided convs {v}: fp32 forward vs CPU float64 max "
              f"{d['max']:.4e}, p99.99 {d['p9999']:.4e}, p50 "
              f"{d['p50']:.4e}, flips {d['flips']} | their local errors "
              + ", ".join(f"{n} {e:.3e}" for n, e in local.items())
              + f" | bf16 B=16 forward {ms:.3f} ms", flush=True)
    del card16, xb
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="HCMA-UNet")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--input", choices=("case", "random"), default="case")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "runs"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp32_drift: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.models.registry import load_model

    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} cudnn {torch.backends.cudnn.version()}",
          flush=True)
    cfg = load_json_config(os.path.join(
        ROOT, "config", "models_config_autopetii.json"))
    cpu32 = load_model(args.model, cfg, device="cpu", seed=args.seed,
                       input_size=SHAPE)
    cpu64 = copy.deepcopy(cpu32).double()
    dev = torch.device("cuda")
    card32 = copy.deepcopy(cpu32).to(dev)
    card64 = copy.deepcopy(cpu64).to(dev)
    x = make_input(args.input, args.batch)
    report = {"card": card, "model": args.model, "input": args.input,
              "batch": args.batch, "forwards": {}, "modules": {}}
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu64(x.double())
        print(f"CPU float64 forward {time.perf_counter() - t0:.1f} s, "
              f"scale {float(ref.abs().max()):.4e}", flush=True)
        runs = {"cpu fp32": lambda: cpu32(x),
                "card float64": lambda: card64(x.double().to(dev))}
        for name in CUDNN:
            def run(name=name):
                with cudnn(name):
                    card32(x.to(dev))       # warm-up (benchmark picks)
                    return card32(x.to(dev))
            runs[f"card fp32 cudnn {name}"] = run
        for what, fn in runs.items():
            d = distance(fn(), ref)
            report["forwards"][what] = d
            print(f"{card} | {args.model} {args.input} B={args.batch} | "
                  f"{what} vs CPU float64: max {d['max']:.4e}, p99.99 "
                  f"{d['p9999']:.4e}, p50 {d['p50']:.4e}, argmax flips "
                  f"{d['flips']}", flush=True)

        if args.variants:
            report["variants"] = variants(card32, cpu32, card64, x, ref,
                                          dev, card, args)

        seen = capture(card64, x.double().to(dev))
        errs = {"cpu": local_errors(cpu32, seen, "cpu")}
        with cudnn("heuristic"):
            errs["card"] = local_errors(card32, seen, dev)
        with cudnn("off"):
            errs["card_no_cudnn"] = local_errors(card32, seen, dev)
    rows = sorted(seen, key=lambda n: -errs["card"][n]
                  / max(errs["cpu"][n], 1e-12))
    for n in seen:
        report["modules"][n] = {k: v[n] for k, v in errs.items()}
    largest = sorted(seen, key=lambda n: -errs["card"][n])
    for title, names in (("card / CPU ratio", rows),
                         ("card error", largest)):
        print(f"{card} | local fp32 error per module, relative to its "
              f"float64 output's max, by {title}, largest first:",
              flush=True)
        for n in names[:args.top]:
            e = report["modules"][n]
            print(f"  {n:64s} cpu {e['cpu']:.3e} card {e['card']:.3e} "
                  f"card-no-cudnn {e['card_no_cudnn']:.3e} ratio "
                  f"{e['card'] / max(e['cpu'], 1e-12):.2f}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"fp32_drift_{args.model}_{args.input}"
                        ".json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
