#!/usr/bin/env python3
"""Time K5b (JLC stage-2 backward), K3b (long-window train-attention
backward) and K3f at the training paths' shapes, for one checkout of the
port.

    python3 tools/bench_train_bwd.py [--root DIR] [--tag NAME] [--out DIR]

``--root`` is the checkout whose ``veloxseg_torch`` is timed (default: this
one), so that an older commit unpacked beside it can be timed in the same
call on the same card (run old, new, new, old). Each kernel is reached as
the train step reaches it, through the autograd entry points that every
checkout of the port has: K5b as the backward of ``jlc_stage2`` (with what
that checkout's forward saved for it), K3b as the backward of
``window_attention_train`` and K3f as its forward. Shapes: K5b at the four
JLC levels of the AutoPET-II 96³ train step (B = 2) and of the 128³
flagship step (B = 16); K3f and K3b at the flagship's level 1 (h 2, 9
windows, Cqk = Cv = 8, L = 1024) at B = 16 and B = 2, attention dropout
0.1. Seeded inputs, fp32, TF32 off. Per shape and function: ms per call
from CUDA events over 20 back-to-back calls after a warm-up (L2 warm), the
device ms per call (the sum of its kernels' times in ``torch.profiler``
over 10 calls), and this checkout's bound as ``chip_smoke.py`` counts it
(``tools/chip_measure.py``). Prints the card and one JSON line per shape;
writes ``<out>/bench_train_bwd_<tag>.json`` (default ``runs``). Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from chip_measure import (bound, card, cuda_ms, device_ms, stage2_bwd_work,
                          train_attention_work)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=os.path.join(HERE, "runs"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_train_bwd: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from veloxseg_torch.ops import _cuda, fused_jlc, pwa_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(f"card: {name} | root {os.path.abspath(args.root)}", flush=True)
    _cuda.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, grad=False):
        t = (torch.randn(*shape, generator=gen) * scale).to(dev)
        return t.requires_grad_(grad)

    def ms(row, key, fn):
        row[key + "_ms"] = cuda_ms(fn)
        row[key + "_device_ms"] = device_ms(fn)

    def backward(y, leaves, g):
        return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)

    rows = []
    # K5b: (path, B, spatial of level 0); C = 16·2^i, E·C = (3, 3, 2, 2)·C
    for path, b, s0 in (("train_96", 2, 24), ("train_flagship", 16, 32)):
        for i, e in enumerate((3, 3, 2, 2)):
            c, s = 16 * 2 ** i, s0 // 2 ** i
            x, g = randn(b, c, s, s, s, grad=True), randn(b, c, s, s, s)
            w1 = randn(e * c, c, 1, 1, 1, scale=(2.0 / c) ** 0.5, grad=True)
            b1 = randn(e * c, scale=0.1, grad=True)
            w2 = randn(c, e * c, 1, 1, 1, scale=(2.0 / (e * c)) ** 0.5,
                       grad=True)
            b2 = randn(c, scale=0.1, grad=True)
            y = fused_jlc.jlc_stage2(x, w1, b1, w2, b2)
            row = dict(tag=args.tag, card=name, kernel="K5b", path=path,
                       level=i, shape=[b, c, s, s, s], hid=e * c,
                       bound_ms=bound(*stage2_bwd_work(b, c, e, s ** 3))[0])
            ms(row, "k5b", backward(y, (x, w1, b1, w2, b2), g))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del x, g, y
            torch.cuda.empty_cache()

    # K3f, K3b: the flagship's level 1
    p, h, n, cq, L = 0.1, 2, 9, 8, 1024
    seed = torch.tensor([1234, 0], dtype=torch.int32, device=dev)
    for b in (16, 2):
        q, k, v = (randn(b, h, n, cq, L, grad=True) for _ in range(3))
        bias = randn(h, L, L, scale=0.5, grad=True)
        do = randn(b, h, n, cq, L)
        scale = 1.0 / cq ** 0.5
        work_f, work_b = train_attention_work(b, h, n, cq, cq, L, True)
        row = dict(tag=args.tag, card=name, kernel="K3", path="train_flagship",
                   level=1, shape=[b, h, n, cq, L], p=p,
                   k3f_bound_ms=bound(*work_f)[0],
                   k3b_bound_ms=bound(*work_b)[0])
        with torch.no_grad():
            ms(row, "k3f", lambda: pwa_attention.window_attention_train(
                q, k, v, bias, seed, scale, p))
        y = pwa_attention.window_attention_train(q, k, v, bias, seed, scale,
                                                 p)
        ms(row, "k3b", backward(y, (q, k, v, bias), do))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, bias, y
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_train_bwd_{args.tag}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
