#!/usr/bin/env python3
"""Time JLC stage 1 (K4f, K4b and, where the tree has it, K4b's weight
gradient alone) at every main path's shapes, for one checkout of the port.

    python3 tools/bench_jlc_stage1.py [--root DIR] [--tag NAME] [--out DIR]

``--root`` is the checkout whose ``veloxseg_torch`` is timed (default: this
one), so that an older commit unpacked beside it can be timed in the same
call on the same card (run old, new, new, old). Shapes: the four JLC levels
of the AutoPET-II 96³ forward (4 tiles, K4f), of its train step (B = 2) and
of the 128³ flagship step (B = 16), with seeded inputs, fp32, TF32 off.
Per shape and function: ms per call from CUDA events over 20 back-to-back
calls after a warm-up (L2 warm; where the kernels take less time than the
host needs to issue a call, this is the host's rate), and the device ms
per call, the sum of its kernels' times in ``torch.profiler`` over 10
calls; cuDNN's weight-only ``convolution_backward`` of the three branches
on the same inputs is the weight gradient's library yardstick.
Prints the card and one JSON line per shape; writes
``<out>/bench_jlc_stage1_<tag>.json`` (default ``runs``). Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from chip_measure import card as card_line
from chip_measure import cuda_ms, device_ms

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=os.path.join(HERE, "runs"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_jlc_stage1: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from veloxseg_torch.ops import _cuda, fused_jlc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card} | root {os.path.abspath(args.root)}", flush=True)
    _cuda.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def ms(row, key, fn, iters=20):
        row[key + "_ms"] = cuda_ms(fn, iters)
        row[key + "_device_ms"] = device_ms(fn)

    # (path, B, spatial of level 0): C = 16·2^i, groups = C / (4, 8, 8, 16)
    paths = [("serving", 4, 24), ("train_96", 2, 24),
             ("train_flagship", 16, 32)]
    rows = []
    for path, b, s0 in paths:
        for i, cg in enumerate((4, 8, 8, 16)):
            c, s = 16 * 2 ** i, s0 // 2 ** i
            groups = c // cg
            x = randn(b, c, s, s, s)
            g = randn(b, c, s, s, s)
            ws = [randn(c, cg, k, k, k, scale=(2.0 / (cg * k ** 3)) ** 0.5)
                  for k in (1, 3, 5)]
            bs = [randn(c, scale=0.1) for _ in ws]
            row = dict(tag=args.tag, card=card, path=path,
                       shape=[b, c, s, s, s], groups=groups)
            with torch.inference_mode():
                ms(row, "k4f", lambda: fused_jlc.jlc_stage1(x, ws, bs,
                                                            groups))
            if path != "serving":
                out = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
                dy = out[0] if isinstance(out, tuple) else out
                ms(row, "k4b", lambda: fused_jlc.jlc_stage1_bwd(
                    x, ws, g, groups))
                row["k4b_has_wgrad"] = isinstance(out, tuple)
                if hasattr(fused_jlc, "jlc_branch_wgrad"):
                    ms(row, "wgrad", lambda: fused_jlc.jlc_branch_wgrad(
                        x, dy, ws, groups))

                def cudnn_wgrad():
                    for w, dyj in zip(ws, dy):
                        torch.ops.aten.convolution_backward(
                            dyj, x, w, None, [1, 1, 1],
                            [w.shape[-1] // 2] * 3, [1, 1, 1], False,
                            [0, 0, 0], groups, [False, True, False])
                ms(row, "cudnn_wgrad", cudnn_wgrad, 5)
                del out, dy
            print(json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_jlc_stage1_{args.tag}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
