#!/usr/bin/env python3
"""Time the serving paths' kernels for one checkout of the port: K1 (eval
window attention) and K6 (the WKV forward).

    python3 tools/bench_serving_kernels.py [--root DIR] [--tag NAME]
                                           [--out DIR] [--sweep]

``--root`` is the checkout whose ``veloxseg_torch`` is timed (default: this
one), so that an older commit unpacked beside it can be timed in the same
call on the same card (run old, new, new, old). Each kernel is reached
through the wrapper the model calls, which every checkout has:
``pwa_attention.window_attention`` and ``wkv.wkv``. Shapes: K1 at the
AutoPET-II serving forward's four levels (4 tiles of 96³: (B, h, N, Cqk,
Cv, L) = (4, 1, 585, 4, 4, 54), (4, 2, 9, 8, 8, 432), (4, 2, 9, 8, 16, 54),
(4, 4, 1, 16, 32, 54)), at Hecktor's L = 512 and at the 128³ flagship's
L = 1024 (both at B = 4, on no main path); K6 at U-RWKV's bottleneck
(4, 216, 128) with ``w = decay / T`` and ``u = first / T``. Seeded inputs,
fp32, TF32 off. Per shape: ms per call from CUDA events over 20
back-to-back calls after a warm-up (L2 warm), the device ms per call (the
sum of its kernels' times in ``torch.profiler`` over 10 calls), the
bound as ``chip_smoke.py`` counts it (``tools/chip_measure.py``), and for
K1 ``scaled_dot_product_attention`` with the bias as a float mask (the
windows as a batch of (B·N, h) heads; the backend that ran is recorded)
timed the same way. Prints the card and one JSON line per shape; writes
``<out>/bench_serving_<tag>.json`` (default ``runs``). Needs CUDA.

``--sweep`` (a checkout whose wrappers take ``launch=``) times instead
every geometry each kernel takes at these shapes, each with its largest
error against the plain version: K1 under every (slabs, windows, chunks)
of ``train_fwd_candidates``, with the bias staged and, for one-tile
windows (L <= 64), read through L1; K6 under every (channels, chunks) with
channels in {4, 8, 16, 32}, chunks in {1, 2, 4, 8, 16, 32, 64} and at most
1024 threads a block. It writes ``<out>/sweep_serving_<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from chip_measure import (bound, card, cuda_ms, device_ms,
                          eval_attention_work, sdpa_backend, wkv_work)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, B, h, N, Cqk, Cv, L)
K1_SHAPES = (("autopet_L0", 4, 1, 585, 4, 4, 54),
             ("autopet_L1", 4, 2, 9, 8, 8, 432),
             ("autopet_L2", 4, 2, 9, 8, 16, 54),
             ("autopet_L3", 4, 4, 1, 16, 32, 54),
             ("hecktor_L1", 4, 2, 9, 8, 8, 512),
             ("flagship_L1", 4, 2, 9, 8, 8, 1024))
K6_SHAPE = (4, 216, 128)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=os.path.join(HERE, "runs"))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("bench_serving_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from veloxseg_torch.models.zoo.urwkv import _fancy_init
    from veloxseg_torch.ops import _cuda, pwa_attention, wkv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(f"card: {name} | root {os.path.abspath(args.root)}", flush=True)
    _cuda.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def k1_inputs(b, h, n, cq, cv, L):
        return (randn(b, h, n, cq, L), randn(b, h, n, cq, L),
                randn(b, h, n, cv, L), randn(h, L, L, scale=0.5))

    b6, t6, c6 = K6_SHAPE
    decay, first, *_ = _fancy_init(c6)
    k6_inputs = (torch.from_numpy(decay / t6).to(dev),
                 torch.from_numpy(first / t6).to(dev),
                 randn(b6, t6, c6), randn(b6, t6, c6))
    if args.sweep:
        return sweep(args, name, dev, k1_inputs, k6_inputs)

    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    with torch.inference_mode():
        for shape_name, b, h, n, cq, cv, L in K1_SHAPES:
            q, k, v, bias = k1_inputs(b, h, n, cq, cv, L)
            scale = 1.0 / cq ** 0.5
            qt, kt, vt = (t.transpose(-1, -2) for t in (q, k, v))
            mask = bias[None, :, None]

            def k1():
                return pwa_attention.window_attention(q, k, v, bias, scale)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, mask,
                                                      scale=scale)
            row = dict(tag=args.tag, card=name, kernel="K1",
                       shape_name=shape_name, shape=[b, h, n, cq, cv, L],
                       bound_ms=bound(*eval_attention_work(b, h, n, cq, cv,
                                                           L))[0],
                       k1_ms=cuda_ms(k1), k1_device_ms=device_ms(k1),
                       sdpa_ms=cuda_ms(sdpa, 5),
                       sdpa_device_ms=device_ms(sdpa),
                       sdpa_backend=sdpa_backend(sdpa))
            emit(row)
            del q, k, v, bias, qt, kt, vt, mask
            torch.cuda.empty_cache()

        def k6():
            return wkv.wkv(*k6_inputs)
        emit(dict(tag=args.tag, card=name, kernel="K6",
                  shape_name="urwkv_bottleneck", shape=list(K6_SHAPE),
                  bound_ms=bound(*wkv_work(b6, t6, c6))[0],
                  k6_ms=cuda_ms(k6), k6_device_ms=device_ms(k6)))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_serving_{args.tag}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def sweep(args, name, dev, k1_inputs, k6_inputs):
    """Device ms and the largest error against the plain version of K1 and
    K6 under every geometry each takes at the bench's shapes."""
    import torch
    from veloxseg_torch.ops import _cuda, pwa_attention as pa, wkv
    sms = _cuda.sm_count(dev)
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    with torch.inference_mode():
        for shape_name, b, h, n, cq, cv, L in K1_SHAPES:
            q, k, v, bias = k1_inputs(b, h, n, cq, cv, L)
            scale = 1.0 / cq ** 0.5
            ref = pa.window_attention_plain(q, k, v, bias, scale)
            chosen = pa.eval_fwd_launch(b, h, n, L, cq, cv, sms)
            # every geometry of the train forward's grid, the bias staged
            # and, for one tile, through L1
            launches = [lw for ldg in sorted({False, L <= 64})
                        for _, lw in sorted(pa.train_fwd_candidates(
                            b, h, n, L, cq, cv, sms, ldg, False))]
            for lw in launches:
                def call(lw=lw):
                    return pa.window_attention(q, k, v, bias, scale,
                                               launch=lw)
                err = float((call() - ref).abs().max())
                emit(dict(tag=args.tag, card=name, kernel="K1",
                          shape_name=shape_name, shape=[b, h, n, cq, cv, L],
                          launch=list(lw), chosen=lw == chosen,
                          max_abs_err=err, device_ms=device_ms(call)))
            del q, k, v, bias, ref
            torch.cuda.empty_cache()

        b6, t6, c6 = K6_SHAPE
        ref = wkv.wkv_plain(*k6_inputs)
        chosen = wkv.wkv_launch(t6)
        for channels in (4, 8, 16, 32):
            for chunks in (1, 2, 4, 8, 16, 32, 64):
                lw = wkv.WkvLaunch(channels, chunks)
                if channels * chunks > 1024:
                    continue

                def call(lw=lw):
                    return wkv.wkv(*k6_inputs, launch=lw)
                err = float((call() - ref).abs().max())
                emit(dict(tag=args.tag, card=name, kernel="K6",
                          shape=list(K6_SHAPE), launch=list(lw),
                          chosen=lw == chosen, max_abs_err=err,
                          device_ms=device_ms(call)))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"sweep_serving_{args.tag}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
