#!/usr/bin/env python3
"""Time the training paths' redesigned kernels for one checkout of the
port: K2b and K2f (train attention, L <= 512), K5f (JLC stage-2 forward),
K5b (its backward), K3b and K3f (long-window train attention).

    python3 tools/bench_train_bwd.py [--root DIR] [--tag NAME] [--out DIR]
                                     [--sweep | --bf16]

``--root`` is the checkout whose ``veloxseg_torch`` is timed (default: this
one), so that an older commit unpacked beside it can be timed in the same
call on the same card (run old, new, new, old). Each kernel is reached as
the train step reaches it, through the autograd entry points that every
checkout of the port has: K2f and K3f as the forward of
``window_attention_train`` (no grad), K2b and K3b as its backward (with
what that checkout's forward saved for it), K5f as ``jlc_stage2`` (no grad)
and K5b as its backward. Shapes: K2 at AutoPET-II 96³'s four levels (B = 2,
L 54 and 432), the 128³ flagship's levels 0, 2, 3 (B = 16, L 128) and
Hecktor's L = 512 level (B = 2); K5f at the four JLC levels of the serving
forward (4 tiles of 96³) and of the flagship step (B = 16); K5b at the four
JLC levels of the 96³ train step (B = 2) and of the flagship step; K3f and
K3b at the flagship's level 1 (h 2, 9 windows, Cqk = Cv = 8, L = 1024) at
B = 16 and B = 2. Attention dropout 0.1; seeded inputs, fp32, TF32 off. Per
shape and function: ms per call from CUDA events over 20 back-to-back
calls after a warm-up (L2 warm), the device ms per call (the sum of its
kernels' times in ``torch.profiler`` over 10 calls), and the bound as
``chip_smoke.py`` counts it (``tools/chip_measure.py``). Beside K2f and K3f
the library yardstick is timed the same way: ``scaled_dot_product_attention``
forward on its ``efficient`` backend, the windows as a batch of (B·N, h)
heads, the bias a float mask, ``dropout_p`` 0.1 (the same work with its own
dropout mask; ``sdpa_fwd_ms`` and ``sdpa_fwd_device_ms``). Prints the card
and one JSON line per shape; writes ``<out>/bench_train_bwd_<tag>.json``
(default ``runs``). Needs CUDA.

``--sweep`` (a checkout whose ``pwa_attention`` has
``train_fwd_candidates``) times instead the train forward (K2f, K3f) at
each of its shapes under every launch geometry its model considers, each
with the model's cost, so that
the model can be checked against the card; it writes
``<out>/sweep_train_fwd_<tag>.json``.

``--bf16`` times instead the bf16 forms of K3f and K5f, each beside its
fp32 form on the same values: K3f at the flagship's level 1 (B = 16 and 2)
beside ``scaled_dot_product_attention`` in bf16 (its default backend, the
bias a bf16 float mask, ``dropout_p`` 0.1), and K5f at the speed CLI's four
JLC levels (B = 16, AutoPET-II 96³: 24³ to 3³) and at the bf16 B = 2 train
step's (``conv_drop`` 0), with a SHA-256 of the plane statistics it writes
(K5b takes them: two checkouts' must agree bit for bit). Where the checkout
has ``fused_jlc.stage2_mma_launch`` it also times K5f's bf16 form under
every hidden split the widths take (``sweep``: [hsplit, vt, device ms]).
Writes
``<out>/bench_bf16_<tag>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from chip_measure import (bound, card, cuda_ms, device_ms, stage2_bwd_work,
                          stage2_fwd_work, train_attention_work)

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=os.path.join(HERE, "runs"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
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
    warm_up(dev)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0, grad=False):
        t = (torch.randn(*shape, generator=gen) * scale).to(dev)
        return t.requires_grad_(grad)

    def ms(row, key, fn):
        row[key + "_ms"] = cuda_ms(fn)
        row[key + "_device_ms"] = device_ms(fn)

    def sdpa_fwd(row, q, k, v, bias, scale):
        from torch.nn.attention import SDPBackend, sdpa_kernel
        b, h, n, _, L = q.shape
        q4, k4, v4 = (t.detach().permute(0, 2, 1, 4, 3)
                      .reshape(b * n, h, L, -1).contiguous()
                      for t in (q, k, v))
        mask = bias.detach()[None]

        def call():
            return F.scaled_dot_product_attention(q4, k4, v4, mask,
                                                  dropout_p=p, scale=scale)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ms(row, "sdpa_fwd", call)

    def backward(y, leaves, g):
        return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)

    rows = []
    p, seed = 0.1, torch.tensor([1234, 0], dtype=torch.int32, device=dev)
    k2_shapes = (("train_96", 0, 2, 1, 585, 4, 4, 54),
                 ("train_96", 1, 2, 2, 9, 8, 8, 432),
                 ("train_96", 2, 2, 2, 9, 8, 16, 54),
                 ("train_96", 3, 2, 4, 1, 16, 32, 54),
                 ("train_flagship", 0, 16, 1, 585, 4, 4, 128),
                 ("train_flagship", 2, 16, 2, 9, 8, 16, 128),
                 ("train_flagship", 3, 16, 4, 1, 16, 32, 128),
                 ("hecktor", 1, 2, 2, 9, 8, 8, 512))
    if args.bf16:
        return bf16_forms(args, name, dev, randn, p, seed, ms)
    if args.sweep:
        return sweep(args, name, dev, randn, p, seed, k2_shapes + (
            ("train_flagship", 1, 16, 2, 9, 8, 8, 1024),
            ("train_flagship", 1, 2, 2, 9, 8, 8, 1024)))
    # K2f, K2b: (path, level, B, h, N, Cqk, Cv, L)
    for path, lvl, b, h, n, cq, cv, L in k2_shapes:
        q, k = (randn(b, h, n, cq, L, grad=True) for _ in range(2))
        v = randn(b, h, n, cv, L, grad=True)
        bias = randn(h, L, L, scale=0.5, grad=True)
        do = randn(b, h, n, cv, L)
        scale = 1.0 / cq ** 0.5
        work_f, work_b = train_attention_work(b, h, n, cq, cv, L)
        row = dict(tag=args.tag, card=name, kernel="K2", path=path,
                   level=lvl, shape=[b, h, n, cq, cv, L], p=p,
                   k2f_bound_ms=bound(*work_f)[0],
                   k2b_bound_ms=bound(*work_b)[0])
        with torch.no_grad():
            ms(row, "k2f", lambda: pwa_attention.window_attention_train(
                q, k, v, bias, seed, scale, p))
            sdpa_fwd(row, q, k, v, bias, scale)
        y = pwa_attention.window_attention_train(q, k, v, bias, seed, scale,
                                                 p)
        ms(row, "k2b", backward(y, (q, k, v, bias), do))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, do, bias, y
        torch.cuda.empty_cache()

    def stage2_inputs(b, c, e, s, grad):
        x = randn(b, c, s, s, s, grad=grad)
        w1 = randn(e * c, c, 1, 1, 1, scale=(2.0 / c) ** 0.5, grad=grad)
        b1 = randn(e * c, scale=0.1, grad=grad)
        w2 = randn(c, e * c, 1, 1, 1, scale=(2.0 / (e * c)) ** 0.5,
                   grad=grad)
        return x, w1, b1, w2, randn(c, scale=0.1, grad=grad)

    # K5f: (path, B, spatial of level 0); C = 16·2^i, E·C = (3, 3, 2, 2)·C
    for path, b, s0 in (("serving", 4, 24), ("train_flagship", 16, 32)):
        for i, e in enumerate((3, 3, 2, 2)):
            c, s = 16 * 2 ** i, s0 // 2 ** i
            ins = stage2_inputs(b, c, e, s, False)
            row = dict(tag=args.tag, card=name, kernel="K5f", path=path,
                       level=i, shape=[b, c, s, s, s], hid=e * c,
                       bound_ms=bound(*stage2_fwd_work(b, c, e, s ** 3))[0])
            with torch.no_grad():
                ms(row, "k5f", lambda: fused_jlc.jlc_stage2(*ins))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del ins
            torch.cuda.empty_cache()

    # K5b: (path, B, spatial of level 0); C = 16·2^i, E·C = (3, 3, 2, 2)·C
    for path, b, s0 in (("train_96", 2, 24), ("train_flagship", 16, 32)):
        for i, e in enumerate((3, 3, 2, 2)):
            c, s = 16 * 2 ** i, s0 // 2 ** i
            x, w1, b1, w2, b2 = stage2_inputs(b, c, e, s, True)
            g = randn(b, c, s, s, s)
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
    h, n, cq, L = 2, 9, 8, 1024
    for b in (16, 2):
        q, k, v = (randn(b, h, n, cq, L, grad=True) for _ in range(3))
        bias = randn(h, L, L, scale=0.5, grad=True)
        do = randn(b, h, n, cq, L)
        scale = 1.0 / cq ** 0.5
        work_f, work_b = train_attention_work(b, h, n, cq, cq, L)
        row = dict(tag=args.tag, card=name, kernel="K3", path="train_flagship",
                   level=1, shape=[b, h, n, cq, L], p=p,
                   k3f_bound_ms=bound(*work_f)[0],
                   k3b_bound_ms=bound(*work_b)[0])
        with torch.no_grad():
            ms(row, "k3f", lambda: pwa_attention.window_attention_train(
                q, k, v, bias, seed, scale, p))
            sdpa_fwd(row, q, k, v, bias, scale)
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


def warm_up(dev, seconds=2.0):
    """Matrix products for ``seconds``, so that the first kernel timed runs
    at the card's working clocks and not at its idle ones (a kernel timed
    first on an idle card measured 1.7× its warm time)."""
    import time

    import torch
    a = torch.randn(4096, 4096, device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = (a @ a) * (1.0 / 64.0)
        torch.cuda.synchronize()


def bf16_forms(args, name, dev, randn, p, seed, ms):
    """K3f's and K5f's bf16 forms beside their fp32 forms on the same
    values (and K3f beside SDPA in bf16), by events and device ms."""
    import hashlib

    import torch
    import torch.nn.functional as F
    from veloxseg_torch.ops import _cuda, fused_jlc, pwa_attention as pa
    from chip_measure import (stage2_fwd_work_bf16,
                              train_attention_work_bf16)
    bf = torch.bfloat16
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)
    h, n, cq, L = 2, 9, 8, 1024
    for b in (16, 2):
        q, k, v = (randn(b, h, n, cq, L).to(bf) for _ in range(3))
        bias = randn(h, L, L, scale=0.5)
        scale = 1.0 / cq ** 0.5
        work = train_attention_work_bf16(b, h, n, cq, cq, L)[0]
        row = dict(tag=args.tag, card=name, kernel="K3f", path=(
            "train_flagship_bf16"), level=1, shape=[b, h, n, cq, L], p=p,
                   bound_ms=bound(*work)[0])
        q32, k32, v32 = q.float(), k.float(), v.float()
        q4, k4, v4 = (t.permute(0, 2, 1, 4, 3).reshape(b * n, h, L, -1)
                      .contiguous() for t in (q, k, v))
        mask = bias.to(bf)[None]
        with torch.no_grad():
            ms(row, "bf16", lambda: pa.window_attention_train_fwd_long(
                q, k, v, bias, seed, scale, p))
            ms(row, "fp32", lambda: pa.window_attention_train_fwd_long(
                q32, k32, v32, bias, seed, scale, p))
            ms(row, "sdpa_bf16", lambda: F.scaled_dot_product_attention(
                q4, k4, v4, mask, dropout_p=p, scale=scale))
        emit(row)
        del q, k, v, q32, k32, v32, q4, k4, v4, mask, bias
        torch.cuda.empty_cache()
    sms = _cuda.sm_count(dev)
    sweepable = hasattr(fused_jlc, "stage2_mma_launch")
    for path, b, s0 in (("speed_autopet", 16, 24), ("train_96_bf16", 2, 24)):
        for i, e in enumerate((3, 3, 2, 2)):
            c, s = 16 * 2 ** i, s0 // 2 ** i
            x = randn(b, c, s, s, s, scale=1.5).to(bf)
            w1 = randn(e * c, c, 1, 1, 1, scale=(2.0 / c) ** 0.5).to(bf)
            b1 = randn(e * c, scale=0.1).to(bf)
            w2 = randn(c, e * c, 1, 1, 1, scale=(2.0 / (e * c)) ** 0.5).to(bf)
            b2 = randn(c, scale=0.1).to(bf)
            ins = (x, w1, b1, w2, b2)
            f32 = [t.float() for t in ins]
            work = stage2_fwd_work_bf16(b, c, e, s ** 3)
            row = dict(tag=args.tag, card=name, kernel="K5f", path=path,
                       level=i, shape=[b, c, s, s, s], hid=e * c,
                       bound_ms=bound(work[0], work[1], work[2])[0])
            with torch.no_grad():
                _, mean, rstd = fused_jlc._jlc_stage2_fwd(*ins)
                torch.cuda.synchronize()
                row["stats_sha256"] = hashlib.sha256(
                    mean.cpu().numpy().tobytes()
                    + rstd.cpu().numpy().tobytes()).hexdigest()[:16]
                ms(row, "bf16", lambda: fused_jlc.jlc_stage2(*ins))
                ms(row, "fp32", lambda: fused_jlc.jlc_stage2(*f32))
                if sweepable:
                    chosen = fused_jlc.stage2_mma_launch(b, c, e * c, s ** 3,
                                                         sms)
                    row["chosen"] = [chosen.hsplit, chosen.vt]
                    row["sweep"] = []
                    for hs in (1, 2, 4):
                        if (e * c) % (16 * hs):
                            continue
                        try:
                            lw = fused_jlc.stage2_mma_launch(
                                b, c, e * c, s ** 3, sms, hs)
                        except ValueError:  # its shared memory does not fit
                            continue
                        row["sweep"].append([hs, lw.vt, device_ms(
                            lambda lw=lw: fused_jlc._jlc_stage2_fwd_mma(
                                *ins, launch=lw))])
            emit(row)
            del x, ins, f32
            torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"bench_bf16_{args.tag}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def sweep(args, name, dev, randn, p, seed, shapes):
    """Device ms of the train forward at each shape under each launch
    geometry of ``train_fwd_candidates``, beside the model's cost."""
    import torch
    from veloxseg_torch.ops import _cuda, pwa_attention as pa
    sms = _cuda.sm_count(dev)
    rows = []
    for path, lvl, b, h, n, cq, cv, L in shapes:
        q, k = randn(b, h, n, cq, L), randn(b, h, n, cq, L)
        v, bias = randn(b, h, n, cv, L), randn(h, L, L, scale=0.5)
        long = pa.uses_long_kernel(L)
        fwd = pa.window_attention_train_fwd_long if long \
            else pa.window_attention_train_fwd
        name_c = "vs_pwa_attention_long_train" if long \
            else "vs_pwa_attention_train"
        widths = pa.LONG_KERNEL_WIDTHS if long else pa.KERNEL_WIDTHS
        chosen = pa.train_fwd_launch(b, h, n, L, cq, cv, sms)
        for cost, lw in sorted(pa.train_fwd_candidates(b, h, n, L, cq, cv,
                                                       sms)):
            def call(lw=lw):
                pa._train_fwd_kernel(fwd, name_c, widths, q, k, v, bias,
                                     seed, 1.0 / cq ** 0.5, p, launch=lw)
            row = dict(tag=args.tag, card=name, path=path, level=lvl,
                       shape=[b, h, n, cq, cv, L], launch=list(lw),
                       chosen=lw == chosen, model_us=cost / 1755.0,
                       device_ms=device_ms(call))
            print(json.dumps(row), flush=True)
            rows.append(row)
        del q, k, v, bias
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"sweep_train_fwd_{args.tag}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
