#!/usr/bin/env python3
"""Run the PyTorch port (``veloxseg_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero; nothing is caught and waved through):

1. require CUDA; print the card's name and power limit; TF32 off.
2. build the CUDA kernels from ``veloxseg_torch/csrc`` (one nvcc each, in
   parallel) and print the build seconds.
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the AutoPET-II main paths give it. Serving (a 4-tile batch of
   96³ tiles): K1 at the four PWA levels and at Hecktor's L = 512, K4f and
   K5f at the four JLC levels. Training (B = 2): K2f and K2b at the four
   PWA levels with attention dropout 0.1 (both sides draw the same
   counter-hash mask), K4b and K5b at the four JLC levels; K2b's dbias and
   K5b's dW1/dW2 must repeat bit for bit, and their checksums are printed
   so that two runs can be compared. Print errors and times: kernel, plain
   version, the least time the card could take (bound), and for K1 one
   library call (``scaled_dot_product_attention`` with the bias as a float
   mask) as a yardstick the port never calls; no one PyTorch call computes
   the function of K2f, K2b, K4b or K5b.
4. build the AutoPET-II model (``config/models_config_autopetii.json``) at
   full width with seeded weights on the card; run the eval forward on a
   seeded (1, 96, 96, 96, 2) tile and hold it against the same model and
   weights on the CPU (``device="cpu"``: every kernel's plain version).
5. sliding-window inference on a seeded (1, 192, 192, 192, 2) volume:
   ROI 96³, overlap 0.25, ``sw_batch_size`` 4, constant blending. The
   kernel launch counts are zeroed just before and read just after: every
   kernel must have run. The voxels only the first tile covers must equal
   that tile's own forward.
6. training at full AutoPET-II width, as published (``conv_drop`` 0.1,
   attention and projection dropout 0.1), B = 2
   (``config/train_config_bs4.json``: AdamW lr 2.5e-4, weight decay 0.01),
   on one seeded synthetic batch whose labels threshold the PET channel: a
   warm-up step, then 10 timed steps (ms per step, steps/s). The loss must
   be finite and fall; the launches per step must be K2f 4, K2b 4, K4f 13,
   K4b 13, K5f 0, K5b 0, K1 0.
7. two steps with ``conv_drop`` 0, where stage 2 runs through its kernels:
   K5f 13 and K5b 13 per step.
8. one step at full width, B = 1, every dropout 0, on the card and on the
   CPU from the same weights: the loss and every parameter's gradient
   must agree (tolerance printed).
9. print one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Details go to ``<out>/chip_smoke.json`` (``--out``, default ``runs``).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores


def cuda_ms(fn, iters=20):
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls (after
    one warm-up), timed with CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_flop):
    """(bound_ms, bound_by): the larger of bytes/HBM rate and
    FLOP/fp32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_flop / FP32_FLOP_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def taps_in_bounds(s, k):
    """Taps of a size-``k`` centred filter that fall inside an axis of
    length ``s`` (zero padding), summed over the ``s`` output positions."""
    r = k // 2
    return sum(min(p + r, s - 1) - max(p - r, 0) + 1 for p in range(s))


def max_err(got, ref):
    d = (got - ref).abs()
    return float(d.max()), float((d / ref.abs().clamp_min(1e-3)).max())


def checksum(t):
    """Short hash of a tensor's bytes: equal across runs iff bit-identical."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def require_close(name, got, ref, atol, rtol):
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} values differ beyond atol {atol} "
            f"rtol {rtol}; max abs err {max_err(got, ref)[0]:.3e}")


def main() -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "runs"),
                    help="directory for chip_smoke.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.core.windows import compute_window_layout
    from veloxseg_torch.infer.sliding_window import sliding_window_inference
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    from veloxseg_torch.ops import _cuda, fused_jlc, pwa_attention
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.optim import build_optimizer
    from veloxseg_torch.train.train_state import (create_train_state,
                                                  train_step_fn)

    # -- phase 1 ------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # -- phase 2 ------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.build_all()
    for name in _cuda.SOURCES:
        _cuda.lib(name)
    print(f"[2] built {len(_cuda.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    report = {"card": card, "shapes": []}
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    cfg_dict = load_json_config(os.path.join(
        ROOT, "config", "models_config_autopetii.json"))["VeloxSeg"]
    hk_dict = load_json_config(os.path.join(
        ROOT, "config", "models_config_hecktor2022.json"))["VeloxSeg"]
    train_cfg = load_json_config(os.path.join(
        ROOT, "config", "train_config_bs4.json"))
    tiles = 4                                    # sw_batch_size
    batch = train_cfg["batch_size"]              # 2

    # -- phase 3: K1 ----------------------------------------------------------
    def k1_shapes(cfg, levels, tiles=tiles):
        size = [s // cfg["patch_size"] for s in cfg["input_size"]]
        heads = cfg.get("num_heads", [1, 2, 2, 4])
        out = []
        for i in range(4):
            lay = compute_window_layout(
                size, cfg["min_big_window_sizes"][i],
                cfg["min_small_window_sizes"][i], 2, heads[i],
                cfg["min_dim_head"][i], cfg["attn_base_ch"] * 2 ** i)
            L = len(cfg["in_ch"]) * lay.tokens_per_window
            if i in levels:
                out.append((f"L{i}", tiles, heads[i], lay.num_windows,
                            lay.dim_qk, lay.dim_v, L))
            size = [s // 2 for s in size]
        return out

    kernels = {}

    def record(kname, shape_name, weight, n_bytes, n_flop, err, ms,
               plain_ms, library_ms):
        """``weight``: calls per 4-tile forward (serving kernels) or per
        train step (training kernels) at this shape."""
        b_ms, b_by = bound(n_bytes, n_flop)
        row = dict(kernel=kname, shape=shape_name, calls_per_unit=weight,
                   bytes=n_bytes, flop=n_flop, max_abs_err=err[0],
                   max_rel_err=err[1], ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
        report["shapes"].append(row)
        print(f"[3] {kname} {shape_name}: max abs err {err[0]:.3e} rel "
              f"{err[1]:.3e} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})"
              + (f" library {library_ms:.4f} ms" if library_ms is not None
                 else " library none"), flush=True)
        k = kernels.setdefault(kname, dict(err=0.0, calls=0, ms=0.0,
                                           plain=0.0, tb=0.0, to=0.0,
                                           bound=0.0, lib=None))
        k["err"] = max(k["err"], err[0])
        if weight:
            k["calls"] += weight
            k["ms"] += weight * ms
            k["plain"] += weight * plain_ms
            k["bound"] += weight * b_ms
            k["tb"] += weight * n_bytes / HBM_BYTES_PER_S * 1e3
            k["to"] += weight * n_flop / FP32_FLOP_PER_S * 1e3
            if library_ms is not None:
                k["lib"] = (k["lib"] or 0.0) + weight * library_ms

    k1_cases = ([("autopet_" + n, *s, 1) for n, *s in
                 k1_shapes(cfg_dict, range(4))]
                + [("hecktor_" + n, *s, 0) for n, *s in
                   k1_shapes(hk_dict, [1])])
    with torch.inference_mode():
        for name, b, h, n, cqk, cv, L, weight in k1_cases:
            q, k = randn(b, h, n, cqk, L), randn(b, h, n, cqk, L)
            v, bias = randn(b, h, n, cv, L), randn(h, L, L, scale=0.5)
            scale = 1.0 / cqk ** 0.5
            got = pwa_attention.window_attention(q, k, v, bias, scale)
            ref = pwa_attention.window_attention_plain(q, k, v, bias, scale)
            torch.cuda.synchronize()
            require_close(f"K1 {name}", got, ref, atol=1e-4, rtol=1e-4)
            qt, kt, vt = (t.transpose(-1, -2) for t in (q, k, v))
            mask = bias[None, :, None]
            lib_out = F.scaled_dot_product_attention(qt, kt, vt, mask,
                                                     scale=scale)
            require_close(f"K1 {name} library", lib_out.transpose(-1, -2),
                          ref, atol=1e-3, rtol=1e-3)
            n_bytes = 4 * (q.numel() + k.numel() + 2 * v.numel()
                           + bias.numel())
            # QKᵀ and PV products, plus scale, bias, max, exp, sum and the
            # final divide per score / output
            n_flop = (2 * b * h * n * L * L * (cqk + cv)
                      + 5 * b * h * n * L * L + b * h * n * L * cv)
            record("pwa_attention", name, weight, n_bytes, n_flop,
                   max_err(got, ref),
                   cuda_ms(lambda: pwa_attention.window_attention(
                       q, k, v, bias, scale)),
                   cuda_ms(lambda: pwa_attention.window_attention_plain(
                       q, k, v, bias, scale), 5),
                   cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, mask, scale=scale), 5))

        # -- phase 3: K4f, K5f ------------------------------------------------
        base, spatial0 = cfg_dict["base_ch"], 96 // cfg_dict["patch_size"]
        for i in range(4):
            c = base * 2 ** i
            s = spatial0 // 2 ** i
            groups = c // cfg_dict["min_dim_group"][i]
            e = cfg_dict["conv_expansion_factor"][i]
            cg = c // groups
            weight = 2 if i < 3 else 1       # encoder and decoder levels
            x = randn(tiles, c, s, s, s)
            ws = [randn(c, cg, k, k, k, scale=(2.0 / (cg * k ** 3)) ** 0.5)
                  for k in (1, 3, 5)]
            bs = [randn(c, scale=0.1) for _ in ws]
            w1 = randn(e * c, c, 1, 1, 1, scale=(2.0 / c) ** 0.5)
            b1 = randn(e * c, scale=0.1)
            w2 = randn(c, e * c, 1, 1, 1, scale=(2.0 / (e * c)) ** 0.5)
            b2 = randn(c, scale=0.1)
            vox = tiles * c * s ** 3
            out1 = fused_jlc.jlc_stage1(x, ws, bs, groups)
            ref1 = fused_jlc.jlc_stage1_plain(x, ws, bs, groups)
            torch.cuda.synchronize()
            require_close(f"K4f L{i}", out1, ref1, atol=1e-4, rtol=1e-4)
            n_bytes = 4 * (2 * vox + sum(w.numel() for w in ws))
            # grouped conv MACs over the taps inside the volume (those in
            # the zero padding need no work), then per branch value: stats
            # (2), normalize (2), GELU (4), branch sum (1); residual add (1)
            n_flop = (2 * tiles * c * cg * sum(taps_in_bounds(s, k) ** 3
                                               for k in (1, 3, 5))
                      + 9 * 3 * vox + vox)
            record("jlc_stage1", f"L{i}", weight, n_bytes, n_flop,
                   max_err(out1, ref1),
                   cuda_ms(lambda: fused_jlc.jlc_stage1(x, ws, bs, groups)),
                   cuda_ms(lambda: fused_jlc.jlc_stage1_plain(
                       x, ws, bs, groups), 5), None)

            out = fused_jlc.jlc_stage2(out1, w1, b1, w2, b2)
            ref = fused_jlc.jlc_stage2_plain(out1, w1, b1, w2, b2)
            torch.cuda.synchronize()
            require_close(f"K5f L{i}", out, ref, atol=1e-4, rtol=1e-4)
            n_bytes = 4 * (2 * vox + w1.numel() + b1.numel() + w2.numel()
                           + b2.numel())
            # the two channel products, then stats (2) and normalize (2)
            # per input, bias + GELU (5) per hidden, bias + residual (2)
            n_flop = (4 * vox * e * c + 4 * vox + 5 * vox * e + 2 * vox)
            record("jlc_stage2", f"L{i}", weight, n_bytes, n_flop,
                   max_err(out, ref),
                   cuda_ms(lambda: fused_jlc.jlc_stage2(out1, w1, b1, w2,
                                                        b2)),
                   cuda_ms(lambda: fused_jlc.jlc_stage2_plain(
                       out1, w1, b1, w2, b2), 5), None)

    # -- phase 3: K2f, K2b (train attention, B = 2, dropout 0.1) -----------
    p_drop = 0.1                 # attn_drop: VeloxSegConfig's default
    seed = torch.tensor([1234, 0], dtype=torch.int32, device=dev)
    sums = {}
    for name, b, h, n, cqk, cv, L in k1_shapes(cfg_dict, range(4), batch):
        q, k = randn(b, h, n, cqk, L), randn(b, h, n, cqk, L)
        v, bias = randn(b, h, n, cv, L), randn(h, L, L, scale=0.5)
        do = randn(b, h, n, cv, L)
        scale = 1.0 / cqk ** 0.5
        qkvb = (q, k, v, bias, seed)
        got = pwa_attention.window_attention_train_fwd(*qkvb, scale, p_drop)
        ref = pwa_attention.window_attention_train_fwd_plain(*qkvb, scale,
                                                             p_drop)
        torch.cuda.synchronize()
        require_close(f"K2f {name}", got, ref, atol=1e-4, rtol=1e-4)
        scores = b * h * n * L * L
        n_bytes = 4 * (q.numel() + k.numel() + 2 * v.numel()
                       + bias.numel()) + 8
        # QKᵀ and PV, softmax as K1 (5 per score), and the mask: the
        # hash's 14 integer operations and the select, per score, counted
        # at the fp32 rate (the card's int32 rate is not higher)
        n_flop = (2 * scores * (cqk + cv) + 5 * scores + b * h * n * L * cv
                  + 16 * scores)
        record("pwa_attention_train_fwd", name, 1, n_bytes, n_flop,
               max_err(got, ref),
               cuda_ms(lambda: pwa_attention.window_attention_train_fwd(
                   *qkvb, scale, p_drop)),
               cuda_ms(lambda: pwa_attention.window_attention_train_fwd_plain(
                   *qkvb, scale, p_drop), 5), None)

        grads = pwa_attention.window_attention_train_bwd(*qkvb, do, scale,
                                                         p_drop)
        again = pwa_attention.window_attention_train_bwd(*qkvb, do, scale,
                                                         p_drop)
        refs = pwa_attention.window_attention_train_bwd_plain(
            *qkvb, do, scale, p_drop)
        torch.cuda.synchronize()
        errs = []
        for gname, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
            top = float(r.abs().max())
            require_close(f"K2b {name} {gname}", g, r, atol=1e-4 * top,
                          rtol=1e-4)
            errs.append(max_err(g, r))
        if not torch.equal(grads[3], again[3]):
            raise AssertionError(f"K2b {name}: dbias differs between calls")
        sums[f"K2b {name} dbias"] = checksum(grads[3])
        n_bytes = 4 * (2 * (q.numel() + k.numel() + v.numel())
                       + 2 * bias.numel() + do.numel()) + 8
        # QKᵀ recomputed once, dOᵀV, dV, dQ, dK; softmax, dS (3) and the
        # mask (16) per score; dbias summed over the windows
        n_flop = (2 * scores * (3 * cqk + 2 * cv) + 5 * scores
                  + 3 * scores + 16 * scores + scores)
        record("pwa_attention_train_bwd", name, 1, n_bytes, n_flop,
               (max(e[0] for e in errs), max(e[1] for e in errs)),
               cuda_ms(lambda: pwa_attention.window_attention_train_bwd(
                   *qkvb, do, scale, p_drop)),
               cuda_ms(lambda: pwa_attention.window_attention_train_bwd_plain(
                   *qkvb, do, scale, p_drop), 5), None)

    # -- phase 3: K4b, K5b (JLC backward, B = 2) ---------------------------
    for i in range(4):
        c = base * 2 ** i
        s = spatial0 // 2 ** i
        groups = c // cfg_dict["min_dim_group"][i]
        e = cfg_dict["conv_expansion_factor"][i]
        cg = c // groups
        # per train step: encoder, student decoder and two teachers at
        # L0-L2; the encoder alone at L3
        weight = 4 if i < 3 else 1
        x, g = randn(batch, c, s, s, s), randn(batch, c, s, s, s)
        ws = [randn(c, cg, k, k, k, scale=(2.0 / (cg * k ** 3)) ** 0.5)
              for k in (1, 3, 5)]
        w1 = randn(e * c, c, 1, 1, 1, scale=(2.0 / c) ** 0.5)
        b1 = randn(e * c, scale=0.1)
        w2 = randn(c, e * c, 1, 1, 1, scale=(2.0 / (e * c)) ** 0.5)
        vox = batch * c * s ** 3
        dy = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
        ref = fused_jlc.jlc_stage1_bwd_plain(x, ws, g, groups)
        torch.cuda.synchronize()
        require_close(f"K4b L{i}", dy, ref, atol=1e-4 * float(ref.abs().max()),
                      rtol=1e-4)
        n_bytes = 4 * (2 * vox + sum(w.numel() for w in ws) + 3 * vox)
        # the recomputed convolution (as K4f), then per branch value:
        # stats (2), normalize (2), GELU' (8), ·g (1), the two sums (2)
        # and the InstanceNorm backward (4)
        n_flop = (2 * batch * c * cg * sum(taps_in_bounds(s, k) ** 3
                                           for k in (1, 3, 5))
                  + 19 * 3 * vox)
        record("jlc_stage1_bwd", f"L{i}", weight, n_bytes, n_flop,
               max_err(dy, ref),
               cuda_ms(lambda: fused_jlc.jlc_stage1_bwd(x, ws, g, groups)),
               cuda_ms(lambda: fused_jlc.jlc_stage1_bwd_plain(
                   x, ws, g, groups), 5), None)

        got = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g)
        again = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g)
        refs = fused_jlc.jlc_stage2_bwd_plain(x, w1, b1, w2, g)
        torch.cuda.synchronize()
        errs = []
        for gname, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                               refs):
            require_close(f"K5b L{i} {gname}", a, r,
                          atol=1e-4 * float(r.abs().max()), rtol=1e-4)
            errs.append(max_err(a, r))
        for gname, a, a2 in (("dW1", got[1], again[1]),
                             ("dW2", got[3], again[3])):
            if not torch.equal(a, a2):
                raise AssertionError(f"K5b L{i}: {gname} differs between "
                                     f"calls")
            sums[f"K5b L{i} {gname}"] = checksum(a)
        n_bytes = 4 * (3 * vox + 2 * (w1.numel() + w2.numel())
                       + 2 * b1.numel() + 2 * c)
        # five channel products (W1ŷ, W2ᵀg, dW2, dW1, W1ᵀdz1), stats (4),
        # GELU and GELU' (14) per hidden value, the IN backward (8)
        n_flop = 10 * vox * e * c + 4 * vox + 14 * vox * e + 8 * vox
        record("jlc_stage2_bwd", f"L{i}", weight, n_bytes, n_flop,
               (max(x_[0] for x_ in errs), max(x_[1] for x_ in errs)),
               cuda_ms(lambda: fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g)),
               cuda_ms(lambda: fused_jlc.jlc_stage2_bwd_plain(
                   x, w1, b1, w2, g), 5), None)
    print(f"[3] bit-identical on repeat; checksums {json.dumps(sums)}",
          flush=True)
    report["checksums"] = sums

    # -- phase 4: full-width eval forward, card vs CPU -----------------------
    wrappers = {"pwa_attention": pwa_attention.window_attention,
                "jlc_stage1": fused_jlc.jlc_stage1,
                "jlc_stage2": fused_jlc.jlc_stage2}
    model, cfg = build_veloxseg(cfg_dict, device="cuda", seed=0)
    x96 = torch.randn(1, 96, 96, 96, 2, generator=torch.Generator()
                      .manual_seed(1))
    with torch.inference_mode():
        x96_dev = x96.to(dev)
        for w in wrappers.values():
            w.launches = 0
        y = model(x96_dev)
        torch.cuda.synchronize()
        per_forward = {n: w.launches for n, w in wrappers.items()}
        fwd_ms = cuda_ms(lambda: model(x96_dev), 5)
        cpu_model, _ = build_veloxseg(cfg_dict, device="cpu", seed=0)
        t0 = time.perf_counter()
        y_cpu = cpu_model(x96)
        cpu_s = time.perf_counter() - t0
    if tuple(y.shape) != (1, 96, 96, 96, cfg.n_classes) \
            or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"bad forward output {tuple(y.shape)}")
    scale = float(y_cpu.abs().max())
    fwd_err = float((y.cpu() - y_cpu).abs().max())
    # fp32 on both (TF32 off); cuDNN and the kernels sum in other orders
    if not fwd_err <= 1e-4 * scale:
        raise AssertionError(f"GPU forward differs from the CPU forward: "
                             f"max abs err {fwd_err:.3e} on scale {scale:.3e}")
    # the per-shape weights of phase 3 build the per-forward sums below:
    # they must add up to the launches one forward really made
    weights = {n: kernels[n]["calls"] for n in wrappers}
    if weights != per_forward:
        raise AssertionError(f"phase-3 calls per forward {weights} differ "
                             f"from the forward's launches {per_forward}")
    print(f"[4] AutoPET-II eval forward (1,96,96,96,2): max abs err vs CPU "
          f"{fwd_err:.3e} on output scale {scale:.3e} (tol 1e-4 x scale) | "
          f"GPU {fwd_ms:.3f} ms/forward (CPU {cpu_s:.2f} s) | launches per "
          f"forward {per_forward}", flush=True)
    report["forward"] = dict(max_abs_err=fwd_err, scale=scale,
                             gpu_ms=fwd_ms, cpu_s=cpu_s,
                             launches_per_forward=per_forward)

    # -- phase 5: sliding-window inference (the main path) -------------------
    vol = torch.randn(1, 192, 192, 192, 2,
                      generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        vol_dev = vol.to(dev)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        seg = sliding_window_inference(vol_dev, (96, 96, 96), model,
                                       sw_batch_size=tiles, overlap=0.25,
                                       mode="constant")
        torch.cuda.synchronize()
        sw_s = time.perf_counter() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        first = model(vol_dev[:, :96, :96, :96])
    if tuple(seg.shape) != (1, 192, 192, 192, cfg.n_classes) \
            or not bool(torch.isfinite(seg).all()):
        raise AssertionError(f"bad sliding-window output {tuple(seg.shape)}")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    # voxels [0, 72)³ lie in the first tile only (tile starts 0, 72, 96)
    sw_err = float((seg[:, :72, :72, :72] - first[:, :72, :72, :72])
                   .abs().max())
    if not sw_err <= 1e-5 * float(first.abs().max()):
        raise AssertionError(f"sliding window disagrees with the first "
                             f"tile's forward: {sw_err:.3e}")
    print(f"[5] sliding window (1,192,192,192,2), ROI 96, overlap 0.25, "
          f"sw_batch_size 4, constant: {sw_s:.3f} s wall, "
          f"{1.0 / sw_s:.3f} volumes/s | launches {launches} | single-tile "
          f"region err {sw_err:.3e}", flush=True)
    report["sliding_window"] = dict(wall_s=sw_s, volumes_per_s=1.0 / sw_s,
                                    launches=launches, region_err=sw_err)

    # -- phase 6: the train step, full width, as published -----------------
    del model, first, seg
    wrappers.update({
        "pwa_attention_train_fwd": pwa_attention.window_attention_train_fwd,
        "pwa_attention_train_bwd": pwa_attention.window_attention_train_bwd,
        "jlc_stage1_bwd": fused_jlc.jlc_stage1_bwd,
        "jlc_stage2_bwd": fused_jlc.jlc_stage2_bwd})
    loss_obj = CompositeLoss(train_cfg, cfg)
    opt_cfg = train_cfg["optimizer"]

    def make_state(model_cfg, device, seed):
        m, _ = build_veloxseg(model_cfg, device=device, seed=seed)
        return create_train_state(m, build_optimizer(
            opt_cfg["optimizer_type"], opt_cfg["optimizer_args"],
            m.parameters()))

    xb = torch.randn(batch, 96, 96, 96, 2,
                     generator=torch.Generator().manual_seed(3))
    yb = (xb[..., 0] > 1.0).long()            # PET channel above 1 σ
    xb_dev, yb_dev = xb.to(dev), yb.to(dev)
    step = train_step_fn(loss_obj)            # on the card
    state = make_state(cfg_dict, "cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    torch.cuda.reset_peak_memory_stats()
    state, aux = step(state, xb_dev, yb_dev, gen)         # warm-up, step 1
    losses = [aux["loss"]]
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for _ in range(10):
        state, aux = step(state, xb_dev, yb_dev, gen)
        losses.append(aux["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 10
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    train_launches = {n: w.launches for n, w in wrappers.items()}
    per_step = {n: c / 10 for n, c in train_launches.items()}
    want = {"pwa_attention": 0, "jlc_stage1": 13, "jlc_stage2": 0,
            "pwa_attention_train_fwd": 4, "pwa_attention_train_bwd": 4,
            "jlc_stage1_bwd": 13, "jlc_stage2_bwd": 0}
    if per_step != want:
        raise AssertionError(f"train step launches {per_step}, want {want}")
    if not all(v == v and abs(v) < float("inf") for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    print(f"[6] AutoPET-II train step (B={batch}, 96³, fp32, conv_drop "
          f"{cfg_dict['conv_drop']}): {step_ms:.3f} ms/step, "
          f"{1e3 / step_ms:.3f} steps/s over 10 steps, peak "
          f"{peak_gb:.2f} GB | loss step 1 {losses[0]:.5f} -> step 11 "
          f"{losses[-1]:.5f} | launches per step {per_step}", flush=True)
    report["train"] = dict(batch=batch, ms_per_step=step_ms,
                           steps_per_s=1e3 / step_ms, peak_gb=peak_gb,
                           losses=losses, launches_per_step=per_step)
    del state

    # -- phase 7: conv_drop 0, stage 2 through K5f/K5b ---------------------
    state = make_state(dict(cfg_dict, conv_drop=0.0), "cuda", 0)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for _ in range(2):
        state, aux = step(state, xb_dev, yb_dev, gen)
    torch.cuda.synchronize()
    step0_ms = (time.perf_counter() - t0) * 1e3 / 2
    nodrop_launches = {n: w.launches for n, w in wrappers.items()}
    per_step0 = {n: c / 2 for n, c in nodrop_launches.items()}
    want0 = dict(want, jlc_stage2=13, jlc_stage2_bwd=13)
    if per_step0 != want0 or not bool(torch.isfinite(aux["loss"])):
        raise AssertionError(f"conv_drop 0 launches {per_step0}, want "
                             f"{want0}; loss {float(aux['loss'])}")
    print(f"[7] conv_drop 0: {step0_ms:.3f} ms/step (2 steps) | launches "
          f"per step {per_step0}", flush=True)
    report["train_conv_drop0"] = dict(ms_per_step=step0_ms,
                                      launches_per_step=per_step0)
    del state
    # phase 3's weights per train step match these runs
    for n in ("pwa_attention_train_fwd", "pwa_attention_train_bwd",
              "jlc_stage1_bwd", "jlc_stage2_bwd"):
        if kernels[n]["calls"] != want0[n]:
            raise AssertionError(f"phase-3 calls per step of {n} "
                                 f"{kernels[n]['calls']} != {want0[n]}")

    # -- phase 8: one train step, card vs CPU, dropout off -----------------
    nodrop = dict(cfg_dict, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
                  drop_path=0.0)
    grads, step_losses = [], []
    for device in ("cuda", "cpu"):
        st = make_state(nodrop, device, 5)
        t0 = time.perf_counter()
        st, aux = train_step_fn(loss_obj, device=device)(
            st, xb[:1], yb[:1], None)
        step_losses.append(float(aux["loss"]))
        if device == "cpu":
            cpu_step_s = time.perf_counter() - t0
        grads.append({k: p.grad.detach().cpu()
                      for k, p in st.model.named_parameters()})
        del st
    g_all = max(float(g.abs().max()) for g in grads[1].values())
    worst, worst_key = 0.0, None
    for k, r in grads[1].items():
        err = float((grads[0][k] - r).abs().max())
        # 1e-4 of the gradient's own max, plus 1e-5 of the model's largest
        # gradient for the ones that are 0 in exact arithmetic (biases in
        # front of an InstanceNorm, where both sides hold rounding noise),
        # as tests/test_torch_train_step.py holds the port against JAX
        tol = 1e-4 * float(r.abs().max()) + 1e-5 * g_all
        if not err <= tol:
            raise AssertionError(f"card vs CPU gradient of {k}: max abs err "
                                 f"{err:.3e} > {tol:.3e}")
        ratio = err / tol
        if ratio > worst:
            worst, worst_key = ratio, k
    loss_rel = abs(step_losses[0] - step_losses[1]) / abs(step_losses[1])
    if not loss_rel <= 1e-5:
        raise AssertionError(f"card vs CPU loss {step_losses}")
    print(f"[8] train step card vs CPU (B=1, dropout 0): loss "
          f"{step_losses[0]:.6f} vs {step_losses[1]:.6f} (rel {loss_rel:.2e},"
          f" tol 1e-5) | {len(grads[1])} gradients within 1e-4 x own max + "
          f"1e-5 x largest ({g_all:.3e}); closest to its tolerance "
          f"{worst_key} at {worst:.3f} of it | CPU step {cpu_step_s:.1f} s",
          flush=True)
    report["train_vs_cpu"] = dict(losses=step_losses, loss_rel=loss_rel,
                                  worst_ratio=worst, worst_param=worst_key,
                                  largest_grad=g_all, cpu_step_s=cpu_step_s)

    # -- phase 9 ------------------------------------------------------------
    meta = {
        "pwa_attention": ("veloxseg_torch/csrc/pwa_attention.cu",
                          "veloxseg_tpu/ops/pwa_attention.py:56"),
        "jlc_stage1": ("veloxseg_torch/csrc/jlc_stage1.cu",
                       "veloxseg_tpu/ops/fused_jlc.py:111"),
        "jlc_stage2": ("veloxseg_torch/csrc/jlc_stage2.cu",
                       "veloxseg_tpu/ops/fused_jlc.py:177"),
        "pwa_attention_train_fwd": ("veloxseg_torch/csrc/pwa_attention.cu",
                                    "veloxseg_tpu/ops/pwa_attention.py:322"),
        "pwa_attention_train_bwd": (
            "veloxseg_torch/csrc/pwa_attention_bwd.cu",
            "veloxseg_tpu/ops/pwa_attention.py:344"),
        "jlc_stage1_bwd": ("veloxseg_torch/csrc/jlc_stage1.cu",
                           "veloxseg_tpu/ops/fused_jlc.py:135"),
        "jlc_stage2_bwd": ("veloxseg_torch/csrc/jlc_stage2.cu",
                           "veloxseg_tpu/ops/fused_jlc.py:194"),
    }
    serving = ("pwa_attention", "jlc_stage1", "jlc_stage2")
    # launches: the three main-path runs, each counted from 0 (serving:
    # the sliding window; train: 10 steps as published, 2 at conv_drop 0);
    # ms, plain_ms and bound_ms: summed per 4-tile forward (serving
    # kernels) or per train step at B = 2 (training kernels)
    line = {"kernels": [dict(
        name=n, route="cuda", source=meta[n][0], replaces=meta[n][1],
        launches=launches.get(n, 0) + train_launches[n] + nodrop_launches[n],
        launches_serving=launches.get(n, 0),
        launches_train=train_launches[n] + nodrop_launches[n],
        per="forward, 4 tiles" if n in serving else f"train step, B={batch}",
        max_abs_err=k["err"], ms=k["ms"],
        plain_ms=k["plain"], bound_ms=k["bound"],
        bound_by="bytes" if k["tb"] >= k["to"] else "operations",
        library_ms=k["lib"]) for n, k in kernels.items()]}
    report["kernels"] = line["kernels"]
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
