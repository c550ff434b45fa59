#!/usr/bin/env python3
"""Run the PyTorch port (``veloxseg_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero; nothing is caught and waved through):

1. require CUDA; print the card's name and power limit; TF32 off.
2. build the CUDA kernels from ``veloxseg_torch/csrc`` (one nvcc each, in
   parallel) and print the build seconds.
3. hold each kernel against its plain PyTorch version on the card at the
   shapes each main path gives it. AutoPET-II serving (a 4-tile batch of
   96³ tiles): K1 at the four PWA levels, at Hecktor's L = 512 and at the
   128³ flagship's L = 1024, K4f and K5f at the four JLC levels. AutoPET-II
   training (B = 2): K2f and K2b at the four PWA levels with attention
   dropout 0.1 (both sides draw the same counter-hash mask), K4f, K5f, K4b
   and K5b at the four JLC levels. The 128³ flagship (``bench.py``'s
   training at its B = 16, level 1 at L = 1024): K3f and K3b (also at
   B = 2), K2f and K2b at the three L = 128 levels and, beside K3, at
   L = 1024, K4f, K5f, K4b and K5b at its four JLC levels. U-RWKV: K6 at
   its bottleneck's (4, 216, 128). K1, K2f and K3f are one kernel
   (``csrc/pwa_attention_train.cu``, K1 its instance without dropout and
   lse); its launch geometry is printed for each, and K6's.
   K4b is held against its plain version in dy and in the branch
   weights' gradient; its weight-gradient launches
   are also timed alone ("jlc_branch_wgrad", on K4b's own dy). K2f and K3f
   also write each row's log-sum-exp (held against its plain version), and
   K2b and K3b take it with the forward's output; K2b also runs at
   Hecktor's L = 512 (no main path's, weight 0); K5b takes K5f's plane
   statistics, as the train step runs it. Every K2b, K3b and K5b output,
   K5f's output and statistics and K4b's dW must repeat bit for bit; the
   K2b/K3b dbias, K4b dW and K5b dW1/dW2 checksums are printed so that two
   runs can be compared. The timers, the card query and the bounds are
   ``tools/chip_measure.py``'s. Print errors and times: kernel, plain
   version, the least time the card could take (bound), and one library
   call as a yardstick the port never calls: for K1
   ``scaled_dot_product_attention`` with the bias as a float mask; for K2f
   and K2b (and K3 beside them) the same call with ``dropout_p`` = p and,
   for the backward, its autograd backward with the mask requiring grad
   (same work, different dropout mask: SDPA draws its own; the backend
   that ran is printed); for K4b's wgrad cuDNN's weight-only
   ``convolution_backward`` of each branch; no one PyTorch call computes
   the function of K4f, K4b, K5 or K6. Each path's calls per unit must
   equal the launches its run makes (phases 4, 7, 9, 11).
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
   K4b 13 (each with its weight-gradient launches: wgrad 13) and no other.
7. two steps with ``conv_drop`` 0, where stage 2 runs through its kernels:
   K5f 13 and K5b 13 per step.
8. one step at full width, B = 1, every dropout 0, on the card and on the
   CPU from the same weights: the loss and every parameter's gradient
   must agree (tolerance printed).
9. path A, training the 128³ flagship (``core/config.flagship_config``:
   bench.py's ``_flagship``, dropout at its defaults, ``conv_drop`` 0) at
   bench.py's B = 16 with its loss weights and AdamW: a warm-up step, then
   10 timed steps (ms per step, peak memory, the loss falling). Launches
   per step: K2f 3, K2b 3, K3f 1, K3b 1, K4f, K4b (and its wgrad), K5f,
   K5b 13 each, and they must equal phase 3's calls per step.
10. one flagship step at B = 1, every dropout 0, card against CPU, as 8.
11. path B, U-RWKV (``load_model("U-RWKV", models_config_autopetii)``)
    with seeded weights: the forward of a seeded (4, 96, 96, 96, 2) batch
    on the card and on the CPU (batch norms take the statistics of the 4
    tiles on both), and K6's launches per forward (6).
12. U-RWKV sliding window over phase 5's volume (ROI 96³, overlap 0.25,
    ``sw_batch_size`` 4, constant), counts zeroed before and read after:
    s and volumes/s; the voxels only the first tile covers must equal the
    first predictor call's output for that tile (the batch norms see the
    other tiles of the call), and those only the last tile covers the last
    call's, filled up with the first tile as the JAX package fills it.
13. print one ``{"kernels": [...]}`` line (with ``excess_ms``, each path's
    launches × (ms − bound) per call at that path's own shapes, summed),
    the card line, and last ``{"ok": true, "device": {...}}``.

Details go to ``<out>/chip_smoke.json`` (``--out``, default ``runs``).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tools"))
# the timers, the card query and the bounds, shared with the bench tools
from chip_measure import (FP32_FLOP_PER_S, HBM_BYTES_PER_S,  # noqa: E402
                          bound, card as card_line, cuda_ms,
                          eval_attention_work, sdpa_backend, stage2_bwd_work,
                          stage2_fwd_work, train_attention_work, wkv_work)


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


def compare_grads(what, grads, step_losses):
    """Card (``grads[0]``) against CPU (``grads[1]``) gradients and losses
    of one train step; returns the report dict. 1e-4 of each gradient's
    own max, plus 1e-5 of the model's largest gradient for the ones that
    are 0 in exact arithmetic (biases in front of an InstanceNorm, where
    both sides hold rounding noise), as tests/test_torch_train_step.py
    holds the port against JAX."""
    g_all = max(float(g.abs().max()) for g in grads[1].values())
    worst, worst_key = 0.0, None
    for k, r in grads[1].items():
        err = float((grads[0][k] - r).abs().max())
        tol = 1e-4 * float(r.abs().max()) + 1e-5 * g_all
        if not err <= tol:
            raise AssertionError(f"{what}: card vs CPU gradient of {k}: max "
                                 f"abs err {err:.3e} > {tol:.3e}")
        if err / tol > worst:
            worst, worst_key = err / tol, k
    loss_rel = abs(step_losses[0] - step_losses[1]) / abs(step_losses[1])
    if not loss_rel <= 1e-5:
        raise AssertionError(f"{what}: card vs CPU loss {step_losses}")
    return dict(losses=step_losses, loss_rel=loss_rel, worst_ratio=worst,
                worst_param=worst_key, largest_grad=g_all,
                n_grads=len(grads[1]))


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

    from veloxseg_torch.core.config import flagship_config, load_json_config
    from veloxseg_torch.core.windows import compute_window_layout
    from veloxseg_torch.infer.sliding_window import (compute_tile_origins,
                                                     sliding_window_inference)
    from veloxseg_torch.models.registry import load_model
    from veloxseg_torch.models.zoo.urwkv import _fancy_init
    from veloxseg_torch.nn.veloxseg import build_veloxseg
    from veloxseg_torch.ops import _cuda, fused_jlc, pwa_attention, wkv
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.optim import build_optimizer
    from veloxseg_torch.train.train_state import (create_train_state,
                                                  train_step_fn)

    # -- phase 1 ------------------------------------------------------------
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
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

    all_models = load_json_config(os.path.join(
        ROOT, "config", "models_config_autopetii.json"))
    cfg_dict = all_models["VeloxSeg"]
    hk_dict = load_json_config(os.path.join(
        ROOT, "config", "models_config_hecktor2022.json"))["VeloxSeg"]
    train_cfg = load_json_config(os.path.join(
        ROOT, "config", "train_config_bs4.json"))
    tiles = 4                                    # sw_batch_size
    batch = train_cfg["batch_size"]              # 2
    fcfg = flagship_config()                     # bench.py's 128³ model
    big_batch = 16                               # bench.py's B

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

    # per unit (one main path's run at its own shapes: "serving", the
    # AutoPET-II forward of 4 tiles; "train_96", its train step at B = 2;
    # "train_flagship", the 128³ step at B = 16; "urwkv_serving", the
    # U-RWKV forward of 4 tiles) and kernel: the calls per unit and the
    # sums of ms, plain ms and bound over them
    units, errs = {}, {}

    def record(kname, shape_name, weight, n_bytes, n_flop, err, ms,
               plain_ms, library_ms, unit="serving"):
        """``weight``: calls per ``unit`` at this shape (0: checked and
        timed, but in no unit's sums)."""
        b_ms, b_by = bound(n_bytes, n_flop)
        row = dict(kernel=kname, shape=shape_name, unit=unit,
                   calls_per_unit=weight, bytes=n_bytes, flop=n_flop,
                   max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms)
        report["shapes"].append(row)
        print(f"[3] {kname} {shape_name}: max abs err {err[0]:.3e} rel "
              f"{err[1]:.3e} | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})"
              + (f" library {library_ms:.4f} ms" if library_ms is not None
                 else " library none"), flush=True)
        errs[kname] = max(errs.get(kname, 0.0), err[0])
        if not weight:
            return
        acc = units.setdefault(unit, {}).setdefault(
            kname, dict(calls=0, ms=0.0, plain=0.0, tb=0.0, to=0.0,
                        bound=0.0, lib=None))
        acc["calls"] += weight
        acc["ms"] += weight * ms
        acc["plain"] += weight * plain_ms
        acc["bound"] += weight * b_ms
        acc["tb"] += weight * n_bytes / HBM_BYTES_PER_S * 1e3
        acc["to"] += weight * n_flop / FP32_FLOP_PER_S * 1e3
        if library_ms is not None:
            acc["lib"] = (acc["lib"] or 0.0) + weight * library_ms

    k1_cases = ([("autopet_" + n, *s, 1) for n, *s in
                 k1_shapes(cfg_dict, range(4))]
                + [("hecktor_" + n, *s, 0) for n, *s in
                   k1_shapes(hk_dict, [1])]
                + [("flagship_" + n, *s, 0) for n, *s in
                   k1_shapes(fcfg.to_dict(), [1])])
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
            geometry = pwa_attention.eval_fwd_launch(b, h, n, L, cqk, cv,
                                                     _cuda.sm_count(dev))
            print(f"[3] K1 {name}: geometry {geometry}", flush=True)
            record("pwa_attention", name, weight,
                   *eval_attention_work(b, h, n, cqk, cv, L),
                   max_err(got, ref),
                   cuda_ms(lambda: pwa_attention.window_attention(
                       q, k, v, bias, scale)),
                   cuda_ms(lambda: pwa_attention.window_attention_plain(
                       q, k, v, bias, scale), 5),
                   cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, mask, scale=scale), 5))

    # -- phase 3: K2f, K2b, K3f, K3b (train attention, dropout 0.1) --------
    p_drop = 0.1                 # attn_drop: VeloxSegConfig's default
    seed = torch.tensor([1234, 0], dtype=torch.int32, device=dev)
    sums, backends = {}, {}

    def train_attention(long, name, b, h, n, cqk, cv, L, weight,
                        unit="train_96"):
        """Hold K2 (``long`` False) or K3 against the plain versions and
        time them, beside SDPA as the library yardstick; the forward's lse
        must match its plain version and every output of the backward,
        which takes the forward's out and lse, repeat bit for bit."""
        pa = pwa_attention
        fwd = pa.window_attention_train_fwd_long if long \
            else pa.window_attention_train_fwd
        bwd = pa.window_attention_train_bwd_long if long \
            else pa.window_attention_train_bwd
        tag = "K3" if long else "K2"
        fname = fwd.__name__.replace("window_attention", "pwa_attention")
        bname = bwd.__name__.replace("window_attention", "pwa_attention")
        q, k = randn(b, h, n, cqk, L), randn(b, h, n, cqk, L)
        v, bias = randn(b, h, n, cv, L), randn(h, L, L, scale=0.5)
        do = randn(b, h, n, cv, L)
        scale = 1.0 / cqk ** 0.5
        qkvb = (q, k, v, bias, seed)
        got, lse = saved = fwd(*qkvb, scale, p_drop)
        require_close(f"{tag}f {name} lse", lse,
                      pa.train_lse_plain(q, k, bias, scale), atol=1e-5,
                      rtol=1e-5)
        ref = pa.window_attention_train_fwd_plain(*qkvb, scale, p_drop)
        torch.cuda.synchronize()
        require_close(f"{tag}f {name}", got, ref, atol=1e-4, rtol=1e-4)
        err = max_err(got, ref)
        del got, ref
        geometry = pa.train_fwd_launch(b, h, n, L, cqk, cv,
                                       _cuda.sm_count(dev))
        print(f"[3] {tag}f {name}: geometry {geometry}", flush=True)
        # the library yardstick: SDPA on the windows as a batch of
        # (b·n, h) heads, the bias a float mask broadcast over the batch;
        # the same work with its own dropout mask
        q4, k4, v4, do4 = (t.permute(0, 2, 1, 4, 3).reshape(b * n, h, L, -1)
                           .contiguous() for t in (q, k, v, do))
        bias4 = bias.clone()
        for t in (q4, k4, v4, bias4):
            t.requires_grad_()

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, k4, v4, bias4[None], dropout_p=p_drop, scale=scale)
        with torch.no_grad():
            lib_f = cuda_ms(sdpa, 5)
            backend = sdpa_backend(sdpa)
        y4 = sdpa()
        if not bool(torch.isfinite(y4).all()):
            raise AssertionError(f"SDPA {name}: non-finite output")

        def sdpa_bwd():
            return torch.autograd.grad(y4, (q4, k4, v4, bias4), do4,
                                       retain_graph=True)
        lib_b = cuda_ms(sdpa_bwd, 5)
        del y4, q4, k4, v4, do4, bias4
        backends[f"{tag} {name}"] = backend
        print(f"[3] SDPA {name}: backend {backend} (same work, different "
              f"dropout mask)", flush=True)
        work_f, work_b = train_attention_work(b, h, n, cqk, cv, L)
        record(fname, name, weight, *work_f, err,
               cuda_ms(lambda: fwd(*qkvb, scale, p_drop)),
               cuda_ms(lambda: pa.window_attention_train_fwd_plain(
                   *qkvb, scale, p_drop), 5), lib_f, unit)

        grads = bwd(*qkvb, do, scale, p_drop, *saved)
        again = bwd(*qkvb, do, scale, p_drop, *saved)
        refs = pa.window_attention_train_bwd_plain(*qkvb, do, scale, p_drop)
        torch.cuda.synchronize()
        gerrs = []
        for gname, g, r in zip(("dq", "dk", "dv", "dbias"), grads, refs):
            top = float(r.abs().max())
            require_close(f"{tag}b {name} {gname}", g, r, atol=1e-4 * top,
                          rtol=1e-4)
            gerrs.append(max_err(g, r))
        del refs
        # every sum of K2b and K3b is taken in a fixed order
        for gname, g, g2 in zip(("dq", "dk", "dv", "dbias"), grads, again):
            if not torch.equal(g, g2):
                raise AssertionError(f"{tag}b {name}: {gname} differs "
                                     f"between calls")
        sums[f"{tag}b {name} dbias"] = checksum(grads[3])
        del grads, again
        record(bname, name, weight, *work_b,
               (max(e[0] for e in gerrs), max(e[1] for e in gerrs)),
               cuda_ms(lambda: bwd(*qkvb, do, scale, p_drop, *saved)),
               cuda_ms(lambda: pa.window_attention_train_bwd_plain(
                   *qkvb, do, scale, p_drop), 5), lib_b, unit)
        del saved
        torch.cuda.empty_cache()

    # AutoPET-II, B = 2: K2 at every level
    for name, b, h, n, cqk, cv, L in k1_shapes(cfg_dict, range(4), batch):
        train_attention(False, name, b, h, n, cqk, cv, L, 1)
    # Hecktor's L = 512 level, K2's largest window (on no main path)
    for name, b, h, n, cqk, cv, L in k1_shapes(hk_dict, [1], batch):
        train_attention(False, f"hecktor_{name}", b, h, n, cqk, cv, L, 0)
    # the 128³ flagship: K3 at level 1 (B = 2, then bench.py's B = 16), K2
    # at levels 0, 2, 3 (B = 16), and K2 at level 1 beside K3, not counted
    flag = k1_shapes(fcfg.to_dict(), range(4), big_batch)
    for name, b, h, n, cqk, cv, L in flag:
        if pwa_attention.uses_long_kernel(L):
            train_attention(True, f"flagship_{name}_B2", batch, h, n, cqk,
                            cv, L, 0, "train_flagship")
            train_attention(True, f"flagship_{name}", b, h, n, cqk, cv, L, 1,
                            "train_flagship")
            train_attention(False, f"flagship_{name}", b, h, n, cqk, cv, L,
                            0, "train_flagship")
        else:
            train_attention(False, f"flagship_{name}", b, h, n, cqk, cv, L,
                            1, "train_flagship")

    # -- phase 3: K4f, K5f, K4b, K5b (the JLC blocks) ---------------------
    def jlc_cases(tag, jcfg, b, unit, weights, backward):
        """K4f and K5f (and with ``backward`` K4b and K5b) at the four JLC
        levels of ``jcfg`` at batch ``b``; ``weights``: calls per level
        and ``unit``. K5b's dW1 and dW2 must repeat bit for bit."""
        spatial0 = jcfg["input_size"][0] // jcfg["patch_size"]
        for i in range(4):
            c = jcfg["base_ch"] * 2 ** i
            s = spatial0 // 2 ** i
            groups = c // jcfg["min_dim_group"][i]
            e = jcfg["conv_expansion_factor"][i]
            cg = c // groups
            name, weight = f"{tag}L{i}", weights[i]
            x = randn(b, c, s, s, s)
            ws = [randn(c, cg, k, k, k, scale=(2.0 / (cg * k ** 3)) ** 0.5)
                  for k in (1, 3, 5)]
            bs = [randn(c, scale=0.1) for _ in ws]
            w1 = randn(e * c, c, 1, 1, 1, scale=(2.0 / c) ** 0.5)
            b1 = randn(e * c, scale=0.1)
            w2 = randn(c, e * c, 1, 1, 1, scale=(2.0 / (e * c)) ** 0.5)
            b2 = randn(c, scale=0.1)
            vox = b * c * s ** 3
            # grouped conv MACs over the taps inside the volume (those in
            # the zero padding need no work)
            conv_flop = 2 * b * c * cg * sum(taps_in_bounds(s, k) ** 3
                                             for k in (1, 3, 5))
            with torch.inference_mode():
                out1 = fused_jlc.jlc_stage1(x, ws, bs, groups)
                ref1 = fused_jlc.jlc_stage1_plain(x, ws, bs, groups)
                torch.cuda.synchronize()
                require_close(f"K4f {name}", out1, ref1, atol=1e-4,
                              rtol=1e-4)
                n_bytes = 4 * (2 * vox + sum(w.numel() for w in ws))
                # then per branch value: stats (2), normalize (2), GELU (4),
                # branch sum (1); residual add (1)
                n_flop = conv_flop + 9 * 3 * vox + vox
                record("jlc_stage1", name, weight, n_bytes, n_flop,
                       max_err(out1, ref1),
                       cuda_ms(lambda: fused_jlc.jlc_stage1(x, ws, bs,
                                                            groups)),
                       cuda_ms(lambda: fused_jlc.jlc_stage1_plain(
                           x, ws, bs, groups), 5), None, unit)
                del ref1

                out, mean, rstd = fused_jlc._jlc_stage2_fwd(out1, w1, b1, w2,
                                                           b2)
                again = fused_jlc._jlc_stage2_fwd(out1, w1, b1, w2, b2)
                ref = fused_jlc.jlc_stage2_plain(out1, w1, b1, w2, b2)
                torch.cuda.synchronize()
                require_close(f"K5f {name}", out, ref, atol=1e-4, rtol=1e-4)
                # fixed-order sums: the output and the statistics repeat
                for what, t, t2 in zip(("out", "mean", "rstd"),
                                       (out, mean, rstd), again):
                    if not torch.equal(t, t2):
                        raise AssertionError(f"K5f {name}: {what} differs "
                                             f"between calls")
                del again, mean, rstd
                record("jlc_stage2", name, weight,
                       *stage2_fwd_work(b, c, e, s ** 3),
                       max_err(out, ref),
                       cuda_ms(lambda: fused_jlc.jlc_stage2(out1, w1, b1, w2,
                                                            b2)),
                       cuda_ms(lambda: fused_jlc.jlc_stage2_plain(
                           out1, w1, b1, w2, b2), 5), None, unit)
                del out, ref, out1
            if not backward:
                continue

            g = randn(b, c, s, s, s)
            dy, dws = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
            _, again = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
            ref, ref_dws = fused_jlc.jlc_stage1_bwd_plain(x, ws, g, groups)
            torch.cuda.synchronize()
            errs4 = []
            for gname, a, r in [("dy", dy, ref)] + [
                    (f"dW{k}", a, r) for k, a, r in zip((1, 3, 5), dws,
                                                        ref_dws)]:
                require_close(f"K4b {name} {gname}", a, r,
                              atol=1e-4 * float(r.abs().max()), rtol=1e-4)
                errs4.append(max_err(a, r))
            for k, a, a2 in zip((1, 3, 5), dws, again):
                if not torch.equal(a, a2):
                    raise AssertionError(f"K4b {name}: dW{k} differs between "
                                         f"calls")
                sums[f"K4b {name} dW{k}"] = checksum(a)
            del again, ref_dws
            w_numel = sum(w.numel() for w in ws)
            # x and g in, dy and dW out
            n_bytes = 4 * (2 * vox + w_numel + 3 * vox + w_numel)
            # the recomputed convolution (as K4f), then per branch value:
            # stats (2), normalize (2), GELU' (8), ·g (1), the two sums (2)
            # and the InstanceNorm backward (4); the weight gradient's MACs
            # over the same in-bound taps
            n_flop = 2 * conv_flop + 19 * 3 * vox
            record("jlc_stage1_bwd", name, weight, n_bytes, n_flop,
                   (max(e[0] for e in errs4), max(e[1] for e in errs4)),
                   cuda_ms(lambda: fused_jlc.jlc_stage1_bwd(x, ws, g, groups)),
                   cuda_ms(lambda: fused_jlc.jlc_stage1_bwd_plain(
                       x, ws, g, groups), 5), None, unit)

            # K4b's weight-gradient launches alone, on the same dy; the
            # library yardstick is cuDNN's weight-only wgrad of each branch
            got = fused_jlc.jlc_branch_wgrad(x, dy, ws, groups)
            torch.cuda.synchronize()
            werrs = []
            for k, a, r in zip((1, 3, 5), got, dws):
                # the same kernels on the same dy as inside K4b
                if not torch.equal(a, r):
                    raise AssertionError(f"K4b wgrad {name}: dW{k} differs "
                                         f"from K4b's")
            ref_w = fused_jlc.jlc_branch_wgrad_plain(x, dy, ws, groups)
            for k, a, r in zip((1, 3, 5), got, ref_w):
                require_close(f"K4b wgrad {name} dW{k}", a, r,
                              atol=1e-4 * float(r.abs().max()), rtol=1e-4)
                werrs.append(max_err(a, r))
            del got, ref_w

            def cudnn_wgrad():
                for w, dyj in zip(ws, dy):
                    torch.ops.aten.convolution_backward(
                        dyj, x, w, None, [1, 1, 1], [w.shape[-1] // 2] * 3,
                        [1, 1, 1], False, [0, 0, 0], groups,
                        [False, True, False])
            record("jlc_branch_wgrad", name, weight,
                   4 * (vox + 3 * vox + w_numel), conv_flop,
                   (max(e[0] for e in werrs), max(e[1] for e in werrs)),
                   cuda_ms(lambda: fused_jlc.jlc_branch_wgrad(x, dy, ws,
                                                              groups)),
                   cuda_ms(lambda: fused_jlc.jlc_branch_wgrad_plain(
                       x, dy, ws, groups), 5), cuda_ms(cudnn_wgrad, 5), unit)
            del dy, dws, ref

            # K5b as the train step runs it: with K5f's plane statistics
            with torch.inference_mode():
                _, mean, rstd = fused_jlc._jlc_stage2_fwd(x, w1, b1, w2, b2)
            got = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
            again = fused_jlc.jlc_stage2_bwd(x, w1, b1, w2, g, mean, rstd)
            refs = fused_jlc.jlc_stage2_bwd_plain(x, w1, b1, w2, g)
            torch.cuda.synchronize()
            errs5 = []
            for gname, a, r in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                                   refs):
                require_close(f"K5b {name} {gname}", a, r,
                              atol=1e-4 * float(r.abs().max()), rtol=1e-4)
                errs5.append(max_err(a, r))
            for gname, a, a2 in zip(("dx", "dW1", "db1", "dW2", "db2"),
                                    got, again):
                if not torch.equal(a, a2):
                    raise AssertionError(f"K5b {name}: {gname} differs "
                                         f"between calls")
            sums[f"K5b {name} dW1"] = checksum(got[1])
            sums[f"K5b {name} dW2"] = checksum(got[3])
            del got, again, refs
            record("jlc_stage2_bwd", name, weight,
                   *stage2_bwd_work(b, c, e, s ** 3),
                   (max(x_[0] for x_ in errs5), max(x_[1] for x_ in errs5)),
                   cuda_ms(lambda: fused_jlc.jlc_stage2_bwd(
                       x, w1, b1, w2, g, mean, rstd)),
                   cuda_ms(lambda: fused_jlc.jlc_stage2_bwd_plain(
                       x, w1, b1, w2, g), 5), None, unit)
            del mean, rstd
            torch.cuda.empty_cache()

    # serving: encoder and decoder at L0-L2, the encoder alone at L3; a
    # train step: encoder, student decoder and two teachers at L0-L2, the
    # encoder alone at L3 (forward and backward alike)
    jlc_cases("", cfg_dict, tiles, "serving", (2, 2, 2, 1), False)
    jlc_cases("B2_", cfg_dict, batch, "train_96", (4, 4, 4, 1), True)
    jlc_cases("flagship_", fcfg.to_dict(), big_batch, "train_flagship",
              (4, 4, 4, 1), True)

    # -- phase 3: K6 (U-RWKV's bottleneck: 6³ tokens, 128 channels) --------
    b6, t6, c6 = tiles, 216, 128
    decay, first, *_ = _fancy_init(c6)
    w6 = torch.from_numpy(decay / t6).to(dev)      # w = decay / T
    u6 = torch.from_numpy(first / t6).to(dev)      # u = first / T
    k6, v6 = randn(b6, t6, c6), randn(b6, t6, c6)
    with torch.inference_mode():
        got = wkv.wkv(w6, u6, k6, v6)
        ref = wkv.wkv_plain(w6, u6, k6, v6)
        torch.cuda.synchronize()
        # fp32, the same recurrence cut into chunks; expf and fused
        # multiply-adds
        require_close("K6", got, ref, atol=1e-5, rtol=1e-5)
        print(f"[3] K6: geometry "
              f"{wkv.wkv_launch(t6)}",
              flush=True)
        record("wkv", f"({b6},{t6},{c6})", 6, *wkv_work(b6, t6, c6),
               max_err(got, ref), cuda_ms(lambda: wkv.wkv(w6, u6, k6, v6)),
               cuda_ms(lambda: wkv.wkv_plain(w6, u6, k6, v6), 5), None,
               "urwkv_serving")
    print(f"[3] bit-identical on repeat; checksums {json.dumps(sums)}",
          flush=True)
    report["checksums"] = sums
    report["sdpa_backends"] = backends

    # -- phase 4: full-width eval forward, card vs CPU -----------------------
    serving = {"pwa_attention": pwa_attention.window_attention,
               "jlc_stage1": fused_jlc.jlc_stage1,
               "jlc_stage2": fused_jlc.jlc_stage2}
    wrappers = dict(serving, **{
        "pwa_attention_train_fwd": pwa_attention.window_attention_train_fwd,
        "pwa_attention_train_bwd": pwa_attention.window_attention_train_bwd,
        "pwa_attention_train_fwd_long":
            pwa_attention.window_attention_train_fwd_long,
        "pwa_attention_train_bwd_long":
            pwa_attention.window_attention_train_bwd_long,
        "jlc_stage1_bwd": fused_jlc.jlc_stage1_bwd,
        "jlc_branch_wgrad": fused_jlc.jlc_branch_wgrad,
        "jlc_stage2_bwd": fused_jlc.jlc_stage2_bwd,
        "wkv": wkv.wkv})

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {n: w.launches for n, w in wrappers.items()}

    model, cfg = build_veloxseg(cfg_dict, device="cuda", seed=0)
    x96 = torch.randn(1, 96, 96, 96, 2, generator=torch.Generator()
                      .manual_seed(1))
    with torch.inference_mode():
        x96_dev = x96.to(dev)
        zero_counts()
        y = model(x96_dev)
        torch.cuda.synchronize()
        per_forward = {n: c for n, c in counts().items() if c}
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
    weights = {n: a["calls"] for n, a in units["serving"].items()}
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
    del cpu_model, y_cpu

    # -- phase 5: sliding-window inference (the serving path) ----------------
    vol = torch.randn(1, 192, 192, 192, 2,
                      generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        vol_dev = vol.to(dev)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        seg = sliding_window_inference(vol_dev, (96, 96, 96), model,
                                       sw_batch_size=tiles, overlap=0.25,
                                       mode="constant")
        torch.cuda.synchronize()
        sw_s = time.perf_counter() - t0
        launches = counts()
        first = model(vol_dev[:, :96, :96, :96])
    if tuple(seg.shape) != (1, 192, 192, 192, cfg.n_classes) \
            or not bool(torch.isfinite(seg).all()):
        raise AssertionError(f"bad sliding-window output {tuple(seg.shape)}")
    missing = [n for n in serving if launches[n] <= 0]
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
          f"{1.0 / sw_s:.3f} volumes/s | launches "
          f"{ {n: c for n, c in launches.items() if c} } | single-tile "
          f"region err {sw_err:.3e}", flush=True)
    report["sliding_window"] = dict(wall_s=sw_s, volumes_per_s=1.0 / sw_s,
                                    launches=launches, region_err=sw_err)

    # -- phase 6: the train step, full width, as published -----------------
    del model, first, seg
    loss_obj = CompositeLoss(train_cfg, cfg)
    opt_cfg = train_cfg["optimizer"]

    def make_state(model_cfg, device, seed):
        m, _ = build_veloxseg(model_cfg, device=device, seed=seed)
        return create_train_state(m, build_optimizer(
            opt_cfg["optimizer_type"], opt_cfg["optimizer_args"],
            m.parameters()))

    def train_run(what, state, step, x_dev, y_dev, n_steps, want):
        """``n_steps`` timed steps after the counts are zeroed: (state,
        losses, ms per step, launches per step); the launches must be
        ``want`` (0 for the wrappers not named)."""
        losses = []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, aux = step(state, x_dev, y_dev, gen_dev)
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        got = counts()
        per_step = {n: c / n_steps for n, c in got.items()}
        full = {n: want.get(n, 0) for n in wrappers}
        if per_step != full:
            raise AssertionError(f"{what}: launches per step {per_step}, "
                                 f"want {full}")
        losses = [float(v) for v in losses]
        if not all(v == v and abs(v) < float("inf") for v in losses):
            raise AssertionError(f"{what}: non-finite losses {losses}")
        return state, losses, ms, got, {n: c for n, c in per_step.items()
                                        if c}

    xb = torch.randn(batch, 96, 96, 96, 2,
                     generator=torch.Generator().manual_seed(3))
    yb = (xb[..., 0] > 1.0).long()            # PET channel above 1 σ
    xb_dev, yb_dev = xb.to(dev), yb.to(dev)
    step = train_step_fn(loss_obj)            # on the card
    state = make_state(cfg_dict, "cuda", 0)
    gen_dev = torch.Generator(device=dev).manual_seed(4)
    torch.cuda.reset_peak_memory_stats()
    state, aux = step(state, xb_dev, yb_dev, gen_dev)     # warm-up, step 1
    first_loss = float(aux["loss"])
    want = {"jlc_stage1": 13, "pwa_attention_train_fwd": 4,
            "pwa_attention_train_bwd": 4, "jlc_stage1_bwd": 13,
            "jlc_branch_wgrad": 13}
    state, losses, step_ms, train_launches, per_step = train_run(
        "AutoPET-II train", state, step, xb_dev, yb_dev, 10, want)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [first_loss] + losses
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not falling: {losses}")
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
    want0 = dict(want, jlc_stage2=13, jlc_stage2_bwd=13)
    state, _, step0_ms, nodrop_launches, per_step0 = train_run(
        "AutoPET-II conv_drop 0", state, step, xb_dev, yb_dev, 2, want0)
    print(f"[7] conv_drop 0: {step0_ms:.3f} ms/step (2 steps) | launches "
          f"per step {per_step0}", flush=True)
    report["train_conv_drop0"] = dict(ms_per_step=step0_ms,
                                      launches_per_step=per_step0)
    del state
    # phase 3's calls per train step match these runs
    weights = {n: a["calls"] for n, a in units["train_96"].items()}
    if weights != want0:
        raise AssertionError(f"phase-3 calls per step {weights} differ from "
                             f"the launches per step {want0}")

    # -- phase 8: one train step, card vs CPU, dropout off -----------------
    nodrop = dict(cfg_dict, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
                  drop_path=0.0)

    def card_vs_cpu(what, model_cfg, loss, xs, ys, seed):
        grads, step_losses = [], []
        for device in ("cuda", "cpu"):
            st = make_state(model_cfg, device, seed)
            t0 = time.perf_counter()
            st, aux = train_step_fn(loss, device=device)(st, xs, ys, None)
            step_losses.append(float(aux["loss"]))
            if device == "cpu":
                cpu_step_s = time.perf_counter() - t0
            grads.append({k: p.grad.detach().cpu()
                          for k, p in st.model.named_parameters()})
            del st
        out = compare_grads(what, grads, step_losses)
        out["cpu_step_s"] = cpu_step_s
        return out

    r8 = card_vs_cpu("AutoPET-II", nodrop, loss_obj, xb[:1], yb[:1], 5)
    print(f"[8] train step card vs CPU (B=1, dropout 0): loss "
          f"{r8['losses'][0]:.6f} vs {r8['losses'][1]:.6f} (rel "
          f"{r8['loss_rel']:.2e}, tol 1e-5) | {r8['n_grads']} gradients "
          f"within 1e-4 x own max + 1e-5 x largest "
          f"({r8['largest_grad']:.3e}); closest to its tolerance "
          f"{r8['worst_param']} at {r8['worst_ratio']:.3f} of it | CPU step "
          f"{r8['cpu_step_s']:.1f} s", flush=True)
    report["train_vs_cpu"] = r8
    del xb_dev, yb_dev
    torch.cuda.empty_cache()

    # -- phase 9: path A, the 128³ flagship train step, B = 16 -------------
    xf = torch.randn(big_batch, 128, 128, 128, 2,
                     generator=torch.Generator().manual_seed(6))
    yf = (xf[..., 0] > 1.0).long()
    xf_dev, yf_dev = xf.to(dev), yf.to(dev)
    # bench.py:146-151: the same loss weights and AdamW as train_cfg's
    flag_loss = CompositeLoss(train_cfg, fcfg)
    flag_step = train_step_fn(flag_loss)
    state = make_state(fcfg, "cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    state, aux = flag_step(state, xf_dev, yf_dev, gen_dev)   # warm-up
    first_loss = float(aux["loss"])
    want_f = {"jlc_stage1": 13, "jlc_stage2": 13, "jlc_stage1_bwd": 13,
              "jlc_branch_wgrad": 13, "jlc_stage2_bwd": 13,
              "pwa_attention_train_fwd": 3,
              "pwa_attention_train_bwd": 3,
              "pwa_attention_train_fwd_long": 1,
              "pwa_attention_train_bwd_long": 1}
    state, f_losses, flag_ms, flag_launches, flag_per_step = train_run(
        "flagship train", state, flag_step, xf_dev, yf_dev, 10, want_f)
    flag_peak = torch.cuda.max_memory_allocated() / 1e9
    f_losses = [first_loss] + f_losses
    if not f_losses[-1] < f_losses[0]:
        raise AssertionError(f"flagship losses not falling: {f_losses}")
    # phase 3's calls per flagship step match the run
    weights = {n: a["calls"] for n, a in units["train_flagship"].items()}
    if weights != want_f:
        raise AssertionError(f"phase-3 calls per flagship step {weights} "
                             f"differ from the launches per step {want_f}")
    print(f"[9] flagship train step (bench.py's 128³, B={big_batch}, fp32, "
          f"attn/proj dropout {fcfg.attn_drop}, conv_drop {fcfg.conv_drop}):"
          f" {flag_ms:.3f} ms/step, {1e3 / flag_ms:.4f} steps/s, "
          f"{big_batch * 1e3 / flag_ms:.3f} volumes/s over 10 steps, peak "
          f"{flag_peak:.2f} GB | loss step 1 {f_losses[0]:.5f} -> step 11 "
          f"{f_losses[-1]:.5f} | launches per step {flag_per_step} (phase "
          f"3's calls per step agree)", flush=True)
    report["flagship_train"] = dict(
        batch=big_batch, ms_per_step=flag_ms, steps_per_s=1e3 / flag_ms,
        peak_gb=flag_peak, losses=f_losses, launches_per_step=flag_per_step)
    del state, xf_dev, yf_dev
    torch.cuda.empty_cache()

    # -- phase 10: one flagship step, card vs CPU, dropout off -------------
    r10 = card_vs_cpu("flagship", fcfg.replace(
        attn_drop=0.0, proj_drop=0.0, conv_drop=0.0, drop_path=0.0),
        flag_loss, xf[:1], yf[:1], 7)
    print(f"[10] flagship train step card vs CPU (B=1, 128³, dropout 0): "
          f"loss {r10['losses'][0]:.6f} vs {r10['losses'][1]:.6f} (rel "
          f"{r10['loss_rel']:.2e}, tol 1e-5) | {r10['n_grads']} gradients "
          f"within 1e-4 x own max + 1e-5 x largest "
          f"({r10['largest_grad']:.3e}); closest to its tolerance "
          f"{r10['worst_param']} at {r10['worst_ratio']:.3f} of it | CPU "
          f"step {r10['cpu_step_s']:.1f} s", flush=True)
    report["flagship_vs_cpu"] = r10
    del xf, yf

    # -- phase 11: path B, the U-RWKV forward, card vs CPU -----------------
    urwkv = load_model("U-RWKV", all_models, device="cuda", seed=0)
    x4 = torch.randn(tiles, 96, 96, 96, 2,
                     generator=torch.Generator().manual_seed(8))
    with torch.inference_mode():
        x4_dev = x4.to(dev)
        zero_counts()
        y4 = urwkv(x4_dev)
        torch.cuda.synchronize()
        u_per_forward = {n: c for n, c in counts().items() if c}
        u_ms = cuda_ms(lambda: urwkv(x4_dev), 5)
        cpu_urwkv = load_model("U-RWKV", all_models, device="cpu", seed=0)
        t0 = time.perf_counter()
        y4_cpu = cpu_urwkv(x4)
        u_cpu_s = time.perf_counter() - t0
    del cpu_urwkv
    if tuple(y4.shape) != (tiles, 96, 96, 96, 2) \
            or not bool(torch.isfinite(y4).all()):
        raise AssertionError(f"bad U-RWKV output {tuple(y4.shape)}")
    u_calls = {n: a["calls"] for n, a in units["urwkv_serving"].items()}
    if u_per_forward != {"wkv": 6} or u_calls != {"wkv": 6}:
        raise AssertionError(f"U-RWKV launches per forward {u_per_forward}, "
                             f"phase-3 calls {u_calls}; want wkv 6")
    u_scale = float(y4_cpu.abs().max())
    u_err = float((y4.cpu() - y4_cpu).abs().max())
    # fp32 on both (TF32 off); cuDNN, the kernel and the batch norms' sums
    # run in other orders
    if not u_err <= 1e-4 * u_scale:
        raise AssertionError(f"U-RWKV card forward differs from the CPU's: "
                             f"{u_err:.3e} on scale {u_scale:.3e}")
    print(f"[11] U-RWKV forward (4,96,96,96,2): max abs err vs CPU "
          f"{u_err:.3e} on output scale {u_scale:.3e} (tol 1e-4 x scale) | "
          f"GPU {u_ms:.3f} ms/forward (CPU {u_cpu_s:.2f} s) | launches per "
          f"forward {u_per_forward}", flush=True)
    report["urwkv_forward"] = dict(max_abs_err=u_err, scale=u_scale,
                                   gpu_ms=u_ms, cpu_s=u_cpu_s,
                                   launches_per_forward=u_per_forward)
    del y4, y4_cpu, x4_dev

    # -- phase 12: path B, U-RWKV sliding window ---------------------------
    with torch.inference_mode():
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        useg = sliding_window_inference(vol_dev, (96, 96, 96), urwkv,
                                        sw_batch_size=tiles, overlap=0.25,
                                        mode="constant")
        torch.cuda.synchronize()
        usw_s = time.perf_counter() - t0
        u_launches = counts()
        # the first predictor call, and the last: its 3 tiles and a copy of
        # the first (the batch norms see the tiles of their call)
        origins = compute_tile_origins((192,) * 3, (96,) * 3, 0.25)
        n_calls = -(-len(origins) // tiles)
        last = origins[(n_calls - 1) * tiles:]

        def call(origs):
            return urwkv(torch.cat([vol_dev[:, o[0]:o[0] + 96,
                                            o[1]:o[1] + 96, o[2]:o[2] + 96]
                                    for o in origs]))
        ufirst = call(origins[:tiles])
        ulast = call(last + origins[:1] * (tiles - len(last)))
    if tuple(useg.shape) != (1, 192, 192, 192, 2) \
            or not bool(torch.isfinite(useg).all()):
        raise AssertionError(f"bad U-RWKV sliding window {tuple(useg.shape)}")
    if {n: c for n, c in u_launches.items() if c} != {"wkv": 6 * n_calls}:
        raise AssertionError(f"U-RWKV sliding-window launches {u_launches}, "
                             f"want wkv {6 * n_calls}")
    # voxels [0, 72)³ lie in the first tile only, [168, 192)³ in the last
    # only (tile starts 0, 72, 96)
    j = len(last) - 1
    usw_err = max(
        float((useg[:, :72, :72, :72] - ufirst[:1, :72, :72, :72])
              .abs().max()),
        float((useg[:, 168:, 168:, 168:] - ulast[j:j + 1, 72:, 72:, 72:])
              .abs().max()))
    if not usw_err <= 1e-5 * float(ufirst[:1].abs().max()):
        raise AssertionError(f"U-RWKV sliding window disagrees with the "
                             f"first call's first tile or the last call's "
                             f"last: {usw_err:.3e}")
    print(f"[12] U-RWKV sliding window (1,192,192,192,2), ROI 96, overlap "
          f"0.25, sw_batch_size 4, constant: {usw_s:.3f} s wall, "
          f"{1.0 / usw_s:.3f} volumes/s | launches wkv {u_launches['wkv']} "
          f"({n_calls} calls, the last filled up with the first tile) | "
          f"first and last single-tile regions err {usw_err:.3e}",
          flush=True)
    report["urwkv_sliding_window"] = dict(
        wall_s=usw_s, volumes_per_s=1.0 / usw_s, launches=u_launches,
        region_err=usw_err)

    # -- phase 13 -----------------------------------------------------------
    meta = {
        "pwa_attention": ("veloxseg_torch/csrc/pwa_attention_train.cu",
                          "veloxseg_tpu/ops/pwa_attention.py:56"),
        "jlc_stage1": ("veloxseg_torch/csrc/jlc_stage1.cu",
                       "veloxseg_tpu/ops/fused_jlc.py:111"),
        "jlc_stage2": ("veloxseg_torch/csrc/jlc_stage2.cu",
                       "veloxseg_tpu/ops/fused_jlc.py:177"),
        "pwa_attention_train_fwd": (
            "veloxseg_torch/csrc/pwa_attention_train.cu",
            "veloxseg_tpu/ops/pwa_attention.py:322"),
        "pwa_attention_train_bwd": (
            "veloxseg_torch/csrc/pwa_attention_bwd.cu",
            "veloxseg_tpu/ops/pwa_attention.py:344"),
        "pwa_attention_train_fwd_long": (
            "veloxseg_torch/csrc/pwa_attention_train.cu",
            "veloxseg_tpu/ops/pwa_attention.py:410"),
        "pwa_attention_train_bwd_long": (
            "veloxseg_torch/csrc/pwa_attention_long.cu",
            "veloxseg_tpu/ops/pwa_attention.py:451"),
        "jlc_stage1_bwd": ("veloxseg_torch/csrc/jlc_stage1.cu",
                           "veloxseg_tpu/ops/fused_jlc.py:135"),
        "jlc_branch_wgrad": ("veloxseg_torch/csrc/jlc_stage1.cu",
                             "veloxseg_tpu/ops/fused_jlc.py:369"),
        "jlc_stage2_bwd": ("veloxseg_torch/csrc/jlc_stage2.cu",
                           "veloxseg_tpu/ops/fused_jlc.py:194"),
        "wkv": ("veloxseg_torch/csrc/wkv.cu", "veloxseg_tpu/ops/wkv.py:77"),
    }
    per = {"serving": "forward, 4 tiles, AutoPET-II 96³",
           "train_96": f"train step, B={batch}, AutoPET-II 96³",
           "train_flagship": f"train step, B={big_batch}, flagship 128³",
           "urwkv_serving": "U-RWKV forward, 4 tiles, 96³"}
    headline = {"pwa_attention": "serving", "jlc_stage1": "serving",
                "jlc_stage2": "serving", "pwa_attention_train_fwd": "train_96",
                "pwa_attention_train_bwd": "train_96",
                "jlc_stage1_bwd": "train_96", "jlc_branch_wgrad": "train_96",
                "jlc_stage2_bwd": "train_96",
                "pwa_attention_train_fwd_long": "train_flagship",
                "pwa_attention_train_bwd_long": "train_flagship",
                "wkv": "urwkv_serving"}
    # launches: the main-path runs, each counted from 0: the VeloxSeg
    # sliding window (5), the AutoPET-II train steps (6, 7), the flagship
    # train steps (9), the U-RWKV sliding window (12). ms, plain_ms,
    # bound_ms: summed over the kernel's calls in its headline unit
    # (``per``). excess_ms, the order of work on the kernels: per path,
    # its launches × (ms − bound_ms) per call at that path's own shapes
    paths = {"serving": ("serving", launches),
             "train_96": ("train_96", train_launches),
             "train_96_conv_drop0": ("train_96", nodrop_launches),
             "train_flagship": ("train_flagship", flag_launches),
             "urwkv_serving": ("urwkv_serving", u_launches)}
    line = {"kernels": []}
    for n, (src, replaces) in meta.items():
        k = units[headline[n]][n]
        by_path = {}
        for key, (unit, got) in paths.items():
            if not got[n]:
                continue
            u = units.get(unit, {}).get(n)
            if u is None:
                raise AssertionError(f"{n} ran on {key}, but phase 3 did "
                                     f"not time it at that path's shapes")
            by_path[key] = got[n] * (u["ms"] - u["bound"]) / u["calls"]
        line["kernels"].append(dict(
            name=n, route="cuda", source=src, replaces=replaces,
            launches=sum(got[n] for _, got in paths.values()),
            launches_by_path={key: got[n] for key, (_, got) in paths.items()
                              if got[n]},
            per=per[headline[n]], max_abs_err=errs[n], ms=k["ms"],
            plain_ms=k["plain"], bound_ms=k["bound"],
            bound_by="bytes" if k["tb"] >= k["to"] else "operations",
            library_ms=k["lib"], excess_ms=sum(by_path.values()),
            excess_ms_by_path=by_path))
    report["units"] = units
    missing = set(meta) - {k["name"] for k in line["kernels"]
                           if k["launches"] > 0}
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    report["kernels"] = line["kernels"]
    report["wall_s"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[13] all phases passed in {report['wall_s']:.1f} s", flush=True)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
