#!/usr/bin/env python3
"""Run the PyTorch port (``veloxseg_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero; nothing is caught and waved through):

1. require CUDA; print the card's name and power limit; TF32 off.
2. build the CUDA kernels from ``veloxseg_torch/csrc`` (one nvcc each, in
   parallel; the bf16 forms' sources once more with ``-DVS_BF16``) and
   print the build seconds.
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
   lse); its launch geometry is printed for each, and K6's. K3f's and
   K5f's bf16 forms are kernels of their own on the bf16 tensor cores
   (``csrc/pwa_attention_long_mma.cu``, ``csrc/jlc_stage2_mma.cu``).
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
   equal the launches its run makes (phases 4, 7, 9, 11). Last, the bf16
   forms on bf16 operands, at the trainer's shapes: K2f and K2b (p = 0.1)
   at the four 96³ levels and K4f, K4b and its wgrad at the four JLC
   levels, at B = 2 (phase 6's step) and B = 4 (phase 14's), each against
   its bf16 plain version by the CPU tests' rule (at least 99% of the
   elements bit for bit equal, the rest within 1 bf16 ulp but at most 0.1%
   within 2^-8 of the largest magnitude), timed beside
   its fp32 form on the same values, bounded with 2-byte elements and the
   products of bf16 operands at the tensor cores' rate; the yardsticks in
   bf16 (SDPA; cuDNN's weight-only ``convolution_backward``). At B = 2
   also K5f and K5b in bf16 (the step at ``conv_drop`` 0, phase 7; K5b's
   outputs repeat bit for bit). For the speed CLI (phase 16) at its batch,
   B = 16: K1 in bf16 at AutoPET-II's four levels (beside SDPA in bf16),
   at Hecktor's L = 512 and BraTS's L = 216, K4f and K5f in bf16 at the
   four JLC levels, K6 on bf16 operands (cast at its edges). For the bf16
   128³ flagship step (phase 9): K3f and K3b in bf16 at its level 1 (L =
   1024) at B = 16 and B = 2, p = 0.1, against their bf16 plain versions
   (the kept weights rounded before ·V and the dV product, dS before the
   dq and dk products), K3b's outputs repeating bit for bit, each timed
   beside its fp32 form on the same values and SDPA in bf16.
4. build the AutoPET-II model (``config/models_config_autopetii.json``) at
   full width with seeded weights on the card; run the eval forward on a
   seeded (1, 96, 96, 96, 2) tile and hold it against the same model and
   weights on the CPU (``device="cpu"``: every kernel's plain version).
   Then the same forward in bf16 (``model.to(torch.bfloat16)``, as the
   speed CLI runs it: K1, K4f and K5f in their bf16 forms, 4, 7 and 7
   launches) on both, held to ``chip_measure.FORWARD_BOUND`` relative to
   the CPU's own bf16-to-fp32 distance.
5. sliding-window inference on a seeded (1, 192, 192, 192, 2) volume:
   ROI 96³, overlap 0.25, ``sw_batch_size`` 4, constant blending. The
   kernel launch counts are zeroed just before and read just after: every
   kernel must have run. The voxels only the first tile covers must equal
   that tile's own forward.
6. training at full AutoPET-II width, as published (``conv_drop`` 0.1,
   attention and projection dropout 0.1), B = 2
   (``config/train_config_bs4.json``: AdamW lr 2.5e-4, weight decay 0.01),
   on one seeded synthetic batch whose labels threshold the PET channel,
   in bf16 as the trainer steps and then in fp32: each a warm-up step,
   then 10 timed steps (ms per step, steps/s, peak memory). The loss must
   be finite and fall; the launches per step must be K2f 4, K2b 4, K4f 13,
   K4b 13 (each with its weight-gradient launches: wgrad 13), of the bf16
   forms in bf16 and of the fp32 ones in fp32, and no other.
7. two bf16 steps with ``conv_drop`` 0, where stage 2 runs through its
   kernels in their bf16 forms: K5f 13 and K5b 13 per step.
8. one step at full width, B = 1, every dropout 0, on the card and on the
   CPU from the same weights: the loss and every parameter's gradient
   must agree (tolerance printed). Then the same step in bf16 on both,
   held to ``chip_measure.STEP_BOUND`` relative to the CPU's own
   bf16-to-fp32 distance (the bound the CPU test holds the bf16 step to
   against the JAX one; printed).
9. path A, training the 128³ flagship (``core/config.flagship_config``:
   bench.py's ``_flagship``, dropout at its defaults, ``conv_drop`` 0) at
   bench.py's B = 16 with its loss weights and AdamW, in bf16 and then in
   fp32: a warm-up step, then 10 timed steps (ms per step, peak memory,
   the loss falling). Launches per step: K2f 3, K2b 3, K3f 1, K3b 1, K4f,
   K4b (and its wgrad), K5f, K5b 13 each (in bf16 all of them the bf16
   forms, no fp32 K3), and the fp32 ones must equal phase 3's calls per
   step. The bf16 step's ms is printed beside the fp32 step's.
10. one flagship step at B = 1, every dropout 0, card against CPU, as 8;
    then the same step in bf16 on both, held to
    ``chip_measure.STEP_BOUND`` as phase 8's bf16 step.
11. path B, U-RWKV (``load_model("U-RWKV", models_config_autopetii)``)
    with seeded weights: the forward of a seeded (4, 96, 96, 96, 2) batch
    on the card and on the CPU (batch norms take the statistics of the 4
    tiles on both), and K6's launches per forward (6); then in bf16 on
    both, held to ``chip_measure.FORWARD_BOUND`` (K6's fp32 kernel, cast
    at its edges as the JAX package's ``wkv_pallas`` casts).
12. U-RWKV sliding window over phase 5's volume (ROI 96³, overlap 0.25,
    ``sw_batch_size`` 4, constant), counts zeroed before and read after:
    s and volumes/s; the voxels only the first tile covers must equal the
    first predictor call's output for that tile (the batch norms see the
    other tiles of the call), and those only the last tile covers the last
    call's, filled up with the first tile as the JAX package fills it.
13. the serving CLI (``veloxseg_torch.cli.test_main.main`` →
    ``infer/driver.run_inference``) over synthetic NIfTI cases written by
    the port's ``save_nifti`` (``tests/make_fixtures.py``'s blob lesions),
    with seeded weights at the published widths saved as ``val_best.pth``
    and ``train_rate`` = ``val_rate`` = 0: AutoPET-II VeloxSeg over two
    192³ cases with ``--use_hd95 1`` (counts zeroed before, read after;
    per case the seconds of read, window, argmax, metrics and HD95 from
    the driver's log, and volumes/s end to end); case 0 again with the
    driver's ``CPU_STITCH_THRESHOLD`` lowered and ``--specific_sample 0``
    (the host-summed logits within 1e-5 × scale of the device-summed ones,
    the same mask, the NIfTIs read back at the label's shape); one
    96 × 96 × 80 case on the card and through ``run_inference(...,
    device="cpu")`` (masks equal but where the CPU's top-2 margin is below
    1e-4, metrics within 1e-4); U-RWKV on that case (K6 6 launches), and
    Hecktor (``models_config_hecktor2022.json``) and BraTS
    (``models_config_brats2021.json``) on one one-tile case each. Every
    CSV has the JAX package's columns and every dice lies in [0, 1].
14. the training CLI (``veloxseg_torch.cli.train_main.main`` →
    ``train/trainer.run_train``) over 10 synthetic 112×112×104 AutoPET-II
    cases (6 train, 2 val, 2 test) with ``config/models_config_autopetii.json``
    and ``config/train_config_bs4.json`` as published but for the dataset
    paths, ``epochs`` (2), ``val_interval`` and ``save_model_interval`` (1)
    and the save and log paths: 2 epochs of 3 steps (B = 4: ``batch_size``
    2 × ``num_samples`` 2) with validation and checkpoints each; counts
    zeroed before, read after: the bf16 forms of K2f, K2b, K4f, K4b and its
    wgrad per step must be phase 6's, K1, K4f and K5f per validation batch
    (fp32) phase 4's per forward (phase 3 also times K2 and the JLC blocks
    at B = 4). Per epoch,
    beside the card's name and power limit, a smoke reading (3 steps, so
    the first batch, checkpoints and validation weigh heavily): s, steps,
    the median step's stream span (CUDA events: the host's issue of the
    step or the device's work, whichever ends later), the loader wait,
    patches/s, validation s and checkpoint-write s; and which NIfTI reader
    and rotation ran. Then: resume from ``0.pth`` (epoch 1 at the
    scheduler's learning rate, the optimizer's step count 3 → 6); serve
    the run's ``val_best.pth`` with ``cli.test_main`` on the 2 test cases;
    one epoch from ``0.pth`` with every dropout 0 and the steps forced to
    fp32 on the card and through ``run_train(..., device="cpu")`` (phase 8
    holds the bf16 step card against CPU): losses within 1e-4 relative, epoch
    dice within 2e-3, weights element by element within 0.25·lr where the
    CPU's gradient is real and 2·3·lr·1.1 where it is rounding noise.
    Last, the steady run: 60 cases (links to the 10), 2 epochs of 18
    steps with the published intervals (no validation), launches per step
    phase 6's, the split of each epoch and its patches/s after the first
    batch, the trainer's own device ms per step and idle share from its
    ``profile_dir`` trace (steps 3-12), and the step outside the trainer,
    alone and beside a thread that drains the warm loader.
16. (run before 15) the speed CLI (``veloxseg_torch.cli.speed_main.main``
    → the bf16 eval forward): VeloxSeg and U-RWKV on AutoPET-II, VeloxSeg
    on Hecktor2022 and BraTS2021, with ``T_TIMED`` cut to
    ``SPEED_T_TIMED``; counts zeroed before each run and read after: the
    bf16 forms of K1, K4f and K5f (and K6 with U-RWKV) launched, no fp32
    form; per model images/s, batch size, Params and FLOPS. The operations
    per image at AutoPET-II's full shape, counted on the card (the kernels
    report theirs) and on the CPU (the plain versions), must be equal.
17. (run before 15) the export CLI (``veloxseg_torch.cli.export_main.main``
    → ``infer/export.py``): the AutoPET-II model at its published width
    with seeded weights saved as ``val_best.pth``, exported on the card
    with a symbolic batch (traced under the portable scope: no kernel
    launches); the artifact loaded in a process that imports only
    ``torch`` and run on seeded 96³ tiles at B = 1 and B = 3 (a batch never
    named at export), held to the live eval forward (the kernels) within
    phase 4's card-against-CPU tolerance; the export s, the artifact's MB
    and the loaded program's B = 1 forward ms beside the live forward's.
18. (run before 15) ``preprocess_main normalize-ctpet`` over two of
    phase 13's synthetic AutoPET-II cases (its generator, written at a
    spacing unlike the training spacing), then ``extern_main`` on the card
    over their normalized PET volumes (3-D, one channel, resampled to
    ``spacing.AutoPETII`` so that each spans two tiles on every axis) with
    the AutoPET-II model, and with ``--normalize_intensity 1`` over two
    4-channel MSD-style cases with the BraTS2021 model, both at published
    widths; counts zeroed before and read after (K1, K4f and K5f
    launched); each run again with ``--device cpu``, held by phase 13's
    rule (logits within 1e-5 of the CPU's scale, masks equal but where the
    CPU's top-2 margin is below 1e-4, metrics within 1e-4); s per case
    split into read, resample (or z-score), window and metrics.
19. (run before 15) the zoo: the eight baselines of the registry (UNet,
    VNet, MedNeXt, UNETR, SwinUNETR, SegFormer, SlimUNETR, UNETRpp) at
    their published AutoPET-II configs with seeded weights: each one's
    eval forward of a seeded (1, 96, 96, 96, 2) batch (``ZOO_BATCH``; 2
    until phase 22 came) on the card against
    the CPU in fp32 (phase 4's tolerance, 1e-4 of the scale, or 4× the
    card forward's own movement under a 1e-7 relative input change where
    that is larger: SegFormer's softmax is steep) and in bf16 (the card's
    against the CPU's fp32 forward, 0.5-1.5 of the CPU's own bf16-to-fp32
    distance: ``ZOO_BF16_MAX``), with no kernel of the port launched;
    ``speed_main`` over the eight at AutoPET-II's shape
    (``ZOO_SPEED_DATASETS``; the three until phase 21 came) (images/s,
    batch, Params, GFLOPs per image; ``ZOO_SPEED_T_TIMED``, probes of
    ``ZOO_PROBE_ITERS``), and the serving CLI on SwinUNETR from a ``.pth``
    the port wrote over one 96 × 96 × 80 synthetic case, card against
    ``run_inference(..., device="cpu")`` by phase 13's rule, and each
    device's float64 forward of the model it served on the case (the
    raw tiles within 1e-10 of the scale: ``compare_rows``'s ``ref64``).
20. (run before 15) the same for the seven that close the zoo (VSmTrans,
    NestedFormer, A2FSeg, HDense, SuperLightNet, U-KAN, HCMA-UNet with
    its selective scan): the forwards card vs CPU in fp32 and bf16 (HCMA-
    UNet's 2-channel LayerNorms make it ill-conditioned: held within 4×
    the card's movement), ``speed_main`` over the seven at AutoPET-II's
    shape (at the three until phase 21 came, NestedFormer reported as
    skipped at Hecktor's, where its window does not divide its bottleneck:
    ``ZOO_CANNOT``), and
    the serving CLI on HCMA-UNet, held as phase [19] holds SwinUNETR:
    its float64 tiles card vs CPU within 1e-10 of the scale; its fp32
    logits, where 4× the CPU's own fp32 distance from float64 exceeds
    phase 13's 1e-5 of the scale (HCMA-UNet's case: 2.0e-2 on 42.4),
    against the CPU's float64 logits within that 4× (``compare_rows``).
21. zoo training (its train steps card vs CPU run right after phase 2,
    the rest before 15). K6b (``ops/wkv.wkv_bwd``, the WKV
    backward) against ``wkv_bwd_plain`` on the card at U-RWKV's train
    shapes, (4, 216, 128) (AutoPET-II, BraTS) and (4, 256, 128) (Hecktor),
    fp32, with ``w = decay / T`` (both signs) and a seeded ±1 ``w``: each
    output within 1e-4 of its scale and bit for bit on repeat; event and
    device ms, the bound, and the torch-op route (autograd through
    ``wkv_chunked_plain``, its backward) beside it. Then each of U-RWKV,
    UNet, MedNeXt, SwinUNETR and U-KAN: one train step at 64³, B = 2
    (U-KAN 4), card against CPU in fp32 (the loss within 1e-5; every
    gradient within phase [8]'s rule plus 4x the CPU's own fp32 distance
    from the float64 step: ``zoo_grads_close``; the float64 step, the
    model, input and loss in float64, runs on the card, U-RWKV's on the
    CPU, and U-KAN's on both, within 1e-10 of each gradient's scale) and
    in bf16
    (``STEP_BOUND`` against the CPU's bf16 step, which must repeat bit for
    bit, its convolutions' backward in fp32 on the bf16 operands; the loss
    term dropped where the CPU's bf16 loss lies within 1e-5 of its fp32
    loss); U-RWKV's card steps launch K6 and K6b 6 times each.
    Then ``cli.train_main`` at the
    published AutoPET-II configs (96³, 4 patches a step, bf16) over 30
    synthetic cases (links to 10): U-RWKV 2 epochs with validation and
    checkpoints, K6b 6 and K6 6 launches a step (K6 6 a validation batch),
    resumed from ``0.pth``, its ``val_best.pth`` served by
    ``cli.test_main``; the four others one epoch each. Per run the median
    step's stream span, the trace's device ms per step and idle share, and
    peak memory.
22. zoo training, part two (its train steps card vs CPU run after [21]'s,
    the rest after [21]). The seven that draw in training (VNet, UNETR,
    SlimUNETR, NestedFormer, SuperLightNet, HCMA-UNet) and SegFormer: one
    train step card against CPU as [21]'s, in factor mode (the dropouts
    ``x · (1 + rate)``, SuperLightNet's block i folding direction i mod 3:
    ``factor_mode``), each bound also allowing 4x the card's own movement
    under a 1e-7 input change, at the smallest size where that holds
    (``ZOO_TRAIN_DROPOUT_SIZE``, ``tools/zoo_train_sizes.py``). Then real
    dropout: a bf16 step of VNet and of HCMA-UNet at their published rates
    from a CUDA generator, its masks, loss and gradients bit for bit on a
    repeat from the same seed, other masks under another, each site's keep
    fraction within 4σ. Then ``cli.train_main`` at the published
    AutoPET-II configs on VNet, SuperLightNet and HCMA-UNet, one epoch
    each, as [21] runs its four: the median step's stream span, the
    trace's device ms per step and idle share, peak memory.
15. print the seconds of each phase, one ``{"kernels": [...]}`` line (a
    row per kernel and per bf16 form, with ``excess_ms``, each path's
    launches × (ms − bound) per call at that path's own shapes, summed),
    the card line, and last ``{"ok": true, "device": {...}}``.

Details go to ``<out>/chip_smoke.json`` (``--out``, default ``runs``).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import json
import math
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "tools"))
# the timers, the card query and the bounds, shared with the bench tools
from chip_measure import (FORWARD_BOUND, HBM_BYTES_PER_S,  # noqa: E402
                          STEP_BOUND, bound, card as card_line, cuda_ms,
                          device_ms,
                          eval_attention_work, eval_attention_work_bf16,
                          forward_distances, ops_ms, sdpa_backend,
                          stage2_bwd_work, stage2_bwd_work_bf16,
                          stage2_fwd_work, stage2_fwd_work_bf16,
                          step_bound_violations, step_distances,
                          train_attention_work, train_attention_work_bf16,
                          wkv_bwd_work, wkv_work)


# the speed CLI's timing in phase 16: three windows of 1 s (the CLI's own
# default is 12 s, three of 4)
SPEED_T_TIMED = 3.0
# and in phases 19 and 20, where a zoo model's B = 16 forward takes up to
# 0.8 s: three windows of 0.5 s, each window's probe of 2 + 2 dispatches
# (the CLI's 20 + 20 took 680 s for the 24 runs; 3 s and 3 + 3 until
# phase 22 came)
ZOO_SPEED_T_TIMED = 1.5
ZOO_PROBE_ITERS = 2
# the dataset shapes of phases 19 and 20's speed runs: AutoPET-II's alone
# since phase 21 came (the three took ~180 s of each phase; the Hecktor and
# BraTS figures measured before stand in PERF.md)
ZOO_SPEED_DATASETS = ("AutoPETII",)


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
    import torch
    raw = t.detach().cpu().contiguous().view(torch.uint8)  # bf16 included
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def require_close(name, got, ref, atol, rtol):
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} values differ beyond atol {atol} "
            f"rtol {rtol}; max abs err {max_err(got, ref)[0]:.3e}")


def bf16_ulps(got, ref):
    """Elementwise distance of two bf16 tensors in units in the last place
    (adjacent bf16 values 1 apart, +0 and −0 equal)."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        mag = i & 0x7FFF
        return torch.where(i < 0, -mag, mag)
    return (key(got) - key(ref)).abs()


def require_bf16_match(name, got, ref):
    """A bf16 form against its bf16 plain version, by the rule the CPU tests
    hold the plain versions to against the Pallas kernels
    (``tests/torch_port_helpers.assert_bf16_match``): at least 99% of the
    elements bit for bit equal, every other within 1 bf16 ulp but at most
    0.1% of them, which may be further apart (a sum that cancels near 0, a
    flip of a value rounded inside the function) within 2^-8 of the
    tensor's largest magnitude. Returns (max abs err, share bit-equal)."""
    import torch
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: {got.dtype} vs {ref.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    d = bf16_ulps(got, ref)
    equal = float((d == 0).double().mean())
    far = d > 1
    diff = (got.double() - ref.double()).abs()
    gap = float(diff[far].max()) if bool(far.any()) else 0.0
    floor = 2.0 ** -8 * float(ref.double().abs().max())
    if not (equal >= 0.99 and float(far.double().mean()) <= 1e-3
            and gap <= floor):
        raise AssertionError(f"{name}: {equal:.4%} bit-equal, "
                             f"{int(far.sum())} elements more than 1 ulp "
                             f"apart by up to {gap:.3e} (floor {floor:.3e})")
    return max_err(got.float(), ref.float()), equal


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


# -- phase 13's synthetic cases and its CLI runs ----------------------------

BINARY_COLUMNS = ["name", "fp_rate", "fn_rate", "precision", "recall", "f1",
                  "iou", "dice", "time", "hd95"]
BRATS_COLUMNS = ["name", "dice_avg", "dice_et", "dice_tc", "dice_wt", "time",
                 "hd95_avg", "hd95_et", "hd95_tc", "hd95_wt"]
LOG_SPLIT = re.compile(
    r"(\S+): .* \| s: read ([\d.]+) window ([\d.]+) argmax ([\d.]+) "
    r"metrics ([\d.]+) hd95 ([\d.]+)")


def blob_volume(rng, shape, n_blobs=2):
    """``tests/make_fixtures.py``'s synthetic case: noise with ellipsoid
    lesions (+2.0) and their binary label."""
    import numpy as np
    vol = rng.standard_normal(shape).astype(np.float32) * 0.1
    label = np.zeros(shape, dtype=np.int16)
    zz, yy, xx = np.ogrid[tuple(slice(0, s) for s in shape)]
    for _ in range(n_blobs):
        c = [rng.integers(s // 4, 3 * s // 4) for s in shape]
        r = rng.integers(3, max(4, min(shape) // 6))
        mask = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 +
                (xx - c[2]) ** 2) < r ** 2
        vol[mask] += 2.0
        label[mask] = 1
    return vol, label


def write_cases(root, dataset, shape, n, seed, spacing=(1.0, 1.0, 1.0)):
    """``n`` synthetic cases of ``dataset`` as ``tests/make_fixtures.py``
    lays them out, written by the port's ``save_nifti``; returns the train
    config's ``dataset_path`` globs, keyed as the driver reads them."""
    import numpy as np
    from veloxseg_torch.data.nifti import save_nifti
    from veloxseg_torch.train.trainer import PROFILES
    profile = PROFILES[dataset]
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for i in range(n):
        vol, label = blob_volume(rng, shape)
        if not profile.binary_label:
            # classes 2 and 3 carved out of the lesions, as the fixtures do
            idx = np.argwhere(label > 0)
            third = max(len(idx) // 3, 1)
            for cls, sl in ((2, slice(third, 2 * third)),
                            (3, slice(2 * third, None))):
                sel = idx[sl]
                label[sel[:, 0], sel[:, 1], sel[:, 2]] = cls
            images = [vol + rng.standard_normal(shape).astype(np.float32)
                      * 0.1 for _ in profile.modality_names]
        else:
            # (ct, pet); float32, as the volumes are read: the fixtures'
            # float64 CT takes zlib tens of times longer to write at 192³
            ct = (rng.standard_normal(shape).astype(np.float32) * 0.2
                  + label.astype(np.float32) * 1.5)
            images = [ct, vol]
        for mod, img in zip(profile.modality_names, images):
            save_nifti(os.path.join(root, f"case{i:03d}_{mod}.nii.gz"), img,
                       spacing)
        save_nifti(os.path.join(root, f"case{i:03d}.nii.gz"), label,
                   spacing)
    globs = {key: os.path.join(root, f"case*_{mod}.nii.gz")
             for key, mod in zip(profile.glob_keys, profile.modality_names)}
    globs["label_path"] = os.path.join(root, "case???.nii.gz")
    return globs


def read_csv(path):
    """(header, rows as dicts of str) of a metrics CSV."""
    import csv
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], [dict(zip(rows[0], r)) for r in rows[1:]]


def check_csv(path, columns, n_rows):
    """The JAX columns in the JAX order, ``n_rows`` rows, every dice in
    [0, 1]."""
    header, rows = read_csv(path)
    if header != columns or len(rows) != n_rows:
        raise AssertionError(f"{path}: columns {header}, {len(rows)} rows; "
                             f"want {columns}, {n_rows} rows")
    for row in rows:
        for c in columns:
            if c.startswith("dice") and not 0.0 <= float(row[c]) <= 1.0:
                raise AssertionError(f"{path}: {c} = {row[c]}")
    return rows


def compare_rows(what, card_lg, cpu_lg, card_row, cpu_row, columns,
                 ref64=None):
    """Card against CPU on one case: its blended logits within 1e-5 of the
    CPU's scale, masks equal except where the CPU's top-2 margin is below
    1e-4, the CSV's metrics within 1e-4 and HD95 within 1e-4 relative
    where the masks agree (NaN on both or neither). With ``ref64`` (each
    device's float64 forward of the model it served, on the same case: the
    raw tiles and the blended logits), the two float64 forwards' tiles
    must agree within 1e-10 of the scale; and where 4× the CPU's own fp32
    logits' distance from its float64 ones exceeds that 1e-5 (a forward so
    ill-conditioned on this case that no two fp32 forwards of it meet
    phase 13's bound), the card's fp32 logits are held to the CPU's
    float64 ones within that 4×, and a flipped voxel's float64 top-2
    margin within twice it (the card's own error widens neither).
    Returns the numbers."""
    import math

    import numpy as np
    scale = float(np.abs(cpu_lg).max())
    ref, tol, margin_tol = cpu_lg, 1e-5 * scale, 1e-4
    err64 = own = None
    if ref64 is not None:
        (card_tiles, cpu_tiles), cpu64 = ref64
        err64 = float(np.abs(card_tiles - cpu_tiles).max())
        if not err64 <= 1e-10 * scale:
            raise AssertionError(f"{what} card vs CPU in float64: tiles err "
                                 f"{err64:.3e} on scale {scale:.3e}")
        own = float(np.abs(cpu_lg - cpu64).max())
        if 4 * own > tol:
            ref, tol = cpu64, 4 * own
            margin_tol = 2 * tol
    logit_err = float(np.abs(card_lg - ref).max())
    top2 = np.sort(ref, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    flips = np.argmax(card_lg, -1) != np.argmax(cpu_lg, -1)
    if not logit_err <= tol:
        raise AssertionError(f"{what} card vs CPU: logits err "
                             f"{logit_err:.3e} on scale {scale:.3e}, tol "
                             f"{tol:.3e}")
    if not (margin[flips] < margin_tol).all():
        raise AssertionError(f"{what} card vs CPU: {int(flips.sum())} voxels "
                             f"differ, margins up to "
                             f"{margin[flips].max():.3e}")
    metric_err = 0.0
    for c in columns[1:]:
        if c == "time" or (c.startswith("hd95") and flips.any()):
            continue
        a, b = float(card_row[c] or "nan"), float(cpu_row[c])
        if math.isnan(a) or math.isnan(b):
            if math.isnan(a) != math.isnan(b):
                raise AssertionError(f"{what} card vs CPU: {c} {a} vs {b}")
            continue
        if not abs(a - b) <= (1e-4 * abs(b) if c.startswith("hd95")
                              else 1e-4):
            raise AssertionError(f"{what} card vs CPU: {c} {a} vs {b}")
        if not c.startswith("hd95"):
            metric_err = max(metric_err, abs(a - b))
    return dict(logit_err=logit_err, scale=scale, tol=tol, err64=err64,
                own=own, float64_rule=ref is not cpu_lg,
                flips=int(flips.sum()), metric_err=metric_err)


def serving_cli_phase(card, zero_counts, counts, serving, configs, patches,
                      spacing, big=192, small=(96, 96, 80),
                      hecktor=(120, 128, 60), brats=(90, 96, 80)):
    """Phase 13: ``veloxseg_torch.cli.test_main.main`` on the card over
    synthetic NIfTI cases (``write_cases``) with seeded weights saved as
    ``val_best.pth``: AutoPET-II VeloxSeg (``configs``: each dataset's
    models config) over two ``big``³ cases with HD95, timed per part from
    the driver's log; both again with the host-summed window; one
    one-tile case each of AutoPET-II (``small``), Hecktor and BraTS on the
    card and through ``run_inference(..., device="cpu")``; ``--specific_sample
    0`` on the AutoPET-II one; U-RWKV on it too. Checks fail the run.
    Returns the report, with the launch counts of the AutoPET-II run
    (``launches``) and of each other run (``other[key]["launches"]``)."""
    import tempfile

    import numpy as np
    import torch

    from veloxseg_torch.cli.test_main import build_parser
    from veloxseg_torch.cli.test_main import main as serve_main
    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.data.nifti import load_nifti
    from veloxseg_torch.infer import driver
    from veloxseg_torch.models.registry import load_model
    from veloxseg_torch.train.trainer import PROFILES

    t13 = time.perf_counter()
    recorded = []                 # (host-summed?, blended logits) per case
    window = driver.sliding_window_inference

    def recording(*a, **kw):
        out = window(*a, **kw)
        recorded.append((bool(kw.get("cpu_accumulate")), out))
        return out

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        cases = {
            "autopet_big": ("AutoPETII", write_cases(
                os.path.join(work, "autopet_big"), "AutoPETII", (big,) * 3,
                2, seed=40, spacing=spacing)),
            "autopet_small": ("AutoPETII", write_cases(
                os.path.join(work, "autopet_small"), "AutoPETII", small,
                1, seed=41, spacing=spacing)),
            "hecktor": ("Hecktor2022", write_cases(
                os.path.join(work, "hecktor"), "Hecktor2022", hecktor,
                1, seed=42)),
            "brats": ("BraTS2021", write_cases(
                os.path.join(work, "brats"), "BraTS2021", brats, 1,
                seed=43))}
        steps = {"write_cases": time.perf_counter() - t0}
        t0 = time.perf_counter()
        # seeded weights at the published widths, saved as the reference
        # trainer saves them
        ckpts = {}
        for key, dataset, model_name, seed in (
                ("autopet", "AutoPETII", "VeloxSeg", 3),
                ("urwkv", "AutoPETII", "U-RWKV", 4),
                ("hecktor", "Hecktor2022", "VeloxSeg", 5),
                ("brats", "BraTS2021", "VeloxSeg", 6)):
            ckpts[key] = os.path.join(work, "ckpt", key)
            os.makedirs(ckpts[key])
            weights = load_model(model_name, load_json_config(
                configs[dataset]), device="cpu", seed=seed).state_dict()
            torch.save(weights, os.path.join(ckpts[key], "val_best.pth"))
        steps["weights"] = time.perf_counter() - t0

        def argv(name, model_name, ckpt, *extra):
            """The CLI's flags for the cases ``name`` (its train and test
            configs written here, its results under ``work/name``)."""
            dataset, globs = cases[name]
            base = os.path.join(work, "out", name)
            os.makedirs(base, exist_ok=True)
            for fname, cfg in (
                    ("train.json", {"patch_size": {dataset: patches[dataset]},
                                    "train_rate": 0, "val_rate": 0,
                                    "dataset_path": {dataset: globs}}),
                    ("test.json", {"result_metric_path":
                                   os.path.join(base, "metric"),
                                   "result_pred_path":
                                   os.path.join(base, "prediction"),
                                   "sliding_window": {"overlap": 0.25}})):
                with open(os.path.join(base, fname), "w") as f:
                    json.dump(cfg, f)
            return ["--dataset_name", dataset, "--model_name", model_name,
                    "--model_config", configs[dataset],
                    "--train_config", os.path.join(base, "train.json"),
                    "--test_config", os.path.join(base, "test.json"),
                    "--checkpoint_dir", ckpts[ckpt], *extra]

        def csv_of(name, model_name):
            return os.path.join(work, "out", name, "metric",
                                f"{cases[name][0]}_{model_name}.csv")

        def timed(run_argv):
            """One CLI call on the card: (seconds, launch counts)."""
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            serve_main(run_argv)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, counts()

        driver.sliding_window_inference = recording
        try:
            # AutoPET-II at full width, two big cases, HD95 (the main path)
            recorded.clear()
            cli_s, cli_launches = timed(argv("autopet_big", "VeloxSeg",
                                             "autopet", "--use_hd95", "1"))
            steps["main_run"] = cli_s
            main_logits = [lg for _, lg in recorded]
            rows = check_csv(csv_of("autopet_big", "VeloxSeg"),
                             BINARY_COLUMNS, 2)
            missing = [n for n in serving if cli_launches[n] <= 0]
            if missing or len(main_logits) != 2:
                raise AssertionError(f"serving CLI: kernels not launched "
                                     f"{missing}, {len(main_logits)} cases")
            log = os.path.join(work, "out", "autopet_big", "metric",
                               "test_AutoPETII_VeloxSeg.log")
            with open(log) as f:
                splits = [m.groups() for m in LOG_SPLIT.finditer(f.read())]
            per_case = []
            for (name, *parts), row in zip(splits, rows):
                read_s, win_s, arg_s, met_s, hd_s = map(float, parts)
                per_case.append(dict(name=name, read_s=read_s,
                                     window_s=win_s, argmax_s=arg_s,
                                     metrics_s=met_s, hd95_s=hd_s,
                                     time_s=float(row["time"]),
                                     dice=float(row["dice"]),
                                     hd95=row["hd95"]))
                print(f"[13] {card} | {name} {big}³: read {read_s:.4f} s, "
                      f"window {win_s:.4f} s (synchronized), argmax "
                      f"{arg_s:.4f} s, metrics {met_s:.4f} s, HD95 "
                      f"{hd_s:.4f} s, time (read to prediction) "
                      f"{float(row['time']):.4f} s | dice "
                      f"{float(row['dice']):.4f} hd95 {row['hd95']}",
                      flush=True)
            if len(per_case) != 2:
                raise AssertionError(f"serving CLI: {len(per_case)} per-case "
                                     f"log lines in {log}")
            print(f"[13] serving CLI, AutoPET-II VeloxSeg at full width, "
                  f"2 cases of {big}³, --use_hd95 1: {cli_s:.3f} s end to end "
                  f"(model, checkpoint, CSV included), "
                  f"{2 / cli_s:.4f} volumes/s | launches "
                  f"{ {n: c for n, c in cli_launches.items() if c} } | "
                  f"writing the cases took {steps['write_cases']:.1f} s",
                  flush=True)

            # the host-summed window on both big cases
            t0 = time.perf_counter()
            recorded.clear()
            threshold = driver.CPU_STITCH_THRESHOLD
            driver.CPU_STITCH_THRESHOLD = big ** 3 - 1
            try:
                serve_main(argv("autopet_big", "VeloxSeg", "autopet"))
            finally:
                driver.CPU_STITCH_THRESHOLD = threshold
            scale = max(float(lg.abs().max()) for lg in main_logits)
            stitch_err = 0.0
            for (stitched, host_lg), dev_lg in zip(recorded, main_logits):
                stitch_err = max(stitch_err, float(
                    (host_lg - dev_lg).abs().max()))
                if not stitched or not torch.equal(
                        torch.argmax(host_lg[0], -1),
                        torch.argmax(dev_lg[0], -1)):
                    raise AssertionError(f"cpu_accumulate: ran {stitched}, "
                                         f"the masks differ")
            if len(recorded) != 2 or not stitch_err <= 1e-5 * scale:
                raise AssertionError(f"cpu_accumulate: {len(recorded)} cases,"
                                     f" logits err {stitch_err:.3e}")
            steps["host_summed"] = time.perf_counter() - t0
            print(f"[13] cpu_accumulate (threshold lowered) on both {big}³ "
                  f"cases: logits err {stitch_err:.3e} vs the device sums "
                  f"(tol 1e-5 x scale {scale:.3e}), masks identical "
                  f"({steps['host_summed']:.1f} s)", flush=True)

            # card against CPU: one one-tile case of each profile
            other = {}
            for key, name, columns in (
                    ("autopet", "autopet_small", BINARY_COLUMNS),
                    ("hecktor", "hecktor", BINARY_COLUMNS),
                    ("brats", "brats", BRATS_COLUMNS)):
                dataset = cases[name][0]
                recorded.clear()
                run_argv = argv(name, "VeloxSeg", key, "--use_hd95", "1",
                                "--sw_batch_size", "1")
                wall, got = timed(run_argv)
                if [n for n in serving if got[n] <= 0]:
                    raise AssertionError(f"{key} CLI launches {got}")
                card_row, = check_csv(csv_of(name, "VeloxSeg"), columns, 1)
                args = build_parser().parse_args(run_argv)
                with open(args.train_config) as f:
                    train_json = json.load(f)
                with open(args.test_config) as f:
                    test_json = json.load(f)
                t0 = time.perf_counter()
                cpu_row, = driver.run_inference(
                    args, train_json, load_json_config(configs[dataset]),
                    test_json, device="cpu")
                cpu_s = time.perf_counter() - t0
                (_, card_lg), (_, cpu_lg) = recorded
                shape = tuple(card_lg.shape)
                cmp = compare_rows(key, card_lg[0].cpu().numpy(),
                                   cpu_lg[0].numpy(), card_row, cpu_row,
                                   columns)
                other[key] = dict(wall_s=wall, cpu_s=cpu_s, launches=got,
                                  row=card_row, card_vs_cpu=cmp)
                steps[key] = wall + cpu_s
                print(f"[13] {key} card vs CPU ({dataset}, VeloxSeg at its "
                      f"published width, one case, logits {shape}): "
                      f"{wall:.3f} s card, {cpu_s:.3f} s CPU | launches "
                      f"{ {n: c for n, c in got.items() if c} } | logits max "
                      f"abs err {cmp['logit_err']:.3e} on scale "
                      f"{cmp['scale']:.3e} (tol 1e-5 x scale), "
                      f"{cmp['flips']} voxels differ (all with CPU top-2 "
                      f"margin < 1e-4), metrics max abs err "
                      f"{cmp['metric_err']:.3e} (tol 1e-4) | "
                      + ", ".join(f"{c} {card_row[c]}" for c in columns[1:]
                                  if c != "time"), flush=True)

            # --specific_sample 0 on the small AutoPET-II case
            t0 = time.perf_counter()
            recorded.clear()
            serve_main(argv("autopet_small", "VeloxSeg", "autopet",
                            "--specific_sample", "0", "--sw_batch_size",
                            "1"))
            (_, lg), = recorded
            pred_dir = os.path.join(work, "out", "autopet_small",
                                    "prediction")
            label = load_nifti(cases["autopet_small"][1]["label_path"]
                               .replace("???", "000"))
            saved = {k: load_nifti(os.path.join(
                pred_dir, f"case000_{k}.nii.gz"))
                for k in PROFILES["AutoPETII"].modality_names + ("pred",)}
            if any(v.shape != label.shape for v in saved.values()) \
                    or not np.array_equal(
                        saved["pred"].data,
                        torch.argmax(lg[0], -1).cpu().numpy()):
                raise AssertionError(
                    f"--specific_sample: shapes "
                    f"{ {k: v.shape for k, v in saved.items()} }, label "
                    f"{label.shape}, or the saved prediction is not the "
                    f"run's argmax")
            steps["specific_sample"] = time.perf_counter() - t0
            print(f"[13] --specific_sample 0 on the {small} case: NIfTIs "
                  f"{sorted(saved)} read back at {label.shape}, the "
                  f"prediction equal to the run's argmax "
                  f"({steps['specific_sample']:.1f} s)", flush=True)

            # U-RWKV on the small case
            wall, got = timed(argv("autopet_small", "U-RWKV", "urwkv",
                                   "--use_hd95", "1"))
            if got["wkv"] <= 0:
                raise AssertionError(f"urwkv CLI launches {got}")
            row, = check_csv(csv_of("autopet_small", "U-RWKV"),
                             BINARY_COLUMNS, 1)
            steps["urwkv"] = wall
            other["urwkv"] = dict(wall_s=wall, launches=got, row=row)
            print(f"[13] urwkv via the CLI (AutoPETII, U-RWKV, one case): "
                  f"{wall:.3f} s | launches "
                  f"{ {n: c for n, c in got.items() if c} } | "
                  + ", ".join(f"{c} {row[c]}" for c in BINARY_COLUMNS[1:]
                              if c != "time"), flush=True)
        finally:
            driver.sliding_window_inference = window
    return dict(
        wall_s=cli_s, volumes_per_s=2 / cli_s, per_case=per_case,
        launches=cli_launches, steps_s=steps, stitch_err=stitch_err,
        other=other, phase_s=time.perf_counter() - t13)


# -- phase 14's training CLI runs --------------------------------------------

TRAIN_SPLIT = re.compile(
    r"epoch (\d+) split: ([\d.]+) s \| steps (\d+), step median ([\d.]+) "
    r"ms \(([^)]*)\), loop ([\d.]+) s, loader wait ([\d.]+) s \(first "
    r"batch ([\d.]+) s\), ([\d.]+) patches/s \| checkpoints ([\d.]+) s \| "
    r"validation ([\d.]+) s \((\d+) batches\)")


def train_weights_close(what, got, ref, grad_max, lr, steps):
    """Card against CPU weights after ``steps`` AdamW steps from one
    checkpoint, element by element, split by the CPU run's gradients
    (``grad_max``: per key, each element's largest |gradient| over the
    steps), as ``tests/torch_port_helpers.assert_adamw_weights_close``
    holds the port against JAX: Adam scales a gradient of rounding noise
    up to a step of up to lr either way on each side, so a noise element
    is held to 2·steps·lr·1.1 and every other element to 0.25·lr. Noise:
    every element of a tensor whose gradient is at most 1e-5 of the
    model's largest, and in the other tensors each element whose gradient
    is at most 1e-4 of its tensor's largest (phase [8]'s relative
    gradient tolerance). Returns (max abs err over real elements, over
    noise elements, the share of real elements)."""
    import torch
    g_all = max(float(g.max()) for g in grad_max.values())
    worst = {True: 0.0, False: 0.0}
    n_real = n_all = 0
    for k, r in ref.items():
        err = (got[k].cpu().double() - r.double()).abs()
        g = grad_max.get(k)
        if g is None:       # a buffer: never updated
            if float(err.max()) != 0.0:
                raise AssertionError(f"{what}: buffer {k} differs")
            continue
        g = g.double()
        g_max = float(g.max())
        noise = (torch.ones_like(g, dtype=torch.bool)
                 if g_max <= 1e-5 * g_all else g <= 1e-4 * g_max)
        bound_ = torch.where(noise, 2.0 * steps * lr * 1.1, 0.25 * lr)
        if not bool((err <= bound_).all()):
            i = int((err - bound_).argmax())
            raise AssertionError(
                f"{what}: weight {k} element {i} differs by "
                f"{float(err.flatten()[i]):.3e} > "
                f"{float(bound_.flatten()[i]):.3e} (its CPU gradient "
                f"{float(g.flatten()[i]):.3e}, the tensor's largest "
                f"{g_max:.3e})")
        for is_noise in (True, False):
            sel = err[noise] if is_noise else err[~noise]
            if sel.numel():
                worst[is_noise] = max(worst[is_noise], float(sel.max()))
        n_real += int((~noise).sum())
        n_all += noise.numel()
    return worst[False], worst[True], n_real / n_all


def split_lines(log):
    """The trainer log's per-epoch ``split:`` lines as dicts."""
    keys = ("epoch", "epoch_s", "steps", "step_median_ms", "timer",
            "loop_s", "loader_wait_s", "first_wait_s", "patches_per_s",
            "checkpoint_s", "val_s", "val_batches")
    out = []
    for m in TRAIN_SPLIT.findall(log):
        e = dict(zip(keys, m))
        for k in keys:
            if k != "timer":
                e[k] = (int(e[k]) if k in ("epoch", "steps", "val_batches")
                        else float(e[k]))
        # patches/s over the loop but the first batch's wait, 4 a step
        e["steady_patches_per_s"] = 4 * e["steps"] / (
            e["loop_s"] - e["first_wait_s"])
        out.append(e)
    return out


def step_spans(step, state, batches, gen, n=12):
    """Median stream span (CUDA events, as the trainer's step timer) and
    median host ms of issuing ``step`` over the last n − 2 of n steps."""
    import statistics

    import torch
    spans, hosts = [], []
    for i in range(n):
        x, y = batches[i % len(batches)]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, _ = step(state, x, y, gen)
        b.record()
        hosts.append((time.perf_counter() - t0) * 1e3)
        b.synchronize()
        spans.append(a.elapsed_time(b))
    return statistics.median(spans[2:]), statistics.median(hosts[2:])


def trainer_steady_run(card, zero_counts, counts, per_step, work, published,
                       model_config_path, src_globs, n_src, n_cases=60):
    """Phase 14's epochs at a length where the per-epoch costs are minor:
    ``n_cases`` AutoPET-II cases (links to the ``n_src`` written ones, so
    36 train cases: 18 steps an epoch; 100 and 30 until phase 22 came, a
    depth cut to keep the script in its time) with the published configs
    but for
    the dataset paths, 2 epochs, the save and log paths and
    ``profile_dir`` (a trace of steps 3-12 of epoch 1); validation and the
    periodic checkpoint every 5 epochs as published, so neither runs.
    Epoch 2 reads the warm cache: the steady state. From the trace, the
    step's device ms and idle share inside the trainer. Then the same step
    outside the trainer on the run's weights, alone and beside a thread
    that drains a warm-cache copy of the train loader without pause: its
    stream span and host issue ms, to show whether the loader's threads
    slow the host's issue of the step."""
    import threading

    import torch

    from veloxseg_torch.cli.train_main import main as train_main
    from veloxseg_torch.data.dataset import (PatchLoader,
                                             SegmentationDataset,
                                             default_train_transform)
    from veloxseg_torch.data.prefetch import device_put
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.train_state import train_step_fn
    from veloxseg_torch.utils.runtime import rotation_range_from_degrees
    from chip_measure import trace_split

    globs = linked_cases(src_globs, os.path.join(work, "steady_cases"),
                         n_src, n_cases)
    trace_dir = os.path.join(work, "steady", "trace")
    cfg = dict(published, dataset_path={"AutoPETII": globs}, epochs=2,
               save_path=os.path.join(work, "steady", "save"),
               log_path=os.path.join(work, "steady", "logs"),
               profile_dir=trace_dir)
    path = os.path.join(work, "steady.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    changed = sorted(k for k in cfg if cfg[k] != published.get(k))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    res = train_main(["--dataset_name", "AutoPETII", "--model_name",
                      "VeloxSeg", "--model_config", model_config_path,
                      "--train_config", path])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counts()
    date = os.path.basename(res["save_path"])
    with open(os.path.join(cfg["log_path"],
                           f"AutoPETII_VeloxSeg_{date}.log")) as f:
        epochs = split_lines(f.read())
    n_steps = sum(e["steps"] for e in epochs)
    per_epoch = int(published["train_rate"] * n_cases) // 2
    if len(epochs) != 2 or n_steps != 2 * per_epoch or any(
            e["val_batches"] for e in epochs):
        raise AssertionError(f"steady trainer run: epochs {epochs}")
    want = {n: n_steps * per_step.get(n, 0) for n in launches}
    if launches != want:
        raise AssertionError(f"steady trainer run launches {launches}, "
                             f"want {n_steps} x phase 6's {per_step}")
    tr = trace_split(trace_dir)
    if tr["steps"] != 10:
        raise AssertionError(f"steady trainer trace: {tr}")
    tr_step = dict(device_ms=tr["device_ms"] / 10,
                   wall_ms=tr["wall_ms"] / 10,
                   idle_share=1 - tr["device_ms"] / tr["wall_ms"],
                   device_ops=tr["device_ops"] / 10)
    for e in epochs:
        print(f"[14] {card} | steady run epoch {e['epoch']}: "
              f"{e['epoch_s']:.4f} s, {e['steps']} steps of 4 patches 96³,"
              f" step median {e['step_median_ms']:.3f} ms ({e['timer']}),"
              f" loop {e['loop_s']:.4f} s, loader wait "
              f"{e['loader_wait_s']:.4f} s (first batch "
              f"{e['first_wait_s']:.4f} s), {e['patches_per_s']:.3f} "
              f"patches/s, {e['steady_patches_per_s']:.3f} patches/s after "
              f"the first batch, checkpoint writes {e['checkpoint_s']:.4f} "
              f"s", flush=True)
    print(f"[14] {card} | steady run trace of steps 3-12 (epoch 1, under "
          f"the profiler): device {tr_step['device_ms']:.3f} ms/step, wall "
          f"{tr_step['wall_ms']:.3f} ms/step, idle share "
          f"{tr_step['idle_share']:.3f}, {tr_step['device_ops']:.0f} device "
          f"operations/step | changed: {', '.join(changed)} | launches = "
          f"{n_steps} steps x phase 6's per step | {run_s:.1f} s",
          flush=True)

    # the trainer's step outside the trainer, alone and beside the loader
    state = res["state"]
    del res
    dev = next(state.model.parameters()).device
    patterns = {"ct": globs["ct_path"], "pet": globs["pet_path"],
                "label": globs["label_path"]}
    train_files, _, _ = SegmentationDataset.from_globs(
        patterns, "AutoPETII").split(cfg["train_rate"], cfg["val_rate"])
    loader = PatchLoader(
        train_files, ("ct", "pet"), default_train_transform(
            cfg["patch_size"]["AutoPETII"], num_samples=2, rotate_prob=0.5,
            range_z=rotation_range_from_degrees(15),
            use_foreground_crop=True),
        batch_size=cfg["batch_size"], num_samples=2, num_workers=8,
        shuffle=True, binary_label=True, cache=True)
    stop = threading.Event()
    passes = []

    def drain():
        while not stop.is_set():
            for _ in loader:
                if stop.is_set():
                    break
            passes.append(time.perf_counter())

    try:
        batches = []
        for xy in loader:           # the first pass fills the cache
            if len(batches) < 2:
                batches.append(device_put(xy, dev))
        step = train_step_fn(CompositeLoss("VeloxSeg", cfg, num_modal=state.model.cfg.num_modalities), dev,
                             deep_metric_heads=True,
                             compute_dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(0)
        alone = step_spans(step, state, batches, gen)
        th = threading.Thread(target=drain)
        th.start()
        try:
            busy = step_spans(step, state, batches, gen)
        finally:
            stop.set()
            th.join()
    finally:
        loader.close()
    trainer_span = epochs[1]["step_median_ms"]
    print(f"[14] {card} | the step outside the trainer (B = 4, 10 steps): "
          f"alone stream span {alone[0]:.3f} ms, host issue {alone[1]:.3f}"
          f" ms | beside a thread draining the warm loader "
          f"({len(passes)} full passes): span {busy[0]:.3f} ms, host issue "
          f"{busy[1]:.3f} ms | in the trainer, epoch 2: span "
          f"{trainer_span:.3f} ms", flush=True)
    return dict(epochs=epochs, trace=tr_step, changed_keys=changed,
                run_s=run_s, alone=alone, beside_loader=busy,
                loader_passes=len(passes), trainer_span_ms=trainer_span)


def trainer_cli_phase(card, zero_counts, counts, per_step, per_forward,
                      model_config_path, train_config_path,
                      shape=(112, 112, 104), n_cases=10):
    """Phase 14: ``veloxseg_torch.cli.train_main.main`` on the card over
    ``n_cases`` synthetic AutoPET-II cases (``write_cases``; 6 train, 2
    val, 2 test), with the published model and train configs but for the
    keys it lists; 2 epochs with validation and checkpoints each; the
    launches of K2f, K2b, K4f, K4b (and its wgrad) per step must be phase
    6's, those of K1, K4f and K5f per validation batch phase 4's per
    forward. Then resume from ``0.pth`` (epoch, learning rate, optimizer
    step), serve ``val_best.pth`` through ``cli.test_main`` on the test
    split, and run one epoch from ``0.pth`` with every dropout at 0 on the
    card and through ``run_train(..., device="cpu")``: the same losses,
    epoch dice and final weights (tolerances printed). Returns the report
    with the main run's launches split into its steps and its validation
    (``launches_train``, ``launches_val``)."""
    import argparse
    import tempfile

    import torch

    from veloxseg_torch.cli.test_main import main as serve_main
    from veloxseg_torch.cli.train_main import main as train_main
    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.data.nifti_fast import native_status
    from veloxseg_torch.train import trainer
    from veloxseg_torch.train.optim import EpochScheduler

    t14 = time.perf_counter()
    published = load_json_config(train_config_path)
    models = load_json_config(model_config_path)
    steps = {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        globs = write_cases(os.path.join(work, "cases"), "AutoPETII", shape,
                            n_cases, seed=60,
                            spacing=tuple(published["spacing"]["AutoPETII"]))
        steps["write_cases"] = time.perf_counter() - t0

        def train_config(name, **over):
            """The published train config with the phase's changes."""
            cfg = dict(published, dataset_path={"AutoPETII": globs},
                       epochs=2, val_interval=1, save_model_interval=1,
                       save_path=os.path.join(work, name, "save"),
                       log_path=os.path.join(work, name, "logs"), **over)
            path = os.path.join(work, f"{name}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            return cfg, path
        main_cfg, main_json = train_config("main")
        changed = sorted(k for k in main_cfg if main_cfg[k] != published.get(
            k))
        argv = ["--dataset_name", "AutoPETII", "--model_name", "VeloxSeg",
                "--model_config", model_config_path, "--train_config",
                main_json]

        def log_of(res):
            date = os.path.basename(res["save_path"])
            with open(os.path.join(main_cfg["log_path"],
                                   f"AutoPETII_VeloxSeg_{date}.log")) as f:
                return f.read()

        # the main run: 2 epochs from seeded weights, on the card
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = train_main(argv)
        torch.cuda.synchronize()
        steps["main_run"] = time.perf_counter() - t0
        launches = counts()
        log = log_of(res)
        epochs = split_lines(log)
        n_steps = sum(e["steps"] for e in epochs)
        n_val = sum(e["val_batches"] for e in epochs)
        if len(epochs) != 2 or n_steps != 6 or n_val != 2:
            raise AssertionError(f"trainer CLI: epochs {epochs}")
        val_part = {n: n_val * per_forward.get(n, 0) for n in launches}
        train_part = {n: c - val_part[n] for n, c in launches.items()}
        want = {n: n_steps * per_step.get(n, 0) for n in launches}
        if train_part != want:
            raise AssertionError(f"trainer CLI launches {launches}: train "
                                 f"part {train_part}, want {n_steps} steps "
                                 f"x phase 6's {per_step}, plus {n_val} "
                                 f"validation batches x phase 4's "
                                 f"{per_forward}")
        files = sorted(f for f in os.listdir(res["save_path"])
                       if f.endswith(".pth"))
        if files != ["0.pth", "1.pth", "train_best.pth", "val_best.pth"]:
            raise AssertionError(f"trainer CLI checkpoints {files}")
        losses = [float(v) for v in re.findall(r"Training Loss:([\d.]+)",
                                               log)]
        if len(losses) != n_steps or not all(
                math.isfinite(v) for v in losses):
            raise AssertionError(f"trainer CLI losses {losses}")
        status = native_status()
        print(f"[14] {card} | {status}", flush=True)
        for e in epochs:    # 3 steps: a smoke reading, not an epoch's rate
            print(f"[14] {card} | smoke epoch {e['epoch']}: "
                  f"{e['epoch_s']:.4f} s, "
                  f"{e['steps']} steps of 4 patches 96³, step median "
                  f"{e['step_median_ms']:.3f} ms ({e['timer']}), loop "
                  f"{e['loop_s']:.4f} s, loader wait {e['loader_wait_s']:.4f}"
                  f" s (first batch {e['first_wait_s']:.4f} s), "
                  f"{e['patches_per_s']:.3f} patches/s, validation "
                  f"{e['val_s']:.4f} s ({e['val_batches']} batch), "
                  f"checkpoint writes {e['checkpoint_s']:.4f} s", flush=True)
        print(f"[14] training CLI (train_main, published AutoPET-II model "
              f"and train config; changed: {', '.join(changed)}): "
              f"{steps['main_run']:.3f} s for 2 epochs | losses "
              f"{losses[0]:.5f} ... {losses[-1]:.5f} | best train dice "
              f"{res['best_train_dice']:.4f} val {res['best_val_dice']:.4f}"
              f" | launches { {n: c for n, c in launches.items() if c} } = "
              f"{n_steps} steps x phase 6's per step + {n_val} validation "
              f"batches x phase 4's per forward | checkpoints {files}",
              flush=True)
        save_dir = res["save_path"]
        del res

        # resume from 0.pth: epoch 1 again, at its learning rate
        ckpt0 = os.path.join(save_dir, "0.pth")
        saved_step = float(torch.load(ckpt0, weights_only=True)[
            "optimizer"]["state"][0]["step"])
        t0 = time.perf_counter()
        res = train_main(argv + ["--checkpoint_path", ckpt0])
        torch.cuda.synchronize()
        steps["resume"] = time.perf_counter() - t0
        opt = res["state"].optimizer
        lr = opt.param_groups[0]["lr"]
        want_lr = EpochScheduler(main_cfg).learning_rate(1)
        step_now = float(opt.state_dict()["state"][0]["step"])
        if "Resumed from" not in log_of(res) or lr != want_lr \
                or saved_step != 3 or step_now != saved_step + 3:
            raise AssertionError(f"resume: lr {lr} (want {want_lr}), "
                                 f"optimizer step {saved_step} -> "
                                 f"{step_now}")
        print(f"[14] resumed from 0.pth at epoch 1: lr {lr:.3e} (the "
              f"scheduler's epoch-1 value), optimizer step {saved_step:.0f}"
              f" -> {step_now:.0f} ({steps['resume']:.1f} s)", flush=True)
        del res, opt

        # serve the run's val_best.pth on the test split
        test_json = os.path.join(work, "test.json")
        with open(test_json, "w") as f:
            json.dump({"result_metric_path": os.path.join(work, "metric"),
                       "sliding_window": {"overlap": 0.25}}, f)
        t0 = time.perf_counter()
        rows = serve_main(argv[:4] + ["--model_config", model_config_path,
                                      "--train_config", main_json,
                                      "--test_config", test_json,
                                      "--checkpoint_dir", save_dir])
        steps["serve"] = time.perf_counter() - t0
        n_test = n_cases - int((main_cfg["train_rate"]
                                + main_cfg["val_rate"]) * n_cases)
        check_csv(os.path.join(work, "metric", "AutoPETII_VeloxSeg.csv"),
                  BINARY_COLUMNS[:-1], n_test)
        dices = ", ".join(f"{r['dice']:.4f}" for r in rows)
        print(f"[14] val_best.pth served by cli.test_main on the "
              f"{len(rows)} test cases: dice {dices} "
              f"({steps['serve']:.1f} s)", flush=True)

        # card against CPU: one epoch from 0.pth, every dropout 0, the
        # steps forced to fp32 as tests/torch_port_helpers.run_both_trainers
        # forces them (a bf16 epoch on the CPU is slow; phase 8 holds the
        # bf16 step card against CPU)
        nodrop = dict(models, VeloxSeg=dict(
            models["VeloxSeg"], attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
            drop_path=0.0))
        recorded = {}
        grad_max = {}   # the CPU run's largest |gradient| per element
        step_fn = trainer.train_step_fn

        def recording(*a, **kw):
            inner = step_fn(*a, **dict(kw, compute_dtype=None))

            def step(state, x, y, gen):
                state, aux = inner(state, x, y, gen)
                recorded[key].append(aux["loss"])
                if key == "cpu":
                    for k, p in state.model.named_parameters():
                        if p.grad is None:
                            continue
                        g = p.grad.detach().abs()
                        grad_max[k] = (torch.maximum(grad_max[k], g)
                                       if k in grad_max else g.clone())
                return state, aux
            return step

        cmp = {}
        trainer.train_step_fn = recording
        try:
            for key in ("cuda", "cpu"):
                recorded[key] = []
                cfg, _ = train_config(f"cmp_{key}")
                args = argparse.Namespace(
                    dataset_name="AutoPETII", model_name="VeloxSeg",
                    checkpoint_path=ckpt0, num_workers=8, model_index=None,
                    select_modal=None)
                t0 = time.perf_counter()
                r = trainer.run_train(args, cfg, nodrop, device=key)
                steps[f"cmp_{key}"] = time.perf_counter() - t0
                cmp[key] = dict(
                    losses=[float(v) for v in recorded[key]],
                    train_dice=r["best_train_dice"],
                    val_dice=r["best_val_dice"],
                    weights={k: v.detach().cpu() for k, v in
                             r["state"].model.state_dict().items()})
                del r
        finally:
            trainer.train_step_fn = step_fn
        card_l, cpu_l = cmp["cuda"]["losses"], cmp["cpu"]["losses"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        if len(card_l) != 3 or len(cpu_l) != 3 or not loss_rel <= 1e-4:
            raise AssertionError(f"trainer card vs CPU losses {card_l} vs "
                                 f"{cpu_l}")
        dice_err = max(abs(cmp["cuda"][k] - cmp["cpu"][k])
                       for k in ("train_dice", "val_dice"))
        if not dice_err <= 2e-3:
            raise AssertionError(f"trainer card vs CPU dice {cmp}")
        w_err, w_noise, w_real = train_weights_close(
            "trainer card vs CPU", cmp["cuda"]["weights"],
            cmp["cpu"]["weights"], grad_max, want_lr, 3)
        print(f"[14] trainer card vs CPU (one epoch from 0.pth, dropout 0, "
              f"steps forced to fp32, 3 steps + validation): losses {[f'{v:.6f}' for v in card_l]}"
              f" vs {[f'{v:.6f}' for v in cpu_l]} (max rel {loss_rel:.2e}, "
              f"tol 1e-4) | train dice {cmp['cuda']['train_dice']:.5f} vs "
              f"{cmp['cpu']['train_dice']:.5f}, val dice "
              f"{cmp['cuda']['val_dice']:.5f} vs {cmp['cpu']['val_dice']:.5f}"
              f" (tol 2e-3) | weights, elements with a real CPU gradient "
              f"({w_real:.3f} of all): max abs err {w_err:.3e} (tol "
              f"0.25·lr = {0.25 * want_lr:.2e}); noise elements "
              f"{w_noise:.3e} (tol 2·3·lr·1.1 = {6.6 * want_lr:.2e}) | "
              f"card {steps['cmp_cuda']:.1f} s, CPU "
              f"{steps['cmp_cpu']:.1f} s", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        steady = trainer_steady_run(card, zero_counts, counts, per_step,
                                    work, published, model_config_path,
                                    globs, n_cases)
        steps["steady"] = time.perf_counter() - t0
    return dict(
        epochs=epochs, steady=steady, launches=launches,
        launches_train=train_part,
        launches_val=val_part, losses=losses, changed_keys=changed,
        native=status, card_vs_cpu=dict(
            losses=[card_l, cpu_l], loss_rel=loss_rel, dice_err=dice_err,
            weights_err_real=w_err, weights_err_noise=w_noise,
            real_share=w_real),
        steps_s=steps, phase_s=time.perf_counter() - t14)


# -- phase 17: the export CLI ------------------------------------------------

# the loaded artifact, in a process that imports torch alone: B = 1 and 3
# on the card (TF32 off, as here), the B = 1 forward timed by CUDA events
_LOAD_ARTIFACT = """
import json, sys
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
program = torch.export.load(sys.argv[1]).module()
out = {}
with torch.inference_mode():
    for b in (1, 3):
        x = torch.from_numpy(np.load(f"{sys.argv[2]}/x{b}.npy")).cuda()
        np.save(f"{sys.argv[2]}/y{b}.npy", program(x).cpu().numpy())
    x = torch.from_numpy(np.load(f"{sys.argv[2]}/x1.npy")).cuda()
    for _ in range(2):
        program(x)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        program(x)
    end.record()
    torch.cuda.synchronize()
    out["b1_ms"] = start.elapsed_time(end) / 5
assert "veloxseg_torch" not in sys.modules, "the artifact needed the port"
print(json.dumps(out))
"""


def export_phase(card, zero_counts, counts, config_path, patch):
    """Phase 17: ``cli.export_main`` on the card for the AutoPET-II model at
    its published width (seeded weights saved as ``val_best.pth``), the
    artifact loaded and run in a ``torch``-only process at B = 1 and 3 and
    held to the live eval forward (phase 4's tolerance)."""
    import subprocess
    import tempfile

    import numpy as np
    import torch

    from veloxseg_torch.cli.export_main import main as export_main
    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.models.registry import load_model

    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        models = load_json_config(config_path)
        weights = load_model("VeloxSeg", models, device="cpu",
                             seed=8).state_dict()
        os.makedirs(os.path.join(work, "ckpt"))
        torch.save(weights, os.path.join(work, "ckpt", "val_best.pth"))
        train_json = os.path.join(work, "train.json")
        with open(train_json, "w") as f:
            json.dump({"patch_size": {"AutoPETII": patch}}, f)
        art = os.path.join(work, "autopet.pt2")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        export_main(["--dataset_name", "AutoPETII", "--model_name",
                     "VeloxSeg", "--model_config", config_path,
                     "--train_config", train_json, "--checkpoint_dir",
                     os.path.join(work, "ckpt"), "--output", art])
        export_s = time.perf_counter() - t0
        traced = {n: c for n, c in counts().items() if c}
        if traced:
            raise AssertionError(f"export launched kernels {traced}: it "
                                 f"traces the plain versions")
        mb = os.path.getsize(art) / 1e6
        rng = np.random.default_rng(17)
        xs = {b: rng.standard_normal((b, *patch, 2)).astype(np.float32)
              for b in (1, 3)}
        for b, x in xs.items():
            np.save(os.path.join(work, f"x{b}.npy"), x)
        t0 = time.perf_counter()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        r = subprocess.run([sys.executable, "-c", _LOAD_ARTIFACT, art, work],
                           cwd=work, env=env, capture_output=True, text=True,
                           timeout=600)
        load_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"the artifact did not load and run in a "
                                 f"torch-only process:\n{r.stderr[-3000:]}")
        loaded = json.loads(r.stdout.strip().splitlines()[-1])
        live = load_model("VeloxSeg", models, device="cuda")
        live.load_state_dict(weights)
        live.eval()
        errs = {}
        with torch.inference_mode():
            for b, x in xs.items():
                zero_counts()
                want = live(torch.from_numpy(x).cuda())
                torch.cuda.synchronize()
                ran = counts()
                if not all(ran[n] > 0 for n in ("pwa_attention", "jlc_stage1",
                                                "jlc_stage2")):
                    raise AssertionError(f"live forward launches {ran}")
                got = np.load(os.path.join(work, f"y{b}.npy"))
                want = want.cpu().numpy()
                scale = float(np.abs(want).max())
                errs[b] = float(np.abs(got - want).max())
                # phase 4's card-against-CPU tolerance: the plain versions
                # against the kernels, fp32, TF32 off
                if got.shape != want.shape or not errs[b] <= 1e-4 * scale:
                    raise AssertionError(
                        f"exported B={b}: shape {got.shape} vs {want.shape},"
                        f" max abs err {errs[b]:.3e} on scale {scale:.3e}")
            x1 = torch.from_numpy(xs[1]).cuda()
            live_ms = cuda_ms(lambda: live(x1), 5)
    out = dict(export_s=export_s, artifact_mb=mb, load_and_run_s=load_s,
               loaded_b1_ms=loaded["b1_ms"], live_b1_ms=live_ms,
               max_abs_err=errs, phase_s=time.perf_counter() - t17)
    print(f"[17] {card} | export CLI, AutoPET-II VeloxSeg at its published "
          f"width, symbolic batch: export {export_s:.1f} s, artifact "
          f"{mb:.1f} MB | loaded in a torch-only process and run at B = 1 "
          f"and 3: max abs err vs the live forward (kernels) "
          f"{errs[1]:.3e}, {errs[3]:.3e} (tol 1e-4 x scale) | B = 1 forward "
          f"{loaded['b1_ms']:.3f} ms loaded (plain versions) vs "
          f"{live_ms:.3f} ms live (kernels)", flush=True)
    return out


# -- phase 18: the preprocess and extern CLIs --------------------------------

EXTERN_COLUMNS = ["checkpoint", "name", "fp_rate", "fn_rate", "precision",
                  "recall", "f1", "iou", "dice", "time"]
EXTERN_SPLIT = re.compile(
    r"(\S+): dice [\d.]+ \| s: read ([\d.]+) resample ([\d.]+) window "
    r"([\d.]+) metrics ([\d.]+) \| shape \(([\d, ]+)\)")


def extern_cli_phase(card, zero_counts, counts, serving, configs, patches,
                     spacing, small=(96, 96, 80), brats=(90, 96, 80)):
    """Phase 18: ``preprocess_main normalize-ctpet`` over two of phase 13's
    synthetic AutoPET-II cases (``small``, written at a spacing unlike
    ``spacing`` so that the resampled volume spans two tiles on every axis),
    ``extern_main`` over their normalized PET volumes with the AutoPET-II
    model, and with ``--normalize_intensity 1`` over two 4-channel
    MSD-style cases with the BraTS2021 model; each on the card and with
    ``--device cpu``, compared by phase 13's rule. Returns the report, with
    the AutoPET-II run's launch counts (``launches``)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from veloxseg_torch.cli.extern_main import main as extern_main
    from veloxseg_torch.cli.preprocess_main import main as preprocess_main
    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.data.nifti import save_nifti
    from veloxseg_torch.infer import sliding_window as sw
    from veloxseg_torch.models.registry import load_model

    t18 = time.perf_counter()
    raw_spacing = (2.5, 2.5, 4.0)
    recorded = []
    window = sw.sliding_window_inference

    def recording(*a, **kw):
        out = window(*a, **kw)
        recorded.append(out[0].float().cpu().numpy())
        return out

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        raw = write_cases(os.path.join(work, "raw"), "AutoPETII", small, 2,
                          seed=41, spacing=raw_spacing)
        steps = {"write_cases": time.perf_counter() - t0}
        t0 = time.perf_counter()
        norm = os.path.join(work, "norm")
        with contextlib.redirect_stdout(io.StringIO()) as said:
            stats = preprocess_main([
                "normalize-ctpet", "--ct_glob", raw["ct_path"], "--pet_glob",
                raw["pet_path"], "--label_glob", raw["label_path"],
                "--out_dir", norm])
        steps["preprocess"] = time.perf_counter() - t0
        if "CT foreground stats" not in said.getvalue() \
                or not stats["std"] > 0:
            raise AssertionError(f"preprocess: {said.getvalue()}")
        # MSD-style BraTS cases: the four modalities on a fourth axis
        rng = np.random.default_rng(44)
        msd = os.path.join(work, "msd")
        os.makedirs(msd)
        for i in range(2):
            vol, label = blob_volume(rng, brats)
            img = np.stack([vol * (j + 1) + rng.standard_normal(brats)
                            .astype(np.float32) * 0.1 for j in range(4)], -1)
            save_nifti(os.path.join(msd, f"msd{i:03d}.nii.gz"), img)
            save_nifti(os.path.join(msd, f"msd{i:03d}_seg.nii.gz"), label)
        ckpts = {}
        for key, dataset, seed in (("autopet", "AutoPETII", 9),
                                   ("brats", "BraTS2021", 10)):
            ckpts[key] = os.path.join(work, f"{key}.pth")
            torch.save(load_model("VeloxSeg", load_json_config(
                configs[dataset]), device="cpu", seed=seed).state_dict(),
                ckpts[key])
        with open(os.path.join(work, "train.json"), "w") as f:
            json.dump({"patch_size": patches,
                       "spacing": {"AutoPETII": list(spacing),
                                   "BraTS2021": [1.0, 1.0, 1.0]},
                       "dataset_path": {
                           "AutoPETExtern": {
                               "data_path": os.path.join(
                                   norm, "case*_pet.nii.gz"),
                               "label_path": os.path.join(
                                   norm, "case???.nii.gz")},
                           "MSD": {
                               "data_path": os.path.join(
                                   msd, "msd???.nii.gz"),
                               "label_path": os.path.join(
                                   msd, "msd*_seg.nii.gz")}}}, f)
        runs, launches = {}, None
        sw.sliding_window_inference = recording
        try:
            for key, dataset, train_ds, extra in (
                    ("autopet", "AutoPETExtern", "AutoPETII", []),
                    ("brats", "MSD", "BraTS2021",
                     ["--normalize_intensity", "1"])):
                out = {}
                for dev in ("cuda", "cpu"):
                    base = os.path.join(work, "out", key, dev)
                    test_json = os.path.join(base, "test.json")
                    os.makedirs(base)
                    with open(test_json, "w") as f:
                        json.dump({"result_metric_path": base,
                                   "sliding_window": {"overlap": 0.25}}, f)
                    recorded.clear()
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        zero_counts()
                    t0 = time.perf_counter()
                    extern_main(["--dataset_name", dataset, "--train_dataset",
                                 train_ds, "--model_name", "VeloxSeg",
                                 "--checkpoints", ckpts[key],
                                 "--train_config",
                                 os.path.join(work, "train.json"),
                                 "--model_config", configs[train_ds],
                                 "--test_config", test_json,
                                 "--device", dev, *extra])
                    wall = time.perf_counter() - t0
                    got = counts() if dev == "cuda" else None
                    rows = check_csv(os.path.join(
                        base, f"extern_{dataset}_VeloxSeg.csv"),
                        EXTERN_COLUMNS, 2)
                    with open(os.path.join(
                            base, f"extern_{dataset}_VeloxSeg.log")) as f:
                        splits = [m.groups()
                                  for m in EXTERN_SPLIT.finditer(f.read())]
                    out[dev] = dict(wall=wall, launches=got, rows=rows,
                                    logits=list(recorded), splits=splits)
                if [n for n in serving if out["cuda"]["launches"][n] <= 0]:
                    raise AssertionError(f"extern {key} launches "
                                         f"{out['cuda']['launches']}")
                if key == "autopet":
                    launches = out["cuda"]["launches"]
                cmps = [compare_rows(f"extern {key} {r['name']}", cl, pl, r,
                                     pr, EXTERN_COLUMNS[1:])
                        for cl, pl, r, pr in zip(
                            out["cuda"]["logits"], out["cpu"]["logits"],
                            out["cuda"]["rows"], out["cpu"]["rows"])]
                if len(cmps) != 2:
                    raise AssertionError(f"extern {key}: {len(cmps)} cases")
                per_case = []
                for name, *parts, shape in out["cuda"]["splits"]:
                    read_s, res_s, win_s, met_s = map(float, parts)
                    shape = tuple(int(v) for v in shape.split(","))
                    tiles = [-(-max(s - p, 0) // int(p * 0.75)) + 1
                             for s, p in zip(shape, patches[train_ds])]
                    if key == "autopet" and min(tiles) < 2:
                        raise AssertionError(f"extern: {name} resampled to "
                                             f"{shape}, tiles {tiles}")
                    per_case.append(dict(name=name, read_s=read_s,
                                         resample_s=res_s, window_s=win_s,
                                         metrics_s=met_s, shape=shape,
                                         tiles=tiles))
                    print(f"[18] {card} | extern {key} {name}: read "
                          f"{read_s:.4f} s, "
                          + ("resample" if key == "autopet" else "z-score")
                          + f" {res_s:.4f} s, window {win_s:.4f} s "
                          f"(synchronized), metrics {met_s:.4f} s | volume "
                          f"{shape}, tiles {tiles}", flush=True)
                steps[key] = out["cuda"]["wall"]
                steps[f"{key}_cpu"] = out["cpu"]["wall"]
                runs[key] = dict(
                    card_s=out["cuda"]["wall"], cpu_s=out["cpu"]["wall"],
                    per_case=per_case, card_vs_cpu=cmps,
                    launches={n: c for n, c in out["cuda"]["launches"].items()
                              if c},
                    rows=out["cuda"]["rows"])
                print(f"[18] extern {key} ({dataset} with the {train_ds} "
                      f"model at its published width, 2 cases"
                      + (", --normalize_intensity 1" if extra else "")
                      + f"): {out['cuda']['wall']:.3f} s card, "
                      f"{out['cpu']['wall']:.3f} s CPU | launches "
                      f"{runs[key]['launches']} | logits max abs err "
                      f"{max(c['logit_err'] for c in cmps):.3e} (tol 1e-5 x "
                      f"scale), {sum(c['flips'] for c in cmps)} voxels differ "
                      f"(all with CPU top-2 margin < 1e-4), metrics max abs "
                      f"err {max(c['metric_err'] for c in cmps):.3e} (tol "
                      f"1e-4) | dice "
                      + ", ".join(r["dice"] for r in out["cuda"]["rows"]),
                      flush=True)
        finally:
            sw.sliding_window_inference = window
    print(f"[18] preprocess normalize-ctpet over 2 cases of {small} at "
          f"{raw_spacing} mm: {steps['preprocess']:.2f} s | CT stats "
          f"{ {k: round(v, 4) for k, v in stats.items()} }", flush=True)
    return dict(runs=runs, ct_stats=stats, steps_s=steps, launches=launches,
                phase_s=time.perf_counter() - t18)


# -- phase 19: the zoo's eight baselines ----------------------------------

ZOO = ("UNet", "VNet", "MedNeXt", "UNETR", "SwinUNETR", "SegFormer",
       "SlimUNETR", "UNETRpp")
# the models whose builder refuses a dataset's shape, as the JAX module
# fails there: NestedFormer's window (3, 3, 2) does not divide Hecktor's
# (8, 8, 4) bottleneck
ZOO_CANNOT = {("NestedFormer", "Hecktor2022")}
# phase 20: the seven that close the zoo
ZOO_LAST = ("VSmTrans", "NestedFormer", "A2FSeg", "HDense", "SuperLightNet",
            "U-KAN", "HCMA-UNet")
# the forwards card vs CPU, at 96³ (B = 2 until phase 22 came: a scale cut,
# the CPU's forwards setting the time of phases 19 and 20)
ZOO_BATCH = 1
# the bf16 forward on the card against the CPU's fp32 one: at least
# FORWARD_BOUND's 0.5 (it rounds as bf16) and at most this much of the
# CPU's own bf16-to-fp32 distance (it is the same function). Its distance
# from the CPU's bf16 forward is printed, not held to FORWARD_BOUND's 0.9:
# where the attention scores are rounded to bf16 (UNETR, as flax's
# attention rounds them), the two devices' sums round some scores apart,
# and the two bf16 forwards drift 0.93 of that distance apart (PERF.md
# §6); the CPU tests hold each bf16 forward to the JAX one.
ZOO_BF16_MAX = 1.5


def zoo_phase(card, zero_counts, counts, configs, patches, spacing,
              names=ZOO, tag=19, serve="SwinUNETR",
              small=(96, 96, 80)):
    """Phase 19 (and 20, with ``names`` the seven that close the zoo,
    ``serve`` HCMA-UNet): the zoo baselines ``names`` of the registry at
    their published AutoPET-II configs (``configs``: each dataset's models
    config), seeded weights. Per model, the fp32 eval forward of a seeded
    (ZOO_BATCH, 96, 96, 96, 2) batch on the card against the same on the
    CPU, within 1e-4 of the CPU logits' scale, or within 4× the card forward's
    own movement under a 1e-7 relative change of its input where that is
    larger (the ill-conditioned models: printed); then both in bf16
    (``.to(bf16)``, as the speed CLI runs them), the card's against the
    CPU's fp32 forward relative to the CPU's own bf16-to-fp32 distance
    (``ZOO_BF16_MAX``). No kernel of the port may launch. Then ``speed_main`` over ``names`` at
    the shapes of ``ZOO_SPEED_DATASETS`` (``SPEED_T_TIMED``,
    ``ZOO_PROBE_ITERS``), and
    the serving CLI on ``serve`` from a ``.pth`` the port wrote, over one
    ``small`` AutoPET-II case, card against ``run_inference(...,
    device="cpu")`` by phase 13's rule, with each device's float64 forward
    of the model it served, through the same window, as ``compare_rows``'s
    ``ref64``. Every line is tagged ``[tag]``. Returns the report."""
    import tempfile

    import torch

    from veloxseg_torch.cli import speed_main
    from veloxseg_torch.cli.test_main import build_parser
    from veloxseg_torch.cli.test_main import main as serve_main
    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.infer import driver
    from veloxseg_torch.models.registry import load_model
    from veloxseg_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    bf = torch.bfloat16
    dev = torch.device("cuda")
    models = load_json_config(configs["AutoPETII"])
    shape = tuple(patches["AutoPETII"])
    x = torch.randn(ZOO_BATCH, *shape, 2,
                    generator=torch.Generator().manual_seed(19))
    xp = x * (1 + 1e-7 * torch.randn(x.shape, generator=torch.Generator()
                                     .manual_seed(20)))
    report = {"forwards": {}, "speed": {}}
    for name in names:
        t0 = time.perf_counter()
        with torch.inference_mode():
            model = load_model(name, models, device="cuda", seed=0,
                               input_size=shape)
            x_dev = x.to(dev)
            zero_counts()
            y = model(x_dev)
            torch.cuda.synchronize()
            launched = {n: c for n, c in counts().items() if c}
            moved = float((model(xp.to(dev)) - y).abs().max())
            ms = cuda_ms(lambda: model(x_dev), 3)
            cpu_model = load_model(name, models, device="cpu", seed=0,
                                   input_size=shape)
            t1 = time.perf_counter()
            y_cpu = cpu_model(x)
            cpu_s = time.perf_counter() - t1
            y = y.cpu()
            model16 = model.to(bf)
            y16 = model16(x_dev.to(bf)).float().cpu()
            ms16 = cuda_ms(lambda: model16(x_dev.to(bf)), 3)
            y16_cpu = cpu_model.to(bf)(x.to(bf)).float()
        del model, model16, cpu_model, x_dev
        torch.cuda.empty_cache()
        if tuple(y.shape) != (ZOO_BATCH, *shape, 2) \
                or not bool(torch.isfinite(y).all()) \
                or not bool(torch.isfinite(y16).all()) or launched:
            raise AssertionError(f"zoo {name}: output {tuple(y.shape)}, "
                                 f"kernel launches {launched}")
        scale = float(y_cpu.abs().max())
        err = float((y - y_cpu).abs().max())
        tol = max(1e-4 * scale, 4 * moved)
        if not err <= tol:
            raise AssertionError(f"zoo {name} card vs CPU: max abs err "
                                 f"{err:.3e}, tol {tol:.3e} (scale "
                                 f"{scale:.3e}, moved {moved:.3e})")
        d = forward_distances(y16, y16_cpu, y_cpu)
        if not (FORWARD_BOUND["to_fp32"] <= d["to_fp32"] <= ZOO_BF16_MAX):
            raise AssertionError(
                f"zoo {name} bf16 card vs CPU fp32: {d['to_fp32']:.4f} of "
                f"the CPU's bf16 distance, outside "
                f"[{FORWARD_BOUND['to_fp32']}, {ZOO_BF16_MAX}]")
        report["forwards"][name] = dict(
            max_abs_err=err, scale=scale, tol=tol, moved=moved, gpu_ms=ms,
            gpu_ms_bf16=ms16, cpu_s=cpu_s, bf16=d,
            seconds=time.perf_counter() - t0)
        print(f"[{tag}] {card} | {name} eval forward ({ZOO_BATCH},{shape[0]},"
              f"{shape[1]},{shape[2]},2) card vs CPU: max abs err "
              f"{err:.3e} on scale {scale:.3e} (tol {tol:.3e}: 1e-4 x scale "
              f"or 4 x the card's movement {moved:.3e} under a 1e-7 "
              f"input change) | bf16 card vs CPU, relative to the CPU's "
              f"bf16-to-fp32 distance: to its fp32 {d['to_fp32']:.4f} (in "
              f"[{FORWARD_BOUND['to_fp32']}, {ZOO_BF16_MAX}]), to its bf16 "
              f"{d['to_bf16']:.4f} | GPU {ms:.3f} ms fp32, "
              f"{ms16:.3f} ms bf16 (CPU {cpu_s:.2f} s) | no kernel launched "
              f"| {time.perf_counter() - t0:.1f} s", flush=True)

    speed_main.T_TIMED = ZOO_SPEED_T_TIMED
    speed_main.PROBE_ITERS = ZOO_PROBE_ITERS
    for dataset in ZOO_SPEED_DATASETS:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = speed_main.main(["--dataset", dataset, "--model_list",
                               ",".join(names), "--model_config",
                               configs[dataset]])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launched = {n: c for n, c in counts().items() if c}
        ran = [r for r in res if "skipped" not in r]
        skipped = {r["model"] for r in res if "skipped" in r}
        if [r["model"] for r in res] != list(names) or launched or not all(
                r["throughput"] > 0 and r["flops"] > 0 for r in ran) \
                or skipped != {n for n, d in ZOO_CANNOT if d == dataset
                               and n in names}:
            raise AssertionError(f"zoo speed CLI {dataset}: "
                                 f"{[r['model'] for r in res]}, skipped "
                                 f"{skipped}, launches {launched}")
        report["speed"][dataset] = dict(results=res, seconds=run_s)
        for r in res:
            if "skipped" in r:
                print(f"[{tag}] {card} | speed CLI {dataset} {r['model']}: "
                      f"skipped, {r['skipped']}", flush=True)
                continue
            print(f"[{tag}] {card} | speed CLI {dataset} {r['model']}: "
                  f"{r['throughput']:.2f} images/s @ batch size "
                  f"{r['batch_size']}, Params {r['params'] / 1e6} M, "
                  f"GFLOPs per image {r['flops'] / 1e9} (bf16, T_TIMED "
                  f"{ZOO_SPEED_T_TIMED} s)", flush=True)
        print(f"[{tag}] speed CLI {dataset}, the {len(names)}: "
              f"{run_s:.1f} s",
              flush=True)
    speed_main.PROBE_ITERS = 20

    # the serving CLI on ``serve``, from a .pth the port wrote
    recorded, calls = [], []
    window = driver.sliding_window_inference

    def recording(*a, **kw):
        out = window(*a, **kw)
        recorded.append(out)
        calls.append((a, kw))
        return out

    with tempfile.TemporaryDirectory() as work:
        globs = write_cases(os.path.join(work, "cases"), "AutoPETII", small,
                            1, seed=44, spacing=spacing)
        ckpt = os.path.join(work, "ckpt")
        save_checkpoint(os.path.join(ckpt, "val_best.pth"), load_model(
            serve, models, device="cpu", seed=7, input_size=shape))
        for fname, cfg in (
                ("train.json", {"patch_size": {"AutoPETII": list(shape)},
                                "train_rate": 0, "val_rate": 0,
                                "dataset_path": {"AutoPETII": globs}}),
                ("test.json", {"result_metric_path":
                               os.path.join(work, "metric"),
                               "sliding_window": {"overlap": 0.25}})):
            with open(os.path.join(work, fname), "w") as f:
                json.dump(cfg, f)
        run_argv = ["--dataset_name", "AutoPETII", "--model_name",
                    serve, "--model_config", configs["AutoPETII"],
                    "--train_config", os.path.join(work, "train.json"),
                    "--test_config", os.path.join(work, "test.json"),
                    "--checkpoint_dir", ckpt, "--use_hd95", "1",
                    "--sw_batch_size", "1"]
        driver.sliding_window_inference = recording
        try:
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            serve_main(run_argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {n: c for n, c in counts().items() if c}
            card_row, = check_csv(os.path.join(
                work, "metric", f"AutoPETII_{serve}.csv"),
                BINARY_COLUMNS, 1)

            args = build_parser().parse_args(run_argv)
            with open(args.train_config) as f:
                train_json = json.load(f)
            with open(args.test_config) as f:
                test_json = json.load(f)
            t0 = time.perf_counter()
            cpu_row, = driver.run_inference(args, train_json, models,
                                            test_json, device="cpu")
            cpu_s = time.perf_counter() - t0
            # each device's float64 forward of the model it served: a
            # float64 copy through the same window over the same case, its
            # raw tiles kept (the window rounds what it blends to fp32)
            tiles, blended = [], []
            for a, kw in calls:
                m64 = copy.deepcopy(a[2]).double()
                raw = []

                def predict64(t, m64=m64, raw=raw):
                    y = m64(t.double())
                    raw.append(y.cpu())
                    return y
                with torch.inference_mode():
                    blended.append(window(a[0], a[1], predict64, *a[3:],
                                          **kw)[0].cpu().numpy())
                tiles.append(torch.cat(raw).numpy())
                del m64
            calls.clear()
        finally:
            driver.sliding_window_inference = window
    card_lg, cpu_lg = recorded
    if launched:
        raise AssertionError(f"zoo serving CLI: kernel launches {launched}")
    cmp = compare_rows(serve, card_lg[0].cpu().numpy(),
                       cpu_lg[0].numpy(), card_row, cpu_row, BINARY_COLUMNS,
                       (tiles, blended[1]))
    report["serving_cli"] = dict(wall_s=wall, cpu_s=cpu_s, row=card_row,
                                 card_vs_cpu=cmp)
    print(f"[{tag}] {card} | serving CLI {serve} from the port's .pth "
          f"(AutoPETII, one {small} case, logits "
          f"{tuple(card_lg.shape)}): {wall:.3f} s card, {cpu_s:.3f} s CPU "
          f"| logits max abs err {cmp['logit_err']:.3e} on scale "
          f"{cmp['scale']:.3e} ("
          + (f"against the CPU's float64 logits, tol {cmp['tol']:.3e}: 4 x "
             f"the CPU's fp32 distance from them, {cmp['own']:.3e}, above "
             f"1e-5 x scale" if cmp["float64_rule"] else
             f"against the CPU's fp32 logits, tol {cmp['tol']:.3e}: 1e-5 x "
             f"scale; the CPU's fp32 distance from its float64 logits "
             f"{cmp['own']:.3e}")
          + f"), {cmp['flips']} voxels differ (each with a top-2 margin "
          f"below {'2 x tol' if cmp['float64_rule'] else '1e-4'}), float64 "
          f"tiles card vs CPU {cmp['err64']:.3e} (tol 1e-10 x scale), "
          f"metrics max abs err {cmp['metric_err']:.3e} | "
          + ", ".join(f"{c} {card_row[c]}" for c in BINARY_COLUMNS[1:]
                      if c != "time"), flush=True)
    report["phase_s"] = time.perf_counter() - t_phase
    return report


# -- phase 21: zoo training -------------------------------------------------

# the zoo models the port trains (train/trainer.TRAINABLE but VeloxSeg)
ZOO_TRAIN = ("U-RWKV", "UNet", "MedNeXt", "SwinUNETR", "U-KAN")
# the step card against CPU: 64³ (a depth cut: the CPU's steps set the
# phase's time), B = 2 but U-KAN's 4 (its deepest level's batch norms over
# few values, as tests/test_torch_zoo_train.py runs it)
ZOO_TRAIN_SIZE = 64
ZOO_TRAIN_BATCH = {"U-KAN": 4}
# the models whose float64 yardstick step runs on the CPU: U-RWKV's K6
# takes fp32 alone; every other model's runs on the card, which agrees
# with the CPU's float64 step to 1e-10 (ZOO_AGREE64, held in each run)
ZOO_CPU64 = ("U-RWKV",)
ZOO_AGREE64 = "U-KAN"
# phase 22: the seven that draw in training (SegFormer with them), and the
# smallest size at which [21]'s rule holds for each (tools/zoo_train_sizes.py)
ZOO_TRAIN_DROPOUT = ("VNet", "UNETR", "SegFormer", "SlimUNETR",
                     "NestedFormer", "SuperLightNet", "HCMA-UNet")
ZOO_TRAIN_DROPOUT_SIZE = {"VNet": (32, 32, 32), "UNETR": (32, 32, 32),
                          "SegFormer": (32, 32, 32),
                          "SlimUNETR": (32, 32, 32),
                          "NestedFormer": (48, 48, 32),
                          "SuperLightNet": (32, 32, 32),
                          "HCMA-UNet": (64, 64, 64)}


def sized_entry(name, entry, size):
    """``name``'s model-config entry for an input of ``size``: its size key
    (``img_size``, ``image_size``, ``patch_ini``) set to it, SlimUNETR's
    ``embedding_dim`` to its bottleneck's token count."""
    entry = dict(entry)
    for key in ("img_size", "image_size", "patch_ini"):
        if key in entry:
            entry[key] = list(size)
    if name == "SlimUNETR":
        entry["embedding_dim"] = math.prod(s // 32 for s in size)
    return entry


@contextlib.contextmanager
def factor_mode():
    """The zoo's dropouts as ``x · (1 + rate)`` (the factor in x's dtype)
    and SuperLightNet's block i folding direction i mod 3, while the
    context lasts: the steps then are one function on every device, as
    ``tests/test_torch_zoo_train_dropout.py`` holds them against JAX."""
    from veloxseg_torch.models.zoo import common, superlightnet
    saved = common.dropout, superlightnet.fold_directions

    def factor(x, rate, training, generator, channel=False):
        if not training or rate == 0.0:
            return x
        return x * x.new_tensor(1.0 + rate)

    common.dropout = factor
    superlightnet.fold_directions = \
        lambda n, generator: [i % 3 for i in range(n)]
    try:
        yield
    finally:
        common.dropout, superlightnet.fold_directions = saved


def zoo_grads_close(what, card, cpu, cpu64, card_moved=None):
    """Card fp32 gradients against the CPU's, each tensor within 1e-4 of
    its own largest magnitude plus 1e-5 of the model's largest gradient
    (phase [8]'s rule) plus 4x the CPU's own fp32 distance from ``cpu64``,
    the float64 step's gradients: sums over 64³ voxels that cancel
    (the first convs' weights) which fp32 cannot give to 1e-4;
    ``tests/test_torch_zoo_train.py`` holds the port against JAX the same
    way. With ``card_moved``, the card's gradients on an input moved by
    1e-7 relative, each tolerance also takes 4x the card's own movement
    (phase [22]'s ill-conditioned models, as [19] holds a steep forward).
    Returns (the worst tensor's share of its tolerance, its key, the
    card's distance from the float64 gradients over all tensors relative
    to the CPU's), or raises."""
    g_all = max(float(g.abs().max()) for g in cpu.values())
    worst, worst_key = 0.0, None
    d_card = d_cpu = 0.0
    for k, r in cpu.items():
        err = float((card[k] - r).abs().max())
        tol = (1e-4 * float(r.abs().max()) + 1e-5 * g_all
               + 4.0 * float((r - cpu64[k]).abs().max()))
        if card_moved is not None:
            tol += 4.0 * float((card_moved[k] - card[k]).abs().max())
        d_card += float(((card[k] - cpu64[k]) ** 2).sum())
        d_cpu += float(((r - cpu64[k]) ** 2).sum())
        if err / tol > worst:
            worst, worst_key = err / tol, k
    if not worst <= 1.0:
        raise AssertionError(f"{what}: card vs CPU gradient of {worst_key}: "
                             f"{worst:.3f} of its tolerance")
    return worst, worst_key, math.sqrt(d_card / d_cpu)


def cpu_bf16_conv_backward_in_fp32():
    """A dispatch mode under which a bf16 convolution's backward on the CPU
    runs in fp32 on the same bf16 operands and rounds its gradients to
    bf16, as a bf16 convolution accumulates in fp32 and rounds its output:
    the same function up to the order of the sums. PyTorch 2.11's CPU bf16
    conv3d weight gradient at a 2³ level (SwinUNETR's ``encoder10``,
    U-KAN's ``decoder1`` at 64³) returns uninitialized values (1e30, inf,
    NaN) in most runs, whatever the oneDNN ISA or the thread count
    (ROADMAP.md §3); the forward repeats."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    conv_bwd = torch.ops.aten.convolution_backward.default

    class Fp32ConvBackward(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is conv_bwd and args[0].dtype == torch.bfloat16 \
                    and args[0].device.type == "cpu":
                outs = func(*(a.float() for a in args[:3]), *args[3:],
                            **(kwargs or {}))
                return tuple(None if o is None else o.to(torch.bfloat16)
                             for o in outs)
            return func(*args, **(kwargs or {}))

    return Fp32ConvBackward()


def zoo_train_steps(card, zero_counts, counts, all_models, names=ZOO_TRAIN,
                    sizes=None, tag=21, factor=False, moved=False):
    """Phases 21 and 22: each model's train step (``train_state.
    train_step_fn``, AdamW as published) from one seed's weights on one
    seeded batch of ``sizes[name]`` (default 64³; B = 2, U-KAN 4), on the
    card and on the CPU (``factor``: under :class:`factor_mode`, the
    dropouts a factor and SuperLightNet's folds fixed). In fp32 by
    ``zoo_grads_close`` with a float64 step (the model, the input and
    the loss in float64) as the yardstick of fp32's own error, on the card
    but for ``ZOO_CPU64``'s; for ``ZOO_AGREE64`` also on the CPU, the two
    within 1e-10 of each gradient's scale. The loss within 1e-5. In
    bf16, as the trainer steps, by ``chip_measure.STEP_BOUND`` against the
    CPU's bf16 step, whose loss term is dropped where the CPU's bf16 loss
    lies within 1e-5 of its fp32 loss (a loss averaged over the voxels
    that does not see bf16). The CPU's bf16 step runs its convolutions'
    backward under :func:`cpu_bf16_conv_backward_in_fp32` and must repeat
    bit for bit in two runs. With ``moved`` (phase [22]), the card also
    steps on the input moved by 1e-7 relative, and each of these bounds
    also allows 4x the card's own movement (the losses, each gradient;
    ``chip_measure.step_distances``'s ``moved``): the ill-conditioned
    models' steps (the steep softmax of SegFormer, the 12- and 2-channel
    LayerNorms of SuperLightNet and HCMA-UNet) move under rounding as much
    as the two devices differ. U-RWKV's steps on the card launch K6 and
    K6b 6 times each, the others no kernel of the port."""
    import numpy as np
    import torch
    from veloxseg_torch.models.registry import load_model
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.optim import build_optimizer
    from veloxseg_torch.train.train_state import (create_train_state,
                                                  takes_generator,
                                                  train_step_fn)
    opt = {"lr": 2.5e-4, "weight_decay": 0.01}
    loss_cfg = {"deep_Loss_weight": [1, 1, 1, 1]}
    sizes = sizes or {}
    out = {}
    for name in names:
        t0 = time.perf_counter()
        b = ZOO_TRAIN_BATCH.get(name, 2)
        size = tuple(sizes.get(name, (ZOO_TRAIN_SIZE,) * 3))
        rng = np.random.default_rng(21)
        x = torch.from_numpy(rng.standard_normal(
            (b, *size, 2)).astype(np.float32))
        y = torch.from_numpy((rng.random((b, *size)) < 0.3)
                             .astype(np.int64))
        x_moved = x * (1 + 1e-7 * torch.from_numpy(rng.standard_normal(
            x.shape).astype(np.float32)))
        cfg = {name: sized_entry(name, all_models[name], size)}
        loss_obj = CompositeLoss(name, loss_cfg)
        runs, launches, secs = {}, {}, {}
        # one seeded init, copied to each run's device
        base = load_model(name, cfg, device="cpu", seed=0, input_size=size)

        def build(dev):
            return copy.deepcopy(base).to(dev)

        def one_step(key, dev, dt, inputs=x):
            model = build(dev)
            state = create_train_state(model, build_optimizer(
                "adamw", opt, model.parameters()))
            step = train_step_fn(loss_obj, dev, with_metrics=False,
                                 compute_dtype=dt)
            gen = torch.Generator(dev).manual_seed(22)
            if dev == "cuda":
                torch.cuda.synchronize()
                zero_counts()
            t1 = time.perf_counter()
            if dev == "cpu" and dt is not None:
                with cpu_bf16_conv_backward_in_fp32():
                    state, aux = step(state, inputs, y, gen)
            else:
                state, aux = step(state, inputs, y, gen)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches[key] = {n: c for n, c in counts().items() if c}
            secs[key] = time.perf_counter() - t1
            return (float(aux["loss"]), {
                k: p.grad.detach().double().cpu()
                for k, p in model.named_parameters()})

        def step64(key, dev):
            """The loss and gradients with the model, the input and the
            loss in float64."""
            model = build(dev).double().train()
            xd = x.double().to(dev)
            args = ((xd, torch.Generator(dev).manual_seed(22))
                    if takes_generator(model) else (xd,))
            t1 = time.perf_counter()
            loss = loss_obj(model(*args), y.to(dev), sr_labels=xd)
            loss.backward()
            if dev == "cuda":
                torch.cuda.synchronize()
            secs[key] = time.perf_counter() - t1
            return float(loss), {k: p.grad.detach().cpu()
                                 for k, p in model.named_parameters()}

        with factor_mode() if factor else contextlib.nullcontext():
            for key, dev, dt in (("card32", "cuda", None),
                                 ("cpu32", "cpu", None),
                                 ("card16", "cuda", torch.bfloat16),
                                 ("cpu16", "cpu", torch.bfloat16)):
                runs[key] = one_step(key, dev, dt)
            if moved:
                runs["card32_moved"] = one_step("card32_moved", "cuda", None,
                                                x_moved)
                runs["card16_moved"] = one_step(
                    "card16_moved", "cuda", torch.bfloat16, x_moved)
            again = one_step("cpu16_again", "cpu", torch.bfloat16)
            if not (again[0] == runs["cpu16"][0] and all(
                    torch.equal(again[1][k], g)
                    for k, g in runs["cpu16"][1].items())):
                raise AssertionError(f"{name}: the CPU's bf16 step does not "
                                     f"repeat bit for bit")
            del again
            where64 = "cpu" if name in ZOO_CPU64 else "cuda"
            l64, g64 = step64(f"{where64}64", where64)
            agree = None
            if name == ZOO_AGREE64:
                l64c, g64c = step64("cpu64", "cpu")
                # of each gradient's scale, a floor of 1e-5 of the
                # largest for the gradients that are 0 in exact arithmetic
                g_all = max(float(g.abs().max()) for g in g64c.values())
                agree = max(float((g - g64c[k]).abs().max())
                            / (float(g64c[k].abs().max()) + 1e-5 * g_all)
                            for k, g in g64.items())
                if not (agree <= 1e-10
                        and abs(l64 - l64c) <= 1e-10 * abs(l64c)):
                    raise AssertionError(
                        f"{name}: the card's float64 step {l64} lies "
                        f"{agree:.3e} of a gradient's scale from the CPU's "
                        f"({l64c})")
        want = {"wkv": 6, "wkv_bwd": 6} if name == "U-RWKV" else {}
        if any(v != want for v in launches.values()):
            raise AssertionError(f"{name} train step launches {launches}, "
                                 f"want {want} in each")
        (l32, g32), (lc, gc) = runs["cpu32"], runs["card32"]
        l16 = runs["cpu16"][0]
        lm, gm = runs.get("card32_moved", (lc, None))
        if not all(math.isfinite(v) for v, _ in runs.values()) \
                or not abs(lc - l32) <= 1e-5 * abs(l32) + 4 * abs(lm - lc):
            raise AssertionError(f"{name} step losses "
                                 f"{ {k: v for k, (v, _) in runs.items()} }")
        worst, worst_key, ratio = zoo_grads_close(
            f"{name} fp32 step at {size}", gc, g32, g64, gm)
        d = step_distances(runs["card16"], runs["cpu16"], runs["cpu32"],
                           runs.get("card16_moved"))
        bad = step_bound_violations(d)
        loss_sees_bf16 = abs(l16 - l32) >= 1e-5 * abs(l32)
        if not loss_sees_bf16:
            bad = [k for k in bad if k != "loss"]
        if bad:
            raise AssertionError(
                f"{name} bf16 step card vs CPU outside {STEP_BOUND} in "
                f"{bad}: {d}; losses card {runs['card16'][0]}, CPU "
                f"{l16}, CPU fp32 {l32}")
        shape = "x".join(str(s) for s in size)
        print(f"[{tag}] {card} | {name} train step ({b}, {shape}, 2)"
              + (" in factor mode" if factor else "")
              + f" card vs CPU: fp32 loss {lc:.6f} vs {l32:.6f} (rel "
              f"{abs(lc - l32) / abs(l32):.2e}, tol 1e-5"
              + (f" + 4x the card's movement {abs(lm - lc):.2e}" if moved
                 else "")
              + f"); {len(g32)} gradients, worst {worst:.3f} of the "
              f"tolerance ({worst_key}; with 4x the CPU's own fp32 distance "
              f"from the {where64}'s float64 step"
              + (", and 4x the card's movement" if moved else "")
              + f", the card's all together {ratio:.3f}x the CPU's"
              + ("" if agree is None else
                 f"; the card's float64 step {agree:.2e} of each gradient's "
                 f"scale from the CPU's")
              + f") | bf16 relative to the CPU's bf16-to-fp32 distance (the "
              f"CPU's repeating bit for bit): loss {d['loss']:.4f} (card "
              f"{runs['card16'][0]:.6f}, CPU {l16:.6f}"
              + ("" if loss_sees_bf16 else
                 ", not held: the CPU's bf16 loss within 1e-5 of its fp32")
              + f"), gradients to its bf16 {d['grads_to_bf16']:.4f}, to "
              f"its fp32 {d['grads_to_fp32']:.4f}, worst tensor "
              f"{d['tensor_to_bf16']:.4f} ({d['tensor']}) | launches per "
              f"step {launches['card32'] or 'none'} | s: "
              + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        out[name] = dict(size=list(size), loss=[lc, l32], worst_ratio=worst,
                         worst_param=worst_key, global_ratio=ratio,
                         float64_on=where64, float64_agree=agree,
                         bf16=d, bf16_loss_held=loss_sees_bf16,
                         launches=launches, step_s=secs)
        del runs, base
    return out


def linked_cases(src_globs, root, n_src, n_cases):
    """``n_cases`` cases under ``root``, links to the ``n_src`` that
    ``write_cases`` wrote at ``src_globs``; returns their globs."""
    cases = os.path.dirname(src_globs["label_path"])
    os.makedirs(root)
    names = sorted(os.listdir(cases))
    for i in range(n_cases):
        for name in names:
            if name.startswith(f"case{i % n_src:03d}"):
                os.symlink(os.path.join(cases, name), os.path.join(
                    root, f"case{i:03d}" + name[len("case000"):]))
    return {k: os.path.join(root, os.path.basename(v))
            for k, v in src_globs.items()}


def zoo_trainer_cli_phase(card, zero_counts, counts, model_config_path,
                          train_config_path, shape=(112, 112, 104),
                          n_src=10, n_cases=30, names=ZOO_TRAIN, tag=21):
    """Phase 21: ``cli.train_main`` on the card for the zoo models the port
    trains, at the published AutoPET-II model and train configs (96³
    patches, 4 a step, bf16, AdamW 2.5e-4) but for the dataset paths, the
    epochs, the save and log paths and ``profile_dir``: ``n_cases``
    synthetic cases (links to ``n_src`` written as phase [14] writes
    them; 18 train, 9 steps an epoch). U-RWKV: 2 epochs with validation
    and checkpoints each, launches K6b 6 per step and K6 6 per step and per
    validation batch; then resume from ``0.pth`` and serve ``val_best.pth``
    through ``cli.test_main`` on the test split. The others: one epoch at
    the published intervals (no validation). Per run: the median step's
    stream span, the trace's device ms per step and idle share (steps 3-9
    of epoch 1, ``profile_dir``), peak memory."""
    import tempfile

    import torch

    from veloxseg_torch.cli.test_main import main as serve_main
    from veloxseg_torch.cli.train_main import main as train_main
    from veloxseg_torch.core.config import load_json_config
    from veloxseg_torch.train.optim import EpochScheduler
    from chip_measure import trace_split

    published = load_json_config(train_config_path)
    out = {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        src = write_cases(os.path.join(work, "src"), "AutoPETII", shape,
                          n_src, seed=61,
                          spacing=tuple(published["spacing"]["AutoPETII"]))
        globs = linked_cases(src, os.path.join(work, "cases"), n_src,
                             n_cases)
        out["write_cases_s"] = time.perf_counter() - t0

        def run(name, tag, extra_argv=(), **over):
            cfg = dict(published, dataset_path={"AutoPETII": globs},
                       save_path=os.path.join(work, name, "save"),
                       log_path=os.path.join(work, name, f"logs_{tag}"),
                       **over)
            path = os.path.join(work, f"{name}_{tag}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            argv = ["--dataset_name", "AutoPETII", "--model_name", name,
                    "--model_config", model_config_path, "--train_config",
                    path, *extra_argv]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t1 = time.perf_counter()
            res = train_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            date = os.path.basename(res["save_path"])
            with open(os.path.join(cfg["log_path"],
                                   f"AutoPETII_{name}_{date}.log")) as f:
                log = f.read()
            return dict(res=res, cfg=cfg, argv=argv, log=log, wall_s=wall,
                        epochs=split_lines(log),
                        launches={n: c for n, c in counts().items() if c},
                        peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)

        def figures(name, r, trace_dir):
            tr = trace_split(trace_dir)
            n_steps = sum(e["steps"] for e in r["epochs"])
            fig = dict(
                steps=n_steps, epoch_s=[e["epoch_s"] for e in r["epochs"]],
                step_median_ms=[e["step_median_ms"] for e in r["epochs"]],
                patches_per_s=[e["patches_per_s"] for e in r["epochs"]],
                trace_steps=tr["steps"],
                device_ms=tr["device_ms"] / tr["steps"],
                wall_ms=tr["wall_ms"] / tr["steps"],
                idle_share=1 - tr["device_ms"] / tr["wall_ms"],
                peak_gb=r["peak_gb"], wall_s=r["wall_s"],
                launches=r["launches"],
                losses=[float(v) for v in re.findall(
                    r"Training Loss:([\d.]+)", r["log"])])
            if tr["steps"] < 5 or len(fig["losses"]) != n_steps \
                    or not all(math.isfinite(v) for v in fig["losses"]):
                raise AssertionError(f"{name} trainer CLI: trace {tr}, "
                                     f"losses {fig['losses']}")
            per = {n: c / n_steps for n, c in r["launches"].items()}
            print(f"[{tag}] {card} | {name} train_main (AutoPETII, published "
                  f"configs, bf16): {len(r['epochs'])} epoch(s) of "
                  f"{r['epochs'][0]['steps']} steps of 4 patches 96³ in "
                  f"{r['wall_s']:.1f} s | step median "
                  + ", ".join(f"{v:.3f}" for v in fig["step_median_ms"])
                  + f" ms (stream span) | trace of {tr['steps']} steps: "
                  f"device {fig['device_ms']:.3f} ms/step, wall "
                  f"{fig['wall_ms']:.3f} ms/step, idle share "
                  f"{fig['idle_share']:.3f} | peak {fig['peak_gb']:.2f} GB | "
                  f"launches per step {per or 'none'} | losses "
                  f"{fig['losses'][0]:.4f} ... {fig['losses'][-1]:.4f}",
                  flush=True)
            return fig

        for name in names:
            trace_dir = os.path.join(work, name, "trace")
            if name != "U-RWKV":
                r = run(name, "main", epochs=1, profile_dir=trace_dir)
                if r["launches"] or r["epochs"][0]["val_batches"]:
                    raise AssertionError(f"{name} trainer CLI: launches "
                                         f"{r['launches']}, epochs "
                                         f"{r['epochs']}")
                out[name] = figures(name, r, trace_dir)
                continue
            r = run(name, "main", epochs=2, val_interval=1,
                    save_model_interval=1, profile_dir=trace_dir)
            n_steps = sum(e["steps"] for e in r["epochs"])
            n_val = sum(e["val_batches"] for e in r["epochs"])
            want = {"wkv": 6 * (n_steps + n_val), "wkv_bwd": 6 * n_steps}
            if len(r["epochs"]) != 2 or not n_val or r["launches"] != want:
                raise AssertionError(f"U-RWKV trainer CLI: launches "
                                     f"{r['launches']}, want {want}; epochs "
                                     f"{r['epochs']}")
            fig = figures(name, r, trace_dir)
            save_dir = r["res"]["save_path"]
            files = sorted(f for f in os.listdir(save_dir)
                           if f.endswith(".pth"))
            if files != ["0.pth", "1.pth", "train_best.pth",
                         "val_best.pth"]:
                raise AssertionError(f"U-RWKV trainer CLI checkpoints "
                                     f"{files}")
            # resume from 0.pth: epoch 2 again, at its learning rate
            ckpt0 = os.path.join(save_dir, "0.pth")
            saved = float(torch.load(ckpt0, weights_only=True)[
                "optimizer"]["state"][0]["step"])
            r2 = run(name, "resume", ("--checkpoint_path", ckpt0), epochs=2,
                     val_interval=1, save_model_interval=1)
            optim = r2["res"]["state"].optimizer
            lr = optim.param_groups[0]["lr"]
            want_lr = EpochScheduler(r2["cfg"]).learning_rate(1)
            now = float(optim.state_dict()["state"][0]["step"])
            per_epoch = r["epochs"][0]["steps"]
            if "Resumed from" not in r2["log"] or lr != want_lr \
                    or saved != per_epoch or now != saved + per_epoch:
                raise AssertionError(f"U-RWKV resume: lr {lr} (want "
                                     f"{want_lr}), optimizer step {saved} "
                                     f"-> {now}")
            # serve the run's val_best.pth on the test split
            test_json = os.path.join(work, "test.json")
            with open(test_json, "w") as f:
                json.dump({"result_metric_path": os.path.join(work,
                                                              "metric"),
                           "sliding_window": {"overlap": 0.25}}, f)
            zero_counts()
            t1 = time.perf_counter()
            rows = serve_main(["--dataset_name", "AutoPETII", "--model_name",
                               name, "--model_config", model_config_path,
                               "--train_config", r["argv"][-1],
                               "--test_config", test_json,
                               "--checkpoint_dir", save_dir])
            serve_s = time.perf_counter() - t1
            served = {n: c for n, c in counts().items() if c}
            n_test = n_cases - int((r["cfg"]["train_rate"]
                                    + r["cfg"]["val_rate"]) * n_cases)
            check_csv(os.path.join(work, "metric", "AutoPETII_U-RWKV.csv"),
                      BINARY_COLUMNS[:-1], n_test)
            if set(served) != {"wkv"}:
                raise AssertionError(f"U-RWKV served launches {served}")
            print(f"[21] {card} | U-RWKV resumed from 0.pth at epoch 2: lr "
                  f"{lr:.3e} (the scheduler's), optimizer step {saved:.0f} "
                  f"-> {now:.0f} ({r2['wall_s']:.1f} s) | val_best.pth "
                  f"served by cli.test_main on {len(rows)} test cases: dice "
                  + ", ".join(f"{row['dice']:.4f}" for row in rows)
                  + f" ({serve_s:.1f} s, launches {served})", flush=True)
            out[name] = dict(fig, launches_total=r["launches"],
                             n_val=n_val, resume_s=r2["wall_s"],
                             serve_s=serve_s, served_launches=served)
            del r, r2, optim
            torch.cuda.empty_cache()
    return out


# -- phase 22: zoo training, part two --------------------------------------

# the real dropout's checks on the card: these models' steps at their
# published rates
ZOO_REAL_DROPOUT = ("VNet", "HCMA-UNet")
# and cli.train_main on these
ZOO_TRAIN_CLI_DROPOUT = ("VNet", "SuperLightNet", "HCMA-UNet")


def real_dropout_steps(card, all_models, names=ZOO_REAL_DROPOUT,
                       size=(32, 32, 32), b=2):
    """Phase 22: one bf16 train step of each of ``names`` on the card at
    its published dropout rates, drawing from a CUDA generator: every
    site's mask recorded (``models/zoo/common.dropout`` wrapped). A
    second step from the same weights and generator seed gives the same
    masks, loss and gradients bit for bit (cuDNN's deterministic
    algorithms on for the three steps); a third under another seed other
    masks and another loss. Each site's keep fraction (the kept share of
    its nonzero inputs; per sample and channel for VNet's channel
    dropouts) lies within 4σ of its binomial: the worst is printed."""
    import numpy as np
    import torch
    from veloxseg_torch.models.registry import load_model
    from veloxseg_torch.models.zoo import common
    from veloxseg_torch.train.loss import CompositeLoss
    from veloxseg_torch.train.optim import build_optimizer
    from veloxseg_torch.train.train_state import (create_train_state,
                                                  train_step_fn)
    real = common.dropout
    out = {}
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((b, *size, 2))
                         .astype(np.float32))
    y = torch.from_numpy((rng.random((b, *size)) < 0.3).astype(np.int64))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name in names:
            t0 = time.perf_counter()
            cfg = {name: sized_entry(name, all_models[name], size)}
            runs = []
            for seed in (7, 7, 8):
                sites = []

                def recording(t, rate, training, generator, channel=False,
                              sites=sites):
                    got = real(t, rate, training, generator, channel)
                    if training and rate:
                        kept, live = got != 0, t != 0
                        if channel:
                            kept = kept.flatten(2).any(-1)
                            live = live.flatten(2).any(-1)
                        sites.append((rate, channel, kept & live,
                                      int(live.sum())))
                    return got

                model = load_model(name, cfg, device="cuda", seed=0,
                                   input_size=size)
                state = create_train_state(model, build_optimizer(
                    "adamw", {"lr": 2.5e-4, "weight_decay": 0.01},
                    model.parameters()))
                step = train_step_fn(CompositeLoss(name, {
                    "deep_Loss_weight": [1, 1, 1, 1]}), "cuda",
                    with_metrics=False, compute_dtype=torch.bfloat16)
                common.dropout = recording
                try:
                    state, aux = step(state, x, y, torch.Generator(
                        "cuda").manual_seed(seed))
                finally:
                    common.dropout = real
                torch.cuda.synchronize()
                runs.append((float(aux["loss"]), sites, {
                    k: p.grad.detach().clone()
                    for k, p in model.named_parameters()}))
                del model, state
            (l0, s0, g0), (l1, s1, g1), (l2, s2, _) = runs
            same = (l0 == l1 and len(s0) == len(s1) and all(
                torch.equal(a[2], c[2]) for a, c in zip(s0, s1))
                and all(torch.equal(g, g1[k]) for k, g in g0.items()))
            other = l2 != l0 and any(not torch.equal(a[2], c[2])
                                     for a, c in zip(s0, s2))
            worst, worst_site, draws = 0.0, None, 0
            for i, (rate, channel, kept, n) in enumerate(s0):
                keep = 1.0 - rate
                share = float(kept.sum()) / n
                z = abs(share - keep) / math.sqrt(keep * (1 - keep) / n)
                draws += n
                if z > worst:
                    worst, worst_site = z, (i, rate, channel, n, share)
            if not (same and other and s0 and worst <= 4.0
                    and all(math.isfinite(r[0]) for r in runs)):
                raise AssertionError(
                    f"{name} real dropout: repeat bit for bit {same}, "
                    f"another seed differs {other}, {len(s0)} sites, worst "
                    f"keep fraction {worst:.2f} sigma at {worst_site}")
            rates = sorted({(r, c) for r, c, _, _ in s0})
            print(f"[22] {card} | {name} bf16 train step ({b}, "
                  f"{'x'.join(map(str, size))}, 2) at its published "
                  f"dropout rates {rates} (rate, per channel), a CUDA "
                  f"generator: {len(s0)} sites, {draws} draws; the same "
                  f"seed again bit for bit (masks, loss {l0:.6f}, "
                  f"{len(g0)} gradients), another seed other masks (loss "
                  f"{l2:.6f}) | worst site's keep fraction "
                  f"{worst_site[4]:.5f} against {1 - worst_site[1]} over "
                  f"{worst_site[3]} draws: {worst:.2f} sigma (tol 4) | "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            out[name] = dict(sites=len(s0), draws=draws, rates=rates,
                             worst_sigma=worst, losses=[l0, l1, l2])
            del runs, s0, s1, s2, g0, g1
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


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
    phase_s, t_lap = {}, [time.perf_counter()]

    def lap(k):
        """Seconds of phase ``k``, from the end of the one before."""
        now = time.perf_counter()
        phase_s[k] = round(now - t_lap[0], 1)
        t_lap[0] = now

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
    for name, (source, _) in _cuda.LIBRARIES.items():
        _cuda.lib(source, torch.bfloat16 if name.endswith("_bf16")
                  else torch.float32)
    print(f"[2] built {len(_cuda.LIBRARIES)} kernel libraries in "
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
    bt_dict = load_json_config(os.path.join(
        ROOT, "config", "models_config_brats2021.json"))["VeloxSeg"]
    train_cfg = load_json_config(os.path.join(
        ROOT, "config", "train_config_bs4.json"))
    tiles = 4                                    # sw_batch_size
    batch = train_cfg["batch_size"]              # 2
    fcfg = flagship_config()                     # bench.py's 128³ model
    big_batch = 16                               # bench.py's B

    lap(2)
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
        "wkv": wkv.wkv, "wkv_bwd": wkv.wkv_bwd})
    # each kernel's count: its wrapper's ``launches`` (the fp32 form) or,
    # for the bf16 forms, ``launches_bf16``
    counters = {n: (w, "launches") for n, w in wrappers.items()}
    counters.update({f"{n}_bf16": (wrappers[n], "launches_bf16") for n in (
        "pwa_attention", "pwa_attention_train_fwd", "pwa_attention_train_bwd",
        "pwa_attention_train_fwd_long", "pwa_attention_train_bwd_long",
        "jlc_stage1", "jlc_stage2", "jlc_stage1_bwd", "jlc_branch_wgrad",
        "jlc_stage2_bwd")})

    def zero_counts():
        for w, attr in counters.values():
            setattr(w, attr, 0)

    def counts():
        return {n: getattr(w, attr) for n, (w, attr) in counters.items()}

    # -- phase 21, part 1: the zoo's train steps card vs CPU ------------------
    report["zoo_train_steps"] = zoo_train_steps(card, zero_counts, counts,
                                                all_models)
    torch.cuda.empty_cache()
    lap("21_steps")
    # -- phase 22, part 1: the seven that draw in training, in factor mode
    report["zoo_train_dropout_steps"] = zoo_train_steps(
        card, zero_counts, counts, all_models, names=ZOO_TRAIN_DROPOUT,
        sizes=ZOO_TRAIN_DROPOUT_SIZE, tag=22, factor=True, moved=True)
    torch.cuda.empty_cache()
    lap("22_steps")
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
               plain_ms, library_ms, unit="serving", tc_flop=0, tag=3):
        """``weight``: calls per ``unit`` at this shape (0: checked and
        timed, but in no unit's sums); ``tc_flop``: products of bf16
        operands, bounded at the tensor cores' rate."""
        b_ms, b_by = bound(n_bytes, n_flop, tc_flop)
        row = dict(kernel=kname, shape=shape_name, unit=unit,
                   calls_per_unit=weight, bytes=n_bytes, flop=n_flop,
                   tc_flop=tc_flop,
                   max_abs_err=err[0], max_rel_err=err[1], ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms)
        report["shapes"].append(row)
        print(f"[{tag}] {kname} {shape_name}: max abs err {err[0]:.3e} rel "
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
        acc["to"] += weight * ops_ms(n_flop, tc_flop)
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
        got, lse, out32 = fwd(*qkvb, scale, p_drop)
        saved = (out32, lse)
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
    # the trainer's step (phase 14): batch_size 2 x num_samples 2 patches,
    # B = 4; K2 at every level, the JLC blocks (drawn last, so the inputs
    # of the checksums above stay as they were)
    for name, b, h, n, cqk, cv, L in k1_shapes(cfg_dict, range(4),
                                               2 * batch):
        train_attention(False, f"B4_{name}", b, h, n, cqk, cv, L, 1,
                        "train_96_b4")
    jlc_cases("B4_", cfg_dict, 2 * batch, "train_96_b4", (4, 4, 4, 1), True)

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
    # -- phase 3: the bf16 forms, on the operands the trainer's steps pass --
    bf = torch.bfloat16
    vs_fp32 = {}     # (kernel, shape): (bf16 ms, the fp32 form's ms)
    # K1's, K5f's and K5b's forms, by device time (events at these sizes
    # time the host's issue): (kernel, shape): (bf16 device ms, the fp32
    # form's)
    vs_fp32_dev = {}

    def device_pair(key, fn16, fn32):
        vs_fp32_dev[key] = (device_ms(fn16), device_ms(fn32))
        return f"device {vs_fp32_dev[key][0]:.4f} ms (fp32 form " \
               f"{vs_fp32_dev[key][1]:.4f})"

    def train_attention_bf16(name, b, h, n, cqk, cv, L, weight, unit,
                             long=False):
        """K2f and K2b (``long``: K3f and K3b) on bf16 q, k, v, dO (bias
        fp32) at p = 0.1 against their bf16 plain versions, timed beside
        SDPA in bf16 and beside the fp32 forms on the same values."""
        pa = pwa_attention
        tag = "K3" if long else "K2"
        fwd = pa.window_attention_train_fwd_long if long \
            else pa.window_attention_train_fwd
        bwd = pa.window_attention_train_bwd_long if long \
            else pa.window_attention_train_bwd
        fname = fwd.__name__.replace("window_attention", "pwa_attention")
        bname = bwd.__name__.replace("window_attention", "pwa_attention")

        def fwd_plain():
            if long:
                return pa.window_attention_train_fwd_long_plain(
                    *qkvb, scale, p_drop)[0]
            return pa.window_attention_train_fwd_plain(*qkvb, scale, p_drop)

        def bwd_plain():
            return pa.window_attention_train_bwd_plain(
                *qkvb, do, scale, p_drop, row_blocked=long)
        q, k = randn(b, h, n, cqk, L).to(bf), randn(b, h, n, cqk, L).to(bf)
        v, do = randn(b, h, n, cv, L).to(bf), randn(b, h, n, cv, L).to(bf)
        bias = randn(h, L, L, scale=0.5)
        scale = 1.0 / cqk ** 0.5
        qkvb = (q, k, v, bias, seed)
        out, lse, out32 = fwd(*qkvb, scale, p_drop)
        require_close(f"{tag}f bf16 {name} lse", lse,
                      pa.train_lse_plain(q, k, bias, scale), atol=1e-5,
                      rtol=1e-5)
        ref = fwd_plain()
        torch.cuda.synchronize()
        err_f, equal = require_bf16_match(f"{tag}f bf16 {name}", out, ref)
        del ref
        if long:  # out32: the product of the unrounded weights, K3b's D
            require_close(f"K3f bf16 {name} out32", out32,
                          pa.window_attention_train_fwd_long_plain(
                              *qkvb, scale, p_drop)[1], atol=1e-5, rtol=1e-4)
        q4, k4, v4, do4 = (t.permute(0, 2, 1, 4, 3).reshape(b * n, h, L, -1)
                           .contiguous() for t in (q, k, v, do))
        bias4 = bias.to(bf)
        for t in (q4, k4, v4, bias4):
            t.requires_grad_()

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, k4, v4, bias4[None], dropout_p=p_drop, scale=scale)
        with torch.no_grad():
            lib_f = cuda_ms(sdpa, 5)
            backend = sdpa_backend(sdpa)
        y4 = sdpa()

        def sdpa_bwd():
            return torch.autograd.grad(y4, (q4, k4, v4, bias4), do4,
                                       retain_graph=True)
        lib_b = cuda_ms(sdpa_bwd, 5)
        del y4, q4, k4, v4, do4, bias4
        backends[f"{tag} bf16 {name}"] = backend
        work_f, work_b = train_attention_work_bf16(b, h, n, cqk, cv, L)
        ms_f = cuda_ms(lambda: fwd(*qkvb, scale, p_drop))
        record(f"{fname}_bf16", name, weight, *work_f[:2], err_f, ms_f,
               cuda_ms(fwd_plain, 5), lib_f, unit, work_f[2])

        grads = bwd(*qkvb, do, scale, p_drop, out32, lse)
        again = bwd(*qkvb, do, scale, p_drop, out32, lse)
        refs = bwd_plain()
        torch.cuda.synchronize()
        gerrs = [require_bf16_match(f"{tag}b bf16 {name} {gname}", g, r)[0]
                 for gname, g, r in zip(("dq", "dk", "dv"), grads, refs)]
        top = float(refs[3].abs().max())
        require_close(f"{tag}b bf16 {name} dbias", grads[3], refs[3],
                      atol=1e-4 * top, rtol=1e-4)
        gerrs.append(max_err(grads[3], refs[3]))
        for gname, g, g2 in zip(("dq", "dk", "dv", "dbias"), grads, again):
            if not torch.equal(g, g2):
                raise AssertionError(f"{tag}b bf16 {name}: {gname} differs "
                                     f"between calls")
        sums[f"{tag}b bf16 {name} dbias"] = checksum(grads[3])
        del grads, again, refs
        ms_b = cuda_ms(lambda: bwd(*qkvb, do, scale, p_drop, out32, lse))
        record(f"{bname}_bf16", name, weight, *work_b[:2],
               (max(e[0] for e in gerrs), max(e[1] for e in gerrs)), ms_b,
               cuda_ms(bwd_plain, 5), lib_b, unit, work_b[2])
        # the fp32 forms on the same values
        qkvb32 = (q.float(), k.float(), v.float(), bias, seed)
        do32 = do.float()
        o32, l32, _ = fwd(*qkvb32, scale, p_drop)
        vs_fp32[f"{tag}f {name}"] = (ms_f, cuda_ms(
            lambda: fwd(*qkvb32, scale, p_drop)))
        vs_fp32[f"{tag}b {name}"] = (ms_b, cuda_ms(
            lambda: bwd(*qkvb32, do32, scale, p_drop, o32, l32)))
        if long:
            print(f"[3] K3f bf16 {name}: geometry "
                  f"{pa.long_mma_launch(b, h, n, L, _cuda.sm_count(dev))}",
                  flush=True)
        print(f"[3] {tag} bf16 {name}: out {equal:.4%} bit-equal to the "
              f"plain version | fwd {ms_f:.4f} ms (fp32 form "
              f"{vs_fp32[f'{tag}f {name}'][1]:.4f}), bwd {ms_b:.4f} ms (fp32 "
              f"form {vs_fp32[f'{tag}b {name}'][1]:.4f}) | SDPA bf16 backend "
              f"{backend}", flush=True)
        del out, lse, out32, o32, l32
        torch.cuda.empty_cache()

    def stage2_bf16(name, out1, e, weight, unit, backward):
        """K5f's bf16 form on the bf16 ``out1`` and seeded bf16 weights
        (and with ``backward`` K5b's, on K5f's statistics as the train step
        runs it) against the bf16 plain versions, timed beside the fp32
        forms on the same values; no one library call computes them. The
        statistics and every K5b output must repeat bit for bit."""
        b, c, s = out1.shape[0], out1.shape[1], out1.shape[2]
        sms = _cuda.sm_count(dev)
        w1 = randn(e * c, c, 1, 1, 1, scale=(2.0 / c) ** 0.5).to(bf)
        b1 = randn(e * c, scale=0.1).to(bf)
        w2 = randn(c, e * c, 1, 1, 1, scale=(2.0 / (e * c)) ** 0.5).to(bf)
        b2 = randn(c, scale=0.1).to(bf)
        f32 = [t.float() for t in (out1, w1, b1, w2, b2)]
        with torch.inference_mode():
            out, mean, rstd = fused_jlc._jlc_stage2_fwd(out1, w1, b1, w2, b2)
            again = fused_jlc._jlc_stage2_fwd(out1, w1, b1, w2, b2)
            ref = fused_jlc.jlc_stage2_plain(out1, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err5, equal = require_bf16_match(f"K5f bf16 {name}", out, ref)
            for what, t, t2 in zip(("out", "mean", "rstd"),
                                   (out, mean, rstd), again):
                if not torch.equal(t, t2):
                    raise AssertionError(f"K5f bf16 {name}: {what} differs "
                                         f"between calls")
            del out, again, ref
            f_bytes, f_flop, f_tc = stage2_fwd_work_bf16(b, c, e, s ** 3)
            ms5f = cuda_ms(lambda: fused_jlc.jlc_stage2(out1, w1, b1, w2,
                                                        b2))
            record("jlc_stage2_bf16", name, weight, f_bytes, f_flop, err5,
                   ms5f, cuda_ms(lambda: fused_jlc.jlc_stage2_plain(
                       out1, w1, b1, w2, b2), 5), None, unit, f_tc)
            vs_fp32[f"K5f {name}"] = (ms5f, cuda_ms(
                lambda: fused_jlc.jlc_stage2(*f32)))
            _, m32, r32 = fused_jlc._jlc_stage2_fwd(*f32)
            dev5f = device_pair(
                f"K5f {name}",
                lambda: fused_jlc.jlc_stage2(out1, w1, b1, w2, b2),
                lambda: fused_jlc.jlc_stage2(*f32))
        text = (f"K5f {ms5f:.4f} ms (fp32 form "
                f"{vs_fp32[f'K5f {name}'][1]:.4f}), {dev5f}, geometry "
                f"{fused_jlc.stage2_mma_launch(b, c, e * c, s ** 3, sms)}")
        if backward:
            g = randn(*out1.shape).to(bf)
            args = (out1, w1, b1, w2, g, mean, rstd)
            got = fused_jlc.jlc_stage2_bwd(*args)
            again = fused_jlc.jlc_stage2_bwd(*args)
            refs = fused_jlc.jlc_stage2_bwd_plain(out1, w1, b1, w2, g)
            torch.cuda.synchronize()
            errs5 = [require_bf16_match(f"K5b bf16 {name} {gname}", a,
                                        r)[0]
                     for gname, a, r in zip(("dx", "dw1", "db1", "dw2",
                                             "db2"), got, refs)]
            for gname, a, a2 in zip(("dx", "dW1", "db1", "dW2", "db2"),
                                    got, again):
                if not torch.equal(a, a2):
                    raise AssertionError(f"K5b bf16 {name}: {gname} "
                                         f"differs between calls")
            sums[f"K5b bf16 {name} dW1"] = checksum(got[1])
            sums[f"K5b bf16 {name} dW2"] = checksum(got[3])
            del got, again, refs
            b_bytes, b_flop, b_tc = stage2_bwd_work_bf16(b, c, e, s ** 3)
            ms5b = cuda_ms(lambda: fused_jlc.jlc_stage2_bwd(*args))
            record("jlc_stage2_bwd_bf16", name, weight, b_bytes, b_flop,
                   (max(x_[0] for x_ in errs5), max(x_[1] for x_ in errs5)),
                   ms5b, cuda_ms(lambda: fused_jlc.jlc_stage2_bwd_plain(
                       out1, w1, b1, w2, g), 5), None, unit, b_tc)
            g32 = g.float()
            vs_fp32[f"K5b {name}"] = (ms5b, cuda_ms(
                lambda: fused_jlc.jlc_stage2_bwd(*f32[:4], g32, m32, r32)))
            dev5b = device_pair(
                f"K5b {name}", lambda: fused_jlc.jlc_stage2_bwd(*args),
                lambda: fused_jlc.jlc_stage2_bwd(*f32[:4], g32, m32, r32))
            text += (f"; K5b {ms5b:.4f} ms (fp32 form "
                     f"{vs_fp32[f'K5b {name}'][1]:.4f}), {dev5b}")
        print(f"[3] K5 bf16 {name}: out {equal:.4%} bit-equal to the plain "
              f"version | {text}", flush=True)
        torch.cuda.empty_cache()

    def jlc_bf16_cases(tag, jcfg, b, unit, weights, stage2=False):
        """K4f, K4b and its wgrad on bf16 x, g and weights at the four JLC
        levels against their bf16 plain versions (the wgrad on the
        kernel's own dy), timed beside the fp32 forms on the same values;
        the wgrad's yardstick cuDNN's bf16 weight-only
        ``convolution_backward``. With ``stage2``, K5f and K5b on x as
        :func:`stage2_bf16` runs them (the train step at ``conv_drop``
        0)."""
        spatial0 = jcfg["input_size"][0] // jcfg["patch_size"]
        for i in range(4):
            c = jcfg["base_ch"] * 2 ** i
            s = spatial0 // 2 ** i
            groups = c // jcfg["min_dim_group"][i]
            cg = c // groups
            name, weight = f"{tag}L{i}", weights[i]
            x, g = randn(b, c, s, s, s).to(bf), randn(b, c, s, s, s).to(bf)
            ws = [randn(c, cg, k, k, k, scale=(2.0 / (cg * k ** 3)) ** 0.5)
                  .to(bf) for k in (1, 3, 5)]
            bs = [randn(c, scale=0.1).to(bf) for _ in ws]
            x32, g32 = x.float(), g.float()
            ws32, bs32 = [w.float() for w in ws], [t.float() for t in bs]
            vox = b * c * s ** 3
            w_numel = sum(w.numel() for w in ws)
            conv_flop = 2 * b * c * cg * sum(taps_in_bounds(s, k) ** 3
                                             for k in (1, 3, 5))
            with torch.inference_mode():
                out1 = fused_jlc.jlc_stage1(x, ws, bs, groups)
                ref1 = fused_jlc.jlc_stage1_plain(x, ws, bs, groups)
                torch.cuda.synchronize()
                err1, equal = require_bf16_match(f"K4f bf16 {name}", out1,
                                                 ref1)
                del out1, ref1
                ms4f = cuda_ms(lambda: fused_jlc.jlc_stage1(x, ws, bs,
                                                            groups))
                record("jlc_stage1_bf16", name, weight,
                       2 * (2 * vox + w_numel), 9 * 3 * vox + vox, err1,
                       ms4f, cuda_ms(lambda: fused_jlc.jlc_stage1_plain(
                           x, ws, bs, groups), 5), None, unit, conv_flop)
                vs_fp32[f"K4f {name}"] = (ms4f, cuda_ms(
                    lambda: fused_jlc.jlc_stage1(x32, ws32, bs32, groups)))

            dy, dws = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
            _, again = fused_jlc.jlc_stage1_bwd(x, ws, g, groups)
            ref_dy, _ = fused_jlc.jlc_stage1_bwd_plain(x, ws, g, groups)
            ref_w = fused_jlc.jlc_branch_wgrad_plain(x, dy, ws, groups)
            torch.cuda.synchronize()
            errs4 = [require_bf16_match(f"K4b bf16 {name} dy", dy,
                                        ref_dy)[0]]
            for k, a, r in zip((1, 3, 5), dws, ref_w):
                errs4.append(require_bf16_match(f"K4b bf16 {name} dW{k}", a,
                                                r)[0])
            for k, a, a2 in zip((1, 3, 5), dws, again):
                if not torch.equal(a, a2):
                    raise AssertionError(f"K4b bf16 {name}: dW{k} differs "
                                         f"between calls")
                sums[f"K4b bf16 {name} dW{k}"] = checksum(a)
            del again, ref_dy, ref_w
            err4 = (max(e[0] for e in errs4), max(e[1] for e in errs4))
            ms4b = cuda_ms(lambda: fused_jlc.jlc_stage1_bwd(x, ws, g, groups))
            record("jlc_stage1_bwd_bf16", name, weight,
                   2 * (2 * vox + w_numel + 3 * vox + w_numel),
                   19 * 3 * vox, err4, ms4b,
                   cuda_ms(lambda: fused_jlc.jlc_stage1_bwd_plain(
                       x, ws, g, groups), 5), None, unit, 2 * conv_flop)
            vs_fp32[f"K4b {name}"] = (ms4b, cuda_ms(
                lambda: fused_jlc.jlc_stage1_bwd(x32, ws32, g32, groups)))
            got = fused_jlc.jlc_branch_wgrad(x, dy, ws, groups)
            torch.cuda.synchronize()
            for k, a, r in zip((1, 3, 5), got, dws):
                if not torch.equal(a, r):
                    raise AssertionError(f"K4b bf16 wgrad {name}: dW{k} "
                                         f"differs from K4b's")
            del got

            def cudnn_wgrad():
                for w, dyj in zip(ws, dy):
                    torch.ops.aten.convolution_backward(
                        dyj, x, w, None, [1, 1, 1], [w.shape[-1] // 2] * 3,
                        [1, 1, 1], False, [0, 0, 0], groups,
                        [False, True, False])
            msw = cuda_ms(lambda: fused_jlc.jlc_branch_wgrad(x, dy, ws,
                                                             groups))
            record("jlc_branch_wgrad_bf16", name, weight,
                   2 * (vox + 3 * vox + w_numel), 0,
                   (max(e[0] for e in errs4[1:]),
                    max(e[1] for e in errs4[1:])), msw,
                   cuda_ms(lambda: fused_jlc.jlc_branch_wgrad_plain(
                       x, dy, ws, groups), 5), cuda_ms(cudnn_wgrad, 5), unit,
                   conv_flop)
            dy32 = dy.float()
            vs_fp32[f"wgrad {name}"] = (msw, cuda_ms(
                lambda: fused_jlc.jlc_branch_wgrad(x32, dy32, ws32, groups)))
            print(f"[3] K4 bf16 {name}: out1 {equal:.4%} bit-equal to the "
                  f"plain version | K4f {ms4f:.4f} ms (fp32 form "
                  f"{vs_fp32[f'K4f {name}'][1]:.4f}), K4b {ms4b:.4f} ms "
                  f"(fp32 form {vs_fp32[f'K4b {name}'][1]:.4f}), wgrad "
                  f"{msw:.4f} ms (fp32 form "
                  f"{vs_fp32[f'wgrad {name}'][1]:.4f})", flush=True)
            del dy, dws, dy32
            torch.cuda.empty_cache()
            if stage2:
                stage2_bf16(name, x, jcfg["conv_expansion_factor"][i],
                            weight, unit, True)

    # the AutoPET-II train step (B = 2, phase 6; at conv_drop 0 with K5,
    # phase 7) and the trainer's (B = 4, phase 14): K2 at every level, the
    # JLC blocks at their calls per step
    for bb, unit in ((batch, "train_96_bf16"),
                     (2 * batch, "train_96_b4_bf16")):
        for name, b, h, n, cqk, cv, L in k1_shapes(cfg_dict, range(4), bb):
            train_attention_bf16(f"B{bb}_{name}", b, h, n, cqk, cv, L, 1,
                                 unit)
        jlc_bf16_cases(f"B{bb}_", cfg_dict, bb, unit, (4, 4, 4, 1),
                       stage2=bb == batch)
    # the bf16 128³ flagship step (phase 9): K3 at level 1, at bench.py's
    # B = 16 and at B = 2 (in no unit)
    for name, b, h, n, cqk, cv, L in flag:
        if pwa_attention.uses_long_kernel(L):
            train_attention_bf16(f"flagship_{name}_B2", batch, h, n, cqk, cv,
                                 L, 0, "train_flagship_bf16", long=True)
            train_attention_bf16(f"flagship_{name}", b, h, n, cqk, cv, L, 1,
                                 "train_flagship_bf16", long=True)

    # the speed CLI's bf16 eval forward (phase 16) at the batch it finds,
    # B = 16: K1 at AutoPET-II's four levels (Hecktor's L = 512 and
    # BraTS's L = 216 too, in no unit), K4f and K5f at the four JLC
    # levels, K6 at U-RWKV's bottleneck (its fp32 kernel, bf16 cast at the
    # edges as the JAX package casts it)
    speed_b = 16

    def eval_attention_bf16(name, b, h, n, cqk, cv, L, weight, unit):
        """K1's bf16 form against its bf16 plain version, timed beside its
        fp32 form on the same values and beside SDPA in bf16 (the bias a
        bf16 float mask)."""
        pa = pwa_attention
        q, k = randn(b, h, n, cqk, L).to(bf), randn(b, h, n, cqk, L).to(bf)
        v, bias = randn(b, h, n, cv, L).to(bf), randn(h, L, L, scale=0.5)
        scale = 1.0 / cqk ** 0.5
        n_bytes, n_flop, n_tc = eval_attention_work_bf16(b, h, n, cqk, cv, L)
        with torch.inference_mode():
            got = pa.window_attention(q, k, v, bias, scale)
            ref = pa.window_attention_plain(q, k, v, bias, scale)
            torch.cuda.synchronize()
            err, equal = require_bf16_match(f"K1 bf16 {name}", got, ref)
            del got, ref
            qt, kt, vt = (t.transpose(-1, -2) for t in (q, k, v))
            mask = bias.to(bf)[None, :, None]
            ms = cuda_ms(lambda: pa.window_attention(q, k, v, bias, scale))
            record("pwa_attention_bf16", name, weight, n_bytes, n_flop, err,
                   ms, cuda_ms(lambda: pa.window_attention_plain(
                       q, k, v, bias, scale), 5),
                   cuda_ms(lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, mask, scale=scale), 5), unit, n_tc)
            q32, k32, v32 = q.float(), k.float(), v.float()
            vs_fp32[f"K1 {name}"] = (ms, cuda_ms(lambda: pa.window_attention(
                q32, k32, v32, bias, scale)))
            dev = device_pair(
                f"K1 {name}", lambda: pa.window_attention(q, k, v, bias, scale),
                lambda: pa.window_attention(q32, k32, v32, bias, scale))
        print(f"[3] K1 bf16 {name}: out {equal:.4%} bit-equal to the plain "
              f"version | {ms:.4f} ms (fp32 form "
              f"{vs_fp32[f'K1 {name}'][1]:.4f}), {dev}", flush=True)
        del q, k, v, qt, kt, vt, q32, k32, v32
        torch.cuda.empty_cache()

    for name, b, h, n, cqk, cv, L in k1_shapes(cfg_dict, range(4), speed_b):
        eval_attention_bf16(f"B16_{name}", b, h, n, cqk, cv, L, 1,
                            "speed_autopet")
    for tag, dcfg, lvl in (("hecktor", hk_dict, 1), ("brats", bt_dict, 1)):
        for name, b, h, n, cqk, cv, L in k1_shapes(dcfg, [lvl], speed_b):
            eval_attention_bf16(f"{tag}_B16_{name}", b, h, n, cqk, cv, L, 0,
                                "speed_autopet")
    spatial0 = cfg_dict["input_size"][0] // cfg_dict["patch_size"]
    for i, weight in enumerate((2, 2, 2, 1)):
        c, s = cfg_dict["base_ch"] * 2 ** i, spatial0 // 2 ** i
        groups = c // cfg_dict["min_dim_group"][i]
        cg = c // groups
        name = f"B16_L{i}"
        x = randn(speed_b, c, s, s, s).to(bf)
        ws = [randn(c, cg, k, k, k, scale=(2.0 / (cg * k ** 3)) ** 0.5)
              .to(bf) for k in (1, 3, 5)]
        bs = [randn(c, scale=0.1).to(bf) for _ in ws]
        vox = speed_b * c * s ** 3
        with torch.inference_mode():
            out1 = fused_jlc.jlc_stage1(x, ws, bs, groups)
            ref1 = fused_jlc.jlc_stage1_plain(x, ws, bs, groups)
            torch.cuda.synchronize()
            err1, _ = require_bf16_match(f"K4f bf16 {name}", out1, ref1)
            del ref1
            ms4f = cuda_ms(lambda: fused_jlc.jlc_stage1(x, ws, bs, groups))
            record("jlc_stage1_bf16", name, weight,
                   2 * (2 * vox + sum(w.numel() for w in ws)),
                   9 * 3 * vox + vox, err1, ms4f,
                   cuda_ms(lambda: fused_jlc.jlc_stage1_plain(
                       x, ws, bs, groups), 5), None, "speed_autopet",
                   2 * speed_b * c * cg * sum(taps_in_bounds(s, k) ** 3
                                              for k in (1, 3, 5)))
        stage2_bf16(name, out1, cfg_dict["conv_expansion_factor"][i],
                    weight, "speed_autopet", False)
        del x, out1
    b6s = speed_b
    k6s, v6s = (randn(b6s, t6, c6).to(bf) for _ in range(2))
    w6s, u6s = w6.to(bf), u6.to(bf)
    with torch.inference_mode():
        got = wkv.wkv(w6s, u6s, k6s, v6s)
        ref = wkv.wkv_plain(w6s.float(), u6s.float(), k6s.float(),
                            v6s.float()).to(bf)
        torch.cuda.synchronize()
        record("wkv", f"bf16 ({b6s},{t6},{c6})", 6, *wkv_work(b6s, t6, c6),
               require_bf16_match("K6 bf16", got, ref)[0],
               cuda_ms(lambda: wkv.wkv(w6s, u6s, k6s, v6s)),
               cuda_ms(lambda: wkv.wkv_plain(w6s, u6s, k6s, v6s), 5), None,
               "speed_urwkv")
        del got, ref
    report["bf16_vs_fp32_ms"] = vs_fp32
    report["bf16_vs_fp32_device_ms"] = vs_fp32_dev
    print(f"[3] bit-identical on repeat; checksums {json.dumps(sums)}",
          flush=True)
    report["checksums"] = sums
    report["sdpa_backends"] = backends

    lap(3)
    # -- phase 4: full-width eval forward, card vs CPU -----------------------

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
    # the same forward in bf16, as the speed CLI runs it (the model cast
    # with .to(bf16)), card against CPU: held to chip_measure.FORWARD_BOUND
    # relative to the CPU's own bf16-to-fp32 distance
    model16 = build_veloxseg(cfg_dict, device="cuda", seed=0)[0].to(bf)
    with torch.inference_mode():
        x96_16 = x96_dev.to(bf)
        zero_counts()
        y16 = model16(x96_16)
        torch.cuda.synchronize()
        per_forward16 = {n: c for n, c in counts().items() if c}
        fwd16_ms = cuda_ms(lambda: model16(x96_16), 5)
        cpu16 = build_veloxseg(cfg_dict, device="cpu", seed=0)[0].to(bf)
        t0 = time.perf_counter()
        y16_cpu = cpu16(x96.to(bf))
        cpu16_s = time.perf_counter() - t0
    if not bool(torch.isfinite(y16).all()):
        raise AssertionError("bf16 forward: non-finite output")
    want16 = {"pwa_attention_bf16": 4, "jlc_stage1_bf16": 7,
              "jlc_stage2_bf16": 7}
    if per_forward16 != want16:
        raise AssertionError(f"bf16 forward launches {per_forward16}, want "
                             f"{want16}")
    d4 = forward_distances(y16.float().cpu(), y16_cpu.float(), y_cpu)
    if not (d4["to_bf16"] <= FORWARD_BOUND["to_bf16"]
            and d4["to_fp32"] >= FORWARD_BOUND["to_fp32"]):
        raise AssertionError(f"bf16 forward card vs CPU outside "
                             f"{FORWARD_BOUND}: {d4}")
    print(f"[4] bf16 eval forward (1,96,96,96,2) card vs CPU, relative to "
          f"the CPU's bf16-to-fp32 distance: to its bf16 "
          f"{d4['to_bf16']:.4f} (<= {FORWARD_BOUND['to_bf16']}), to its "
          f"fp32 {d4['to_fp32']:.4f} (>= {FORWARD_BOUND['to_fp32']}) | GPU "
          f"{fwd16_ms:.3f} ms/forward (fp32 {fwd_ms:.3f}; CPU {cpu16_s:.2f} "
          f"s) | launches per forward {per_forward16}", flush=True)
    report["forward_bf16"] = dict(d4, gpu_ms=fwd16_ms, cpu_s=cpu16_s,
                                  launches_per_forward=per_forward16)
    del cpu_model, y_cpu, cpu16, y16_cpu, model16, y16, x96_16

    lap(4)
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

    lap(5)
    # -- phase 6: the train step, full width, as published -----------------
    del model, first, seg
    loss_obj = CompositeLoss("VeloxSeg", train_cfg,
                             num_modal=cfg.num_modalities)
    opt_cfg = train_cfg["optimizer"]

    def make_state(model_cfg, device, seed):
        m, _ = build_veloxseg(model_cfg, device=device, seed=seed)
        return create_train_state(m, build_optimizer(
            opt_cfg["optimizer_type"], opt_cfg["optimizer_args"],
            m.parameters()))

    def train_run(what, state, step, x_dev, y_dev, n_steps, want):
        """``n_steps`` timed steps after the counts are zeroed: (state,
        losses, ms per step, launches per step); the launches must be
        ``want`` (0 for the kernels not named)."""
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
        full = {n: want.get(n, 0) for n in counters}
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
    # on the card; bf16 as the trainer steps, and fp32
    steps = {"bf16": train_step_fn(loss_obj, compute_dtype=torch.bfloat16),
             "fp32": train_step_fn(loss_obj)}
    gen_dev = torch.Generator(device=dev).manual_seed(4)
    want32 = {"jlc_stage1": 13, "pwa_attention_train_fwd": 4,
              "pwa_attention_train_bwd": 4, "jlc_stage1_bwd": 13,
              "jlc_branch_wgrad": 13}
    wants = {"bf16": {f"{n}_bf16": c for n, c in want32.items()},
             "fp32": want32}
    runs6 = {}
    for dt in ("bf16", "fp32"):
        state = make_state(cfg_dict, "cuda", 0)
        torch.cuda.reset_peak_memory_stats()
        state, aux = steps[dt](state, xb_dev, yb_dev, gen_dev)  # warm-up
        first_loss = float(aux["loss"])
        state, losses, step_ms, got, per = train_run(
            f"AutoPET-II train {dt}", state, steps[dt], xb_dev, yb_dev, 10,
            wants[dt])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [first_loss] + losses
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train losses ({dt}) not falling: "
                                 f"{losses}")
        runs6[dt] = dict(batch=batch, ms_per_step=step_ms,
                         steps_per_s=1e3 / step_ms, peak_gb=peak_gb,
                         losses=losses, launches_per_step=per, launches=got)
        print(f"[6] AutoPET-II train step (B={batch}, 96³, {dt}, conv_drop "
              f"{cfg_dict['conv_drop']}): {step_ms:.3f} ms/step, "
              f"{1e3 / step_ms:.3f} steps/s over 10 steps, peak "
              f"{peak_gb:.2f} GB | loss step 1 {losses[0]:.5f} -> step 11 "
              f"{losses[-1]:.5f} | launches per step {per}", flush=True)
        del state
    step = steps["bf16"]
    want = wants["bf16"]
    per_step = runs6["bf16"]["launches_per_step"]
    train_launches = runs6["bf16"].pop("launches")
    train32_launches = runs6["fp32"].pop("launches")
    print(f"[6] bf16 step / fp32 step: "
          f"{runs6['bf16']['ms_per_step'] / runs6['fp32']['ms_per_step']:.3f}"
          f" of the time, {runs6['bf16']['peak_gb']:.2f} / "
          f"{runs6['fp32']['peak_gb']:.2f} GB peak", flush=True)
    report["train"] = runs6

    lap(6)
    # -- phase 7: conv_drop 0, stage 2 through K5f/K5b ---------------------
    # in bf16, as the trainer steps: K5's bf16 forms
    state = make_state(dict(cfg_dict, conv_drop=0.0), "cuda", 0)
    k5 = {"jlc_stage2": 13, "jlc_stage2_bwd": 13}
    want0 = dict(want, **{f"{n}_bf16": c for n, c in k5.items()})
    state, _, step0_ms, nodrop_launches, per_step0 = train_run(
        "AutoPET-II conv_drop 0", state, step, xb_dev, yb_dev, 2, want0)
    print(f"[7] conv_drop 0, bf16 (K5f, K5b in their bf16 forms): "
          f"{step0_ms:.3f} ms/step (2 steps) | launches per step "
          f"{per_step0}", flush=True)
    report["train_conv_drop0"] = dict(ms_per_step=step0_ms,
                                      launches_per_step=per_step0)
    del state
    # phase 3's calls per train step match these runs: the bf16 forms'
    # (K5's at conv_drop 0) and the fp32 forms'
    weights = {n: a["calls"] for n, a in units["train_96_bf16"].items()}
    weights32 = {n: a["calls"] for n, a in units["train_96"].items()}
    if weights != want0 or weights32 != dict(want32, **k5):
        raise AssertionError(f"phase-3 calls per step {weights}, "
                             f"{weights32} differ from the launches per "
                             f"step {want0}, {dict(want32, **k5)}")

    lap(7)
    # -- phase 8: one train step, card vs CPU, dropout off -----------------
    nodrop = dict(cfg_dict, attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
                  drop_path=0.0)

    def one_step(model_cfg, loss, xs, ys, seed, device, dtype=None):
        """(loss, {key: gradient on the CPU}, s) of one step from seeded
        weights."""
        st = make_state(model_cfg, device, seed)
        t0 = time.perf_counter()
        st, aux = train_step_fn(loss, device=device, compute_dtype=dtype)(
            st, xs, ys, None)
        step_loss = float(aux["loss"])
        step_s = time.perf_counter() - t0
        return step_loss, {k: p.grad.detach().cpu()
                           for k, p in st.model.named_parameters()}, step_s

    def card_vs_cpu(what, model_cfg, loss, xs, ys, seed):
        runs = [one_step(model_cfg, loss, xs, ys, seed, d)
                for d in ("cuda", "cpu")]
        out = compare_grads(what, [r[1] for r in runs],
                            [r[0] for r in runs])
        out["cpu_step_s"] = runs[1][2]
        return out, runs[1]

    r8, cpu32 = card_vs_cpu("AutoPET-II", nodrop, loss_obj, xb[:1], yb[:1],
                            5)
    print(f"[8] train step card vs CPU (B=1, dropout 0): loss "
          f"{r8['losses'][0]:.6f} vs {r8['losses'][1]:.6f} (rel "
          f"{r8['loss_rel']:.2e}, tol 1e-5) | {r8['n_grads']} gradients "
          f"within 1e-4 x own max + 1e-5 x largest "
          f"({r8['largest_grad']:.3e}); closest to its tolerance "
          f"{r8['worst_param']} at {r8['worst_ratio']:.3f} of it | CPU step "
          f"{r8['cpu_step_s']:.1f} s", flush=True)
    report["train_vs_cpu"] = r8
    # the same step in bf16, card against CPU, held by the bound the CPU
    # test holds the bf16 step to against the JAX one, derived here from
    # the CPU's own bf16-to-fp32 distance (chip_measure.step_distances)
    card16, cpu16 = (one_step(nodrop, loss_obj, xb[:1], yb[:1], 5, d,
                              torch.bfloat16) for d in ("cuda", "cpu"))
    d8 = step_distances(card16[:2], cpu16[:2], cpu32[:2])
    bad = step_bound_violations(d8)
    if bad:
        raise AssertionError(f"bf16 train step card vs CPU outside the "
                             f"bound {STEP_BOUND} in {bad}: {d8}")
    print(f"[8] bf16 train step card vs CPU (B=1, dropout 0): loss "
          f"{card16[0]:.6f} vs {cpu16[0]:.6f} (CPU fp32 {cpu32[0]:.6f}) | "
          f"relative to the CPU's bf16-to-fp32 distance: loss "
          f"{d8['loss']:.4f} (bound <= {STEP_BOUND['loss']}), all "
          f"gradients to the CPU's bf16 {d8['grads_to_bf16']:.4f} (<= "
          f"{STEP_BOUND['grads_to_bf16']}) and to its fp32 "
          f"{d8['grads_to_fp32']:.4f} (>= {STEP_BOUND['grads_to_fp32']}), "
          f"worst tensor {d8['tensor_to_bf16']:.4f} (<= "
          f"{STEP_BOUND['tensor_to_bf16']}, {d8['tensor']}) | CPU bf16 step "
          f"{cpu16[2]:.1f} s", flush=True)
    report["train_vs_cpu_bf16"] = dict(d8, cpu_step_s=cpu16[2],
                                       losses=[card16[0], cpu16[0],
                                               cpu32[0]])
    del card16, cpu16, cpu32
    del xb_dev, yb_dev
    torch.cuda.empty_cache()

    lap(8)
    # -- phase 9: path A, the 128³ flagship train step, B = 16 -------------
    xf = torch.randn(big_batch, 128, 128, 128, 2,
                     generator=torch.Generator().manual_seed(6))
    yf = (xf[..., 0] > 1.0).long()
    xf_dev, yf_dev = xf.to(dev), yf.to(dev)
    # bench.py:146-151: the same loss weights and AdamW as train_cfg's
    flag_loss = CompositeLoss("VeloxSeg", train_cfg,
                              num_modal=fcfg.num_modalities)
    want_f = {"jlc_stage1": 13, "jlc_stage2": 13, "jlc_stage1_bwd": 13,
              "jlc_branch_wgrad": 13, "jlc_stage2_bwd": 13,
              "pwa_attention_train_fwd": 3,
              "pwa_attention_train_bwd": 3,
              "pwa_attention_train_fwd_long": 1,
              "pwa_attention_train_bwd_long": 1}
    # in bf16 every kernel of the step runs its bf16 form (no fp32 K3)
    want_fs = {"bf16": {f"{n}_bf16": c for n, c in want_f.items()},
               "fp32": want_f}
    runs9 = {}
    for dt, cdt in (("bf16", torch.bfloat16), ("fp32", None)):
        flag_step = train_step_fn(flag_loss, compute_dtype=cdt)
        state = make_state(fcfg, "cuda", 0)
        torch.cuda.reset_peak_memory_stats()
        state, aux = flag_step(state, xf_dev, yf_dev, gen_dev)  # warm-up
        first_loss = float(aux["loss"])
        state, f_losses, flag_ms, got, flag_per_step = train_run(
            f"flagship train {dt}", state, flag_step, xf_dev, yf_dev, 10,
            want_fs[dt])
        flag_peak = torch.cuda.max_memory_allocated() / 1e9
        f_losses = [first_loss] + f_losses
        if not f_losses[-1] < f_losses[0]:
            raise AssertionError(f"flagship losses ({dt}) not falling: "
                                 f"{f_losses}")
        runs9[dt] = dict(
            batch=big_batch, ms_per_step=flag_ms, steps_per_s=1e3 / flag_ms,
            peak_gb=flag_peak, losses=f_losses,
            launches_per_step=flag_per_step, launches=got)
        print(f"[9] flagship train step (bench.py's 128³, B={big_batch}, "
              f"{dt}, attn/proj dropout {fcfg.attn_drop}, conv_drop "
              f"{fcfg.conv_drop}): {flag_ms:.3f} ms/step, "
              f"{1e3 / flag_ms:.4f} steps/s, "
              f"{big_batch * 1e3 / flag_ms:.3f} volumes/s over 10 steps, "
              f"peak {flag_peak:.2f} GB | loss step 1 {f_losses[0]:.5f} -> "
              f"step 11 {f_losses[-1]:.5f} | launches per step "
              f"{flag_per_step}", flush=True)
        del state
    flag_launches = runs9["fp32"].pop("launches")
    # the bf16 steps' K3 launches (its other kernels run at shapes phase 3
    # times in fp32 only, so they count in no path)
    flag16_launches = {n: (c if n.endswith("_long_bf16") else 0)
                       for n, c in runs9["bf16"].pop("launches").items()}
    # phase 3's calls per (fp32) flagship step match the run
    weights = {n: a["calls"] for n, a in units["train_flagship"].items()}
    if weights != want_f:
        raise AssertionError(f"phase-3 calls per flagship step {weights} "
                             f"differ from the launches per step {want_f}")
    weights = {n: a["calls"] for n, a in units["train_flagship_bf16"].items()}
    if weights != {n: c for n, c in want_fs["bf16"].items()
                   if n.endswith("_long_bf16")}:
        raise AssertionError(f"phase-3 calls per bf16 flagship step "
                             f"{weights} differ from its K3 launches")
    print(f"[9] bf16 flagship step {runs9['bf16']['ms_per_step']:.3f} ms / "
          f"fp32 {runs9['fp32']['ms_per_step']:.3f} ms: "
          f"{runs9['bf16']['ms_per_step'] / runs9['fp32']['ms_per_step']:.3f}"
          f" of the time, {runs9['bf16']['peak_gb']:.2f} / "
          f"{runs9['fp32']['peak_gb']:.2f} GB peak (phase 3's calls per "
          f"fp32 step agree)", flush=True)
    report["flagship_train"] = runs9
    del xf_dev, yf_dev
    torch.cuda.empty_cache()

    lap(9)
    # -- phase 10: one flagship step, card vs CPU, dropout off -------------
    flag_nodrop = fcfg.replace(attn_drop=0.0, proj_drop=0.0, conv_drop=0.0,
                               drop_path=0.0)
    r10, cpu32f = card_vs_cpu("flagship", flag_nodrop, flag_loss, xf[:1],
                              yf[:1], 7)
    print(f"[10] flagship train step card vs CPU (B=1, 128³, dropout 0): "
          f"loss {r10['losses'][0]:.6f} vs {r10['losses'][1]:.6f} (rel "
          f"{r10['loss_rel']:.2e}, tol 1e-5) | {r10['n_grads']} gradients "
          f"within 1e-4 x own max + 1e-5 x largest "
          f"({r10['largest_grad']:.3e}); closest to its tolerance "
          f"{r10['worst_param']} at {r10['worst_ratio']:.3f} of it | CPU "
          f"step {r10['cpu_step_s']:.1f} s", flush=True)
    report["flagship_vs_cpu"] = r10
    # the same step in bf16 (K3 in its bf16 forms on the card), card
    # against CPU, held as phase 8's bf16 step
    card16, cpu16 = (one_step(flag_nodrop, flag_loss, xf[:1], yf[:1], 7, d,
                              torch.bfloat16) for d in ("cuda", "cpu"))
    d10 = step_distances(card16[:2], cpu16[:2], cpu32f[:2])
    bad = step_bound_violations(d10)
    if bad:
        raise AssertionError(f"bf16 flagship step card vs CPU outside the "
                             f"bound {STEP_BOUND} in {bad}: {d10}")
    print(f"[10] bf16 flagship train step card vs CPU (B=1, 128³, dropout "
          f"0): loss {card16[0]:.6f} vs {cpu16[0]:.6f} (CPU fp32 "
          f"{cpu32f[0]:.6f}) | relative to the CPU's bf16-to-fp32 distance: "
          f"loss {d10['loss']:.4f} (<= {STEP_BOUND['loss']}), all gradients "
          f"to the CPU's bf16 {d10['grads_to_bf16']:.4f} (<= "
          f"{STEP_BOUND['grads_to_bf16']}) and to its fp32 "
          f"{d10['grads_to_fp32']:.4f} (>= {STEP_BOUND['grads_to_fp32']}), "
          f"worst tensor {d10['tensor_to_bf16']:.4f} (<= "
          f"{STEP_BOUND['tensor_to_bf16']}, {d10['tensor']}) | CPU bf16 step "
          f"{cpu16[2]:.1f} s", flush=True)
    report["flagship_vs_cpu_bf16"] = dict(
        d10, cpu_step_s=cpu16[2], losses=[card16[0], cpu16[0], cpu32f[0]])
    del xf, yf, card16, cpu16, cpu32f

    lap(10)
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
    # in bf16, as the speed CLI runs it, card against CPU (FORWARD_BOUND)
    urwkv16 = load_model("U-RWKV", all_models, device="cuda", seed=0).to(bf)
    with torch.inference_mode():
        x4_16 = x4_dev.to(bf)
        zero_counts()
        y4_16 = urwkv16(x4_16)
        torch.cuda.synchronize()
        u16_per_forward = {n: c for n, c in counts().items() if c}
        u16_ms = cuda_ms(lambda: urwkv16(x4_16), 5)
        cpu16 = load_model("U-RWKV", all_models, device="cpu",
                           seed=0).to(bf)
        t0 = time.perf_counter()
        y4_16_cpu = cpu16(x4.to(bf))
        u16_cpu_s = time.perf_counter() - t0
    if not bool(torch.isfinite(y4_16).all()) \
            or u16_per_forward != {"wkv": 6}:
        raise AssertionError(f"U-RWKV bf16 forward: launches "
                             f"{u16_per_forward} (want wkv 6) or non-finite")
    d11 = forward_distances(y4_16.float().cpu(), y4_16_cpu.float(), y4_cpu)
    if not (d11["to_bf16"] <= FORWARD_BOUND["to_bf16"]
            and d11["to_fp32"] >= FORWARD_BOUND["to_fp32"]):
        raise AssertionError(f"U-RWKV bf16 forward card vs CPU outside "
                             f"{FORWARD_BOUND}: {d11}")
    print(f"[11] U-RWKV bf16 forward (4,96,96,96,2) card vs CPU, relative "
          f"to the CPU's bf16-to-fp32 distance: to its bf16 "
          f"{d11['to_bf16']:.4f} (<= {FORWARD_BOUND['to_bf16']}), to its "
          f"fp32 {d11['to_fp32']:.4f} (>= {FORWARD_BOUND['to_fp32']}) | GPU "
          f"{u16_ms:.3f} ms/forward (fp32 {u_ms:.3f}; CPU {u16_cpu_s:.2f} s) "
          f"| launches per forward {u16_per_forward}", flush=True)
    report["urwkv_forward_bf16"] = dict(d11, gpu_ms=u16_ms,
                                        cpu_s=u16_cpu_s)
    del y4, y4_cpu, x4_dev, urwkv16, cpu16, y4_16, y4_16_cpu, x4_16

    lap(11)
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

    lap(12)
    # -- phase 13: the serving CLI (cli/test_main -> infer/driver) ---------
    del useg, ufirst, ulast, vol_dev, urwkv
    torch.cuda.empty_cache()
    cli = serving_cli_phase(
        card, zero_counts, counts, list(serving),
        {d: os.path.join(ROOT, "config", f"models_config_{n}.json")
         for d, n in (("AutoPETII", "autopetii"),
                      ("Hecktor2022", "hecktor2022"),
                      ("BraTS2021", "brats2021"))},
        train_cfg["patch_size"], tuple(train_cfg["spacing"]["AutoPETII"]))
    cli_launches = cli.pop("launches")
    u_cli_launches = cli["other"]["urwkv"].pop("launches")
    for key in ("autopet", "hecktor", "brats"):
        cli["other"][key].pop("launches")
    if {n: c for n, c in u_cli_launches.items() if c} != {"wkv": 6}:
        raise AssertionError(f"U-RWKV CLI launches {u_cli_launches}, want "
                             f"wkv 6 (one call of 4 tiles)")
    report["serving_cli"] = cli
    print(f"[13] serving CLI phase {cli['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in cli["steps_s"].items()),
          flush=True)

    lap(13)
    # -- phase 14: the training CLI (cli/train_main -> train/trainer) ------
    torch.cuda.empty_cache()
    tr = trainer_cli_phase(
        card, zero_counts, counts, per_step, per_forward,
        os.path.join(ROOT, "config", "models_config_autopetii.json"),
        os.path.join(ROOT, "config", "train_config_bs4.json"))
    # phase 3's calls per trainer step (B = 4, bf16) match phase 6's
    # launches
    weights = {n: a["calls"] for n, a in units["train_96_b4_bf16"].items()
               if n in per_step}
    if weights != per_step:
        raise AssertionError(f"phase-3 calls per trainer step {weights} "
                             f"differ from phase 6's per step {per_step}")
    trainer_train = tr.pop("launches_train")
    trainer_val = tr.pop("launches_val")
    tr.pop("launches")
    report["trainer_cli"] = tr
    print(f"[14] training CLI phase {tr['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in tr["steps_s"].items()),
          flush=True)

    lap(14)
    # -- phase 16: the speed CLI (cli/speed_main -> the bf16 eval forward) -
    from veloxseg_torch.cli import speed_main
    from veloxseg_torch.utils.flops import count_flops
    speed_main.T_TIMED = SPEED_T_TIMED
    speed_runs, speed_launches = {}, None
    for dataset, names in (("AutoPETII", "VeloxSeg,U-RWKV"),
                           ("Hecktor2022", "VeloxSeg"),
                           ("BraTS2021", "VeloxSeg")):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = speed_main.main([
            "--dataset", dataset, "--model_list", names, "--model_config",
            os.path.join(ROOT, "config",
                         f"models_config_{dataset.lower()}.json")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = counts()
        if [r["model"] for r in res] != names.split(",") or not all(
                r["device"] == "default" and r["throughput"] > 0
                and r["flops"] > 0 for r in res):
            raise AssertionError(f"speed CLI {dataset}: {res}")
        need = ["pwa_attention_bf16", "jlc_stage1_bf16", "jlc_stage2_bf16"]
        need += ["wkv"] if "U-RWKV" in names else []
        fp32_forms = [n for n in ("pwa_attention", "jlc_stage1",
                                  "jlc_stage2") if got[n]]
        if any(not got[n] for n in need) or fp32_forms:
            raise AssertionError(f"speed CLI {dataset}: launches {got}; "
                                 f"want {need} and no fp32 form")
        if dataset == "AutoPETII":
            speed_launches = got
        speed_runs[dataset] = dict(results=res, seconds=run_s, launches={
            n: c for n, c in got.items() if c})
        for r in res:
            print(f"[16] speed CLI {dataset} {r['model']}: "
                  f"{r['throughput']:.2f} images/s @ batch size "
                  f"{r['batch_size']}, Params {r['params'] / 1e6} M, FLOPS "
                  f"{r['flops'] / 1e9} G (T_TIMED {SPEED_T_TIMED} s)",
                  flush=True)
        print(f"[16] speed CLI {dataset}: {run_s:.1f} s | launches "
              f"{speed_runs[dataset]['launches']}", flush=True)
    # the operation count per image, on the card (kernels) and on the CPU
    # (plain versions), at AutoPET-II's full shape
    flops = {}
    for d in ("cuda", "cpu"):
        m = load_model("VeloxSeg", all_models, device=d, seed=0).to(bf)
        x1 = torch.zeros((1, *speed_main.INPUT_SIZE["AutoPETII"]), dtype=bf,
                         device=d)
        with torch.inference_mode():
            flops[d] = count_flops(m, x1)
        del m, x1
    cli_flops = speed_runs["AutoPETII"]["results"][0]["flops"]
    if not flops["cuda"] == flops["cpu"] == cli_flops:
        raise AssertionError(f"FLOPs per image card {flops['cuda']}, CPU "
                             f"{flops['cpu']}, CLI {cli_flops}")
    print(f"[16] FLOPs per image, VeloxSeg AutoPET-II (1,96,96,96,2) bf16: "
          f"card {flops['cuda']} = CPU {flops['cpu']}", flush=True)
    report["speed_cli"] = dict(runs=speed_runs, flops=flops,
                               t_timed=SPEED_T_TIMED)

    lap(16)
    # -- phase 17: the export CLI (cli/export_main -> infer/export) --------
    report["export_cli"] = export_phase(
        card, zero_counts, counts,
        os.path.join(ROOT, "config", "models_config_autopetii.json"),
        train_cfg["patch_size"]["AutoPETII"])

    lap(17)
    # -- phase 18: preprocess, then extern (cli/preprocess_main, extern_main)
    ext = extern_cli_phase(
        card, zero_counts, counts, list(serving),
        {d: os.path.join(ROOT, "config", f"models_config_{n}.json")
         for d, n in (("AutoPETII", "autopetii"),
                      ("BraTS2021", "brats2021"))},
        train_cfg["patch_size"], tuple(train_cfg["spacing"]["AutoPETII"]))
    extern_launches = ext.pop("launches")
    report["extern_cli"] = ext
    print(f"[18] preprocess and extern phase {ext['phase_s']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ext["steps_s"].items()),
          flush=True)

    lap(18)
    # -- phase 19: the zoo (registry baselines: forwards, speed CLI, serving)
    torch.cuda.empty_cache()
    zoo_configs = {d: os.path.join(ROOT, "config", f"models_config_{n}.json")
                   for d, n in (("AutoPETII", "autopetii"),
                                ("Hecktor2022", "hecktor2022"),
                                ("BraTS2021", "brats2021"))}
    report["zoo"] = zoo_phase(
        card, zero_counts, counts, zoo_configs, train_cfg["patch_size"],
        tuple(train_cfg["spacing"]["AutoPETII"]))
    print(f"[19] zoo phase {report['zoo']['phase_s']:.1f} s", flush=True)

    lap(19)
    # -- phase 20: the seven that close the zoo, HCMA-UNet served ----------
    torch.cuda.empty_cache()
    report["zoo_last"] = zoo_phase(
        card, zero_counts, counts, zoo_configs, train_cfg["patch_size"],
        tuple(train_cfg["spacing"]["AutoPETII"]), names=ZOO_LAST, tag=20,
        serve="HCMA-UNet")
    print(f"[20] zoo phase {report['zoo_last']['phase_s']:.1f} s",
          flush=True)

    lap(20)
    # -- phase 21, part 2: K6b and the trainer CLI on the zoo --------------
    torch.cuda.empty_cache()
    # K6b at U-RWKV's train shapes: (4, 216, 128) at AutoPET-II and BraTS
    # (6 launches a step, the unit "urwkv_train"), (4, 256, 128) at
    # Hecktor; w = decay / T as the model passes it (of both signs) and a
    # seeded w of ±1, where the state's log-max rescaling runs at each step
    k6b_cases = [(216, "model", 6), (216, "wide", 0), (256, "model", 0)]
    report["wkv_bwd"] = []
    route_ms = None
    for t_b, w_kind, weight in k6b_cases:
        decay, first, *_ = _fancy_init(c6)
        if w_kind == "model":
            wb = torch.from_numpy(decay / t_b).to(dev)
        else:
            wb = (torch.rand(c6, generator=gen) * 2 - 1).to(dev)
        ub = torch.from_numpy(first / t_b).to(dev)
        kb, vb, gb = (randn(b6, t_b, c6) for _ in range(3))
        got = wkv.wkv_bwd(wb, ub, kb, vb, gb)
        again = wkv.wkv_bwd(wb, ub, kb, vb, gb)
        ref = wkv.wkv_bwd_plain(wb, ub, kb, vb, gb)
        torch.cuda.synchronize()
        errs_b = []
        for name_g, g, g2, r in zip(("gw", "gu", "gk", "gv"), got, again,
                                    ref):
            scale = float(r.abs().max())
            e = float((g - r).abs().max())
            # fp32: the same two sweeps, expf and fused multiply-adds on
            # the card, the batch sums in the same order
            if not e <= 1e-4 * scale:
                raise AssertionError(f"K6b {name_g} ({b6},{t_b},{c6}) "
                                     f"{w_kind}: {e:.3e} on scale "
                                     f"{scale:.3e}")
            if not torch.equal(g, g2):
                raise AssertionError(f"K6b {name_g} differs on repeat")
            errs_b.append((e, e / scale))
        err_b = (max(e for e, _ in errs_b), max(r for _, r in errs_b))
        ms_b = cuda_ms(lambda: wkv.wkv_bwd(wb, ub, kb, vb, gb))
        for _ in range(3):  # the profiler drops a window's kernels at times
            dev_ms_b = device_ms(lambda: wkv.wkv_bwd(wb, ub, kb, vb, gb))
            if dev_ms_b > 0:
                break
        # the entry point launched back to back into preallocated outputs
        # (no allocation, no count): the host issues faster than the card
        # runs it, so events give the device's rate
        lib6, out6 = _cuda.lib("wkv"), [torch.empty_like(kb) for _ in "kv"]
        part6 = torch.empty(2, b6, c6, device=dev)
        gwu6 = torch.empty(2, c6, device=dev)
        raw_b = cuda_ms(lambda: lib6.vs_wkv_bwd(
            *(t.data_ptr() for t in (wb, ub, kb, vb, gb, *out6, part6,
                                     gwu6)),
            b6, t_b, c6, wkv.wkv_bwd_channels(t_b), _cuda.stream_ptr(dev)),
            200)
        plain_b = cuda_ms(lambda: wkv.wkv_bwd_plain(wb, ub, kb, vb, gb), 3)
        # the torch-op route: autograd through K6's chunked decomposition
        # in torch ops (not one call), its backward alone
        leaves = [t.clone().requires_grad_() for t in (wb, ub, kb, vb)]
        yb = wkv.wkv_chunked_plain(*leaves, wkv.wkv_launch(t_b).chunks)
        route = cuda_ms(lambda: torch.autograd.grad(
            yb, leaves, gb, retain_graph=True), 3)
        del yb, leaves
        if weight:
            route_ms = route
        record("wkv_bwd", f"({b6},{t_b},{c6}) w {w_kind}", weight,
               *wkv_bwd_work(b6, t_b, c6), err_b, ms_b, plain_b, None,
               "urwkv_train", tag=21)
        print(f"[21] K6b ({b6},{t_b},{c6}) w {w_kind}: bit-identical on "
              f"repeat | device {dev_ms_b:.4f} ms (profiler), "
              f"{raw_b:.4f} ms a raw launch (events) | the torch-op route "
              f"(autograd through wkv_chunked_plain, its backward) "
              f"{route:.3f} ms", flush=True)
        report["wkv_bwd"].append(dict(
            T=t_b, w=w_kind, max_abs_err=err_b[0], max_rel_err=err_b[1],
            ms=ms_b, device_ms=dev_ms_b, raw_launch_ms=raw_b,
            plain_ms=plain_b,
            torch_op_route_ms=route))
    # K6 at the train step's shape is phase 3's (4, 216, 128)
    units.setdefault("urwkv_train", {})["wkv"] = dict(
        units["urwkv_serving"]["wkv"])
    report["zoo_trainer"] = zoo_trainer_cli_phase(
        card, zero_counts, counts,
        os.path.join(ROOT, "config", "models_config_autopetii.json"),
        os.path.join(ROOT, "config", "train_config_bs4.json"))
    ztr = report["zoo_trainer"]["U-RWKV"]
    urwkv_train_launches = {n: ztr["launches_total"].get(n, 0)
                            for n in counters}
    print(f"[21] zoo training phase {time.perf_counter() - t_lap[0]:.1f} s",
          flush=True)

    lap(21)
    # -- phase 22, part 2: real dropout, and the trainer CLI on three ------
    torch.cuda.empty_cache()
    report["real_dropout"] = real_dropout_steps(card, all_models)
    report["zoo_trainer_dropout"] = zoo_trainer_cli_phase(
        card, zero_counts, counts,
        os.path.join(ROOT, "config", "models_config_autopetii.json"),
        os.path.join(ROOT, "config", "train_config_bs4.json"),
        names=ZOO_TRAIN_CLI_DROPOUT, tag=22)
    print(f"[22] zoo training, part two {time.perf_counter() - t_lap[0]:.1f}"
          f" s (its steps card vs CPU {phase_s['22_steps']} s, run after "
          f"phase 2)", flush=True)

    lap(22)
    # -- phase 15 -----------------------------------------------------------
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
        "wkv_bwd": ("veloxseg_torch/csrc/wkv.cu",
                    "veloxseg_tpu/ops/wkv.py:161"),
    }
    # the bf16 forms: the same sources built with -DVS_BF16 (but K3f's and
    # K5f's)
    bf16_forms = ("pwa_attention", "pwa_attention_train_fwd",
                  "pwa_attention_train_bwd", "pwa_attention_train_fwd_long",
                  "pwa_attention_train_bwd_long", "jlc_stage1", "jlc_stage2",
                  "jlc_stage1_bwd", "jlc_branch_wgrad", "jlc_stage2_bwd")
    meta.update({f"{n}_bf16": meta[n] for n in bf16_forms})
    # K3f's and K5f's bf16 forms are kernels of their own, on the tensor
    # cores
    meta["pwa_attention_train_fwd_long_bf16"] = (
        "veloxseg_torch/csrc/pwa_attention_long_mma.cu",
        "veloxseg_tpu/ops/pwa_attention.py:410")
    meta["jlc_stage2_bf16"] = ("veloxseg_torch/csrc/jlc_stage2_mma.cu",
                               "veloxseg_tpu/ops/fused_jlc.py:177")
    per = {"serving": "forward, 4 tiles, AutoPET-II 96³",
           "train_96": f"train step, B={batch}, AutoPET-II 96³",
           "train_96_bf16": f"bf16 train step, B={batch}, AutoPET-II 96³",
           "train_flagship": f"train step, B={big_batch}, flagship 128³",
           "train_flagship_bf16": f"bf16 train step, B={big_batch}, "
                                  f"flagship 128³",
           "urwkv_serving": "U-RWKV forward, 4 tiles, 96³",
           "urwkv_train": "U-RWKV train step, B=4, 96³",
           "speed_autopet": f"bf16 forward, B={speed_b}, AutoPET-II 96³ "
                            f"(speed CLI)"}
    headline = {"pwa_attention": "serving", "jlc_stage1": "serving",
                "jlc_stage2": "serving", "pwa_attention_train_fwd": "train_96",
                "pwa_attention_train_bwd": "train_96",
                "jlc_stage1_bwd": "train_96", "jlc_branch_wgrad": "train_96",
                "jlc_stage2_bwd": "train_96",
                "pwa_attention_train_fwd_long": "train_flagship",
                "pwa_attention_train_bwd_long": "train_flagship",
                "wkv": "urwkv_serving", "wkv_bwd": "urwkv_train"}
    headline.update({f"{n}_bf16": "train_96_bf16" for n in bf16_forms})
    headline.update({"pwa_attention_bf16": "speed_autopet",
                     "jlc_stage2_bf16": "speed_autopet",
                     "pwa_attention_train_fwd_long_bf16":
                         "train_flagship_bf16",
                     "pwa_attention_train_bwd_long_bf16":
                         "train_flagship_bf16"})
    # launches: the main-path runs, each counted from 0: the VeloxSeg
    # sliding window (5), the AutoPET-II train steps (6: bf16 and fp32; 7:
    # bf16, its K5 the fp32 kernels), the fp32 flagship train steps (9)
    # and the bf16 ones' K3 (their other kernels run at shapes phase 3
    # times in fp32 only), the U-RWKV sliding window (12), the serving
    # CLI's AutoPET-II and U-RWKV runs (13; its Hecktor and BraTS runs are
    # at shapes phase 3 does not time as a unit), the training CLI's main
    # run (14: its bf16 steps at B = 4, its validation forwards of 4
    # patches), the extern CLI's AutoPET-II run (18; its BraTS run as
    # phase 13's). ms, plain_ms, bound_ms:
    # summed over the kernel's calls in its headline unit (``per``).
    # excess_ms, the order of work on the kernels: per path, its launches
    # × (ms − bound_ms) per call at that path's own shapes (the first of
    # the path's units that times the kernel)
    paths = {"serving": (("serving",), launches),
             "serving_cli": (("serving",), cli_launches),
             "train_96": (("train_96_bf16", "train_96"), train_launches),
             "train_96_fp32": (("train_96",), train32_launches),
             "train_96_conv_drop0": (("train_96_bf16", "train_96"),
                                     nodrop_launches),
             "train_flagship": (("train_flagship",), flag_launches),
             "train_flagship_bf16": (("train_flagship_bf16",),
                                     flag16_launches),
             "urwkv_serving": (("urwkv_serving",), u_launches),
             "urwkv_cli": (("urwkv_serving",), u_cli_launches),
             "trainer_steps": (("train_96_b4_bf16", "train_96_b4"),
                               trainer_train),
             "trainer_validation": (("serving",), trainer_val),
             "speed_cli": (("speed_autopet", "speed_urwkv"), speed_launches),
             "extern_cli": (("serving",), extern_launches),
             "urwkv_trainer_cli": (("urwkv_train",), urwkv_train_launches)}
    line = {"kernels": []}
    for n, (src, replaces) in meta.items():
        k = units[headline[n]][n]
        by_path = {}
        for key, (unit_names, got) in paths.items():
            if not got[n]:
                continue
            u = next((units[un][n] for un in unit_names
                      if n in units.get(un, {})), None)
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
    for k in line["kernels"]:
        if k["name"] == "wkv_bwd":    # no one PyTorch call computes it
            k["torch_op_route_ms"] = route_ms
    report["units"] = units
    missing = set(meta) - {k["name"] for k in line["kernels"]
                           if k["launches"] > 0}
    if missing:
        raise AssertionError(f"kernels never launched on a main path: "
                             f"{missing}")
    report["kernels"] = line["kernels"]
    report["wall_s"] = time.perf_counter() - t_start
    lap(15)
    report["phase_s"] = phase_s
    print(f"[15] seconds per phase: {json.dumps(phase_s)}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"[15] all phases passed in {report['wall_s']:.1f} s", flush=True)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
