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
   equal the launches its run makes (phases 4, 7, 9, 11). Last, the bf16
   forms on bf16 operands, at the trainer's shapes: K2f and K2b (p = 0.1)
   at the four 96³ levels and K4f, K4b and its wgrad at the four JLC
   levels, at B = 2 (phase 6's step) and B = 4 (phase 14's), each against
   its bf16 plain version by the CPU tests' rule (at least 99% of the
   elements bit for bit equal, the rest within 1 bf16 ulp but at most 0.1%
   within 2^-8 of the largest magnitude), timed beside
   its fp32 form on the same values, bounded with 2-byte elements and the
   products of bf16 operands at the tensor cores' rate; the yardsticks in
   bf16 (SDPA; cuDNN's weight-only ``convolution_backward``).
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
   on one seeded synthetic batch whose labels threshold the PET channel,
   in bf16 as the trainer steps and then in fp32: each a warm-up step,
   then 10 timed steps (ms per step, steps/s, peak memory). The loss must
   be finite and fall; the launches per step must be K2f 4, K2b 4, K4f 13,
   K4b 13 (each with its weight-gradient launches: wgrad 13), of the bf16
   forms in bf16 and of the fp32 ones in fp32, and no other.
7. two bf16 steps with ``conv_drop`` 0, where stage 2 runs through its
   kernels, cast to fp32 at their edges: K5f 13 and K5b 13 per step.
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
   K4b (and its wgrad), K5f, K5b 13 each (in bf16 the bf16 forms of K2 and
   K4; K3 and K5 cast to fp32 at their edges), and the fp32 ones must
   equal phase 3's calls per step.
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
    Last, the steady run: 100 cases (links to the 10), 2 epochs of 30
    steps with the published intervals (no validation), launches per step
    phase 6's, the split of each epoch and its patches/s after the first
    batch, the trainer's own device ms per step and idle share from its
    ``profile_dir`` trace (steps 3-12), and the step outside the trainer,
    alone and beside a thread that drains the warm loader.
15. print the seconds of each phase, one ``{"kernels": [...]}`` line (a
    row per kernel and per bf16 form, with ``excess_ms``, each path's
    launches × (ms − bound) per call at that path's own shapes, summed),
    the card line, and last ``{"ok": true, "device": {...}}``.

Details go to ``<out>/chip_smoke.json`` (``--out``, default ``runs``).
"""

from __future__ import annotations

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
from chip_measure import (HBM_BYTES_PER_S, STEP_BOUND,  # noqa: E402
                          bound, card as card_line, cuda_ms,
                          eval_attention_work, ops_ms, sdpa_backend,
                          stage2_bwd_work, stage2_fwd_work,
                          step_bound_violations, step_distances,
                          train_attention_work, train_attention_work_bf16,
                          wkv_work)


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


def compare_rows(what, card_lg, cpu_lg, card_row, cpu_row, columns):
    """Card against CPU on one case: its blended logits within 1e-5 of the
    CPU's scale, masks equal except where the CPU's top-2 margin is below
    1e-4, the CSV's metrics within 1e-4 and HD95 within 1e-4 relative
    where the masks agree (NaN on both or neither). Returns the
    numbers."""
    import math

    import numpy as np
    scale = float(np.abs(cpu_lg).max())
    logit_err = float(np.abs(card_lg - cpu_lg).max())
    top2 = np.sort(cpu_lg, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    flips = np.argmax(card_lg, -1) != np.argmax(cpu_lg, -1)
    if not logit_err <= 1e-5 * scale:
        raise AssertionError(f"{what} card vs CPU: logits err "
                             f"{logit_err:.3e} on scale {scale:.3e}")
    if not (margin[flips] < 1e-4).all():
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
    return dict(logit_err=logit_err, scale=scale, flips=int(flips.sum()),
                metric_err=metric_err)


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
                       model_config_path, src_globs, n_src, n_cases=100):
    """Phase 14's epochs at a length where the per-epoch costs are minor:
    ``n_cases`` AutoPET-II cases (links to the ``n_src`` written ones, so
    60 train cases: 30 steps an epoch) with the published configs but for
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

    cases = os.path.dirname(src_globs["label_path"])
    root = os.path.join(work, "steady_cases")
    os.makedirs(root)
    names = sorted(os.listdir(cases))
    for i in range(n_cases):
        for name in names:
            if name.startswith(f"case{i % n_src:03d}"):
                os.symlink(os.path.join(cases, name), os.path.join(
                    root, f"case{i:03d}" + name[len("case000"):]))
    globs = {k: os.path.join(root, os.path.basename(v))
             for k, v in src_globs.items()}
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
    if len(epochs) != 2 or n_steps != 60 or any(e["val_batches"]
                                                for e in epochs):
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
        step = train_step_fn(CompositeLoss(cfg, state.model.cfg), dev,
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
    train_cfg = load_json_config(os.path.join(
        ROOT, "config", "train_config_bs4.json"))
    tiles = 4                                    # sw_batch_size
    batch = train_cfg["batch_size"]              # 2
    fcfg = flagship_config()                     # bench.py's 128³ model
    big_batch = 16                               # bench.py's B

    lap(2)
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
               plain_ms, library_ms, unit="serving", tc_flop=0):
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

    def train_attention_bf16(name, b, h, n, cqk, cv, L, weight, unit):
        """K2f and K2b on bf16 q, k, v, dO (bias fp32) at p = 0.1 against
        their bf16 plain versions, timed beside SDPA in bf16 and beside
        the fp32 forms on the same values."""
        pa = pwa_attention
        q, k = randn(b, h, n, cqk, L).to(bf), randn(b, h, n, cqk, L).to(bf)
        v, do = randn(b, h, n, cv, L).to(bf), randn(b, h, n, cv, L).to(bf)
        bias = randn(h, L, L, scale=0.5)
        scale = 1.0 / cqk ** 0.5
        qkvb = (q, k, v, bias, seed)
        out, lse, out32 = pa.window_attention_train_fwd(*qkvb, scale, p_drop)
        require_close(f"K2f bf16 {name} lse", lse,
                      pa.train_lse_plain(q, k, bias, scale), atol=1e-5,
                      rtol=1e-5)
        ref = pa.window_attention_train_fwd_plain(*qkvb, scale, p_drop)
        torch.cuda.synchronize()
        err_f, equal = require_bf16_match(f"K2f bf16 {name}", out, ref)
        del ref
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
        backends[f"K2 bf16 {name}"] = backend
        work_f, work_b = train_attention_work_bf16(b, h, n, cqk, cv, L)
        ms_f = cuda_ms(lambda: pa.window_attention_train_fwd(
            *qkvb, scale, p_drop))
        record("pwa_attention_train_fwd_bf16", name, weight, *work_f[:2],
               err_f, ms_f,
               cuda_ms(lambda: pa.window_attention_train_fwd_plain(
                   *qkvb, scale, p_drop), 5), lib_f, unit, work_f[2])

        grads = pa.window_attention_train_bwd(*qkvb, do, scale, p_drop, out32,
                                              lse)
        again = pa.window_attention_train_bwd(*qkvb, do, scale, p_drop, out32,
                                              lse)
        refs = pa.window_attention_train_bwd_plain(*qkvb, do, scale, p_drop)
        torch.cuda.synchronize()
        gerrs = [require_bf16_match(f"K2b bf16 {name} {gname}", g, r)[0]
                 for gname, g, r in zip(("dq", "dk", "dv"), grads, refs)]
        top = float(refs[3].abs().max())
        require_close(f"K2b bf16 {name} dbias", grads[3], refs[3],
                      atol=1e-4 * top, rtol=1e-4)
        gerrs.append(max_err(grads[3], refs[3]))
        for gname, g, g2 in zip(("dq", "dk", "dv", "dbias"), grads, again):
            if not torch.equal(g, g2):
                raise AssertionError(f"K2b bf16 {name}: {gname} differs "
                                     f"between calls")
        sums[f"K2b bf16 {name} dbias"] = checksum(grads[3])
        del grads, again, refs
        ms_b = cuda_ms(lambda: pa.window_attention_train_bwd(
            *qkvb, do, scale, p_drop, out32, lse))
        record("pwa_attention_train_bwd_bf16", name, weight, *work_b[:2],
               (max(e[0] for e in gerrs), max(e[1] for e in gerrs)), ms_b,
               cuda_ms(lambda: pa.window_attention_train_bwd_plain(
                   *qkvb, do, scale, p_drop), 5), lib_b, unit, work_b[2])
        # the fp32 forms on the same values
        qkvb32 = (q.float(), k.float(), v.float(), bias, seed)
        do32 = do.float()
        o32, l32, _ = pa.window_attention_train_fwd(*qkvb32, scale, p_drop)
        vs_fp32[f"K2f {name}"] = (ms_f, cuda_ms(
            lambda: pa.window_attention_train_fwd(*qkvb32, scale, p_drop)))
        vs_fp32[f"K2b {name}"] = (ms_b, cuda_ms(
            lambda: pa.window_attention_train_bwd(*qkvb32, do32, scale,
                                                  p_drop, o32, l32)))
        print(f"[3] K2 bf16 {name}: out {equal:.4%} bit-equal to the plain "
              f"version | fwd {ms_f:.4f} ms (fp32 form "
              f"{vs_fp32[f'K2f {name}'][1]:.4f}), bwd {ms_b:.4f} ms (fp32 "
              f"form {vs_fp32[f'K2b {name}'][1]:.4f}) | SDPA bf16 backend "
              f"{backend}", flush=True)
        del out, lse, out32, o32, l32
        torch.cuda.empty_cache()

    def jlc_bf16_cases(tag, jcfg, b, unit, weights):
        """K4f, K4b and its wgrad on bf16 x, g and weights at the four JLC
        levels against their bf16 plain versions (the wgrad on the
        kernel's own dy), timed beside the fp32 forms on the same values;
        the wgrad's yardstick cuDNN's bf16 weight-only
        ``convolution_backward``."""
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

    # the AutoPET-II train step (B = 2, phase 6) and the trainer's (B = 4,
    # phase 14): K2 at every level, the JLC blocks at their calls per step
    for bb, unit in ((batch, "train_96_bf16"),
                     (2 * batch, "train_96_b4_bf16")):
        for name, b, h, n, cqk, cv, L in k1_shapes(cfg_dict, range(4), bb):
            train_attention_bf16(f"B{bb}_{name}", b, h, n, cqk, cv, L, 1,
                                 unit)
        jlc_bf16_cases(f"B{bb}_", cfg_dict, bb, unit, (4, 4, 4, 1))
    report["bf16_vs_fp32_ms"] = vs_fp32
    print(f"[3] bit-identical on repeat; checksums {json.dumps(sums)}",
          flush=True)
    report["checksums"] = sums
    report["sdpa_backends"] = backends

    lap(3)
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
    # each kernel's count: its wrapper's ``launches`` (the fp32 form) or,
    # for the bf16 forms, ``launches_bf16``
    counters = {n: (w, "launches") for n, w in wrappers.items()}
    counters.update({f"{n}_bf16": (wrappers[n], "launches_bf16") for n in (
        "pwa_attention_train_fwd", "pwa_attention_train_bwd", "jlc_stage1",
        "jlc_stage1_bwd", "jlc_branch_wgrad")})

    def zero_counts():
        for w, attr in counters.values():
            setattr(w, attr, 0)

    def counts():
        return {n: getattr(w, attr) for n, (w, attr) in counters.items()}

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
    # in bf16, as the trainer steps: K5 runs cast to fp32 at its edges
    state = make_state(dict(cfg_dict, conv_drop=0.0), "cuda", 0)
    k5 = {"jlc_stage2": 13, "jlc_stage2_bwd": 13}
    want0 = dict(want, **k5)
    state, _, step0_ms, nodrop_launches, per_step0 = train_run(
        "AutoPET-II conv_drop 0", state, step, xb_dev, yb_dev, 2, want0)
    print(f"[7] conv_drop 0, bf16 (K5f, K5b cast to fp32 at their edges): "
          f"{step0_ms:.3f} ms/step (2 steps) | launches per step "
          f"{per_step0}", flush=True)
    report["train_conv_drop0"] = dict(ms_per_step=step0_ms,
                                      launches_per_step=per_step0)
    del state
    # phase 3's calls per train step match these runs: the bf16 forms' and
    # K5's (the fp32 kernels the bf16 step runs), and the fp32 forms'
    weights = {n: a["calls"] for n, a in units["train_96_bf16"].items()}
    weights.update({n: units["train_96"][n]["calls"] for n in k5})
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
    flag_loss = CompositeLoss(train_cfg, fcfg)
    want_f = {"jlc_stage1": 13, "jlc_stage2": 13, "jlc_stage1_bwd": 13,
              "jlc_branch_wgrad": 13, "jlc_stage2_bwd": 13,
              "pwa_attention_train_fwd": 3,
              "pwa_attention_train_bwd": 3,
              "pwa_attention_train_fwd_long": 1,
              "pwa_attention_train_bwd_long": 1}
    # in bf16, K3f, K3b, K5f and K5b run cast to fp32 at their edges (no
    # bf16 form yet), so they count as their fp32 forms
    edge_cast = ("jlc_stage2", "jlc_stage2_bwd",
                 "pwa_attention_train_fwd_long",
                 "pwa_attention_train_bwd_long")
    want_fs = {"bf16": {(n if n in edge_cast else f"{n}_bf16"): c
                        for n, c in want_f.items()}, "fp32": want_f}
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
              f"{flag_per_step}"
              + (f" (K3f, K3b, K5f, K5b cast to fp32 at their edges)"
                 if dt == "bf16" else ""), flush=True)
        del state
    flag_launches = runs9["fp32"].pop("launches")
    runs9["bf16"].pop("launches")
    # phase 3's calls per (fp32) flagship step match the run
    weights = {n: a["calls"] for n, a in units["train_flagship"].items()}
    if weights != want_f:
        raise AssertionError(f"phase-3 calls per flagship step {weights} "
                             f"differ from the launches per step {want_f}")
    print(f"[9] bf16 flagship step / fp32: "
          f"{runs9['bf16']['ms_per_step'] / runs9['fp32']['ms_per_step']:.3f}"
          f" of the time, {runs9['bf16']['peak_gb']:.2f} / "
          f"{runs9['fp32']['peak_gb']:.2f} GB peak (phase 3's calls per "
          f"fp32 step agree)", flush=True)
    report["flagship_train"] = runs9
    del xf_dev, yf_dev
    torch.cuda.empty_cache()

    lap(9)
    # -- phase 10: one flagship step, card vs CPU, dropout off -------------
    r10, _ = card_vs_cpu("flagship", fcfg.replace(
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
    del y4, y4_cpu, x4_dev

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
    }
    # the bf16 forms: the same sources built with -DVS_BF16
    bf16_forms = ("pwa_attention_train_fwd", "pwa_attention_train_bwd",
                  "jlc_stage1", "jlc_stage1_bwd", "jlc_branch_wgrad")
    meta.update({f"{n}_bf16": meta[n] for n in bf16_forms})
    per = {"serving": "forward, 4 tiles, AutoPET-II 96³",
           "train_96": f"train step, B={batch}, AutoPET-II 96³",
           "train_96_bf16": f"bf16 train step, B={batch}, AutoPET-II 96³",
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
    headline.update({f"{n}_bf16": "train_96_bf16" for n in bf16_forms})
    # launches: the main-path runs, each counted from 0: the VeloxSeg
    # sliding window (5), the AutoPET-II train steps (6: bf16 and fp32; 7:
    # bf16, its K5 the fp32 kernels), the fp32 flagship train steps (9;
    # its bf16 steps are at shapes phase 3 times in fp32 only), the U-RWKV
    # sliding window (12), the serving CLI's AutoPET-II and U-RWKV runs
    # (13; its Hecktor and BraTS runs are at shapes phase 3 does not time
    # as a unit), the training CLI's main run (14: its bf16 steps at B = 4,
    # its validation forwards of 4 patches). ms, plain_ms, bound_ms:
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
             "urwkv_serving": (("urwkv_serving",), u_launches),
             "urwkv_cli": (("urwkv_serving",), u_cli_launches),
             "trainer_steps": (("train_96_b4_bf16", "train_96_b4"),
                               trainer_train),
             "trainer_validation": (("serving",), trainer_val)}
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
