"""What ``chip_smoke.py`` and the tools in this directory share when they
measure the port on the card: the card's name and power limit, two timers
(CUDA events around back-to-back calls; the device time of
``torch.profiler``), the least time the card could take for a kernel's
work, and the byte and operation counts of the kernels that more than one
of them bounds. PyTorch is imported only by the timers."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20):
    """Mean ms of ``fn`` over ``iters`` back-to-back calls (after one
    warm-up), timed with CUDA events. Where the kernels take less time than
    the host needs to issue a call, this is the host's rate."""
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


def device_ms(fn, iters=10):
    """Device ms per call of ``fn``: the sum of its kernels' times in
    ``torch.profiler`` over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               ) / iters / 1e3


def trace_split(trace_dir):
    """Device time and wall of a ``torch.profiler`` trace that
    ``tensorboard_trace_handler`` wrote into ``trace_dir`` (one
    ``*.pt.trace.json``): the summed durations of its kernels, copies and
    memsets, in ms; the span from its first to its last event, in ms; the
    optimizer steps it holds (its ``Optimizer.step`` ranges); and its
    device operations."""
    import glob
    import json
    paths = sorted(glob.glob(f"{trace_dir}/*.pt.trace.json"))
    if len(paths) != 1:
        raise AssertionError(f"traces in {trace_dir}: {paths}")
    with open(paths[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    steps = sum(1 for e in events
                if e.get("cat") in ("user_annotation", "cpu_op")
                and e.get("name", "").startswith("Optimizer.step#"))
    return dict(device_ms=sum(e["dur"] for e in device) / 1e3,
                wall_ms=(end - start) / 1e3, steps=steps,
                device_ops=len(device))


def bound(n_bytes, n_flop):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the fp32 rate."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_flop / FP32_FLOP_PER_S * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def train_attention_work(b, h, n, cqk, cv, L):
    """Bytes and fp32 operations of the train attention's forward (K2f, K3f)
    and backward (K2b, K3b) on (b, h, n) windows of L tokens: ``((fwd_bytes,
    fwd_flop), (bwd_bytes, bwd_flop))``. Both forwards write each row's
    log-sum-exp, and both backwards read it with the forward's output.
    Every product runs on the fp32 pipes (no tensor cores)."""
    scores, rows = b * h * n * L * L, b * h * n * L
    qk, vv, bias = b * h * n * cqk * L, b * h * n * cv * L, h * L * L
    # q, k, v and bias in, out and the lse rows written, the 8-byte seed
    f_bytes = 4 * (2 * qk + 2 * vv + bias + rows) + 8
    # QKᵀ and PV, softmax as K1 (5 per score), and the mask: the hash's 14
    # integer operations and the select, per score, counted at the fp32
    # rate (the card's int32 rate is not higher)
    f_flop = 2 * scores * (cqk + cv) + 5 * scores + rows * cv + 16 * scores
    # q, k, v, dO, out and lse in, dq, dk, dv out, bias in and dbias out
    b_bytes = 4 * (2 * (2 * qk + vv) + 2 * bias + 2 * vv + rows) + 8
    # dOᵀV, dV, dQ, dK (QKᵀ is the forward's, not counted again); softmax,
    # dS (3) and the mask (16) per score; dbias summed over the windows
    b_flop = (2 * scores * (2 * cqk + 2 * cv) + 5 * scores + 3 * scores
              + 16 * scores + scores)
    return (f_bytes, f_flop), (b_bytes, b_flop)


def eval_attention_work(b, h, n, cqk, cv, L):
    """Bytes and fp32 operations of the eval attention (K1) on (b, h, n)
    windows of L tokens: q, k, v and bias in, out written; QKᵀ and PV,
    plus scale, bias, max, exp and sum per score and the final divide per
    output."""
    n_bytes = 4 * (b * h * n * L * (2 * cqk + 2 * cv) + h * L * L)
    n_flop = (2 * b * h * n * L * L * (cqk + cv) + 5 * b * h * n * L * L
              + b * h * n * L * cv)
    return n_bytes, n_flop


def wkv_work(b, t, c):
    """Bytes and operations of the WKV forward (K6) on (b, t, c): k, v and
    y once, w and u; per (b, t, c) 24 operations (two maxima, four
    exponentials, the output's quotient and the state's update)."""
    return 4 * (3 * b * t * c + 2 * c), 24 * b * t * c


def sdpa_backend(fn) -> str:
    """Which backend of ``scaled_dot_product_attention`` one call of ``fn``
    ran: the names of the device kernels it launched, mapped to the
    backend (flash, efficient, cudnn) or, for none of those, math."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    low = " ".join(names).lower()
    for key, backend in (("flash", "flash"), ("fmha", "efficient"),
                         ("efficient", "efficient"), ("cudnn", "cudnn")):
        if key in low:
            return backend
    return "math"


def stage2_fwd_work(b, c, e, s):
    """Bytes and fp32 operations of K5f on (b, c) planes of ``s`` voxels at
    expansion ``e``: out1 in and out written once, the weights and biases
    in."""
    vox = b * c * s
    n_bytes = 4 * (2 * vox + 2 * e * c * c + e * c + c)
    # the two channel products, then stats (2) and normalize (2) per input,
    # bias + GELU (5) per hidden, bias + residual (2)
    n_flop = 4 * vox * e * c + 4 * vox + 5 * vox * e + 2 * vox
    return n_bytes, n_flop


def stage2_bwd_work(b, c, e, s):
    """Bytes and fp32 operations of K5b on (b, c) planes of ``s`` voxels at
    expansion ``e``: out1 and g in, dx out, the weights in and their
    gradients out, K5f's statistics in."""
    vox = b * c * s
    hid = e * c
    n_bytes = 4 * (3 * vox + 2 * (2 * hid * c) + 2 * hid + 2 * c + 2 * b * c)
    # five channel products (W1ŷ, W2ᵀg, dW2, dW1, W1ᵀdz1) on the fp32
    # pipes, normalize (2), GELU and GELU' (14) per hidden value, the IN
    # backward (8)
    n_flop = 10 * vox * e * c + 2 * vox + 14 * vox * e + 8 * vox
    return n_bytes, n_flop
