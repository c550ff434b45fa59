"""What ``chip_smoke.py`` and the tools in this directory share when they
measure the port on the card: the card's name and power limit, two timers
(CUDA events around back-to-back calls; the device time of
``torch.profiler``), the least time the card could take for a kernel's
work, and the byte and operation counts of the kernels that more than one
of them bounds. PyTorch is imported only by the timers."""

from __future__ import annotations

import math
import subprocess

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12   # H100 SXM bf16 on the tensor cores, dense


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


def ops_ms(n_flop, tc_flop=0):
    """The least ms for ``n_flop`` fp32 operations and ``tc_flop`` products
    of bf16 operands (which the tensor cores could run beside them)."""
    return max(n_flop / FP32_FLOP_PER_S, tc_flop / BF16_TC_FLOP_PER_S) * 1e3


def bound(n_bytes, n_flop, tc_flop=0):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and the
    operations' least time (:func:`ops_ms`: fp32 operations over the fp32
    rate, products of bf16 operands over the bf16 tensor-core rate)."""
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = ops_ms(n_flop, tc_flop)
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


def train_attention_work_bf16(b, h, n, cqk, cv, L):
    """As :func:`train_attention_work` for the bf16 forms of K2f and K2b:
    ``((fwd_bytes, fwd_flop, fwd_tc_flop), (bwd_bytes, ...))``. q, k, v,
    dO, out, dq, dk, dv of 2 bytes; bias, lse, dbias and the forward's
    fp32 out (written by K2f, read by K2b) of 4. The products of bf16
    operands (QKᵀ and PV; dOᵀV, dV, dQ, dK) are counted at the tensor
    cores' rate (``tc_flop``), the rest as fp32."""
    scores, rows = b * h * n * L * L, b * h * n * L
    qk, vv, bias = b * h * n * cqk * L, b * h * n * cv * L, h * L * L
    f_bytes = 2 * (2 * qk + 2 * vv) + 4 * (vv + bias + rows) + 8
    f_tc = 2 * scores * (cqk + cv)
    f_flop = 5 * scores + rows * cv + 16 * scores
    b_bytes = 2 * (2 * (2 * qk + vv) + vv) + 4 * (vv + 2 * bias + rows) + 8
    b_tc = 2 * scores * (2 * cqk + 2 * cv)
    b_flop = 5 * scores + 3 * scores + 16 * scores + scores
    return (f_bytes, f_flop, f_tc), (b_bytes, b_flop, b_tc)


def eval_attention_work(b, h, n, cqk, cv, L):
    """Bytes and fp32 operations of the eval attention (K1) on (b, h, n)
    windows of L tokens: q, k, v and bias in, out written; QKᵀ and PV,
    plus scale, bias, max, exp and sum per score and the final divide per
    output."""
    n_bytes = 4 * (b * h * n * L * (2 * cqk + 2 * cv) + h * L * L)
    n_flop = (2 * b * h * n * L * L * (cqk + cv) + 5 * b * h * n * L * L
              + b * h * n * L * cv)
    return n_bytes, n_flop


def eval_attention_work_bf16(b, h, n, cqk, cv, L):
    """As :func:`eval_attention_work` for K1's bf16 form: ``(bytes, flop,
    tc_flop)``; q, k, v and out of 2 bytes, the bias of 4; QKᵀ and PV (bf16
    operands) at the tensor cores' rate, the rest as fp32."""
    scores = b * h * n * L * L
    n_bytes = 2 * b * h * n * L * (2 * cqk + 2 * cv) + 4 * h * L * L
    return (n_bytes, 5 * scores + b * h * n * L * cv,
            2 * scores * (cqk + cv))


def wkv_work(b, t, c):
    """Bytes and operations of the WKV forward (K6) on (b, t, c): k, v and
    y once, w and u; per (b, t, c) 24 operations (two maxima, four
    exponentials, the output's quotient and the state's update)."""
    return 4 * (3 * b * t * c + 2 * c), 24 * b * t * c


def wkv_bwd_work(b, t, c):
    """Bytes and operations of the WKV backward (K6b) on (b, t, c): k, v
    and gy read once, gk and gv written once, w and u read, gw and gu
    written; per (b, t, c) 56 operations: the forward sweep's 12 (a
    maximum, two exponentials, the state's update) and the reverse sweep's
    44 (the output rebuilt, two more exponentials, the four gradients and
    the adjoints' update)."""
    return 4 * (5 * b * t * c + 4 * c), 56 * b * t * c


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


def stage2_fwd_work_bf16(b, c, e, s):
    """As :func:`stage2_fwd_work` for K5f's bf16 form: ``(bytes, flop,
    tc_flop)``; out1, out, the weights and biases of 2 bytes; the two
    channel products (bf16 operands) at the tensor cores' rate."""
    vox = b * c * s
    n_bytes = 2 * (2 * vox + 2 * e * c * c + e * c + c)
    return (n_bytes, 4 * vox + 5 * vox * e + 2 * vox, 4 * vox * e * c)


def stage2_bwd_work_bf16(b, c, e, s):
    """As :func:`stage2_bwd_work` for K5b's bf16 form: ``(bytes, flop,
    tc_flop)``; out1, g, dx, the weights and their gradients of 2 bytes,
    the statistics of 4; the five channel products at the tensor cores'
    rate."""
    vox = b * c * s
    hid = e * c
    n_bytes = (2 * (3 * vox + 2 * (2 * hid * c) + 2 * hid + 2 * c)
               + 4 * 2 * b * c)
    return (n_bytes, 2 * vox + 14 * vox * e + 8 * vox, 10 * vox * e * c)


# The bound of a bf16 train step against a reference bf16 step, from the
# reference's own bf16-to-fp32 distance (step_distances): the most (or, for
# grads_to_fp32, the least) of each ratio. A step that computes in fp32
# lies 1.0 of that distance from the reference in its loss and ~0 from
# the fp32 step in its gradients, and fails. Two bf16 steps that round in
# other places make nearly independent rounding noise in the gradients, so
# the gradients are held over all tensors together to 1.5 of the distance
# and each tensor to 4 (measured, the largest per-tensor ratio: the port
# against JAX at TINY on the CPU 0.95 over all tensors; the port on the
# card against the CPU at full width 0.62; the losses 0.06 and 0.22).
STEP_BOUND = {"loss": 0.5, "grads_to_bf16": 1.5, "grads_to_fp32": 0.5,
              "tensor_to_bf16": 4.0}


def step_distances(got, ref16, ref32, moved=None, keys=None) -> dict:
    """A bf16 step's distances from a reference bf16 step and the same
    reference in fp32, each relative to the reference's own bf16-to-fp32
    distance. Each argument is ``(loss, {key: gradient})`` (arrays or CPU
    tensors). ``loss``: |L − L16| / |L16 − L32|; over all gradients
    together (the root of the summed squared L2 norms) ``grads_to_bf16``
    G(got, ref16) / G(ref16, ref32) and ``grads_to_fp32`` G(got, ref32) /
    G(ref16, ref32); per tensor the largest ‖got − ref16‖ / (‖ref16 −
    ref32‖ + 2^-8·‖ref32‖ + floor), ``tensor_to_bf16`` (its key
    ``tensor``): 2^-8·‖ref32‖ is one bf16 ulp of the tensor's gradient,
    which the last rounding of a bf16 step may move by while the
    reference's rounding happens to land near its fp32 value (a bias of two
    elements whose gradient is one bf16 sum), and the floor, 1e-5 of the
    largest gradient times √n, covers the gradients that are 0 in exact
    arithmetic (biases in front of an InstanceNorm). ``moved``, the same
    step as ``got`` on an input moved by 1e-7 relative (an ill-conditioned
    model's, phase [22]): each denominator also takes got's own movement,
    the loss's eightfold (so that ``STEP_BOUND``'s 0.5 allows 4× it) and
    each tensor's once (its 4 allows 4× it), as phase [19] holds a steep
    forward within 4× its movement. ``keys``: the tensors taken (default
    all); the floor's largest gradient is over all of them."""
    import numpy as np

    def arr(t):
        return np.asarray(t, dtype=np.float64)

    (loss, g), (l16, g16), (l32, g32) = got, ref16, ref32
    m_loss, m = moved if moved is not None else (loss, g)
    g_all = max(float(np.abs(arr(v)).max()) for v in g32.values())
    d2 = e2 = f2 = 0.0
    worst, worst_key = 0.0, None
    for k in (g32 if keys is None else keys):
        r32, r16, p = arr(g32[k]), arr(g16[k]), arr(g[k])
        d = float(np.linalg.norm(r16 - r32))
        e = float(np.linalg.norm(p - r16))
        d2 += d * d
        e2 += e * e
        f2 += float(np.linalg.norm(p - r32)) ** 2
        ratio = e / (d + 2.0 ** -8 * float(np.linalg.norm(r32))
                     + 1e-5 * g_all * math.sqrt(p.size)
                     + float(np.linalg.norm(arr(m[k]) - p)))
        if ratio > worst:
            worst, worst_key = ratio, k
    return {"loss": abs(loss - l16) / (abs(l16 - l32)
                                       + 8.0 * abs(m_loss - loss)),
            "grads_to_bf16": math.sqrt(e2 / d2),
            "grads_to_fp32": math.sqrt(f2 / d2),
            "tensor_to_bf16": worst, "tensor": worst_key}


def step_bound_violations(d: dict) -> list:
    """The ratios of :func:`step_distances` outside :data:`STEP_BOUND`."""
    return [k for k, lim in STEP_BOUND.items()
            if not (d[k] >= lim if k == "grads_to_fp32" else d[k] <= lim)]


def forward_distances(got, ref16, ref32) -> dict:
    """A bf16 forward's output against a reference forward's in bf16 and in
    fp32, each relative to the reference's own bf16-to-fp32 distance (L2
    norms over the whole output; arrays or CPU tensors): ``to_bf16`` ‖got −
    ref16‖ / ‖ref16 − ref32‖ and ``to_fp32`` ‖got − ref32‖ / ‖ref16 −
    ref32‖."""
    import numpy as np
    got, r16, r32 = (np.asarray(t, dtype=np.float64)
                     for t in (got, ref16, ref32))
    d = float(np.linalg.norm(r16 - r32))
    return {"to_bf16": float(np.linalg.norm(got - r16)) / d,
            "to_fp32": float(np.linalg.norm(got - r32)) / d}


# The bound of a bf16 eval forward against a reference bf16 forward, from
# the reference's own bf16-to-fp32 distance (forward_distances): the most
# ``to_bf16`` and the least ``to_fp32``. A forward that computes in fp32
# lies 1.0 of that distance from the reference bf16 output and ~0 from the
# fp32 one, and fails both sides. Two bf16 forwards that round in a few
# other places, through normalizations over few voxels (TINY's deepest
# levels hold 1-8), drift apart nearly as far as bf16 is from fp32
# (measured: the port against JAX on the CPU, XLA's excess precision off,
# the Pallas kernels in interpret mode, 0.796 at TINY VeloxSeg and 0.797
# at 32³ U-RWKV, ``tools/bf16_eval_reference.py --report``; the TINY
# forward on the card against the CPU 0.57).
FORWARD_BOUND = {"to_bf16": 0.9, "to_fp32": 0.5}
