"""Fenced device timing (``veloxseg_tpu/utils/benchmarking.py``).

A CUDA launch returns before the card has run it, so a loop that reads the
host clock after each call measures the host's issue rate. These helpers
time windows of N dispatches that end with a **fence**: the fetch of a
scalar computed from the last dispatch's output, which cannot complete
before that output exists. The card runs one stream's work in order
(checked once per process by :func:`assert_in_order`), so the fence bounds
every dispatch of the window. The fetch costs one synchronisation, noise
over a window of seconds.

The protocol is the JAX package's: a probe phase sizes the window, then N
dispatches sized to ``seconds``, then the fence; :func:`median_rate` takes
the median over windows.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch


def _first_tensor(out) -> torch.Tensor:
    """The first tensor of ``out`` (a tensor, or a list, tuple or dict of
    them, nested)."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else out
    for item in items:
        return _first_tensor(item)
    raise ValueError("fence: the output holds no tensor")


def fence(out) -> float:
    """A true barrier on ``out`` (a tensor or a nest of them): fetches its
    first element as fp32 to the host, which waits until the work that
    writes it has run. Returns that value."""
    return float(_first_tensor(out).reshape(-1)[:1].float().item())


_IN_ORDER_CHECKED = False


def assert_in_order() -> None:
    """One-shot check that the card runs dispatches in order: the value of
    a light program dispatched after a heavy one must not be readable
    before the heavy one has (mostly) run. In-order execution is what lets
    a window-final fence bound every dispatch of the window. One CUDA
    stream is in order by definition; the check costs one heavy program
    per process and catches a setup that breaks that (work on other
    streams). On the CPU it returns at once: eager CPU ops run as they are
    called."""
    global _IN_ORDER_CHECKED
    if _IN_ORDER_CHECKED:
        return
    if not torch.cuda.is_available():
        _IN_ORDER_CHECKED = True
        return
    dev = torch.device("cuda")
    a = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)

    def heavy():
        x = a
        for _ in range(40):
            x = torch.tanh(x @ a * 0.01)
        return x

    def light():
        return a.reshape(-1)[:1] * 2.0

    fence(heavy())       # warm both (cuBLAS handles, kernels)
    fence(light())
    t0 = time.perf_counter()
    fence(heavy())
    heavy_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = heavy()
    lv = light()
    fence(lv)
    light_after_heavy = time.perf_counter() - t0
    fence(h)
    if light_after_heavy < 0.5 * heavy_t:
        raise RuntimeError(
            f"device appears to execute out of order (heavy={heavy_t:.3f}s "
            f"but a subsequent light fetch returned in "
            f"{light_after_heavy:.3f}s); window timing would under-measure")
    _IN_ORDER_CHECKED = True


def timed_window(dispatch: Callable[[], object], *, seconds: float = 10.0,
                 probe_iters: int = 20,
                 max_iters: Optional[int] = None) -> tuple:
    """Time ``dispatch()`` with a window-final fence.

    1. probe phase: ``probe_iters`` dispatches and a fence (to drain the
       warm-up queue), then ``probe_iters`` more and a fence: the
       per-iteration estimate (one fetch included: it only sizes the
       window);
    2. timed phase: N = seconds / estimate dispatches (at most
       ``max_iters``), then the fence; the wall time includes the queue's
       drain.

    Returns ``(iters, wall_seconds)``."""
    assert_in_order()
    out = None
    for _ in range(probe_iters):
        out = dispatch()
    fence(out)
    t0 = time.perf_counter()
    for _ in range(probe_iters):
        out = dispatch()
    fence(out)
    est = (time.perf_counter() - t0) / probe_iters
    n = max(int(seconds / max(est, 1e-7)), 1)
    if max_iters is not None:
        n = min(n, max_iters)
    t0 = time.perf_counter()
    for _ in range(n):
        out = dispatch()
    fence(out)
    return n, time.perf_counter() - t0


def median_rate(dispatch: Callable[[], object], units_per_iter: float, *,
                windows: int = 3, seconds: float = 10.0,
                max_iters: Optional[int] = None,
                probe_iters: int = 20) -> float:
    """Median units per second over ``windows`` timed windows."""
    rates: List[float] = []
    for _ in range(windows):
        n, dt = timed_window(dispatch, seconds=seconds, max_iters=max_iters,
                             probe_iters=probe_iters)
        rates.append(units_per_iter * n / dt)
    rates.sort()
    return rates[len(rates) // 2]
