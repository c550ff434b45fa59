"""Observability: the port's ``veloxseg_tpu/utils/profiling.py:51-82``.

- :func:`start_trace` / :func:`trace`: a ``torch.profiler`` trace (host and,
  on the card, device activity) written to ``log_dir`` for TensorBoard's
  profile plugin, where the JAX package runs ``jax.profiler``.
- :class:`ThroughputMeter`: patches/s of a train loop.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def start_trace(log_dir: str) -> "torch.profiler.profile":
    """Start a trace into ``log_dir``; call ``.stop()`` on the result to
    end it and write the file."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block into ``log_dir``."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        prof.stop()


class ThroughputMeter:
    """Patches/s since the first :meth:`update`."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._patches = 0
        self.total_patches = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._patches = 0

    def update(self, batch: int):
        if self._t0 is None:
            self.start()
        self._patches += batch
        self.total_patches += batch

    def rate(self) -> float:
        if self._t0 is None or self._patches == 0:
            return 0.0
        return self._patches / (time.perf_counter() - self._t0)
