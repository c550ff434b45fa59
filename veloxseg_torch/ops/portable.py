"""The portable scope: the counterpart of
``veloxseg_tpu/ops/pwa_attention.portable_scope`` (727-739).

While :func:`portable_scope` is active, the eval forward's kernel wrappers
(K1 ``pwa_attention.window_attention``, K4f and K5f behind
``fused_jlc.jlc_stage1`` and ``jlc_stage2``, K6 ``wkv.wkv``) run their
plain PyTorch versions on any device, so a traced graph holds only
``torch.ops.aten`` operations and no kernel launch (and no launch count).
Only the export (``infer/export.py``) enters it: it is named and explicit,
never a fallback. Outside it nothing changes: a CPU tensor takes the plain
version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import contextlib

import torch

_PORTABLE = False


@contextlib.contextmanager
def portable_scope():
    """Run the plain versions while active; the previous state is restored
    on exit, exceptions included."""
    global _PORTABLE
    prev = _PORTABLE
    _PORTABLE = True
    try:
        yield
    finally:
        _PORTABLE = prev


def runs_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version for tensor ``t``: on the
    CPU, or on any device inside a portable scope."""
    return t.device.type == "cpu" or _PORTABLE
