"""Operations of a forward, counted as ``torch.utils.flop_counter``'s
``FlopCounterMode`` counts them, the port's kernels included.

``FlopCounterMode`` sees every library op (convolutions, matrix products,
einsums as their batched products), but not the port's kernels, which
launch through ctypes. So each kernel wrapper reports, where it launches
its kernel, the count that ``FlopCounterMode`` gives its plain version
(:func:`add_kernel_flops`); on the CPU the plain versions run and are
counted by the mode itself. The same forward then counts the same on the
card and on the CPU. The eval kernels report (K1, K4f, K5f; K6's plain
version is elementwise and counts 0); the train kernels do not, so
:func:`count_flops` is for eval forwards.

This is not XLA's ``cost_analysis``, which the JAX package's speed CLI
reads: that one also counts elementwise work (norms, activations, the
softmax), so the two frameworks' numbers are defined differently.
"""

from __future__ import annotations

from typing import Callable, List

_OPEN: List[List[int]] = []  # the kernel totals of the counts in progress


def add_kernel_flops(n: int) -> None:
    """Add ``n`` operations of a launched kernel to every count in
    progress (nothing when none is)."""
    for acc in _OPEN:
        acc[0] += n


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """Operations of one call ``fn(*args, **kwargs)``: ``FlopCounterMode``'s
    total plus what the launched kernels report."""
    from torch.utils.flop_counter import FlopCounterMode
    acc = [0]
    _OPEN.append(acc)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    finally:
        _OPEN.remove(acc)
    return int(counter.get_total_flops()) + acc[0]
