"""Host→device prefetch: overlap batch copies with the step
(``veloxseg_tpu/data/prefetch.py:28-52``; the reference's ``DataLoader`` with
``pin_memory`` and CUDA's asynchronous copies).

:func:`device_put` pins a host batch and copies it with
``non_blocking=True``, so the call returns with the copy in flight on the
current stream; :func:`prefetch_to_device` keeps ``size`` such copies ahead
of the consumer while the threaded :class:`~.dataset.PatchLoader` prepares
the next batches on the host.
"""

from __future__ import annotations

import collections
import functools
from typing import Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch


def device_put(batch, device: Union[str, torch.device]):
    """A (tuple of) numpy array(s) as tensors on ``device``; on the card,
    through pinned memory with the copy in flight."""
    dev = torch.device(device)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    if isinstance(batch, (tuple, list)):
        return tuple(put(a) for a in batch)
    return put(batch)


def prefetch_to_device(iterable: Iterable, size: int = 2,
                       put: Optional[Callable] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Iterator:
    """Yield the batches of ``iterable`` with ``size`` copies in flight.

    ``put`` maps a host batch to device tensors (default
    :func:`device_put` on ``device``). Two in flight hide a 96³ batch's
    copy behind a step; more only pin more memory. ``size <= 1`` copies
    each batch as it is consumed.
    """
    if put is None:
        put = functools.partial(device_put, device=device)
    if size <= 1:
        for batch in iterable:
            yield put(batch)
        return
    buf = collections.deque()
    for batch in iterable:
        buf.append(put(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
