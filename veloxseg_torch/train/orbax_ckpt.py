"""Non-blocking checkpoint writes: the port's counterpart of
``veloxseg_tpu/train/orbax_ckpt.py``, which does not use Orbax.

The JAX package hands its payload to ``orbax.checkpoint.AsyncCheckpointer``
and gets a checkpoint directory. The port snapshots the same payload as
:mod:`.checkpoint` builds it (model and optimizer state dicts copied to
the CPU) and returns; one background thread writes it as the same atomic
``.pth`` file :func:`.checkpoint.save_checkpoint` writes, so the train
loop never waits on the file system. Readers see the file only once it is
whole. An Orbax directory is not written, and reading one raises
(:func:`.checkpoint.load_checkpoint`).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import shutil
from typing import List, Optional

import torch

from .checkpoint import build_payload, write_payload


class AsyncCheckpointWriter:
    """Checkpoint writes on a background thread, in the order asked.

    ``save()`` snapshots the state to the CPU and returns; ``wait()``
    blocks until every pending write is on disk and raises the first
    write's error, if any; ``close()`` waits and stops the thread. One
    writer per training run.
    """

    def __init__(self) -> None:
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending: List[cf.Future] = []

    def save(self, path: str, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None, *,
             epoch: int = 0, best_train_dice: float = 0.0,
             best_val_dice: float = 0.0,
             scheduler_state: Optional[dict] = None) -> None:
        payload = build_payload(model, optimizer, epoch=epoch,
                                best_train_dice=best_train_dice,
                                best_val_dice=best_val_dice,
                                scheduler_state=scheduler_state)
        self._pending.append(self._pool.submit(write_payload, path,
                                               payload))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prune_checkpoint(path: str) -> None:
    """Remove a checkpoint (a file, or an Orbax directory)."""
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.unlink(path)
