"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and asking for CUDA where there is none raises
instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the plain PyTorch path on the CPU")
    return dev


def cli_device(device: str, gpu_id: str = "0") -> torch.device:
    """A CLI's ``--device`` and ``--gpu_id``: ``cuda`` with ``--gpu_id n``
    is ``cuda:n``, made the current device so that the streams, events and
    pinned copies of the run follow it; ``cpu`` or a device with its own
    index ignores ``--gpu_id``. A ``--gpu_id`` that is not one index
    raises."""
    if device == "cuda":
        device = f"cuda:{int(gpu_id)}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev
