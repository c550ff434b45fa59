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
