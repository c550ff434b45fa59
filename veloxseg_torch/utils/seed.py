"""Determinism: the port's copy of ``veloxseg_tpu/utils/seed.py:17-25``
(reference ``utils/seed.py``, seed 12345).

The JAX package seeds the host generators and returns the root PRNG key
that every random draw of a run descends from. The port seeds the same
host generators and PyTorch's, and returns the run's ``torch.Generator`` on
the device in its place: every dropout mask and attention seed of the run
is drawn from it, in step order.
"""

from __future__ import annotations

import random
from typing import Optional, Union

import numpy as np
import torch

DEFAULT_SEED = 12345


def seed_everything(seed: int = DEFAULT_SEED,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> torch.Generator:
    """Seed ``random``, numpy and torch; return a ``torch.Generator`` on
    ``device`` (default the CPU) seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(
        seed)
