"""Gram-matrix reduction, the SDKT statistic.

``veloxseg_tpu/ops/gram.py`` (reference ``model/components/
common_function.py:8-14``): ``einsum('b m s, b n s -> b m n') / (C·S)``
over channels-first features, in fp32. It is one batched matrix product
outside any kernel, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import math

import torch


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """(B, C, *spatial) -> (B, C, C), normalized by C · prod(spatial)."""
    b, c = x.shape[:2]
    s = math.prod(x.shape[2:])
    xf = x.reshape(b, c, s).float()
    return torch.bmm(xf, xf.transpose(1, 2)) / float(c * s)
