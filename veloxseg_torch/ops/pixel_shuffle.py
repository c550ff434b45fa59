"""3-D pixel shuffle (depth-to-space) for channels-first tensors.

Reference semantics: ``model/components/superpixel.py:15-16`` rearranges
``(b, (c s1 s2 s3), d, h, w) -> (b, c, d*s1, h*s2, w*s3)``: the channel
axis factors as ``(c, s1, s2, s3)`` with ``c`` slowest.
"""

from __future__ import annotations

import torch


def pixel_shuffle_3d(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, C*s³, D, H, W) -> (B, C, D*s, H*s, W*s)."""
    b, cs, d, h, w = x.shape
    s = scale
    c = cs // (s * s * s)
    if c * s * s * s != cs:
        raise ValueError(f"channels {cs} not divisible by scale³ {s**3}")
    x = x.reshape(b, c, s, s, s, d, h, w)
    # (b, c, d, s1, h, s2, w, s3)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, c, d * s, h * s, w * s)
