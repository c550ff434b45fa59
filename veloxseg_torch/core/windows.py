"""Static window-layout math for Paired Window Attention.

The reference computes the multi-scale (big, small) window pyramid and the
JL-guided q/k/v channel sizes at module init from ``input_size``
(``model/components/PWA.py:56-85``). Here the same math is a pure function
producing a hashable :class:`WindowLayout`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class WindowLayout:
    """Static description of a PWA level.

    Attributes:
      input_size: spatial size (per-axis) of the feature map at this level.
      big_windows: per-pair big-window sizes; attention is confined to a big
        window.
      small_windows: per-pair small-window sizes; each small window is
        max-pooled to one token.
      tokens_per_axis: number of tokens per axis inside a big window
        (= min_big // min_small, identical across pairs by construction).
      num_pairs: number of (big, small) scale pairs.
      num_heads: attention heads per pair.
      dim_qk: per-head q/k channel dim (the JL projection dim).
      channels_qk: total q/k channels = num_pairs * num_heads * dim_qk.
      channels_v: total v channels (channels rounded up to a multiple of
        channels_qk).
      dim_v: per-(pair, head) v channel dim.
    """

    input_size: Tuple[int, ...]
    big_windows: Tuple[Tuple[int, ...], ...]
    small_windows: Tuple[Tuple[int, ...], ...]
    tokens_per_axis: Tuple[int, ...]
    num_pairs: int
    num_heads: int
    dim_qk: int
    channels_qk: int
    channels_v: int
    dim_v: int

    @property
    def tokens_per_window(self) -> int:
        return math.prod(self.tokens_per_axis)

    def windows_per_pair(self, pair: int) -> Tuple[int, ...]:
        """Big-window grid shape (per axis) for a given scale pair."""
        return tuple(s // b for s, b in
                     zip(self.input_size, self.big_windows[pair]))

    @property
    def num_windows(self) -> int:
        """Total window count summed over all scale pairs."""
        return sum(math.prod(self.windows_per_pair(i))
                   for i in range(self.num_pairs))


def compute_window_layout(
    input_size: Sequence[int],
    min_big_window: Sequence[int],
    min_small_window: Sequence[int],
    scale_factor: int,
    num_heads: int,
    min_dim_head: int,
    in_channels: int,
) -> WindowLayout:
    """Build the multi-scale window pyramid for one PWA level.

    Pairs are grown by ``scale_factor`` until the big window exceeds the
    feature size on every axis (reference ``PWA.py:67-72``). q/k channels are
    the JL down-projection ``num_pairs * num_heads * min_dim_head``; v
    channels round ``in_channels`` up to a multiple of that
    (``PWA.py:74-76``).
    """
    ndim = len(input_size)
    if not (len(min_big_window) == len(min_small_window) == ndim):
        raise ValueError("window sizes must match spatial rank")

    bigs, smalls = [], []
    bw = tuple(int(b) for b in min_big_window)
    sw = tuple(int(s) for s in min_small_window)
    while any(b <= s for b, s in zip(bw, input_size)):
        bigs.append(bw)
        smalls.append(sw)
        bw = tuple(b * scale_factor for b in bw)
        sw = tuple(s * scale_factor for s in sw)

    if not bigs:
        raise ValueError(
            f"No window pair fits input_size={tuple(input_size)} with "
            f"min_big_window={tuple(min_big_window)}")

    tokens_per_axis = tuple(b // s for b, s in
                            zip(min_big_window, min_small_window))
    for b, s, t in zip(min_big_window, min_small_window, tokens_per_axis):
        if b != s * t:
            raise ValueError(
                f"big window {b} must be divisible by small window {s}")

    for big in bigs:
        for s, b in zip(input_size, big):
            if s % b != 0:
                raise ValueError(
                    f"input size {tuple(input_size)} not divisible by big "
                    f"window {big}; all pairs must tile the volume exactly")

    num_pairs = len(bigs)
    channels_qk = num_pairs * num_heads * min_dim_head
    channels_v = math.ceil(in_channels / channels_qk) * channels_qk
    dim_v = channels_v // (num_pairs * num_heads)

    return WindowLayout(
        input_size=tuple(int(s) for s in input_size),
        big_windows=tuple(bigs),
        small_windows=tuple(smalls),
        tokens_per_axis=tokens_per_axis,
        num_pairs=num_pairs,
        num_heads=num_heads,
        dim_qk=min_dim_head,
        channels_qk=channels_qk,
        channels_v=channels_v,
        dim_v=dim_v,
    )
