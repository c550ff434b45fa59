"""Paired Window Attention (PWA), channels-first.

Reference behavior (``model/components/PWA.py``): each level runs attention
over a pyramid of (big, small) window pairs. Voxels are grouped into big
windows; each small window inside a big window is max-pooled to one token;
attention runs within each big window over its tokens, with the tokens of
all modalities concatenated (joint cross-modal attention); tokens are
scattered back to voxels by align-corners trilinear upsampling, and the
per-pair outputs are concatenated along channels.

Attention runs in the JAX package's ``(B, h, N, C, L)`` token layout
(``ops/pwa_attention.py``): kernel K1 in eval; in train mode K2 (forward
K2f, backward K2b) with the counter-hash weight dropout at ``attn_drop``
and a per-call seed drawn from the step's generator
(``veloxseg_tpu/nn/pwa.py:362-374``). Train mode also applies the
projection dropout, the FFN dropouts and DropPath on both residuals.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.windows import WindowLayout, compute_window_layout
from ..ops.pwa_attention import window_attention, window_attention_train
from ..ops.resize import interp_matrix
from .basic import FFN, Conv1x1, drop_path, dropout
from .norms import LayerNorm
from .patch import PatchMerging


@functools.lru_cache(maxsize=None)
def _relative_position_index(window: Tuple[int, ...]) -> np.ndarray:
    """Flat (l, l) index into the (2t−1)-per-axis bias table
    (``attention_utils.PositionalEmbedding``, ``:73-118``)."""
    axes = [np.arange(t) for t in window]
    coords = np.stack(np.meshgrid(*axes, indexing="ij"))  # (ndim, *window)
    flat = coords.reshape(len(window), -1)                # (ndim, l)
    rel = flat[:, :, None] - flat[:, None, :]             # (ndim, l, l)
    rel = np.moveaxis(rel, 0, -1)                         # (l, l, ndim)
    strides = []
    s = 1
    for t in reversed(window):
        strides.append(s)
        s *= 2 * t - 1
    strides = list(reversed(strides))
    idx = np.zeros(rel.shape[:2], dtype=np.int64)
    for a, t in enumerate(window):
        idx += (rel[..., a] + t - 1) * strides[a]
    return idx


class RelativePositionBias(nn.Module):
    """Learnable relative position bias table for one window shape.

    The index is recomputed here, never loaded: it is a non-persistent
    buffer, so it stays out of the state dict."""

    def __init__(self, window: Sequence[int], num_heads: int):
        super().__init__()
        window = tuple(int(t) for t in window)
        table_len = math.prod(2 * t - 1 for t in window)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(table_len, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window).reshape(-1)),
            persistent=False)
        self.num_heads = num_heads

    def forward(self) -> torch.Tensor:
        """(heads, l, l) bias."""
        idx = self.relative_position_index
        l = math.isqrt(idx.numel())
        bias = self.relative_position_bias_table[idx]
        return bias.reshape(l, l, self.num_heads).permute(2, 0, 1)


# ---------------------------------------------------------------------------
# Window gather / scatter (channels-first voxels, (B, h, N, c, l) tokens).
# ---------------------------------------------------------------------------

def window_gather(x: torch.Tensor, layout: WindowLayout,
                  c_per: int) -> torch.Tensor:
    """(B, P·h·c, D, H, W) -> (B, h, ΣN_p, c, l) tokens.

    The channel axis factors as (pair, head, c), pair slowest, as the
    reference's ``(bswin head c)`` ordering (``PWA.py:111``). Each small
    window is max-pooled to one token (``PWA.py:127``).
    """
    b = x.shape[0]
    spatial = x.shape[2:]
    heads = layout.num_heads
    tok = layout.tokens_per_axis
    xs = []
    for p in range(layout.num_pairs):
        small = layout.small_windows[p]
        grid = tuple(s // bw for s, bw in zip(spatial, layout.big_windows[p]))
        xi = x[:, p * heads * c_per:(p + 1) * heads * c_per]
        # (B, heads, c, Nd, td, sd, Nh, th, sh, Nw, tw, sw)
        xi = xi.reshape(b, heads, c_per,
                        grid[0], tok[0], small[0],
                        grid[1], tok[1], small[1],
                        grid[2], tok[2], small[2])
        xi = xi.amax(dim=(5, 8, 11))
        # -> (B, heads, Nd, Nh, Nw, c, td, th, tw)
        xi = xi.permute(0, 1, 3, 5, 7, 2, 4, 6, 8)
        xs.append(xi.reshape(b, heads, math.prod(grid), c_per,
                             math.prod(tok)))
    return torch.cat(xs, dim=2)


def window_scatter(tokens: torch.Tensor, layout: WindowLayout, c_per: int,
                   spatial: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(B, h, ΣN_p, c, l) tokens -> (B, P·h·c, D, H, W) voxels.

    Per pair: align-corners trilinear upsample of each window's token grid
    back to big-window size (``PWA.py:190``), then the inverse of the gather
    reshapes. ``spatial`` is the runtime feature size (the window pyramid
    comes from the configured size; any divisible input works).
    """
    b, heads = tokens.shape[:2]
    if spatial is None:
        spatial = layout.input_size
    tok = layout.tokens_per_axis
    outs = []
    idx = 0
    for p in range(layout.num_pairs):
        small = layout.small_windows[p]
        grid = tuple(s // bw for s, bw in zip(spatial, layout.big_windows[p]))
        n = math.prod(grid)
        a = tokens[:, :, idx:idx + n]
        idx += n
        a = a.reshape(b, heads, *grid, c_per, *tok)
        for axis, (t, s) in enumerate(zip(tok, small)):
            if s == 1:
                continue
            w = interp_matrix(t, t * s, dtype=a.dtype, device=a.device)
            a = torch.movedim(
                torch.tensordot(a, w, dims=([6 + axis], [1])), -1, 6 + axis)
        # (B, heads, Nd, Nh, Nw, c, bd, bh, bw) ->
        # (B, heads, c, Nd, bd, Nh, bh, Nw, bw)
        a = a.permute(0, 1, 5, 2, 6, 3, 7, 4, 8)
        outs.append(a.reshape(b, heads * c_per, *spatial))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Multimodal PWA attention + transformer blocks.
# ---------------------------------------------------------------------------

class MultiModalPWA(nn.Module):
    """Joint cross-modal paired-window attention (``PWA.py:246-379``).

    Per modality: LayerNorm → 1×1 q/k/v projections (JL down-projection to
    ``channels_qk``/``channels_v``); tokens of all modalities concatenate
    along the token axis inside each window; attention (K1); per-modality
    scatter → 1×1 mix → dropout → residual. ``num_heads == 0`` bypasses
    attention.
    """

    def __init__(self, input_size: Sequence[int], in_channels: Sequence[int],
                 min_big_window: Sequence[int] = (3, 3, 3),
                 min_small_window: Sequence[int] = (1, 1, 1),
                 scale_factor: int = 2, num_heads: int = 1,
                 min_dim_head: int = 4, qkv_bias: bool = True,
                 attn_drop: float = 0.1, proj_drop: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.num_modalities = len(in_channels)
        if num_heads == 0:
            return
        self.layout = lay = compute_window_layout(
            input_size, min_big_window, min_small_window, scale_factor,
            num_heads, min_dim_head, max(in_channels))
        self.input_norms = nn.ModuleList(LayerNorm(c) for c in in_channels)
        self.qkv_proj = nn.ModuleList(
            nn.ModuleList([Conv1x1(c, lay.channels_qk, qkv_bias),
                           Conv1x1(c, lay.channels_qk, qkv_bias),
                           Conv1x1(c, lay.channels_v, qkv_bias)])
            for c in in_channels)
        self.mix_channels = nn.ModuleList(
            Conv1x1(lay.channels_v, c) for c in in_channels)
        self.position_embedding = RelativePositionBias(lay.tokens_per_axis,
                                                       num_heads)

    def forward(self, xs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        if self.num_heads == 0:
            return list(xs)
        lay = self.layout
        m_count = self.num_modalities
        b = xs[0].shape[0]
        spatial = xs[0].shape[2:]

        # per-modality projections, then one gather per q/k/v with the
        # modality folded into the batch
        proj = [[], [], []]
        for m in range(m_count):
            h = self.input_norms[m](xs[m])
            for i, conv in enumerate(self.qkv_proj[m]):
                proj[i].append(conv(h))
        toks = []
        for i, c_per in enumerate((lay.dim_qk, lay.dim_qk, lay.dim_v)):
            t = window_gather(torch.cat(proj[i], dim=0), lay, c_per)
            # (M·B, h, N, c, l) → (B, h, N, c, M·l): the window's token axis
            # is the modality concatenation (``PWA.py:338-370``)
            _, hh, n, _, l = t.shape
            t = t.reshape(m_count, b, hh, n, c_per, l)
            toks.append(t.permute(1, 2, 3, 4, 0, 5).reshape(
                b, hh, n, c_per, m_count * l).contiguous())
        q, k, v = toks

        # the same per-window bias on every (modality_i, modality_j) block
        # (``PWA.py:316-320``): the bias tiled M×M
        bias = self.position_embedding().repeat(1, m_count, m_count)
        scale = 1.0 / math.sqrt(lay.dim_qk)
        if self.training:
            # a fresh int32 seed per call (unused at rate 0); batch offset
            # 0 on one device
            seed = torch.zeros(2, dtype=torch.int32, device=q.device)
            if self.attn_drop > 0.0:
                if generator is None:
                    raise ValueError("train-mode attention needs a "
                                     "torch.Generator for its dropout seed")
                seed[0] = torch.randint(
                    0, 2 ** 31 - 1, (1,), generator=generator,
                    device=generator.device, dtype=torch.int32)[0]
            # the kernels take the bias in fp32, as the JAX package casts
            # it at the Pallas call (``ops/pwa_attention.py:602, 627``)
            attn = window_attention_train(q, k, v, bias.float().contiguous(),
                                          seed, scale, float(self.attn_drop))
        else:
            attn = window_attention(q, k, v, bias.contiguous(), scale)

        _, hh, n, _, ml = attn.shape
        l = ml // m_count
        am = attn.reshape(b, hh, n, lay.dim_v, m_count, l)
        am = am.permute(4, 0, 1, 2, 3, 5).reshape(m_count * b, hh, n,
                                                  lay.dim_v, l)
        am = window_scatter(am, lay, lay.dim_v, spatial)
        return [xs[m] + dropout(self.mix_channels[m](am[m * b:(m + 1) * b]),
                                self.proj_drop, self.training, generator)
                for m in range(m_count)]


class PWABlock(nn.Module):
    """Transformer block: MM-PWA then per-modality LayerNorm + FFN.

    Keeps the reference's double residual (``PWA.py:382-439``): the
    attention output already holds ``x + proj(attn)`` and the block adds
    ``x`` again. In train mode DropPath (per sample, at ``drop_path``)
    scales both residual branches (``veloxseg_tpu/nn/pwa.py:479-480,
    520``) and the FFN drops at ``proj_drop``."""

    def __init__(self, input_size, in_channels, min_big_window,
                 min_small_window, scale_factor=2, num_heads=1,
                 min_dim_head=4, ffn_expansion_ratio=4, act_layer="GELU",
                 qkv_bias=True, attn_drop=0.1, proj_drop=0.1, drop_path=0.0):
        super().__init__()
        self.attn = MultiModalPWA(input_size, in_channels, min_big_window,
                                  min_small_window, scale_factor, num_heads,
                                  min_dim_head, qkv_bias, attn_drop,
                                  proj_drop)
        self.ffns = nn.ModuleList(
            FFN(c, ffn_expansion_ratio, act_layer, proj_drop)
            for c in in_channels)
        self.norms = nn.ModuleList(LayerNorm(c) for c in in_channels)
        self.drop_path = drop_path

    def forward(self, xs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        def dp(t):
            return drop_path(t, self.drop_path, self.training, generator)
        attns = self.attn(xs, generator)
        ys = [x + dp(a) for x, a in zip(xs, attns)]
        return [y + dp(ffn(norm(y), generator))
                for y, ffn, norm in zip(ys, self.ffns, self.norms)]


class TransformerStage(nn.Module):
    """``depth`` PWA blocks + optional per-modality PatchMerging
    (``Transformer_BasicLayer``, ``PWA.py:444-511``)."""

    def __init__(self, input_size, in_channels, depth=2,
                 min_big_window=(3, 3, 3), min_small_window=(1, 1, 1),
                 scale_factor=2, num_heads=1, min_dim_head=4,
                 ffn_expansion_ratio=4, act_layer="GELU", qkv_bias=True,
                 do_downsample=True, attn_drop=0.1, proj_drop=0.1,
                 drop_path: Union[float, Sequence[float]] = 0.0):
        super().__init__()
        if not isinstance(drop_path, (tuple, list)):
            drop_path = (drop_path,) * depth
        self.blocks = nn.ModuleList(
            PWABlock(input_size, in_channels, min_big_window,
                     min_small_window, scale_factor, num_heads, min_dim_head,
                     ffn_expansion_ratio, act_layer, qkv_bias, attn_drop,
                     proj_drop, drop_path[i])
            for i in range(depth))
        self.downs = (nn.ModuleList(PatchMerging(c) for c in in_channels)
                      if do_downsample else None)

    def forward(self, xs: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            xs = blk(xs, generator)
        down = None
        if self.downs is not None:
            down = [d(x) for d, x in zip(self.downs, xs)]
        return list(xs), down
