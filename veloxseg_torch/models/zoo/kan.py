"""The KAN linear layer of U-KAN (``veloxseg_tpu/models/zoo/kan.py``, the
reference's efficient-KAN ``compared_model/UKAN/kan.py``):

    y = SiLU(x) · base_weightᵀ + Σ_g B_g(x) · (spline_weight ∘ spline_scaler)

with a uniform degree-3 B-spline basis (grid size 5 on [−1, 1]). The
reference never updates its grid, so it is a constant here, in fp32 on
every device whatever the model's dtype, and no part of the state dict
(the reference's ``.grid`` keys are dropped when a ``.pth`` is read).

As the JAX layer: the input, the basis and both products in fp32 (float64
stays float64, as the zoo's norms keep it: a float64 step is then float64
throughout) and the output cast back to the input's dtype; in bf16 the
scaled spline weights ``spline_weight ∘ spline_scaler`` are one bf16
product before they widen.

Parameter names and shapes are the reference's: ``base_weight`` and
``spline_scaler`` ``(out, in)``, ``spline_weight`` ``(out, in, grid_size
+ spline_order)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .common import wide


def _make_grid(in_features: int, grid_size: int, spline_order: int,
               grid_range=(-1.0, 1.0)) -> np.ndarray:
    """The knots, ``(in_features, grid_size + 2·spline_order + 1)``."""
    h = (grid_range[1] - grid_range[0]) / grid_size
    pts = (np.arange(-spline_order, grid_size + spline_order + 1)
           * h + grid_range[0])
    return np.tile(pts[None, :], (in_features, 1)).astype(np.float32)


def b_splines(x: torch.Tensor, grid: torch.Tensor,
              spline_order: int) -> torch.Tensor:
    """x ``(N, in)`` → the basis ``(N, in, grid_size + spline_order)``:
    half-open interval tests ``g_i <= x < g_{i+1}``, then Cox-de Boor."""
    x = x.unsqueeze(-1)
    g = grid.unsqueeze(0)
    bases = ((x >= g[..., :-1]) & (x < g[..., 1:])).to(x.dtype)
    for k in range(1, spline_order + 1):
        left = (x - g[..., :-(k + 1)]) / (g[..., k:-1] - g[..., :-(k + 1)])
        right = (g[..., k + 1:] - x) / (g[..., k + 1:] - g[..., 1:-k])
        bases = left * bases[..., :-1] + right * bases[..., 1:]
    return bases


class KANLinear(nn.Module):
    """A KAN layer over the last axis."""

    def __init__(self, in_features: int, out_features: int,
                 grid_size: int = 5, spline_order: int = 3):
        super().__init__()
        self.spline_order = spline_order
        coeffs = grid_size + spline_order
        self.base_weight = nn.Parameter(torch.zeros(out_features,
                                                    in_features))
        self.spline_weight = nn.Parameter(torch.zeros(
            out_features, in_features, coeffs))
        self.spline_scaler = nn.Parameter(torch.zeros(out_features,
                                                      in_features))
        self._grid = _make_grid(in_features, grid_size, spline_order)
        self._grids = {}    # device -> the fp32 grid there

    def grid(self, device) -> torch.Tensor:
        if device not in self._grids:
            self._grids[device] = torch.from_numpy(self._grid).to(device)
        return self._grids[device]

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The JAX layer's init: ``base_weight`` and ``spline_scaler``
        U(±1/√in), ``spline_weight`` N(0, (0.1 / grid_size)²)."""
        bound = self.base_weight.shape[1] ** -0.5
        grid_size = self.spline_weight.shape[-1] - self.spline_order
        with torch.no_grad():
            for p in (self.base_weight, self.spline_scaler):
                p.uniform_(-bound, bound, generator=generator)
            self.spline_weight.normal_(0.0, 0.1 / grid_size,
                                       generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        xf = wide(x.reshape(-1, shape[-1]))
        base = torch.nn.functional.silu(xf) @ self.base_weight.to(
            xf.dtype).t()
        basis = b_splines(xf, self.grid(x.device).to(xf.dtype),
                          self.spline_order)
        scaled = (self.spline_weight
                  * self.spline_scaler.unsqueeze(-1)).to(xf.dtype)
        spline = basis.reshape(xf.shape[0], -1) \
            @ scaled.reshape(scaled.shape[0], -1).t()
        return (base + spline).to(x.dtype).reshape(*shape[:-1], -1)
