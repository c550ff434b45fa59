"""JLC block: kernels K4f/K4b (stage 1) and K5f/K5b (stage 2).

Replaces the Pallas kernels of ``veloxseg_tpu/ops/fused_jlc.py``:
``_k1_kernel`` and ``_k1_bwd_kernel`` (stage 1), ``_k2_kernel`` and
``_k2_bwd_kernel`` (stage 2), tied together there by the custom VJP
``_fused_core``. The port runs them on plain channels-first tensors
``(B, C, D, H, W)``; the 2×2×2 packed parity stream of the TPU layout is
not carried over.

- stage 1: ``out1 = x + Σ_k GELU(IN(gconv_k(x)))`` (``csrc/jlc_stage1.cu``)
- stage 2: ``out = out1 + W2·GELU(W1·IN(out1) + b1) + b2``
  (``csrc/jlc_stage2.cu``; K5f's bf16 form ``csrc/jlc_stage2_mma.cu``, the
  channel MLP on the bf16 tensor cores)

IN is the affine-free InstanceNorm (eps 1e-5, ``max(var, 0)``); GELU is
exact (erf). Each stage is a ``torch.autograd.Function`` that saves only
its inputs and weights and recomputes the rest in its backward:

- stage 1: K4b recomputes the branch convs and their IN statistics,
  emits the cotangent at each branch's conv output and, from it and x, the
  branch weights' gradient (where the JAX package runs XLA's wgrad,
  ``fused_jlc.py:369-374``); the convs' input gradient runs on cuDNN.
- stage 2: K5b recomputes the IN and the MLP and emits dx and the weight
  and bias gradients, summed over batch and voxels in a fixed order.

The kernels do not read the branch conv biases: they cancel inside the
branch InstanceNorm, so their gradient is an exact 0
(``fused_jlc.py:29-32``). The plain versions add them, and the tests show
that the two agree. Each wrapper runs the plain version for a CPU tensor
and the kernel for a CUDA tensor.

Stage 1 also takes bf16 x and weights, as the JAX trainer passes them to
the Pallas kernels (``fused_jlc.py:111-170``): the convs accumulate in fp32
and the InstanceNorm statistics are fp32; the normalized value is rounded
to bf16 before the GELU, whose output is bf16, each branch is added into
the bf16 sum and the residual added in bf16; K4b takes the GELU's gradient
at the rounded value and rounds dy and the weight gradient to bf16. Its
bf16 forms are the same kernels built for bf16 elements (``_cuda.lib(...,
torch.bfloat16)``); the plain versions compute in fp32 and round where the
kernels round. Stage 2 takes bf16 out1, weights and cotangent the same way
(``_k2_kernel``, ``_k2_bwd_kernel``, ``fused_jlc.py:177-243``): fp32
statistics and sums, the normalized value, both channel products' outputs
(after their biases) and the GELU rounded to bf16, the residual added in
bf16; K5b takes the GELU's gradient at the rounded pre-activation, rounds
dz1 before dW1 and dz, adds the rounded IN backward to g in bf16, and
rounds the weight gradients once.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..nn.norms import instance_norm
from ..utils.flops import add_kernel_flops
from . import _cuda
from .portable import runs_plain

# the branch kernel sizes K4's kernels are built for (core/config.py)
KERNEL_SIZES = (1, 3, 5)
_QUAD = 4  # output (and input) channels per K4 thread (csrc/jlc_stage1.cu)
_TAPS = 125 + 27 + 1  # the k = 5, 3, 1 taps of one weight-gradient slab row
_CONV_THREADS = 512  # the most threads of a K4 conv block
_EDGE = 8  # the longest tile edge
_TILE = 64  # voxels per K5b tile (csrc/jlc_stage2.cu:kVT)
_SMEM_FLOATS = 232448 // 4  # the most shared memory a block may hold


def _gelu_as(n: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """GELU of the fp32 ``n`` in the stream's dtype: fp32 as ``F.gelu``;
    bf16 as ``_gelu_exact`` applies it to the rounded value (``fused_jlc.py
    :73-77``): ``nb · Φ(nb)`` with Φ computed in fp32 and rounded, the
    product rounded."""
    if dtype == torch.float32:
        return F.gelu(n)
    nb = n.to(dtype)
    return nb * (0.5 * (1.0 + torch.erf(nb.float() * math.sqrt(0.5)))
                 ).to(dtype)


def _gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d/dx GELU(x) = Φ(x) + x·φ(x) (``fused_jlc.py:80-84``)."""
    cdf = 0.5 * (1.0 + torch.erf(x * math.sqrt(0.5)))
    pdf = torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)
    return cdf + x * pdf


def _plane_stats(y: torch.Tensor):
    """Per-(b, c) mean and rstd over the spatial axes, as
    :func:`instance_norm` computes them."""
    axes = tuple(range(2, y.dim()))
    count = math.prod(y.shape[2:])
    mean = y.sum(dim=axes, keepdim=True) / count
    var = y.square().sum(dim=axes, keepdim=True) / count - mean.square()
    return mean, torch.rsqrt(var.clamp_min(0.0) + 1e-5)


def _in_backward(d: torch.Tensor, yhat: torch.Tensor,
                 rstd: torch.Tensor) -> torch.Tensor:
    """InstanceNorm backward: r·(d − mean(d) − ŷ·mean(d·ŷ))."""
    axes = tuple(range(2, d.dim()))
    return rstd * (d - d.mean(dim=axes, keepdim=True)
                   - yhat * (d * yhat).mean(dim=axes, keepdim=True))


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def jlc_stage1_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor], groups: int
                     ) -> torch.Tensor:
    """Stage 1 with torch ops: grouped conv per branch (+bias) → IN → GELU,
    summed onto the residual. The convs and the IN run in fp32; for bf16
    ``x`` the GELU, the branch sum and the residual round as K4f does."""
    branches = 0
    for w, b in zip(weights, biases):
        y = F.conv3d(x.float(), w.float(), b.float(),
                     padding=w.shape[-1] // 2, groups=groups)
        branches = branches + _gelu_as(instance_norm(y), x.dtype)
    return x + branches


def _conv_args(w: torch.Tensor, groups: int):
    """The branch conv's arguments to ``aten.convolution_backward`` after
    ``(grad_output, input, weight, bias_sizes)``."""
    return ([1, 1, 1], [w.shape[-1] // 2] * 3, [1, 1, 1], False, [0, 0, 0],
            groups)


def jlc_branch_wgrad_plain(x: torch.Tensor, dy: torch.Tensor,
                           weights: Sequence[torch.Tensor], groups: int
                           ) -> List[torch.Tensor]:
    """The branch convs' weight gradients given the cotangent ``dy[j]`` at
    each one's output: the library's wgrad (``fused_jlc.py:369-374`` runs
    XLA's), in fp32, rounded once to x's dtype."""
    return [torch.ops.aten.convolution_backward(
        dyj.float(), x.float(), w.float(), None, *_conv_args(w, groups),
        [False, True, False])[1].to(x.dtype)
        for w, dyj in zip(weights, dy)]


def jlc_stage1_bwd_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         g: torch.Tensor, groups: int
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K4b's function: ``(dy, [dW_j])``, the cotangent at each branch's
    conv output, ``(nb, B, C, D, H, W)``, given the cotangent ``g`` of
    stage 1's output (``_k1_bwd_kernel``), and the branch weights'
    gradient. In fp32; for bf16 ``x`` the GELU's gradient is taken at the
    normalized value rounded to bf16 and dy is rounded to bf16
    (``fused_jlc.py:155-170``)."""
    out = []
    for w in weights:
        y = F.conv3d(x.float(), w.float(), None, padding=w.shape[-1] // 2,
                     groups=groups)
        mean, rstd = _plane_stats(y)
        yhat = (y - mean) * rstd
        dn = g.float() * _gelu_grad(yhat.to(x.dtype).float())
        out.append(_in_backward(dn, yhat, rstd))
    dy = torch.stack(out).to(x.dtype)
    return dy, jlc_branch_wgrad_plain(x, dy, weights, groups)


def jlc_stage1_flops(x: torch.Tensor, weights: Sequence[torch.Tensor]
                     ) -> int:
    """K4f's operations as ``FlopCounterMode`` counts its plain version: per
    branch the grouped conv, 2·(C·C/groups·k³) per output voxel."""
    vox = x.shape[0] * math.prod(x.shape[2:])
    return sum(2 * w.numel() * vox for w in weights)


def jlc_stage2_flops(out1: torch.Tensor, w1: torch.Tensor) -> int:
    """K5f's operations as ``FlopCounterMode`` counts its plain version:
    the two 1×1 convs, 2·E·C·C each per voxel."""
    vox = out1.shape[0] * math.prod(out1.shape[2:])
    return 2 * 2 * w1.numel() * vox


def jlc_stage2_plain(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Stage 2 with torch ops; ``w1`` (E·C, C, 1, 1, 1), ``w2`` (C, E·C,
    1, 1, 1) as the reference's 1×1 convs store them. In fp32; for bf16
    the normalized value, both convs' outputs (bias included), the GELU
    and the residual sum round to bf16 as K5f does (``_k2_kernel``)."""
    dt = out1.dtype
    z = instance_norm(out1.float()).to(dt).float()
    z = F.conv3d(z, w1.float(), b1.float()).to(dt).float()
    z = _gelu_as(z, dt).float()
    z = F.conv3d(z, w2.float(), b2.float()).to(dt).float()
    return (out1.float() + z).to(dt)


def jlc_stage2_bwd_plain(out1: torch.Tensor, w1: torch.Tensor,
                         b1: torch.Tensor, w2: torch.Tensor, g: torch.Tensor):
    """K5b's function (``_k2_bwd_kernel``): ``(dx, dw1, db1, dw2, db2)``
    given the cotangent ``g`` of stage 2's output, the weight gradients
    in the port's weight shapes. In fp32; for bf16 as K5b rounds: z =
    bf16(ŷ), z1pb = bf16(W1·z + b1), z1 = the bf16 GELU of z1pb, GELU' at
    z1pb, dz1b = bf16(dz1) for dW1 and dz (db1 sums dz1), the IN backward
    on the unrounded ŷ, dx = bf16(g + bf16(din)), the weight gradients
    rounded once (``fused_jlc.py:194-243``)."""
    dt = out1.dtype
    b, c = out1.shape[:2]
    hid = w1.shape[0]

    def r(t):  # t rounded to the stream's dtype, as fp32
        return t.to(dt).float()
    x = out1.float()
    mean, rstd = _plane_stats(x)
    yhat = ((x - mean) * rstd).reshape(b, c, -1)
    z = r(yhat)
    g3 = g.float().reshape(b, c, -1)
    w1m, w2m = w1.float().reshape(hid, c), w2.float().reshape(c, hid)
    z1pb = r(torch.einsum("ec,bcs->bes", w1m, z) + b1.float()[:, None])
    db2 = g3.sum(dim=(0, 2))
    dw2 = torch.einsum("bcs,bes->ce", g3, _gelu_as(z1pb, dt).float())
    dz1 = torch.einsum("ce,bcs->bes", w2m, g3) * _gelu_grad(z1pb)
    db1 = dz1.sum(dim=(0, 2))
    dz1b = r(dz1)
    dw1 = torch.einsum("bes,bcs->ec", dz1b, z)
    dz = torch.einsum("ec,bes->bcs", w1m, dz1b)
    dx = g3 + r(_in_backward(dz, yhat, rstd.reshape(b, c, 1)))
    return (dx.reshape(out1.shape).to(dt), dw1.reshape(w1.shape).to(dt),
            db1.to(dt), dw2.reshape(w2.shape).to(dt), db2.to(dt))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

# element types of the stage-1 and stage-2 kernels
_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda(x: torch.Tensor, *tensors: torch.Tensor,
                dtypes=(torch.float32,)) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"no kernel instance for {x.dtype}")
    for t in (x,) + tensors:
        if t.device != x.device or t.dtype != x.dtype \
                or not t.is_contiguous():
            raise ValueError(f"expected contiguous {x.dtype} tensors on "
                             f"{x.device}, got {t.dtype} on {t.device}")


class Stage1Launch(NamedTuple):
    """K4's launch geometry for one shape (``csrc/jlc_stage1.cu`` checks
    it): the tile edges and the tiles along D, H, W; the branch conv's
    voxels per thread along W (``vx``), input-channel slices per block
    (``ks``) and output-channel quads per block (``oqb``); the wgrad's
    output quads per block and its blocks along the (b, tile) units."""
    tz: int
    ty: int
    tx: int
    nz: int
    ny: int
    nx: int
    vx: int
    ks: int
    oqb: int
    wgrad_oqb: int
    chunks: int

    @property
    def tiles(self) -> int:
        return self.nz * self.ny * self.nx

    def wgrad_ranges(self, b: int) -> List[Tuple[int, int]]:
        """The (b, tile) units ``[lo, hi)`` each wgrad block walks; unit
        ``u`` is sample ``u // tiles``, tile ``u % tiles`` (the kernel's
        own arithmetic)."""
        units = b * self.tiles
        per = -(-units // self.chunks)
        return [(i * per, min(units, (i + 1) * per))
                for i in range(self.chunks)]


_WGRAD_BLOCKS_PER_SM = 4  # wgrad blocks hold 100-200 threads


def _edge(n: int) -> int:
    """The tile edge along an axis of ``n`` voxels: at most ``_EDGE``,
    as even as the tile count allows."""
    return -(-n // -(-n // _EDGE))


@functools.lru_cache(maxsize=None)
def stage1_launch(b: int, c: int, groups: int, d: int, h: int, w: int,
                  sms: int) -> Stage1Launch:
    """K4's tiling. Volumes at least 8 wide take 4 voxels per conv thread
    along W (tiles 8 or 4 wide) and all the group's output channels per
    block; narrower ones (the 3³-6³ levels) take 1 voxel per thread, the
    whole W in one tile, and split the input channels over the block's
    threads, so that few voxels still give many threads. The wgrad runs
    about ``_WGRAD_BLOCKS_PER_SM`` blocks per SM, none of them empty."""
    quads = c // groups // _QUAD
    if w >= _EDGE:
        vx, tx, ks, oqb = 4, (8 if w % 8 == 0 else 4), 1, quads
    else:
        vx, tx, ks, oqb = 1, w, quads, 1
    ty, tz = _edge(h), _edge(d)
    while ks * oqb * tz * ty * (tx // vx) > _CONV_THREADS:
        if oqb % 2 == 0:
            oqb //= 2
        elif tz > 1:
            tz = -(-tz // 2)
        elif ks % 2 == 0:
            ks //= 2
        else:
            ty = -(-ty // 2)
    nz, ny, nx = -(-d // tz), -(-h // ty), -(-w // tx)
    wgrad_oqb = 2 if quads % 2 == 0 else 1
    blocks_y = groups * (quads // wgrad_oqb) * quads
    units = b * nz * ny * nx
    chunks = max(1, min(units, -(-_WGRAD_BLOCKS_PER_SM * sms // blocks_y)))
    return Stage1Launch(tz, ty, tx, nz, ny, nx, vx, ks, oqb, wgrad_oqb,
                        -(-units // -(-units // chunks)))


def _stage1_args(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 groups: int):
    """Checked kernel arguments shared by K4f and K4b: the contiguous
    weights and the launch geometry."""
    weights = [w.contiguous() for w in weights]
    _check_cuda(x, *weights, dtypes=_DTYPES)
    b, c, d, h, w = x.shape
    ks = tuple(int(wt.shape[-1]) for wt in weights)
    cg = c // groups
    if ks != KERNEL_SIZES or cg * groups != c or cg % _QUAD \
            or any(tuple(wt.shape) != (c, cg, k, k, k)
                   for wt, k in zip(weights, ks)):
        raise ValueError(f"K4's kernels take the branches {KERNEL_SIZES} "
                         f"with C/groups a multiple of {_QUAD}; got C={c}, "
                         f"groups={groups}, kernels {ks}")
    return weights, stage1_launch(b, c, groups, d, h, w,
                                  _cuda.sm_count(x.device))


def _stage1_scratch(x: torch.Tensor, lw: Stage1Launch):
    """The branch outputs (3, B, C, D, H, W) in fp32, the per-tile
    statistics and the per-plane mean and rstd."""
    b, c = x.shape[:2]
    planes = 3 * b * c
    return (torch.empty((3,) + tuple(x.shape), device=x.device),
            torch.empty((planes * lw.tiles, 2), dtype=torch.float64,
                        device=x.device),
            torch.empty((planes,), device=x.device),
            torch.empty((planes,), device=x.device))


def _jlc_stage1_fwd(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], groups: int
                    ) -> torch.Tensor:
    """K4f, fp32 or bf16 (or the plain version for a CPU tensor, or inside
    a portable scope)."""
    if runs_plain(x):
        return jlc_stage1_plain(x, weights, biases, groups)
    weights, lw = _stage1_args(x, weights, groups)
    scratch, pstat, mean, rstd = _stage1_scratch(x, lw)
    out = torch.empty_like(x)
    lib = _cuda.lib("jlc_stage1", x.dtype)
    with torch.cuda.device(x.device):
        err = lib.vs_jlc_stage1(
            x.data_ptr(), *(wt.data_ptr() for wt in weights),
            scratch.data_ptr(), pstat.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), out.data_ptr(), *x.shape, groups, lw.tz, lw.ty,
            lw.tx, lw.vx, lw.ks, lw.oqb, _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "jlc_stage1")
    _cuda.count_launch(jlc_stage1, x.dtype)
    add_kernel_flops(jlc_stage1_flops(x, weights))
    return out


def _wgrad_out(x: torch.Tensor, weights: Sequence[torch.Tensor],
               lw: Stage1Launch):
    """The wgrad's per-block fp32 slabs and the branches' weight
    gradients (in the weights' dtype)."""
    c, cg = weights[0].shape[:2]
    return (torch.empty((lw.chunks, c * cg * _TAPS), device=x.device),
            [torch.empty_like(wt) for wt in weights])


def jlc_stage1_bwd(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   g: torch.Tensor, groups: int
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """K4b: ``(dy, [dW_j])``, the cotangent at each branch's conv output,
    (3, B, C, D, H, W), and the branch weights' gradient, which K4b's own
    wgrad launches compute from dy and x; both in x's dtype (fp32 or
    bf16)."""
    if x.device.type == "cpu":
        return jlc_stage1_bwd_plain(x, weights, g, groups)
    weights, lw = _stage1_args(x, weights, groups)
    _check_cuda(x, g, dtypes=_DTYPES)
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} differs from x {tuple(x.shape)}")
    scratch, pstat, mean, rstd = _stage1_scratch(x, lw)
    # fp32: dy overwrites the recompute scratch in place
    dy = scratch if x.dtype == torch.float32 \
        else torch.empty_like(scratch, dtype=x.dtype)
    part, dws = _wgrad_out(x, weights, lw)
    lib = _cuda.lib("jlc_stage1", x.dtype)
    with torch.cuda.device(x.device):
        err = lib.vs_jlc_stage1_bwd(
            x.data_ptr(), *(wt.data_ptr() for wt in weights), g.data_ptr(),
            scratch.data_ptr(), dy.data_ptr(), pstat.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
            *(t.data_ptr() for t in dws),
            *x.shape, groups, lw.tz, lw.ty, lw.tx, lw.vx, lw.ks, lw.oqb,
            lw.wgrad_oqb, lw.chunks, _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "jlc_stage1_bwd")
    _cuda.count_launch(jlc_stage1_bwd, x.dtype)
    _cuda.count_launch(jlc_branch_wgrad, x.dtype)
    return dy, dws


jlc_stage1_bwd.launches = 0
jlc_stage1_bwd.launches_bf16 = 0


def jlc_branch_wgrad(x: torch.Tensor, dy: torch.Tensor,
                     weights: Sequence[torch.Tensor], groups: int
                     ) -> List[torch.Tensor]:
    """K4b's weight-gradient launches alone: the branch weights' gradient
    given x and the cotangent ``dy`` (3, B, C, D, H, W) at the branch
    outputs (the plain version for a CPU tensor). The train step runs them
    inside :func:`jlc_stage1_bwd`, which counts them here too."""
    if x.device.type == "cpu":
        return jlc_branch_wgrad_plain(x, dy, weights, groups)
    weights, lw = _stage1_args(x, weights, groups)
    _check_cuda(x, dy, dtypes=_DTYPES)
    if dy.shape != (3,) + tuple(x.shape):
        raise ValueError(f"dy {tuple(dy.shape)} is not 3 x {tuple(x.shape)}")
    part, dws = _wgrad_out(x, weights, lw)
    lib = _cuda.lib("jlc_stage1", x.dtype)
    with torch.cuda.device(x.device):
        err = lib.vs_jlc_branch_wgrad(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(),
            *(t.data_ptr() for t in dws), *x.shape, groups, lw.tz, lw.ty,
            lw.tx, lw.wgrad_oqb, lw.chunks, _cuda.stream_ptr(x.device))
    _cuda.check(lib, err, "jlc_branch_wgrad")
    _cuda.count_launch(jlc_branch_wgrad, x.dtype)
    return dws


jlc_branch_wgrad.launches = 0
jlc_branch_wgrad.launches_bf16 = 0


def _stage2_mats(out1, w1, w2):
    c = out1.shape[1]
    hid = w1.shape[0]
    w1m = w1.reshape(hid, -1).contiguous()
    w2m = w2.reshape(w2.shape[0], -1).contiguous()
    if w1m.shape != (hid, c) or w2m.shape != (c, hid):
        raise ValueError(f"K5 weight shapes do not match C={c}: "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)}")
    return w1m, w2m, hid


class Stage2FwdLaunch(NamedTuple):
    """K5f's launch geometry for one shape (``csrc/jlc_stage2.cu`` checks
    it): the hidden rows per slice (``hs``; E·C in ``slices`` parts), the
    voxels per tile (``vt``) of the flattened (b, voxel) index and the
    tiles, and the chunks of ``per`` tiles each MLP block walks."""
    hs: int
    slices: int
    vt: int
    tiles: int
    chunks: int
    per: int

    def tile_ranges(self) -> List[Tuple[int, int]]:
        """The tiles ``[lo, hi)`` of each chunk; tile ``i`` holds the
        flattened voxels ``[i·vt, (i + 1)·vt)``, voxel ``u`` being sample
        ``u // S``, voxel ``u % S`` (the kernel's own arithmetic)."""
        return [(i * self.per, min(self.tiles, (i + 1) * self.per))
                for i in range(self.chunks)]

    def slice_rows(self) -> List[Tuple[int, int]]:
        """The hidden rows ``[lo, hi)`` of each slice."""
        return [(i * self.hs, (i + 1) * self.hs) for i in range(self.slices)]


_K5F_TILE_FLOATS = 4096  # C·VT of a K5f tile (csrc/jlc_stage2.cu)
_K5F_MIN_SLICE = 16      # fewest hidden rows a slice is cut to


def _k5f_smem_floats(c: int, hs: int, vt: int) -> int:
    """Shared memory of a K5f MLP block (``mlp_fwd_smem_floats``): W1ᵀ and
    W2ᵀ slices, b1 and b2, two stage buffers of ẑ, the hidden tile."""
    return 2 * hs * c + hs + c + (2 * c + hs) * (vt + 4)


@functools.lru_cache(maxsize=None)
def stage2_fwd_launch(b: int, c: int, hid: int, s: int,
                      sms: int) -> Stage2FwdLaunch:
    """K5f's tiling. Tiles of ``vt`` voxels with C·vt = 4096 floats (vt a
    power of two from 32 to 256), so that the 4 × 4 jobs of W2·h are about
    one per thread. The hidden dimension is split into the fewest slices
    whose weights fit a block beside the tiles and that give at least one
    block per SM, but not below 16 rows (at 128 channels: two slices of 128
    fit; the 3³-8³ levels take 8 or 16 slices). About two blocks per SM walk
    the tiles, none of them empty."""
    if c % 4 or hid % 4:
        raise ValueError(f"K5f takes C and E·C multiples of 4; got C={c}, "
                         f"E·C={hid}")
    vt = min(256, max(32, 1 << (_K5F_TILE_FLOATS // c).bit_length() - 1))
    tiles = -(-b * s // vt)
    valid = [n for n in range(1, hid // 4 + 1)
             if hid % n == 0 and (hid // n) % 4 == 0
             and _k5f_smem_floats(c, hid // n, vt) <= _SMEM_FLOATS]
    if not valid:
        raise ValueError(f"K5f: no hidden slice of E·C={hid} fits C={c}")
    cands = [n for n in valid if hid // n >= min(_K5F_MIN_SLICE, hid)] \
        or valid[:1]
    slices = next((n for n in cands if tiles * n >= sms), cands[-1])
    per = -(-tiles // max(1, min(tiles, -(-2 * sms // slices))))
    return Stage2FwdLaunch(hid // slices, slices, vt, tiles, -(-tiles // per),
                           per)


def jlc_stage2_split_plain(out1, w1, b1, w2, b2, lw: Stage2FwdLaunch):
    """K5f's decomposition in torch ops (the tests hold it against JAX):
    the flattened (b, voxel) index in tiles of ``lw.vt`` (zero past the
    end), each hidden slice's part of W2·GELU(W1·ẑ + b1) per tile, the
    slices added in order, then out1 + (Σ + b2)."""
    b, c = out1.shape[:2]
    hid = w1.shape[0]
    mean, rstd = _plane_stats(out1)
    z = ((out1 - mean) * rstd).reshape(b, c, -1)
    s = z.shape[-1]
    pad = lw.tiles * lw.vt - b * s
    zt = F.pad(z.transpose(0, 1).reshape(c, -1), (0, pad))
    zt = zt.reshape(c, lw.tiles, lw.vt).transpose(0, 1)      # (tiles, c, vt)
    w1m, w2m = w1.reshape(hid, c), w2.reshape(c, hid)
    acc = None
    for e0, e1 in lw.slice_rows():
        h = F.gelu(torch.einsum("ec,ict->iet", w1m[e0:e1], zt)
                   + b1[e0:e1, None])
        y = torch.einsum("ce,iet->ict", w2m[:, e0:e1], h)
        acc = y if acc is None else acc + y
    y = acc.transpose(0, 1).reshape(c, -1)[:, :b * s]
    y = y.reshape(c, b, s).transpose(0, 1).reshape(out1.shape)
    return out1 + (y + b2.reshape(1, c, *([1] * (out1.dim() - 2))))


def stage2_widths(c: int, hid: int) -> Tuple[int, int]:
    """The widths K5f and K5b run at: C up to a multiple of 8, E·C up to
    one of 4 (``csrc/jlc_stage2.cu``)."""
    return -(-c // 8) * 8, -(-hid // 4) * 4


def _pad_planes(t: torch.Tensor, cp: int) -> torch.Tensor:
    """``t`` (B, C, ...) widened to ``cp`` channels with zero planes."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, cp - t.shape[1])).contiguous()


def _pad_weights(w1m, b1, w2m, cp: int, hp: int):
    """``w1m`` (E·C, C), ``b1``, ``w2m`` (C, E·C) widened to ``hp`` hidden
    rows and ``cp`` channels with zeros."""
    dh, dc = hp - w1m.shape[0], cp - w1m.shape[1]
    return (F.pad(w1m, (0, dc, 0, dh)), F.pad(b1, (0, dh)),
            F.pad(w2m, (0, dh, 0, dc)))


def pad_stage2_fwd(out1, w1m, b1, w2m, b2, widths=stage2_widths):
    """K5f's inputs widened to ``widths`` (:func:`stage2_widths`, or
    :func:`stage2_mma_widths` for the bf16 form) with zero channels and
    hidden rows. A zero plane normalizes to ẑ = 0; a zero hidden row has
    W1·ẑ + b1 = 0, GELU(0) = 0 and no weight to the outputs; a zero channel
    of W2 and b2 leaves its output plane 0. The real channels see the same
    sums."""
    cp, hp = widths(out1.shape[1], w1m.shape[0])
    return (_pad_planes(out1, cp), *_pad_weights(w1m, b1, w2m, cp, hp),
            F.pad(b2, (0, cp - b2.shape[0])))


def _jlc_stage2_fwd(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor):
    """K5f (or the plain version for a CPU tensor), fp32 or bf16: ``(out,
    mean, rstd)``, the plane statistics K5f took (B·C fp32 values each;
    None for the plain version, which runs on the CPU and inside a portable
    scope). Widths the kernel does not take run padded
    (:func:`pad_stage2_fwd`)."""
    if runs_plain(out1):
        return jlc_stage2_plain(out1, w1, b1, w2, b2), None, None
    if out1.dtype == torch.bfloat16:
        return _jlc_stage2_fwd_mma(out1, w1, b1, w2, b2)
    b, c, d, h, w = out1.shape
    s = d * h * w
    w1m, w2m, hid = _stage2_mats(out1, w1, w2)
    _check_cuda(out1, w1m, b1, w2m, b2)
    if b1.shape != (hid,) or b2.shape != (c,):
        raise ValueError(f"K5f bias shapes {tuple(b1.shape)}, "
                         f"{tuple(b2.shape)} do not match C={c}")
    ins = (out1, w1m, b1, w2m, b2)
    cp, hp = stage2_widths(c, hid)
    if (cp, hp) != (c, hid):
        ins = pad_stage2_fwd(*ins)
    dev = out1.device
    lw = stage2_fwd_launch(b, cp, hp, s, _cuda.sm_count(dev))
    mean = torch.empty((b * cp,), device=dev)
    rstd = torch.empty_like(mean)
    out = torch.empty((b, cp, d, h, w), device=dev, dtype=out1.dtype)
    part = torch.empty((lw.slices * b * cp * s if lw.slices > 1 else 1,),
                       device=dev)
    lib = _cuda.lib("jlc_stage2", out1.dtype)
    with torch.cuda.device(dev):
        err = lib.vs_jlc_stage2(
            *(t.data_ptr() for t in ins), mean.data_ptr(), rstd.data_ptr(),
            out.data_ptr(), part.data_ptr(), b, cp, hp, s, lw.hs, lw.vt,
            lw.chunks, lw.per, _cuda.stream_ptr(dev))
    _cuda.check(lib, err, "jlc_stage2")
    _cuda.count_launch(jlc_stage2, out1.dtype)
    add_kernel_flops(jlc_stage2_flops(out1, w1))
    if cp != c:
        out = out[:, :c].contiguous()
        mean, rstd = (t.reshape(b, cp)[:, :c].reshape(-1).contiguous()
                      for t in (mean, rstd))
    return out, mean, rstd


# K5f's bf16 form (csrc/jlc_stage2_mma.cu): the channel widths it is built
# for, the warps of a block, the most voxels of a tile
_K5F_MMA_WIDTHS = (16, 32, 64, 128)
_K5F_MMA_WARPS = 4
_K5F_MMA_MAX_VT = 256


def stage2_mma_widths(c: int, hid: int) -> Tuple[int, int]:
    """The widths K5f's bf16 form runs at: C up to 16, 32, 64 or 128 and
    E·C up to a multiple of 16 (the k16 steps of its two products)."""
    cp = next((w for w in _K5F_MMA_WIDTHS if w >= c), None)
    if cp is None:
        raise ValueError(f"K5f's bf16 form takes C up to "
                         f"{_K5F_MMA_WIDTHS[-1]}, got {c}")
    return cp, -(-hid // 16) * 16


def _k5f_mma_smem_bytes(c: int, hid: int, vt: int, hsplit: int) -> int:
    """Shared memory of a K5f bf16 block (``mma_stage2_smem_bytes``): W1
    and W2 in bf16 at row strides C + 8 and E·C + 8, two stages of x and
    the ẑ/z2 buffer at a row stride of VT + 8, b1 and b2 in fp32, and with
    ``hsplit`` > 1 the fp32 partials of each hidden part."""
    return (2 * (hid * (c + 8) + c * (hid + 8) + 3 * c * (vt + 8))
            + 4 * (hid + c) + (4 * hsplit * vt * c if hsplit > 1 else 0))


class Stage2MmaLaunch(NamedTuple):
    """K5f's bf16 geometry for one shape (``csrc/jlc_stage2_mma.cu``
    checks it): tiles of ``vt`` voxels of the flattened (b, voxel) index,
    chunks of ``per`` tiles a block walks, and ``hsplit`` warps of a block
    sharing 16 voxels, each over E·C/hsplit hidden rows."""
    vt: int
    hsplit: int
    tiles: int
    chunks: int
    per: int
    smem_bytes: int

    def tile_ranges(self) -> List[Tuple[int, int]]:
        """The tiles ``[lo, hi)`` of each chunk; tile ``i`` holds the
        flattened voxels ``[i·vt, (i + 1)·vt)``."""
        return [(i * self.per, min(self.tiles, (i + 1) * self.per))
                for i in range(self.chunks)]

    def warp_work(self, hid: int) -> List[Tuple[Tuple[int, int],
                                                 Tuple[int, int]]]:
        """Per warp of a block, the voxels ``[lo, hi)`` of a tile and the
        hidden rows ``[lo, hi)`` it computes (the kernel's arithmetic):
        slot ``w // hsplit`` takes consecutive m16 tiles, part
        ``w % hsplit`` a slice of the hidden rows."""
        slots = _K5F_MMA_WARPS // self.hsplit
        mt, hp = self.vt // (16 * slots), hid // self.hsplit
        return [(((w // self.hsplit) * mt * 16,
                  (w // self.hsplit + 1) * mt * 16),
                 ((w % self.hsplit) * hp, (w % self.hsplit + 1) * hp))
                for w in range(_K5F_MMA_WARPS)]


@functools.lru_cache(maxsize=None)
def stage2_mma_launch(b: int, c: int, hid: int, s: int, sms: int,
                      hsplit: int = 0) -> Stage2MmaLaunch:
    """K5f's bf16 geometry at widths :func:`stage2_mma_widths` returns.
    ``hsplit`` (0: chosen): the fewest warps sharing 16 voxels (1, 2 or 4,
    each a whole number of 16 hidden rows) that give the card 4 warps an
    SM, else the most; with more than one, a tile is the block's 16·4 /
    hsplit voxels. With one, tiles of up to 4096 / C voxels (from 64 to
    256), halved while they are fewer than 3 an SM (``tools/
    bench_train_bwd.py --bf16``'s sweep: at 12³, B = 16, tiles of 64
    voxels took 0.89× the device time of 128). As many blocks as fit
    the SMs' shared memory walk the tiles, none of them empty (fewer, each
    walking more tiles, took 1.2-1.45× the time at 24³ and 12³)."""
    if c not in _K5F_MMA_WIDTHS or hid % 16:
        raise ValueError(f"K5f's bf16 form takes C in {_K5F_MMA_WIDTHS} "
                         f"and E·C a multiple of 16; got C={c}, E·C={hid}")
    m16 = -(-b * s // 16)
    valid = [h for h in (1, 2, 4) if hid % (16 * h) == 0]
    if hsplit:
        if hsplit not in valid:
            raise ValueError(f"hsplit {hsplit} does not divide E·C={hid} "
                             f"in 16-row slices")
    else:
        hsplit = next((h for h in valid if m16 * h >= 4 * sms), valid[-1])
    if hsplit > 1:
        vt = 16 * (_K5F_MMA_WARPS // hsplit)
    else:
        vt = max(64, min(_K5F_MMA_MAX_VT, 4096 // c))
        while vt > 64 and -(-b * s // vt) < 3 * sms:
            vt //= 2
    tiles = -(-b * s // vt)
    smem = _k5f_mma_smem_bytes(c, hid, vt, hsplit)
    if smem > 4 * _SMEM_FLOATS:
        raise ValueError(f"K5f's bf16 form: {smem} bytes of shared memory "
                         f"at C={c}, E·C={hid}")
    fit = min(16, 4 * _SMEM_FLOATS // smem)
    per = -(-tiles // min(tiles, fit * sms))
    return Stage2MmaLaunch(vt, hsplit, tiles, -(-tiles // per), per, smem)


def jlc_stage2_mma_plain(out1, w1, b1, w2, b2, hsplit: int):
    """K5f's bf16 form as the kernel splits its sums, in torch ops on the
    padded widths: ẑ = bf16((x − μ)·r); per hidden part, z1 = bf16(W1·ẑ +
    b1), h = the bf16 GELU, and the part's W2·h in fp32; the parts added in
    order, then b2, rounded; out = bf16(x + z2)."""
    dt = out1.dtype
    b, c = out1.shape[:2]
    hid = w1.shape[0]
    x = out1.float()
    mean, rstd = _plane_stats(x)
    z = ((x - mean) * rstd).to(dt).float().reshape(b, c, -1)
    w1m, w2m = w1.float().reshape(hid, c), w2.float().reshape(c, hid)
    acc = None
    hp = hid // hsplit
    for e0 in range(0, hid, hp):
        z1 = torch.einsum("ec,bcs->bes", w1m[e0:e0 + hp], z) \
            + b1.float()[e0:e0 + hp, None]
        h = _gelu_as(z1, dt).float()
        y = torch.einsum("ce,bes->bcs", w2m[:, e0:e0 + hp], h)
        acc = y if acc is None else acc + y
    z2 = (acc + b2.float()[:, None]).to(dt).float()
    return (x + z2.reshape(out1.shape)).to(dt)


def _jlc_stage2_fwd_mma(out1, w1, b1, w2, b2, launch=None):
    """K5f's bf16 form on CUDA tensors: ``(out, mean, rstd)`` as
    :func:`_jlc_stage2_fwd` returns them; other widths run padded to
    :func:`stage2_mma_widths`. ``launch``: a :class:`Stage2MmaLaunch` in
    place of :func:`stage2_mma_launch`'s (the card tests)."""
    b, c, d, h, w = out1.shape
    s = d * h * w
    w1m, w2m, hid = _stage2_mats(out1, w1, w2)
    _check_cuda(out1, w1m, b1, w2m, b2, dtypes=(torch.bfloat16,))
    if b1.shape != (hid,) or b2.shape != (c,):
        raise ValueError(f"K5f bias shapes {tuple(b1.shape)}, "
                         f"{tuple(b2.shape)} do not match C={c}")
    ins = (out1, w1m, b1, w2m, b2)
    cp, hp = stage2_mma_widths(c, hid)
    if (cp, hp) != (c, hid):
        ins = pad_stage2_fwd(*ins, widths=stage2_mma_widths)
    dev = out1.device
    lw = launch or stage2_mma_launch(b, cp, hp, s, _cuda.sm_count(dev))
    mean = torch.empty((b * cp,), device=dev)
    rstd = torch.empty_like(mean)
    out = torch.empty((b, cp, d, h, w), device=dev, dtype=out1.dtype)
    lib = _cuda.lib("jlc_stage2_mma", out1.dtype)
    with torch.cuda.device(dev):
        err = lib.vs_jlc_stage2_mma(
            *(t.data_ptr() for t in ins), mean.data_ptr(), rstd.data_ptr(),
            out.data_ptr(), b, cp, hp, s, lw.vt, lw.hsplit, lw.chunks,
            lw.per, _cuda.stream_ptr(dev))
    _cuda.check(lib, err, "jlc_stage2_mma")
    _cuda.count_launch(jlc_stage2, out1.dtype)
    add_kernel_flops(jlc_stage2_flops(out1, w1))
    if cp != c:
        out = out[:, :c].contiguous()
        mean, rstd = (t.reshape(b, cp)[:, :c].reshape(-1).contiguous()
                      for t in (mean, rstd))
    return out, mean, rstd


class Stage2BwdLaunch(NamedTuple):
    """K5b's launch geometry for one shape (``csrc/jlc_stage2.cu`` checks
    it): the hidden rows per slice (``hs``; E·C in ``slices`` parts), the
    64-voxel tiles per sample and the (b, tile) units, the chunks of
    ``per`` units each tiles block walks, the voxel parts (``tp``) and the
    jobs per thread (``jpt``) of the weight products, and the planes
    blocks per (b, c) plane (``ysplit``)."""
    hs: int
    slices: int
    tiles_per_sample: int
    units: int
    chunks: int
    per: int
    tp: int
    jpt: int
    ysplit: int

    def unit_ranges(self) -> List[Tuple[int, int]]:
        """The units ``[lo, hi)`` of each chunk; unit ``u`` is sample
        ``u // tiles_per_sample``, voxels ``[(u % tiles_per_sample)·64,
        +64)`` (the kernel's own arithmetic)."""
        return [(i * self.per, min(self.units, (i + 1) * self.per))
                for i in range(self.chunks)]

    def slice_rows(self) -> List[Tuple[int, int]]:
        """The hidden rows ``[lo, hi)`` of each slice."""
        return [(i * self.hs, (i + 1) * self.hs) for i in range(self.slices)]


_K5B_THREADS = 256
_K5B_SLICE_WORK = 8192  # HS·C: at most 4 weight jobs of 4×4 a thread
_K5B_ROW = _TILE + 4    # row stride of its [row][voxel] tiles


def _k5b_smem_floats(c: int, hs: int, tp: int) -> int:
    """Shared memory of a K5b tiles block (``mlp_bwd_smem_floats``): W1ᵀ,
    W1 and W2 slices, two stage buffers of x and g, z1 and dz1, b1."""
    return max(3 * hs * c + 4 * c * _K5B_ROW + 2 * hs * _K5B_ROW + hs,
               _K5B_THREADS * 16 if tp > 1 else 0)


@functools.lru_cache(maxsize=None)
def stage2_bwd_launch(b: int, c: int, hid: int, s: int,
                      sms: int) -> Stage2BwdLaunch:
    """K5b's tiling: the fewest hidden slices with HS·C <= 8192 whose
    weights and tiles fit a block (one slice up to 32 channels, two of 64
    rows at 64, eight of 32 at 128), about two tiles blocks per SM over the
    (b, tile) units, none of them empty, and up to 16 planes blocks per
    plane."""
    if c % 8 or hid % 4:
        raise ValueError(f"K5b takes C a multiple of 8 and E·C of 4; got "
                         f"C={c}, E·C={hid}")
    slices = next((n for n in range(1, hid // 4 + 1)
                   if hid % n == 0 and (hid // n) % 4 == 0
                   and hid // n * c <= _K5B_SLICE_WORK
                   and _k5b_smem_floats(c, hid // n, 1) <= _SMEM_FLOATS),
                  None)
    if slices is None:
        raise ValueError(f"K5b: no hidden slice of E·C={hid} fits C={c}")
    hs = hid // slices
    if hs + c > _K5B_THREADS:
        raise ValueError(f"K5b: E·C/slices + C = {hs + c} > {_K5B_THREADS}")
    tps = -(-s // _TILE)
    units = b * tps
    per = -(-units // max(1, min(units, -(-2 * sms // slices))))
    jobs = hs * c // 8
    tp = 1
    while jobs * tp * 2 <= _K5B_THREADS and tp < _TILE // 4:
        tp *= 2
    jpt = -(-jobs // _K5B_THREADS)
    jpt = 1 if jpt == 1 else 2 if jpt == 2 else 4
    ysplit = max(1, min(16, s // 2048))
    return Stage2BwdLaunch(hs, slices, tps, units, -(-units // per), per, tp,
                           jpt, ysplit)


def jlc_stage2_bwd_split_plain(out1, w1, b1, w2, g, lw: Stage2BwdLaunch):
    """K5b's decomposition in torch ops (the tests hold it against the JAX
    VJP): per (chunk, slice) partial weight sums over the chunk's 64-voxel
    units, dz per slice, per-tile sums of dz and dz·ŷ, then the partials
    added in chunk, slice and tile order."""
    b, c = out1.shape[:2]
    hid = w1.shape[0]
    mean, rstd = _plane_stats(out1)
    yhat = ((out1 - mean) * rstd).reshape(b, c, -1)
    g3 = g.reshape(b, c, -1)
    s = yhat.shape[-1]
    pad = lw.tiles_per_sample * _TILE - s
    yt = F.pad(yhat, (0, pad)).reshape(b, c, -1, _TILE).transpose(1, 2)
    gt = F.pad(g3, (0, pad)).reshape(b, c, -1, _TILE).transpose(1, 2)
    yt, gt = yt.reshape(-1, c, _TILE), gt.reshape(-1, c, _TILE)  # units
    w1m, w2m = w1.reshape(hid, c), w2.reshape(c, hid)
    dw1, dw2 = torch.zeros(hid, c), torch.zeros(c, hid)
    db1, db2 = torch.zeros(hid), torch.zeros(c)
    dz = torch.zeros(lw.units, c, _TILE)
    tsum = torch.zeros(lw.units, 2, c)
    for lo, hi in lw.unit_ranges():
        y, gg = yt[lo:hi], gt[lo:hi]
        db2 += gg.sum(dim=(0, 2))
        for e0, e1 in lw.slice_rows():
            z1p = torch.einsum("ec,uct->uet", w1m[e0:e1], y) \
                + b1[e0:e1, None]
            d1 = (torch.einsum("ce,uct->uet", w2m[:, e0:e1], gg)
                  * _gelu_grad(z1p))
            dw1[e0:e1] += torch.einsum("uet,uct->ec", d1, y)
            dw2[:, e0:e1] += torch.einsum("uct,uet->ce", gg, F.gelu(z1p))
            db1[e0:e1] += d1.sum(dim=(0, 2))
            dzs = torch.einsum("ec,uet->uct", w1m[e0:e1], d1)
            dz[lo:hi] += dzs
            tsum[lo:hi, 0] += dzs.sum(-1)
            tsum[lo:hi, 1] += (dzs * y).sum(-1)
    per_b = tsum.reshape(b, -1, 2, c).sum(1) / s         # (b, 2, c)
    dz = dz.reshape(b, -1, c, _TILE).transpose(1, 2).reshape(b, c, -1)
    dz = dz[..., :s]
    r = rstd.reshape(b, c, 1)
    dx = g3 + r * (dz - per_b[:, 0, :, None] - yhat * per_b[:, 1, :, None])
    return (dx.reshape(out1.shape), dw1.reshape(w1.shape), db1,
            dw2.reshape(w2.shape), db2)


def pad_stage2_bwd(out1, w1m, b1, w2m, g, mean, rstd):
    """K5b's inputs widened to :func:`stage2_widths` with zero channels and
    hidden rows (the new planes get mean 0, rstd 1). A zero plane
    normalizes to ŷ = 0 under a zero g, and a zero hidden row has z1p = 0
    and no weight to or from the others: neither adds to any sum, and their
    own gradients are 0."""
    b, c = out1.shape[:2]
    cp, hp = stage2_widths(c, w1m.shape[0])
    dc = cp - c
    return (_pad_planes(out1, cp), *_pad_weights(w1m, b1, w2m, cp, hp),
            _pad_planes(g, cp),
            F.pad(mean.reshape(b, c), (0, dc)).reshape(-1),
            F.pad(rstd.reshape(b, c), (0, dc), value=1.0).reshape(-1))


def jlc_stage2_bwd(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor):
    """K5b: ``(dx, dw1, db1, dw2, db2)`` of stage 2. ``mean``, ``rstd``:
    K5f's plane statistics of ``out1`` (B·C floats each; the plain version
    recomputes them). Widths the kernel does not take run padded
    (:func:`pad_stage2_bwd`). fp32 or bf16, as K5f; the gradients in the
    inputs' dtype."""
    if out1.device.type == "cpu":
        return jlc_stage2_bwd_plain(out1, w1, b1, w2, g)
    b, c, d, h, w = out1.shape
    s = d * h * w
    w1m, w2m, hid = _stage2_mats(out1, w1, w2)
    _check_cuda(out1, w1m, b1, w2m, g, dtypes=_DTYPES)
    _check_cuda(mean, rstd)
    if b1.shape != (hid,) or g.shape != out1.shape \
            or mean.numel() != b * c or rstd.numel() != b * c \
            or mean.device != out1.device:
        raise ValueError(f"K5b: b1 {tuple(b1.shape)}, g {tuple(g.shape)} or "
                         f"the B·C statistics do not match C={c}, E·C={hid}")
    ins = (out1, w1m, b1, w2m, g, mean, rstd)
    cp, hp = stage2_widths(c, hid)
    if (cp, hp) != (c, hid):
        ins = pad_stage2_bwd(*ins)
    lw = stage2_bwd_launch(b, cp, hp, s, _cuda.sm_count(out1.device))
    dev = out1.device
    dz = torch.empty((lw.slices, b, cp, s), device=dev)
    tsum = torch.empty((lw.units, lw.slices, cp, 2), device=dev)
    part = torch.empty((lw.chunks, 2 * hp * cp + hp + cp), device=dev)
    dt = out1.dtype
    dx = torch.empty((b, cp, d, h, w), device=dev, dtype=dt)
    dw1 = torch.empty((hp, cp), device=dev, dtype=dt)
    dw2 = torch.empty((cp, hp), device=dev, dtype=dt)
    db1 = torch.empty((hp,), device=dev, dtype=dt)
    db2 = torch.empty((cp,), device=dev, dtype=dt)
    lib = _cuda.lib("jlc_stage2", dt)
    with torch.cuda.device(dev):
        err = lib.vs_jlc_stage2_bwd(
            *(t.data_ptr() for t in ins), dz.data_ptr(), tsum.data_ptr(),
            part.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), b, cp, hp, s, lw.hs, lw.chunks,
            lw.per, lw.tp, lw.jpt, lw.ysplit, _cuda.stream_ptr(dev))
    _cuda.check(lib, err, "jlc_stage2_bwd")
    _cuda.count_launch(jlc_stage2_bwd, dt)
    return (dx[:, :c].contiguous(), dw1[:hid, :c].reshape(w1.shape),
            db1[:hid], dw2[:c, :hid].reshape(w2.shape), db2[:c])


jlc_stage2_bwd.launches = 0
jlc_stage2_bwd.launches_bf16 = 0


# ---------------------------------------------------------------------------
# The two stages as autograd Functions.
# ---------------------------------------------------------------------------

class _Stage1(torch.autograd.Function):
    """Inputs ``(x, groups, nb, *weights, *biases)``."""

    @staticmethod
    def forward(ctx, x, groups, nb, *params):
        weights, biases = params[:nb], params[nb:]
        ctx.groups, ctx.nb = groups, nb
        ctx.save_for_backward(x, *weights)
        return _jlc_stage1_fwd(x, weights, biases, groups)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        g = g.contiguous()
        dy, dws = jlc_stage1_bwd(x, weights, g, ctx.groups)
        # the branch convs' dgrads on cuDNN (CPU: ATen) in x's dtype, summed
        # in fp32 and rounded once, then added to g, as the JAX package's
        # one dgrad of the packed branch conv (fused_jlc.py:369-375)
        dxc = None
        for w, dyj in zip(weights, dy):
            d = torch.ops.aten.convolution_backward(
                dyj, x, w, None, *_conv_args(w, ctx.groups),
                [True, False, False])[0].float()
            dxc = d if dxc is None else dxc + d
        dx = g + dxc.to(g.dtype)
        zeros = [torch.zeros(w.shape[0], device=w.device, dtype=w.dtype)
                 for w in weights]
        return (dx, None, None, *dws, *zeros)


class _Stage2(torch.autograd.Function):

    @staticmethod
    def forward(ctx, out1, w1, b1, w2, b2):
        # K5b reuses K5f's plane statistics
        out, mean, rstd = _jlc_stage2_fwd(out1, w1, b1, w2, b2)
        ctx.save_for_backward(out1, w1, b1, w2, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        out1, w1, b1, w2, mean, rstd = ctx.saved_tensors
        return jlc_stage2_bwd(out1, w1, b1, w2, g.contiguous(), mean, rstd)


def _needs_graph(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def jlc_stage1(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], groups: int) -> torch.Tensor:
    """JLC stage 1 on ``(B, C, D, H, W)``, fp32 or bf16; ``weights[j]`` is
    the ``(C, C/groups, k, k, k)`` kernel of branch j (odd k; the kernels
    take k = 1, 3, 5). K4f forward; under autograd, K4b (with the weight
    gradient) and the convs' dgrad backward."""
    if not _needs_graph(x, *weights, *biases):
        return _jlc_stage1_fwd(x, weights, biases, groups)
    return _Stage1.apply(x, groups, len(weights), *weights, *biases)


jlc_stage1.launches = 0
jlc_stage1.launches_bf16 = 0


def jlc_stage2(out1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """JLC stage 2 on ``(B, C, D, H, W)``, fp32 or bf16 (the weights in
    out1's dtype): K5f forward, K5b backward."""
    if not _needs_graph(out1, w1, b1, w2, b2):
        return _jlc_stage2_fwd(out1, w1, b1, w2, b2)[0]
    return _Stage2.apply(out1, w1, b1, w2, b2)


jlc_stage2.launches = 0
jlc_stage2.launches_bf16 = 0
