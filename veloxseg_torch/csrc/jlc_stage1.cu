// K4f and K4b: JLC stage 1 forward and backward, fp32 or bf16 (built with
// -DVS_BF16), channels-first (B, C, D, H, W), for the branch set k = (1, 3,
// 5), the only one any config uses (the wrapper raises for another).
//
//   out1 = x + sum_k GELU(InstanceNorm(gconv_k(x)))
//
// Replaces: veloxseg_tpu/ops/fused_jlc.py:_k1_kernel (111-133), called
// through _k1_fwd (260-274), and _k1_bwd_kernel (135-170), called through
// _k1_bwd (277-294). K4b's weight-gradient launches stand in for XLA's
// wgrad of the branch convs in the JAX package's VJP
// (veloxseg_tpu/ops/fused_jlc.py:369-374).
//
// The TPU kernel holds one whole packed sample in VMEM and finishes the
// InstanceNorm statistics in one program. Here blocks see one 3-D tile of
// one (b, group) and run in no order, so each stage is a few launches:
//
// jlc_branch_conv<VX> (K4f and K4b): a direct grouped 3-D convolution of
//   all three branches at once. One block per (tile, group, output-channel
//   chunk, b). It stages the tile of x plus a halo of 2 (the k = 5 radius)
//   and all branches' weights of its output channels in shared memory
//   with cp.async (all of a thread's copies in flight at once); each
//   thread keeps VX voxels along W x 4 output channels x 3 branches
//   in registers. The 125 + 27 + 1 taps are unrolled at compile time, so
//   per input channel a thread issues 50 float4 loads of x rows and 153
//   broadcast float4 loads of weights for 2,448 FMAs (VX = 4). Volumes
//   narrower than 8 along W (the 3^3-6^3 levels) take VX = 1 and split the
//   input channels over the block's threads, summed in a fixed order, so
//   that small levels still fill the card. Its epilogue writes the branch
//   outputs to an fp32 scratch (3, B, C, S) and per-tile partial sums
//   (sum y, sum y^2, in double) per (branch, b, c); jlc_conv_stats sums
//   them over the tiles in order into mean and rstd (eps 1e-5, max(var,
//   0)). The branch conv bias is not read: it cancels inside the
//   InstanceNorm (fused_jlc.py:29-32).
// jlc_stage1_apply (K4f): out1 = x + sum_k GELU((y_k - mean) * rstd).
// jlc_stage1_bwd_planes (K4b): one block per (branch, b, c) plane,
//   dn = g · GELU'(ŷ), dy = rstd · (dn − mean(dn) − ŷ · mean(dn · ŷ)), the
//   means in double in a fixed order, dy over the scratch in place.
// jlc_branch_wgrad (K4b): dW_j[o, ci, t] = sum_b sum_v dy_j[b, o, v] ·
//   x[b, g·cg + ci, v + off_t] for all branches together. One block per
//   (group, output-channel chunk, input-channel chunk of 4, range of
//   (b, tile)); it stages x plus halo and dy of its channels for one tile
//   at a time, with cp.async. A thread owns one (ci, dz, dy) row of taps for 4 output
//   channels (the 5 k = 5 taps along x, and for the 9 central rows the
//   k = 3 and k = 1 taps), slides x along the row in registers, and keeps
//   its sums in registers across every tile it walks. Each block writes its
//   own slab; jlc_wgrad_reduce sums the slabs in block order. No float
//   atomics: dW repeats bit for bit.
//
// What bounds it on this card: fp32 FMA issue. At the 128^3 flagship's
// L0 (16, 16, 32^3), groups 4, the branch conv is 9.25 GFLOP over in-bound
// taps (0.14 ms at 67 TFLOP/s) against ~0.1 GB of the function's own bytes
// (0.03 ms), and the wgrad the same FLOPs; every flagship level is bound
// by operations. At the 3^3 level of 96^3 tiles the work is ~20 MFLOP and
// the bytes of the weights and of dW (128·16·153 floats each) bound it.
// The kernels run the taps that fall into the zero halo as well (7% more
// FMAs at 32^3, 2.9x at 4^3), and the scratch costs one write and two
// reads of 3·B·C·S floats.
//
// The bf16 form (T = bf16: x, the weights, g, out, dy and dW) is the same
// kernels, rounding where the Pallas kernels round (fused_jlc.py:111-170):
// x and the weights are converted to fp32 as they are staged (loaded at
// once, not by cp.async), so the convs accumulate in fp32 into the fp32
// scratch and the statistics are those of the fp32 sums; the apply pass
// rounds the normalized value before the GELU (gelu_in), adds each branch
// into a bf16 sum and the residual in bf16; the planes pass takes the
// GELU's gradient at the rounded normalized value and writes dy rounded to
// bf16 beside the scratch; the wgrad stages x and that dy and rounds each
// weight gradient once, as XLA's bf16 wgrad gives it.
#include "common.cuh"

constexpr int kOq = 4;                    // output channels per thread
constexpr int kCi = 4;                    // input channels per thread slice
constexpr int kHalo = 2;                  // radius of the k = 5 branch
constexpr int kTaps = 125 + 27 + 1;       // k = 5, 3, 1 taps, in that order
constexpr int kPairs = 3 * kOq;           // (branch, channel) per thread
constexpr int kConvMaxThreads = 512;
constexpr int kSeg = 8;                   // segments of the stats reduce
constexpr int kRows = 25;                 // (dz, dy) rows of the k = 5 cube
constexpr int kWgradMaxOq = 2;            // output quads per wgrad block

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout of a tile of x plus halo, [channel][PZ][PY][PX]:
// rows of PX floats, PX a multiple of 4 with PX / 4 odd, so that float4
// row loads of neighbouring rows fall on different banks; channel planes
// ≡ 8 (mod 32) floats apart, so that the wgrad's 4 input channels, read
// by neighbouring lanes, do too.
__host__ __device__ inline int x_pitch(int tx) {
  const int px = round4(tx) + 2 * kHalo;
  return (px / 4) % 2 ? px : px + 4;
}
__host__ __device__ inline int x_plane(int tz, int ty, int tx) {
  const int p = (tz + 2 * kHalo) * (ty + 2 * kHalo) * x_pitch(tx);
  return p + (40 - p % 32) % 32;
}

struct Tiles {
  int tz, ty, tx;      // tile edges
  int ny, nx, n;       // tiles along H, along W, in all
};

__device__ __forceinline__ void tile_origin(const Tiles& tl, int tile,
                                            int& z0, int& y0, int& x0) {
  z0 = (tile / (tl.ny * tl.nx)) * tl.tz;
  y0 = ((tile / tl.nx) % tl.ny) * tl.ty;
  x0 = (tile % tl.nx) * tl.tx;
}

// A mixed-radix index (most significant digit first) walked from `start`
// by `stride` with no division per step: the loops that stage tiles in
// shared memory would otherwise pay several integer divisions (tens of
// instructions each) per element.
template <int N>
struct RadixWalk {
  int d[N], s[N], r[N];
  __device__ __forceinline__ RadixWalk(const int (&radix)[N], int start,
                                       int stride) {
#pragma unroll
    for (int k = N - 1; k > 0; --k) {
      r[k] = radix[k];
      d[k] = start % r[k];
      start /= r[k];
      s[k] = stride % r[k];
      stride /= r[k];
    }
    r[0] = radix[0];
    d[0] = start;
    s[0] = stride;
  }
  __device__ __forceinline__ void step() {
    int carry = 0;
#pragma unroll
    for (int k = N - 1; k > 0; --k) {
      d[k] += s[k] + carry;
      carry = d[k] >= r[k];
      if (carry) d[k] -= r[k];
    }
    d[0] += s[0] + carry;
  }
};

// Stage channels [cbase, cbase + nc) of x (sample and group folded into
// cbase) of the tile at (z0, y0, x0) plus the halo into xs, planes
// ``plane`` floats apart; zero outside the volume. Asynchronous: wait with
// cp_async_wait_all.
template <typename T>
__device__ __forceinline__ void stage_x(
    const T* __restrict__ x, float* xs, int64_t cbase, int nc, int z0,
    int y0, int x0, int D, int H, int W, int PZ, int PY, int PX, int plane) {
  const int64_t S = (int64_t)D * H * W;
  const int radix[4] = {nc, PZ, PY, PX};
  RadixWalk<4> it(radix, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < nc * PZ * PY * PX; i += blockDim.x) {
    const int ci = it.d[0], pz = it.d[1], py = it.d[2], px = it.d[3];
    const int gz = z0 + pz - kHalo, gy = y0 + py - kHalo, gx = x0 + px - kHalo;
    const bool in =
        gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W;
    stage1<T>(xs + ci * plane + (pz * PY + py) * PX + px,
              in ? x + (cbase + ci) * S + ((int64_t)gz * H + gy) * W + gx
                 : x,
              in);
    it.step();
  }
}

template <int VX>
__device__ __forceinline__ void load_row(const float* p, float (&r)[VX + 4]) {
  if constexpr (VX == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < VX + 4; ++i) r[i] = p[i];
  }
}

template <int VX>
__device__ __forceinline__ void fma_tap(float (&a)[VX][kOq], const float* xv,
                                        float4 w) {
#pragma unroll
  for (int v = 0; v < VX; ++v) {
    a[v][0] = fmaf(xv[v], w.x, a[v][0]);
    a[v][1] = fmaf(xv[v], w.y, a[v][1]);
    a[v][2] = fmaf(xv[v], w.z, a[v][2]);
    a[v][3] = fmaf(xv[v], w.w, a[v][3]);
  }
}

// The branch conv. Grid (tiles, groups · noq / oqb, B); block
// ks · oqb · nsp threads, nsp = tz · ty · tx / VX. Thread t: spatial slot
// t % nsp, output quad (t / nsp) % oqb of the block's oqb, input-channel
// slice t / (nsp · oqb) of the ks slices of a round (4·ks channels).
template <typename T, int VX>
__global__ void __launch_bounds__(kConvMaxThreads)
jlc_branch_conv(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ w3, const T* __restrict__ w5,
                float* __restrict__ y, double2* __restrict__ pstat, int B,
                int C, int D, int H, int W, int cg, Tiles tl, int ks,
                int oqb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int noq = cg / kOq;
  const int nxq = tl.tx / VX;
  const int nsp = tl.tz * tl.ty * nxq;
  const int nq = oqb * nsp;
  const int PX = x_pitch(tl.tx), PY = tl.ty + 2 * kHalo;
  const int PZ = tl.tz + 2 * kHalo, plane = x_plane(tl.tz, tl.ty, tl.tx);
  const int rc = kCi * ks;                      // channels per round
  const int tile = blockIdx.x;
  const int g = blockIdx.y / (noq / oqb);
  const int oq0 = (blockIdx.y % (noq / oqb)) * oqb;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int sp = t % nsp, oql = (t / nsp) % oqb, kk = t / nq;
  const int xq = sp % nxq, yy = (sp / nxq) % tl.ty, zz = sp / (nxq * tl.ty);
  int z0, y0, x0;
  tile_origin(tl, tile, z0, y0, x0);
  const int64_t S = (int64_t)D * H * W;
  float4* ws = reinterpret_cast<float4*>(smem);   // [oqb][rc][kTaps]
  float* xs = reinterpret_cast<float*>(ws + oqb * rc * kTaps);

  float acc[3][VX][kOq];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int v = 0; v < VX; ++v)
#pragma unroll
      for (int o = 0; o < kOq; ++o) acc[j][v][o] = 0.f;

  for (int c0 = 0; c0 < cg; c0 += rc) {
    __syncthreads();                  // the previous round is done
    stage_x(x, xs, (int64_t)b * C + (int64_t)g * cg + c0, rc, z0, y0, x0, D,
            H, W, PZ, PY, PX, plane);
    const int wradix[3] = {oqb, rc, kTaps};
    RadixWalk<3> wi(wradix, t, blockDim.x);
    for (int i = t; i < oqb * rc * kTaps; i += blockDim.x, wi.step()) {
      const int q = wi.d[0], ci = wi.d[1], tap = wi.d[2];
      const T* wp = tap < 125 ? w5 : tap < 152 ? w3 : w1;
      const int taps = tap < 125 ? 125 : tap < 152 ? 27 : 1;
      const int tt = tap < 125 ? tap : tap < 152 ? tap - 125 : 0;
      const int64_t o = (int64_t)g * cg + (oq0 + q) * kOq;
      const int64_t st = (int64_t)cg * taps;
      const T* p = wp + (o * cg + c0 + ci) * taps + tt;
      float* d = reinterpret_cast<float*>(ws + i);
#pragma unroll
      for (int k = 0; k < kOq; ++k) stage1<T>(d + k, p + k * st, true);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll 1
    for (int ci = kk * kCi; ci < kk * kCi + kCi; ++ci) {
      const float* xc = xs + ci * plane + (zz * PY + yy) * PX + xq * VX;
      const float4* wc = ws + (oql * rc + ci) * kTaps;
      // a rolled dz keeps the body at 25 unrolled rows of taps
#pragma unroll 1
      for (int dz = 0; dz < 5; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 5; ++dy) {
          float xr[VX + 4];
          load_row<VX>(xc + (dz * PY + dy) * PX, xr);
#pragma unroll
          for (int dx = 0; dx < 5; ++dx) {
            fma_tap<VX>(acc[2], xr + dx, wc[(dz * 5 + dy) * 5 + dx]);
            if (dz >= 1 && dz <= 3 && dy >= 1 && dy <= 3 && dx >= 1 &&
                dx <= 3)
              fma_tap<VX>(acc[1], xr + dx,
                          wc[125 + ((dz - 1) * 3 + dy - 1) * 3 + dx - 1]);
            if (dz == 2 && dy == 2 && dx == 2)
              fma_tap<VX>(acc[0], xr + dx, wc[152]);
          }
        }
      }
    }
  }

  // the ks channel slices' partial sums, added to slice 0's in order
  constexpr int NA = 3 * VX * kOq;
  __syncthreads();
  if (ks > 1) {
    float* fr = reinterpret_cast<float*>(smem);  // [ks - 1][NA][nq]
    if (kk > 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a)
        fr[((kk - 1) * NA + a) * nq + oql * nsp + sp] =
            (&acc[0][0][0])[a];
    }
    __syncthreads();
    if (kk == 0) {
      for (int k = 1; k < ks; ++k) {
#pragma unroll
        for (int a = 0; a < NA; ++a)
          (&acc[0][0][0])[a] += fr[((k - 1) * NA + a) * nq + oql * nsp + sp];
      }
    }
    __syncthreads();
  }

  // store the branch outputs; per-thread statistics of the valid voxels
  double2* red = reinterpret_cast<double2*>(smem);   // [kPairs][nq]
  if (kk == 0) {
    const int gz = z0 + zz, gy = y0 + yy, gx = x0 + xq * VX;
    const bool row_ok = gz < D && gy < H;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int o = 0; o < kOq; ++o) {
        const int64_t c = (int64_t)g * cg + (oq0 + oql) * kOq + o;
        float* yp = y + ((int64_t)j * B * C + (int64_t)b * C + c) * S +
                    ((int64_t)gz * H + gy) * W + gx;
        double s1 = 0.0, s2 = 0.0;
        bool stored = false;
        if constexpr (VX == 4) {
          if (row_ok && gx + 4 <= W && W % 4 == 0) {  // aligned: x0 % 4 == 0
            *reinterpret_cast<float4*>(yp) = make_float4(
                acc[j][0][o], acc[j][1][o], acc[j][2][o], acc[j][3][o]);
            stored = true;
          }
        }
        if (row_ok) {
#pragma unroll
          for (int v = 0; v < VX; ++v) {
            if (gx + v < W) {
              if (!stored) yp[v] = acc[j][v][o];
              const double a = acc[j][v][o];
              s1 += a;
              s2 += a * a;
            }
          }
        }
        red[(j * kOq + o) * nq + oql * nsp + sp] = make_double2(s1, s2);
      }
    }
  }
  __syncthreads();
  // fixed-order reduce over the spatial slots: kSeg segments, then those
  double2* seg = red + kPairs * nq;                 // [oqb][kPairs][kSeg]
  const int len = (nsp + kSeg - 1) / kSeg;
  for (int task = t; task < oqb * kPairs * kSeg; task += blockDim.x) {
    const int s = task % kSeg, q = task / kSeg;
    const int pair = q % kPairs, ql = q / kPairs;
    const double2* src = red + pair * nq + ql * nsp;
    double a1 = 0.0, a2 = 0.0;
    for (int r = s * len; r < min(nsp, (s + 1) * len); ++r) {
      a1 += src[r].x;
      a2 += src[r].y;
    }
    seg[task] = make_double2(a1, a2);
  }
  __syncthreads();
  for (int q = t; q < oqb * kPairs; q += blockDim.x) {
    double a1 = 0.0, a2 = 0.0;
    for (int s = 0; s < kSeg; ++s) {
      a1 += seg[q * kSeg + s].x;
      a2 += seg[q * kSeg + s].y;
    }
    const int pair = q % kPairs, ql = q / kPairs;
    const int j = pair / kOq, o = pair % kOq;
    const int64_t c = (int64_t)g * cg + (oq0 + ql) * kOq + o;
    pstat[((int64_t)j * B * C + (int64_t)b * C + c) * tl.n + tile] =
        make_double2(a1, a2);
  }
}

// mean and rstd of each (branch, b, c) plane from its tiles' partial sums,
// summed in tile order.
__global__ void jlc_conv_stats(const double2* __restrict__ pstat, int tiles,
                               int64_t planes, int64_t S, float eps,
                               float* __restrict__ mean,
                               float* __restrict__ rstd) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= planes) return;
  double s1 = 0.0, s2 = 0.0;
  for (int k = 0; k < tiles; ++k) {
    const double2 v = pstat[p * tiles + k];
    s1 += v.x;
    s2 += v.y;
  }
  const double m = s1 / static_cast<double>(S);
  double var = s2 / static_cast<double>(S) - m * m;
  if (var < 0.0) var = 0.0;
  mean[p] = static_cast<float>(m);
  rstd[p] = static_cast<float>(1.0 / sqrt(var + eps));
}

// out1 = x + sum_j GELU(ŷ_j), the branches added in order into a sum of
// T (its first term exact) and the residual added in T.
template <typename T>
__global__ void jlc_stage1_apply(const T* __restrict__ x,
                                 const float* __restrict__ y,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ rstd,
                                 T* __restrict__ out, int64_t planes,
                                 int64_t S) {
  const int64_t n = planes * S;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t p = i / S;
    float acc = 0.f;
    for (int j = 0; j < 3; ++j) {
      const int64_t pj = j * planes + p;
      acc = round_to<T>(
          acc + gelu_in<T>((y[j * n + i] - mean[pj]) * rstd[pj]));
    }
    out[i] = from_f32<T>(to_f32(x[i]) + acc);
  }
}

// K4b's planes pass: one block per (branch, b, c) plane of the scratch y;
// dy in T (for float the scratch itself, overwritten in place: y and dy
// may alias). The GELU's gradient at ŷ rounded to T (fused_jlc.py:155-162).
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
jlc_stage1_bwd_planes(const float* y, const T* __restrict__ g, T* dy,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, int64_t planes,
                      int64_t S) {
  const int64_t pj = blockIdx.x;              // branch-major plane index
  const float* yp = y + pj * S;
  T* dyp = dy + pj * S;
  const T* gp = g + (pj % planes) * S;
  const float m = mean[pj], r = rstd[pj];
  double s1 = 0.0, s2 = 0.0;
  for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
    const float yh = (yp[i] - m) * r;
    const float dn = to_f32(gp[i]) * gelu_grad(round_to<T>(yh));
    s1 += dn;
    s2 += static_cast<double>(dn) * yh;
  }
  block_sum2(s1, s2);
  const float mdn = static_cast<float>(s1 / static_cast<double>(S));
  const float mdny = static_cast<float>(s2 / static_cast<double>(S));
  for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
    const float yh = (yp[i] - m) * r;
    const float dn = to_f32(gp[i]) * gelu_grad(round_to<T>(yh));
    dyp[i] = from_f32<T>(r * (dn - mdn - yh * mdny));
  }
}

// (dz, dy) of wgrad row r: the 9 rows that also hold k = 3 taps first
// (row 4 is the centre, which also holds the k = 1 tap), then the ring.
__device__ __forceinline__ void wgrad_row(int r, int& dz, int& dy) {
  if (r < 9) {
    dz = 1 + r / 3;
    dy = 1 + r % 3;
  } else if (r < 19) {
    dz = r < 14 ? 0 : 4;
    dy = (r - 9) % 5;
  } else {
    dz = 1 + (r - 19) / 2;
    dy = (r - 19) % 2 ? 4 : 0;
  }
}

// The branch weight gradient. Grid (chunks, groups · (noq / oqb) · noq);
// block kRows · kCi · oqb threads: thread t owns row t / (kCi · oqb), input
// channel t % kCi of the block's 4, output quad (t / kCi) % oqb. Block x
// walks the (b, tile) units [x · per, min(units, (x + 1) · per)) and
// writes its sums to its slab part[x][C][cg][kTaps].
template <typename T>
__global__ void __launch_bounds__(kRows * kCi * kWgradMaxOq)
jlc_branch_wgrad(const T* __restrict__ x, const T* __restrict__ dy,
                 float* __restrict__ part, int B, int C, int D, int H, int W,
                 int cg, Tiles tl, int oqb, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int noq = cg / kOq, nci = cg / kCi;
  const int TXP = round4(tl.tx), PX = x_pitch(tl.tx);
  const int PY = tl.ty + 2 * kHalo, PZ = tl.tz + 2 * kHalo;
  const int plane = x_plane(tl.tz, tl.ty, tl.tx);
  const int nvox = tl.tz * tl.ty * TXP;
  float* xs = reinterpret_cast<float*>(smem);              // [kCi][plane]
  float4* ds = reinterpret_cast<float4*>(xs + kCi * plane);  // [nvox][3][oqb]
  float* dsf = reinterpret_cast<float*>(ds);
  int yi = blockIdx.y;
  const int cc = yi % nci;
  yi /= nci;
  const int oc = yi % (noq / oqb), g = yi / (noq / oqb);
  const int t = threadIdx.x;
  const int row = t / (kCi * oqb), ci = t % kCi, oql = (t / kCi) % oqb;
  int dz, dyr;
  wgrad_row(row, dz, dyr);
  const bool center = row < 9, mid = row == 4;
  const int64_t S = (int64_t)D * H * W;
  const int units = B * tl.n;

  float a5[5][kOq], a3[3][kOq], a1[kOq];
#pragma unroll
  for (int o = 0; o < kOq; ++o) {
#pragma unroll
    for (int d = 0; d < 5; ++d) a5[d][o] = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) a3[d][o] = 0.f;
    a1[o] = 0.f;
  }

  const int u1 = min(units, (int)(blockIdx.x + 1) * per);
  for (int u = blockIdx.x * per; u < u1; ++u) {
    const int b = u / tl.n, tile = u % tl.n;
    int z0, y0, x0;
    tile_origin(tl, tile, z0, y0, x0);
    __syncthreads();                  // the previous tile is done
    stage_x(x, xs, (int64_t)b * C + (int64_t)g * cg + cc * kCi, kCi, z0, y0,
            x0, D, H, W, PZ, PY, PX, plane);
    const int radix[6] = {3, oqb, kOq, tl.tz, tl.ty, TXP};
    RadixWalk<6> it(radix, t, blockDim.x);
    for (int i = t; i < nvox * 3 * oqb * kOq; i += blockDim.x, it.step()) {
      const int j = it.d[0], q = it.d[1], o = it.d[2];
      const int vz = it.d[3], vy = it.d[4], vx = it.d[5];
      const int v = (vz * tl.ty + vy) * TXP + vx;
      const int gz = z0 + vz, gy = y0 + vy, gx = x0 + vx;
      // voxels off the volume add nothing
      const bool in = vx < tl.tx && gz < D && gy < H && gx < W;
      const int64_t c = (int64_t)g * cg + (oc * oqb + q) * kOq + o;
      stage1<T>(dsf + ((v * 3 + j) * oqb + q) * kOq + o,
                in ? dy + ((int64_t)j * B * C + (int64_t)b * C + c) * S +
                         ((int64_t)gz * H + gy) * W + gx
                   : dy,
                in);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int zz = 0; zz < tl.tz; ++zz) {
      for (int yy = 0; yy < tl.ty; ++yy) {
        const float* xrow = xs + ci * plane + ((zz + dz) * PY + yy + dyr) * PX;
        const int vrow = (zz * tl.ty + yy) * TXP;
        for (int x4 = 0; x4 < TXP; x4 += 4) {
          float xr[8];
          load_row<4>(xrow + x4, xr);
#pragma unroll
          for (int xi = 0; xi < 4; ++xi) {
            const int v = vrow + x4 + xi;
            const float4 d5 = ds[(v * 3 + 2) * oqb + oql];
#pragma unroll
            for (int d = 0; d < 5; ++d) {
              a5[d][0] = fmaf(xr[xi + d], d5.x, a5[d][0]);
              a5[d][1] = fmaf(xr[xi + d], d5.y, a5[d][1]);
              a5[d][2] = fmaf(xr[xi + d], d5.z, a5[d][2]);
              a5[d][3] = fmaf(xr[xi + d], d5.w, a5[d][3]);
            }
            if (center) {
              const float4 d3 = ds[(v * 3 + 1) * oqb + oql];
#pragma unroll
              for (int d = 0; d < 3; ++d) {
                a3[d][0] = fmaf(xr[xi + d + 1], d3.x, a3[d][0]);
                a3[d][1] = fmaf(xr[xi + d + 1], d3.y, a3[d][1]);
                a3[d][2] = fmaf(xr[xi + d + 1], d3.z, a3[d][2]);
                a3[d][3] = fmaf(xr[xi + d + 1], d3.w, a3[d][3]);
              }
              if (mid) {
                const float4 d1 = ds[(v * 3) * oqb + oql];
                a1[0] = fmaf(xr[xi + 2], d1.x, a1[0]);
                a1[1] = fmaf(xr[xi + 2], d1.y, a1[1]);
                a1[2] = fmaf(xr[xi + 2], d1.z, a1[2]);
                a1[3] = fmaf(xr[xi + 2], d1.w, a1[3]);
              }
            }
          }
        }
      }
    }
  }

  float* pc = part + (int64_t)blockIdx.x * C * cg * kTaps;
#pragma unroll
  for (int o = 0; o < kOq; ++o) {
    const int64_t c = (int64_t)g * cg + (oc * oqb + oql) * kOq + o;
    float* pp = pc + (c * cg + cc * kCi + ci) * kTaps;
#pragma unroll
    for (int d = 0; d < 5; ++d) pp[(dz * 5 + dyr) * 5 + d] = a5[d][o];
    if (center) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        pp[125 + ((dz - 1) * 3 + dyr - 1) * 3 + d] = a3[d][o];
    }
    if (mid) pp[152] = a1[o];
  }
}

// The slabs summed over the chunks in order, scattered into the three
// branches' (C, cg, k, k, k) weight gradients, rounded once to T.
template <typename T>
__global__ void jlc_wgrad_reduce(const float* __restrict__ part, int chunks,
                                 int64_t n, T* __restrict__ dw1,
                                 T* __restrict__ dw3, T* __restrict__ dw5) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[k * n + i];
    const int64_t oc = i / kTaps;        // o · cg + ci
    const int tap = (int)(i - oc * kTaps);
    if (tap < 125) dw5[oc * 125 + tap] = from_f32<T>(s);
    else if (tap < 152) dw3[oc * 27 + tap - 125] = from_f32<T>(s);
    else dw1[oc] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// Host side. The wrapper (veloxseg_torch/ops/fused_jlc.py:stage1_launch)
// chooses the tiling; these functions check it and launch.
// ---------------------------------------------------------------------------

static bool make_tiles(int D, int H, int W, int tz, int ty, int tx,
                       Tiles& tl) {
  if (tz < 1 || ty < 1 || tx < 1 || tz > 8 || ty > 8 || tx > 8) return false;
  tl.tz = tz;
  tl.ty = ty;
  tl.tx = tx;
  tl.ny = (H + ty - 1) / ty;
  tl.nx = (W + tx - 1) / tx;
  tl.n = ((D + tz - 1) / tz) * tl.ny * tl.nx;
  return true;
}

template <typename T, int VX>
static cudaError_t launch_conv(const T* x, const T* w1, const T* w3,
                               const T* w5, float* y,
                               double2* pstat, int B, int C, int D, int H,
                               int W, int groups, const Tiles& tl, int ks,
                               int oqb, cudaStream_t stream) {
  const int cg = C / groups, noq = cg / kOq;
  const int nsp = tl.tz * tl.ty * (tl.tx / VX);
  const int threads = ks * oqb * nsp;
  if (ks < 1 || oqb < 1 || tl.tx % VX || noq % oqb || cg % (kCi * ks) ||
      threads > kConvMaxThreads || groups * (noq / oqb) > 65535 ||
      B > 65535) {
    return cudaErrorInvalidValue;
  }
  const int rc = kCi * ks;
  const int plane = x_plane(tl.tz, tl.ty, tl.tx);
  const size_t conv = (size_t)oqb * rc * kTaps * sizeof(float4) +
                      (size_t)rc * plane * sizeof(float);
  const size_t slices = (size_t)(ks - 1) * 3 * VX * kOq * oqb * nsp *
                        sizeof(float);
  const size_t stats = ((size_t)kPairs * oqb * nsp +
                        (size_t)oqb * kPairs * kSeg) * sizeof(double2);
  const size_t smem = conv > slices ? (conv > stats ? conv : stats)
                                    : (slices > stats ? slices : stats);
  cudaError_t err = allow_smem(jlc_branch_conv<T, VX>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tl.n, groups * (noq / oqb), B);
  jlc_branch_conv<T, VX><<<grid, threads, smem, stream>>>(
      x, w1, w3, w5, y, pstat, B, C, D, H, W, cg, tl, ks, oqb);
  return cudaGetLastError();
}

// The branch convolution of the three branches into scratch (3, B, C, S),
// then their per-plane statistics: the part K4f and K4b share.
template <typename T>
static cudaError_t conv_and_stats(const T* x, const T* w1, const T* w3,
                                  const T* w5, float* scratch,
                                  double2* pstat, float* mean,
                                  float* rstd, int B, int C, int D, int H,
                                  int W, int groups, const Tiles& tl, int vx,
                                  int ks, int oqb, cudaStream_t stream) {
  cudaError_t err =
      vx == 4 ? launch_conv<T, 4>(x, w1, w3, w5, scratch, pstat, B, C, D, H,
                                  W, groups, tl, ks, oqb, stream)
      : vx == 1 ? launch_conv<T, 1>(x, w1, w3, w5, scratch, pstat, B, C, D,
                                    H, W, groups, tl, ks, oqb, stream)
                : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int64_t planes = 3LL * B * C;
  jlc_conv_stats<<<(unsigned)((planes + 255) / 256), 256, 0, stream>>>(
      pstat, tl.n, planes, (int64_t)D * H * W, 1e-5f, mean, rstd);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t wgrad(const T* x, const T* dy, float* part, T* dw1,
                         T* dw3, T* dw5, int B, int C,
                         int D, int H, int W, int groups, const Tiles& tl,
                         int oqb, int chunks, cudaStream_t stream) {
  const int cg = C / groups, noq = cg / kOq;
  const int units = B * tl.n;
  if (oqb < 1 || oqb > kWgradMaxOq || noq % oqb || chunks < 1 ||
      chunks > units) {
    return cudaErrorInvalidValue;
  }
  const int per = (units + chunks - 1) / chunks;
  const int plane = x_plane(tl.tz, tl.ty, tl.tx);
  const int nvox = tl.tz * tl.ty * round4(tl.tx);
  const size_t smem = (size_t)kCi * plane * sizeof(float) +
                      (size_t)nvox * 3 * oqb * sizeof(float4);
  cudaError_t err = allow_smem(jlc_branch_wgrad<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(chunks, groups * (noq / oqb) * (cg / kCi));
  jlc_branch_wgrad<T><<<grid, kRows * kCi * oqb, smem, stream>>>(
      x, dy, part, B, C, D, H, W, cg, tl, oqb, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = (int64_t)C * cg * kTaps;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256
                                                            : 4096);
  jlc_wgrad_reduce<T><<<blocks, 256, 0, stream>>>(part, chunks, n, dw1, dw3,
                                                  dw5);
  return cudaGetLastError();
}

static bool shape_ok(int C, int groups) {
  return groups >= 1 && C % groups == 0 && (C / groups) % kOq == 0;
}

// K4f. x: (B, C, D, H, W); w1, w3, w5: the k = 1, 3, 5 branches'
// (C, C/groups, k, k, k) weights; out: like x (all Elem); scratch: 3·B·C·S
// floats; pstat: 3·B·C·tiles double2; mean, rstd: 3·B·C floats each. The
// tiling (tz, ty, tx, vx, ks, oqb) comes from the wrapper.
extern "C" int vs_jlc_stage1(const Elem* x, const Elem* w1, const Elem* w3,
                             const Elem* w5, float* scratch, void* pstat,
                             float* mean, float* rstd, Elem* out, int B,
                             int C, int D, int H, int W, int groups, int tz,
                             int ty, int tx, int vx, int ks, int oqb,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t S = (int64_t)D * H * W;
  if (S == 0 || B == 0) return cudaSuccess;
  Tiles tl;
  if (!shape_ok(C, groups) || !make_tiles(D, H, W, tz, ty, tx, tl))
    return cudaErrorInvalidValue;
  cudaError_t err = conv_and_stats(
      x, w1, w3, w5, scratch, static_cast<double2*>(pstat), mean, rstd, B, C,
      D, H, W, groups, tl, vx, ks, oqb, stream);
  if (err != cudaSuccess) return err;
  const int64_t planes = (int64_t)B * C;
  const int64_t n = planes * S;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads < 65536 * 8
                                         ? (n + threads - 1) / threads
                                         : 65536 * 8);
  jlc_stage1_apply<Elem><<<blocks, threads, 0, stream>>>(
      x, scratch, mean, rstd, out, planes, S);
  return cudaGetLastError();
}

// The branch weight gradients alone, given x and dy (3, B, C, S): what K4b
// runs after its planes pass. part: chunks·C·(C/groups)·153 floats; dw1,
// dw3, dw5: the branches' (C, C/groups, k, k, k) gradients (x, dy and dW
// Elem).
extern "C" int vs_jlc_branch_wgrad(const Elem* x, const Elem* dy,
                                   float* part, Elem* dw1, Elem* dw3,
                                   Elem* dw5, int B, int C, int D, int H,
                                   int W, int groups, int tz, int ty, int tx,
                                   int oqb, int chunks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Tiles tl;
  if (!shape_ok(C, groups) || !make_tiles(D, H, W, tz, ty, tx, tl))
    return cudaErrorInvalidValue;
  if ((int64_t)D * H * W == 0 || B == 0) return cudaSuccess;
  return wgrad(x, dy, part, dw1, dw3, dw5, B, C, D, H, W, groups, tl, oqb,
               chunks, stream);
}

// K4b. x, g: (B, C, D, H, W); w1, w3, w5 as for vs_jlc_stage1; scratch:
// 3·B·C·S floats, the recomputed branch outputs; dy: 3·B·C·S, the
// cotangent at each branch's conv output (branch-major; in fp32 it may be
// the scratch itself, overwritten in place); pstat, mean, rstd as for
// vs_jlc_stage1; part, dw1, dw3, dw5 as for vs_jlc_branch_wgrad.
extern "C" int vs_jlc_stage1_bwd(
    const Elem* x, const Elem* w1, const Elem* w3, const Elem* w5,
    const Elem* g, float* scratch, Elem* dy, void* pstat, float* mean,
    float* rstd, float* part, Elem* dw1, Elem* dw3, Elem* dw5, int B, int C,
    int D, int H, int W, int groups, int tz, int ty, int tx, int vx, int ks,
    int oqb, int wgrad_oqb, int chunks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t S = (int64_t)D * H * W;
  if (S == 0 || B == 0) return cudaSuccess;
  Tiles tl;
  if (!shape_ok(C, groups) || !make_tiles(D, H, W, tz, ty, tx, tl))
    return cudaErrorInvalidValue;
  cudaError_t err = conv_and_stats(
      x, w1, w3, w5, scratch, static_cast<double2*>(pstat), mean, rstd, B, C,
      D, H, W, groups, tl, vx, ks, oqb, stream);
  if (err != cudaSuccess) return err;
  jlc_stage1_bwd_planes<Elem><<<3 * B * C, kStatsThreads, 0, stream>>>(
      scratch, g, dy, mean, rstd, (int64_t)B * C, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return wgrad(x, dy, part, dw1, dw3, dw5, B, C, D, H, W, groups, tl,
               wgrad_oqb, chunks, stream);
}
