// K5f and K5b: JLC stage 2 forward and backward, fp32, channels-first
// (B, C, D, H, W).
//
//   out = out1 + W2 · GELU(W1 · InstanceNorm(out1) + b1) + b2
//
// Replaces: veloxseg_tpu/ops/fused_jlc.py:_k2_kernel (177-192), called
// through _k2_fwd (297-312). Two launches:
//   1. plane_stats_kernel (common.cuh): deterministic per-(b, c) mean and
//      rstd of out1 (eps 1e-5, max(var, 0)).
//   2. jlc_channel_mlp: one block per tile of kTile voxels of one sample.
//      It normalizes the tile into shared memory as z[c][v], computes the
//      hidden layer h[e][v] = GELU(b1[e] + sum_c W1[e][c] z[c][v]) into
//      shared memory, then out[c][v] = out1 + b2[c] + sum_e W2[c][e] h[e][v].
//      The tile width is one warp, so the 32 lanes of a warp share one
//      weight index (a broadcast read through L1) and read z and h at
//      consecutive addresses. The matrix products stay in this kernel, as
//      they were inside the TPU kernel's body.
//
// What bounds it on this card: the function reads out1 once and writes out
// once, and does 4·C·E·C FLOP per voxel (E = 2..3); at the AutoPET shapes
// that is ~7 MB and ~0.2 GFLOP per call at L0, so HBM bytes bound it. The
// stats pass reads out1 a second time. The weights are not staged in shared
// memory: at L3 (C = 128, E = 2) W1 and W2 are 256 KB of fp32, more than a
// block may hold, so they stream through L1/L2 as warp-uniform loads.
//
// K5b replaces veloxseg_tpu/ops/fused_jlc.py:_k2_bwd_kernel (194-243),
// called through _k2_bwd (315-343). Given g, the cotangent of out, it
// recomputes ŷ = IN(out1), z1p = W1·ŷ + b1 and z1 = GELU(z1p), then
//   db2 = Σ g,  dW2 = Σ g·z1ᵀ,  dz1 = (W2ᵀ g) ⊙ GELU'(z1p),  db1 = Σ dz1,
//   dW1 = Σ dz1·ŷᵀ,  dz = W1ᵀ dz1,
//   dx = g + rstd·(dz − mean(dz) − ŷ·mean(dz·ŷ)),
// sums over batch and voxels. Four launches:
//   1. plane_stats_kernel on out1 (the forward's statistics).
//   2. jlc_mlp_bwd_tiles: a block walks a chunk of 32-voxel tiles; per
//      tile it stages ŷ and g ([C][32]) and computes z1 and dz1 ([E·C][32])
//      in shared memory, writes dz to an HBM scratch, and adds the tile's
//      weight and bias products (sums over its 32 voxels) into its own
//      partial of (dW1, dW2, db1, db2): a private slab in global memory,
//      each element owned by one thread (written at the chunk's first
//      tile, added to after). The matrix products stay in this kernel, as
//      they were inside the TPU kernel's body.
//   3. jlc_stage2_bwd_planes: one block per (b, c) plane reduces mean(dz)
//      and mean(dz·ŷ) in double in a fixed order and writes dx.
//   4. mlp_partials_reduce: sums the partials over the chunks in order.
// No float atomics: the weight gradients repeat bit for bit.
// Bound: ~10·C·E·C FLOP per voxel (E = 2..3) for the five products, and
// out1, g, dx once in HBM (dz adds a round trip).
#include "common.cuh"

constexpr int kTile = 32;        // voxels per block (one warp wide)
constexpr int kMlpThreads = 256;

__global__ void __launch_bounds__(kMlpThreads)
jlc_channel_mlp(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ mean,
                const float* __restrict__ rstd, float* __restrict__ out,
                int C, int HID, int64_t S) {
  extern __shared__ float sm[];
  float* zs = sm;                 // [C][kTile]
  float* hs = sm + C * kTile;     // [HID][kTile]
  const int b = blockIdx.y;
  const int64_t v0 = (int64_t)blockIdx.x * kTile;
  const float* xb = x + (int64_t)b * C * S;
  float* ob = out + (int64_t)b * C * S;

  for (int i = threadIdx.x; i < C * kTile; i += blockDim.x) {
    const int c = i / kTile, t = i - c * kTile;
    const int64_t v = v0 + t;
    float z = 0.f;
    if (v < S) z = (xb[c * S + v] - mean[b * C + c]) * rstd[b * C + c];
    zs[i] = z;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HID * kTile; i += blockDim.x) {
    const int e = i / kTile, t = i - e * kTile;
    const float* we = w1 + (int64_t)e * C;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(__ldg(we + c), zs[c * kTile + t], acc);
    hs[i] = gelu_exact(acc + __ldg(b1 + e));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < C * kTile; i += blockDim.x) {
    const int c = i / kTile, t = i - c * kTile;
    const int64_t v = v0 + t;
    if (v >= S) continue;
    const float* wc = w2 + (int64_t)c * HID;
    float acc = 0.f;
    for (int e = 0; e < HID; ++e) acc = fmaf(__ldg(wc + e), hs[e * kTile + t], acc);
    ob[c * S + v] = xb[c * S + v] + (acc + __ldg(b2 + c));
  }
}

// x: (B, C, D, H, W) = out1; w1: (HID, C); b1: (HID,); w2: (C, HID);
// b2: (C,); mean, rstd: B·C floats each (scratch); out: like x.
extern "C" int vs_jlc_stage2(const float* x, const float* w1, const float* b1,
                             const float* w2, const float* b2, float* mean,
                             float* rstd, float* out, int B, int C, int HID,
                             int S, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0) return cudaSuccess;
  plane_stats_kernel<<<B * C, kStatsThreads, 0, stream>>>(x, S, 1e-5f, mean,
                                                          rstd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(C + HID) * kTile * sizeof(float);
  err = allow_smem(jlc_channel_mlp, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), B);
  jlc_channel_mlp<<<grid, kMlpThreads, smem, stream>>>(
      x, w1, b1, w2, b2, mean, rstd, out, C, HID, S);
  return cudaGetLastError();
}

constexpr int kBwdThreads = 256;
// Row stride of K5b's [channel][voxel] tiles in shared memory: one more
// than the tile, so lanes that read one voxel of 32 channels hit 32 banks.
constexpr int kLd = kTile + 1;

// K5b launch 2. part: one slab per block, laid out [dW1 (HID·C) | dW2
// (C·HID) | db1 (HID) | db2 (C)].
__global__ void __launch_bounds__(kBwdThreads)
jlc_mlp_bwd_tiles(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ g, const float* __restrict__ mean,
                  const float* __restrict__ rstd, float* __restrict__ dz,
                  float* __restrict__ part, int C, int HID, int64_t S,
                  int tiles_per_sample, int total_tiles, int chunk) {
  extern __shared__ float sm[];
  float* zs = sm;                  // [C][kLd] ŷ
  float* gs = zs + C * kLd;        // [C][kLd] g
  float* z1s = gs + C * kLd;       // [HID][kLd] GELU(z1p)
  float* d1s = z1s + HID * kLd;    // [HID][kLd] dz1
  const int t0 = blockIdx.x * chunk;
  const int t1 = min(t0 + chunk, total_tiles);
  const int64_t slab = 2LL * HID * C + HID + C;
  float* pc = part + blockIdx.x * slab;
  if (t0 >= t1) {  // an empty chunk still owns its slab: zero it
    for (int64_t i = threadIdx.x; i < slab; i += blockDim.x) pc[i] = 0.f;
    return;
  }
  for (int ti = t0; ti < t1; ++ti) {
    const int b = ti / tiles_per_sample;
    const int64_t v0 = (int64_t)(ti - b * tiles_per_sample) * kTile;
    const float* xb = x + (int64_t)b * C * S;
    const float* gb = g + (int64_t)b * C * S;
    float* dzb = dz + (int64_t)b * C * S;
    __syncthreads();  // the previous tile is done with shared memory
    for (int i = threadIdx.x; i < C * kTile; i += blockDim.x) {
      const int c = i / kTile, t = i - c * kTile;
      const int64_t v = v0 + t;
      float z = 0.f, gv = 0.f;  // voxels past the end contribute nothing
      if (v < S) {
        z = (xb[c * S + v] - mean[b * C + c]) * rstd[b * C + c];
        gv = gb[c * S + v];
      }
      zs[c * kLd + t] = z;
      gs[c * kLd + t] = gv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < HID * kTile; i += blockDim.x) {
      const int e = i / kTile, t = i - e * kTile;
      const float* we = w1 + (int64_t)e * C;
      float acc = 0.f, gw = 0.f;
      for (int c = 0; c < C; ++c) {
        acc = fmaf(__ldg(we + c), zs[c * kLd + t], acc);
        gw = fmaf(__ldg(w2 + (int64_t)c * HID + e), gs[c * kLd + t], gw);
      }
      const float z1p = acc + __ldg(b1 + e);
      z1s[e * kLd + t] = gelu_exact(z1p);
      d1s[e * kLd + t] = gw * gelu_grad(z1p);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < C * kTile; i += blockDim.x) {
      const int c = i / kTile, t = i - c * kTile;
      const int64_t v = v0 + t;
      if (v >= S) continue;
      float acc = 0.f;
      for (int e = 0; e < HID; ++e)
        acc = fmaf(__ldg(w1 + (int64_t)e * C + c), d1s[e * kLd + t], acc);
      dzb[c * S + v] = acc;
    }
    // this tile's weight and bias products, summed over its 32 voxels
    const bool first = ti == t0;
    for (int64_t i = threadIdx.x; i < slab; i += blockDim.x) {
      float acc = 0.f;
      if (i < (int64_t)HID * C) {              // dW1[e][c]
        const int e = (int)(i / C), c = (int)(i - (int64_t)e * C);
#pragma unroll 8
        for (int t = 0; t < kTile; ++t)
          acc = fmaf(d1s[e * kLd + t], zs[c * kLd + t], acc);
      } else if (i < 2LL * HID * C) {          // dW2[c][e]
        const int64_t k = i - (int64_t)HID * C;
        const int c = (int)(k / HID), e = (int)(k - (int64_t)c * HID);
#pragma unroll 8
        for (int t = 0; t < kTile; ++t)
          acc = fmaf(gs[c * kLd + t], z1s[e * kLd + t], acc);
      } else if (i < 2LL * HID * C + HID) {    // db1[e]
        const int e = (int)(i - 2LL * HID * C);
        for (int t = 0; t < kTile; ++t) acc += d1s[e * kLd + t];
      } else {                                 // db2[c]
        const int c = (int)(i - 2LL * HID * C - HID);
        for (int t = 0; t < kTile; ++t) acc += gs[c * kLd + t];
      }
      pc[i] = first ? acc : pc[i] + acc;
    }
  }
}

// K5b launch 3: the InstanceNorm backward, one block per (b, c) plane.
__global__ void __launch_bounds__(kStatsThreads)
jlc_stage2_bwd_planes(const float* __restrict__ x,
                      const float* __restrict__ g,
                      const float* __restrict__ dz,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      float* __restrict__ dx, int64_t S) {
  const int64_t p = blockIdx.x;
  const float* xp = x + p * S;
  const float* dp = dz + p * S;
  const float m = mean[p], r = rstd[p];
  double s1 = 0.0, s2 = 0.0;
  for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
    const float d = dp[i];
    s1 += d;
    s2 += static_cast<double>(d) * ((xp[i] - m) * r);
  }
  block_sum2(s1, s2);
  const float m1 = static_cast<float>(s1 / static_cast<double>(S));
  const float m2 = static_cast<float>(s2 / static_cast<double>(S));
  for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
    const float yh = (xp[i] - m) * r;
    dx[p * S + i] = g[p * S + i] + r * (dp[i] - m1 - yh * m2);
  }
}

// K5b launch 4: the partials summed over the chunks, in order.
__global__ void mlp_partials_reduce(const float* __restrict__ part,
                                    int chunks, int C, int HID,
                                    float* __restrict__ dw1,
                                    float* __restrict__ dw2,
                                    float* __restrict__ db1,
                                    float* __restrict__ db2) {
  const int64_t hc = (int64_t)HID * C;
  const int64_t slab = 2 * hc + HID + C;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < slab;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += part[k * slab + i];
    if (i < hc) dw1[i] = s;
    else if (i < 2 * hc) dw2[i - hc] = s;
    else if (i < 2 * hc + HID) db1[i - 2 * hc] = s;
    else db2[i - 2 * hc - HID] = s;
  }
}

// K5b. x = out1, g: (B, C, D, H, W); w1: (HID, C); b1: (HID,); w2:
// (C, HID); mean, rstd: B·C floats (scratch); dz: like x (scratch); part:
// chunks·(2·HID·C + HID + C) floats (scratch; 1 <= chunks <= the number
// of 32-voxel tiles); dx: like x; dw1: (HID, C); db1: (HID,); dw2:
// (C, HID); db2: (C,).
extern "C" int vs_jlc_stage2_bwd(const float* x, const float* w1,
                                 const float* b1, const float* w2,
                                 const float* g, float* mean, float* rstd,
                                 float* dz, float* part, float* dx,
                                 float* dw1, float* db1, float* dw2,
                                 float* db2, int B, int C, int HID, int S,
                                 int chunks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0) return cudaSuccess;
  const int tps = (S + kTile - 1) / kTile;
  const int total = B * tps;
  if (chunks < 1 || chunks > total) return cudaErrorInvalidValue;
  plane_stats_kernel<<<B * C, kStatsThreads, 0, stream>>>(x, S, 1e-5f, mean,
                                                          rstd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(2 * C + 2 * HID) * kLd * sizeof(float);
  err = allow_smem(jlc_mlp_bwd_tiles, smem);
  if (err != cudaSuccess) return err;
  const int chunk = (total + chunks - 1) / chunks;
  jlc_mlp_bwd_tiles<<<chunks, kBwdThreads, smem, stream>>>(
      x, w1, b1, w2, g, mean, rstd, dz, part, C, HID, S, tps, total, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  jlc_stage2_bwd_planes<<<B * C, kStatsThreads, 0, stream>>>(
      x, g, dz, mean, rstd, dx, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t slab = 2LL * HID * C + HID + C;
  mlp_partials_reduce<<<(unsigned)((slab + 255) / 256), 256, 0, stream>>>(
      part, chunks, C, HID, dw1, dw2, db1, db2);
  return cudaGetLastError();
}
