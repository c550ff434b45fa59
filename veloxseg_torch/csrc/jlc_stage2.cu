// K5f: JLC stage 2 forward, fp32, channels-first (B, C, D, H, W).
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
