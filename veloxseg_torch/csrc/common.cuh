// Shared helpers of the port's CUDA kernels (plain C interface, fp32).
//
// Each kernel library is its own translation unit and includes this header
// once, so the definitions below are private to that library.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" const char* vs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Largest dynamic shared memory one block may ask for on Hopper
// (227 KB of the SM's 256 KB).
constexpr int kMaxSmemBytes = 232448;
constexpr int kDefaultSmemBytes = 48 * 1024;

// Exact (erf) GELU, grouped as veloxseg_tpu/ops/fused_jlc.py:_gelu_exact.
__device__ __forceinline__ float gelu_exact(float x) {
  return x * (0.5f * (1.0f + erff(x * 0.70710678118654752f)));
}

// d/dx GELU(x) = Phi(x) + x * phi(x) (veloxseg_tpu/ops/fused_jlc.py:80-84).
__device__ __forceinline__ float gelu_grad(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
  return cdf + x * pdf;
}

// The counter-based dropout hash (lowbias32 avalanche) of
// veloxseg_tpu/ops/pwa_attention.py:_keep_mask, bit for bit: uint32
// arithmetic wraps as jnp.uint32 does. An element is kept where the
// hash is >= the wrapper's threshold min(2^32 - 1, int(p * 2^32)).
__device__ __forceinline__ uint32_t keep_hash(uint32_t gid, uint32_t seed) {
  uint32_t x = gid * 0x9E3779B9u + seed * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Sum two doubles over a block of kStatsThreads threads in a fixed order
// (warp shuffles, then a fixed tree over the warps); every thread gets
// the totals. Deterministic: no atomics.
constexpr int kStatsThreads = 256;

__device__ __forceinline__ void block_sum2(double& s1, double& s2) {
  __shared__ double r1[kStatsThreads / 32], r2[kStatsThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  __syncthreads();  // r1/r2 may still be read from an earlier call
  if (lane == 0) {
    r1[warp] = s1;
    r2[warp] = s2;
  }
  __syncthreads();
  const int nw = blockDim.x / 32;
  s1 = lane < nw ? r1[lane] : 0.0;
  s2 = lane < nw ? r2[lane] : 0.0;
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  s1 = __shfl_sync(0xffffffffu, s1, 0);
  s2 = __shfl_sync(0xffffffffu, s2, 0);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (bytes <= static_cast<size_t>(kDefaultSmemBytes)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Per-plane InstanceNorm statistics: one block reduces one contiguous plane
// of S floats into its mean and rsqrt(max(var, 0) + eps). Sums run in
// double, in a fixed order (strided per thread, then a fixed tree), so a
// run repeats bit for bit and E[x^2] - E[x]^2 loses nothing to fp32
// cancellation. Launch with kStatsThreads threads and one block per plane.
__global__ void __launch_bounds__(kStatsThreads)
plane_stats_kernel(const float* __restrict__ x, int64_t S, float eps,
                   float* __restrict__ mean, float* __restrict__ rstd) {
  const float* p = x + static_cast<int64_t>(blockIdx.x) * S;
  double s1 = 0.0, s2 = 0.0;
  for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
    const double v = p[i];
    s1 += v;
    s2 += v * v;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, off);
    s2 += __shfl_down_sync(0xffffffffu, s2, off);
  }
  __shared__ double r1[kStatsThreads / 32], r2[kStatsThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    r1[warp] = s1;
    r2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    s1 = lane < nw ? r1[lane] : 0.0;
    s2 = lane < nw ? r2[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_down_sync(0xffffffffu, s1, off);
      s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const double m = s1 / static_cast<double>(S);
      double var = s2 / static_cast<double>(S) - m * m;
      if (var < 0.0) var = 0.0;
      mean[blockIdx.x] = static_cast<float>(m);
      rstd[blockIdx.x] = static_cast<float>(1.0 / sqrt(var + eps));
    }
  }
}
