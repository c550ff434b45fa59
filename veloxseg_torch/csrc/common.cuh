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
constexpr int kStatsThreads = 256;

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
