// Shared helpers of the port's CUDA kernels (plain C interface, fp32, and
// bf16 elements for the sources built with -DVS_BF16).
//
// Each kernel library is its own translation unit and includes this header
// once, so the definitions below are private to that library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// The element type of a library's entry points: the tokens, activations,
// weights and their gradients. float, or bf16 where the source is built
// with -DVS_BF16 (veloxseg_torch/ops/_cuda.py:BF16_SOURCES). The kernels
// take it as a template parameter T; every product, sum, statistic and
// scratch buffer stays fp32, and a bf16 form rounds only where the Pallas
// kernel it replaces rounds.
#ifdef VS_BF16
using Elem = __nv_bfloat16;
#else
using Elem = float;
#endif

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x) {
  if constexpr (kIsF32<T>) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// x rounded to T (to nearest even) and back: the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

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

// GELU in the element type T of the stream, as _gelu_exact applies it to
// its input's dtype (veloxseg_tpu/ops/fused_jlc.py:73-77): for bf16 the
// value n is rounded, Phi(n) is computed in fp32 and rounded, and so is
// their product; for float gelu_exact.
template <typename T>
__device__ __forceinline__ float gelu_in(float n) {
  if constexpr (kIsF32<T>) {
    return gelu_exact(n);
  } else {
    const float nb = round_to<T>(n);
    const float phi =
        round_to<T>(0.5f * (1.0f + erff(nb * 0.70710678118654752f)));
    return round_to<T>(nb * phi);
  }
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
// The hash is split so that a kernel walking a row's columns can add
// kHashGid per column to gid·kHashGid + seed·kHashSeed (uint32 arithmetic
// distributes) and run only the avalanche per element.
constexpr uint32_t kHashGid = 0x9E3779B9u, kHashSeed = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t hash_avalanche(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t keep_hash(uint32_t gid, uint32_t seed) {
  return hash_avalanche(gid * kHashGid + seed * kHashSeed);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Copies from global to shared memory that do not hold up the thread
// (cp.async, 4 or 16 bytes), zero-filled where `valid` is false; complete
// after cp_async_wait_all. Staging loops issue all their copies before
// waiting once, instead of one load's latency per element.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src,
                                               bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Staging of T elements from global memory into fp32 shared memory,
// zero where `valid` is false. float: the cp.async copies above (complete
// after cp_async_wait_all); bf16: loaded and converted at once (cp.async
// copies bytes and cannot widen). stage4: four consecutive elements, dst
// 16-byte aligned and src aligned to 4 elements.
template <typename T>
__device__ __forceinline__ void stage1(float* dst, const T* src, bool valid) {
  if constexpr (kIsF32<T>) {
    cp_async_f32(dst, src, valid);
  } else {
    *dst = valid ? to_f32(*src) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void stage4(float* dst, const T* src, bool valid) {
  if constexpr (kIsF32<T>) {
    cp_async_f32x4(dst, src, valid);
  } else {
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {  // one 8-byte load of 4 bf16
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      f = make_float4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<float4*>(dst) = f;
  }
}

// A 16-byte load or store of shared memory (16-byte aligned).
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void sts4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
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
// cancellation. Where S is a multiple of 4 each thread keeps four float4
// loads in flight (a plane of 32³ floats is 128 KB). Launch with
// kStatsThreads threads and one block per plane.
__device__ __forceinline__ void add_stats(double& s1, double& s2, float4 v) {
  const double a = v.x, b = v.y, c = v.z, d = v.w;
  s1 = s1 + a + b + c + d;
  s2 = s2 + a * a + b * b + c * c + d * d;
}

__global__ void __launch_bounds__(kStatsThreads)
plane_stats_kernel(const float* __restrict__ x, int64_t S, float eps,
                   float* __restrict__ mean, float* __restrict__ rstd) {
  const float* p = x + static_cast<int64_t>(blockIdx.x) * S;
  double s1 = 0.0, s2 = 0.0;
  if ((S & 3) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const int64_t n4 = S / 4, bd = blockDim.x;
    int64_t i = threadIdx.x;
    for (; i + 3 * bd < n4; i += 4 * bd) {
      const float4 a = p4[i], b = p4[i + bd], c = p4[i + 2 * bd],
                   d = p4[i + 3 * bd];
      add_stats(s1, s2, a);
      add_stats(s1, s2, b);
      add_stats(s1, s2, c);
      add_stats(s1, s2, d);
    }
    for (; i < n4; i += bd) add_stats(s1, s2, p4[i]);
  } else {
    for (int64_t i = threadIdx.x; i < S; i += blockDim.x) {
      const double v = p[i];
      s1 += v;
      s2 += v * v;
    }
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
