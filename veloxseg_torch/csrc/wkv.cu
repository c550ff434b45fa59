// K6: the RWKV-4 WKV recurrence (forward), fp32.
//
// Replaces: veloxseg_tpu/ops/wkv.py:_wkv_kernel (77-105), called through
// wkv_pallas (108-138). Per (batch b, channel c), over t = 0 .. T − 1, with
// the state (a, b, p) starting at (0, 0, −1e38) (wkv.py:87-105):
//   ww = u + k_t;  q = max(p, ww)
//   y_t = (e^(p−q)·a + e^(ww−q)·v_t) / (e^(p−q)·b + e^(ww−q))
//   ww = p + w;  q' = max(ww, k_t)
//   a ← e^(ww−q')·a + e^(k_t−q')·v_t;  b ← e^(ww−q')·b + e^(k_t−q');  p ← q'
// The running log-max p keeps every exponent <= 0.
//
// What bounds it on this card: the recurrence is sequential in T, and each
// step is ~20 operations on three loads and a store, so neither the bytes
// (12·B·T·C) nor the operations fill the card at U-RWKV's shapes (B·C =
// 512 chains of T = 216): the chain of dependent steps (latency) does.
// One thread owns one (b, c) chain with its state in registers; the
// threads of a warp take consecutive channels, so every load of k_t, v_t
// and every store of y_t is coalesced along C; k and v are read ahead of
// the state's dependence by unrolling the loop. Small blocks (kThreads)
// spread the few chains over as many SMs as possible.
#include "common.cuh"

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
wkv_kernel(const float* __restrict__ w, const float* __restrict__ u,
           const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ y, int B, int T, int C) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(B) * C) return;
  const int64_t b = i / C;
  const int c = static_cast<int>(i - b * C);
  const float wc = w[c], uc = u[c];
  const int64_t base = b * T * C + c;
  float aa = 0.f, bb = 0.f, pp = -1e38f;
#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const int64_t at = base + static_cast<int64_t>(t) * C;
    const float kt = k[at], vt = v[at];
    const float ww = uc + kt;
    const float q = fmaxf(pp, ww);
    const float e1 = expf(pp - q), e2 = expf(ww - q);
    y[at] = (e1 * aa + e2 * vt) / (e1 * bb + e2);
    const float ww2 = pp + wc;
    const float q2 = fmaxf(ww2, kt);
    const float e1b = expf(ww2 - q2), e2b = expf(kt - q2);
    aa = e1b * aa + e2b * vt;
    bb = e1b * bb + e2b;
    pp = q2;
  }
}

// w, u: (C,); k, v, y: (B, T, C), all contiguous fp32 on the device.
extern "C" int vs_wkv(const float* w, const float* u, const float* k,
                      const float* v, float* y, int B, int T, int C,
                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t chains = static_cast<int64_t>(B) * C;
  if (chains == 0 || T == 0) return cudaSuccess;
  const unsigned blocks =
      static_cast<unsigned>((chains + kThreads - 1) / kThreads);
  wkv_kernel<<<blocks, kThreads, 0, stream>>>(w, u, k, v, y, B, T, C);
  return cudaGetLastError();
}
