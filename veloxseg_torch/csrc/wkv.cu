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
// What bounds it on this card: neither bytes (12·B·T·C) nor operations
// (~24 a step) at U-RWKV's shapes ((B, T, C) = (4, 216, 128): 512 chains
// of 216 steps, 1.3 MB), but the chain of dependent steps and the loads
// on it. One thread a chain spreads 512 threads over 16 SMs and waits one
// memory round trip a step. Here:
//   - A block owns (batch, G channels) and first copies its whole k and v
//     tile, [T][G] each, into shared memory by 16-byte cp.async (4-byte
//     where C % 4 != 0), so no load of global memory lies on a chain.
//   - Each chain is cut into P chunks of n = ⌈T/P⌉ steps, one thread a
//     (chunk, channel). The state A = a·e^p, B = b·e^p is linear in the
//     steps: n steps from S_in give e^(n·w)·S_in plus what the same steps
//     give from the zero state. Pass 1: each thread runs its chunk from
//     (0, 0, −1e38) and leaves (p_j, a_j, b_j) in shared memory. Then
//     thread j folds chunks 0 .. j − 1 in order into its incoming state:
//       p = max(p_in + n·w, p_i),
//       a = e^(p_in + n·w − p)·a_in + e^(p_i − p)·a_i,  b likewise.
//     Pass 2 re-runs its chunk from that state and writes y. The chain
//     falls from T steps to 2n + P − 1.
//   - The geometry (G, P) comes from the host (ops/wkv.py:wkv_launch).
// A ragged last channel group reads zeros and writes nothing past C;
// chunks past T (T not a multiple of P, or T < P) are empty.
#include "common.cuh"

constexpr float kNeg = -1e38f;

__global__ void __launch_bounds__(1024)
wkv_kernel(const float* __restrict__ w, const float* __restrict__ u,
           const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ y, int T, int C, int G, int P, int n) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                 // [T][G]
  float* vs = ks + T * G;         // [T][G]
  float* st = vs + T * G;         // [3][P][G]: each chunk's p, a, b
  const int c0 = blockIdx.x * G, valid = min(G, C - c0);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * T * C + c0;
  if ((C & 3) == 0) {  // rows of G channels as 16-byte copies
    const int per_row = G / 4;
    for (int e = threadIdx.x; e < T * per_row; e += blockDim.x) {
      const int t = e / per_row, c = (e - t * per_row) * 4;
      const bool ok = c < valid;
      const int64_t src = base + static_cast<int64_t>(t) * C + (ok ? c : 0);
      cp_async_f32x4(ks + t * G + c, k + src, ok);
      cp_async_f32x4(vs + t * G + c, v + src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < T * G; e += blockDim.x) {
      const int t = e / G, c = e - t * G;
      const bool ok = c < valid;
      const int64_t src = base + static_cast<int64_t>(t) * C + (ok ? c : 0);
      cp_async_f32(ks + e, k + src, ok);
      cp_async_f32(vs + e, v + src, ok);
    }
  }
  const int c = threadIdx.x % G, j = threadIdx.x / G;
  const bool live = c < valid;
  const float wc = live ? w[c0 + c] : 0.f, uc = live ? u[c0 + c] : 0.f;
  const int t0 = j * n, t1 = min(T, t0 + n);
  cp_async_wait_all();
  __syncthreads();

  // pass 1: this chunk from the zero state
  float aa = 0.f, bb = 0.f, pp = kNeg;
  for (int t = t0; t < t1; ++t) {
    const float kt = ks[t * G + c], vt = vs[t * G + c];
    const float ww = pp + wc;
    const float q = fmaxf(ww, kt);
    const float e1 = expf(ww - q), e2 = expf(kt - q);
    aa = e1 * aa + e2 * vt;
    bb = e1 * bb + e2;
    pp = q;
  }
  st[j * G + c] = pp;
  st[(P + j) * G + c] = aa;
  st[(2 * P + j) * G + c] = bb;
  __syncthreads();
  if (t0 >= T) return;

  // the incoming state: chunks 0 .. j − 1 (each n steps) folded in order
  const float decay = static_cast<float>(n) * wc;
  aa = 0.f;
  bb = 0.f;
  pp = kNeg;
  for (int i = 0; i < j; ++i) {
    const float pi = st[i * G + c];
    const float pd = pp + decay;
    const float m = fmaxf(pd, pi);
    const float f1 = expf(pd - m), f2 = expf(pi - m);
    aa = f1 * aa + f2 * st[(P + i) * G + c];
    bb = f1 * bb + f2 * st[(2 * P + i) * G + c];
    pp = m;
  }

  // pass 2: the chunk from its true incoming state, writing y
  for (int t = t0; t < t1; ++t) {
    const float kt = ks[t * G + c], vt = vs[t * G + c];
    const float ww = uc + kt;
    const float q = fmaxf(pp, ww);
    const float e1 = expf(pp - q), e2 = expf(ww - q);
    if (live)
      y[base + static_cast<int64_t>(t) * C + c] =
          (e1 * aa + e2 * vt) / (e1 * bb + e2);
    const float ww2 = pp + wc;
    const float q2 = fmaxf(ww2, kt);
    const float e1b = expf(ww2 - q2), e2b = expf(kt - q2);
    aa = e1b * aa + e2b * vt;
    bb = e1b * bb + e2b;
    pp = q2;
  }
}

// w, u: (C,); k, v, y: (B, T, C), all contiguous fp32 on the device.
// Geometry (ops/wkv.py:wkv_launch): blocks of G channels (a multiple of 4)
// × P chunks of ⌈T/P⌉ steps.
extern "C" int vs_wkv(const float* w, const float* u, const float* k,
                      const float* v, float* y, int B, int T, int C, int G,
                      int P, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || T <= 0 || C <= 0 || G < 4 || G % 4 != 0 || P < 1 ||
      G * P > 1024)
    return cudaErrorInvalidValue;
  const size_t smem =
      (2 * static_cast<size_t>(T) * G + 3 * static_cast<size_t>(P) * G) *
      sizeof(float);
  cudaError_t err = allow_smem(wkv_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((C + G - 1) / G),
                  static_cast<unsigned>(B));
  wkv_kernel<<<grid, G * P, smem, stream>>>(w, u, k, v, y, T, C, G, P,
                                            (T + P - 1) / P);
  return cudaGetLastError();
}
