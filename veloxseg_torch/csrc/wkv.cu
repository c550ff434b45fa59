// K6: the RWKV-4 WKV recurrence (forward), and K6b, its backward; fp32.
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

// Issue the cp.async copies of one [T][G] tile (G channels from c0, rows C
// apart, from ``base``) into shared memory, by the whole block: 16-byte
// copies where C % 4 == 0, else 4-byte; channels at or past ``valid``
// read zeros.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t base, int T, int C, int G,
                                          int valid) {
  if ((C & 3) == 0) {  // rows of G channels as 16-byte copies
    const int per_row = G / 4;
    for (int e = threadIdx.x; e < T * per_row; e += blockDim.x) {
      const int t = e / per_row, c = (e - t * per_row) * 4;
      const bool ok = c < valid;
      cp_async_f32x4(dst + t * G + c,
                     src + base + static_cast<int64_t>(t) * C + (ok ? c : 0),
                     ok);
    }
  } else {
    for (int e = threadIdx.x; e < T * G; e += blockDim.x) {
      const int t = e / G, c = e - t * G;
      const bool ok = c < valid;
      cp_async_f32(dst + e,
                   src + base + static_cast<int64_t>(t) * C + (ok ? c : 0),
                   ok);
    }
  }
}

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
  copy_tile(ks, k, base, T, C, G, valid);
  copy_tile(vs, v, base, T, C, G, valid);
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

// K6b: the WKV backward, fp32: (gw, gu, gk, gv) from (w, u, k, v, gy).
//
// Replaces: veloxseg_tpu/ops/wkv.py:_wkv_bwd (161-167), jax.vjp(wkv_scan),
// which XLA runs as the scan transposed. The RWKV-4 backward on the
// stabilised state: with A_t = a_t·e^(p_t), B_t = b_t·e^(p_t) the state
// before step t and D_t = B_t + e^(u+k_t) (= e^(q_t)·d_t, d_t the forward's
// denominator), the adjoints α_t = ∂L/∂A_t, β_t = ∂L/∂B_t are carried
// scaled by e^(p_t): α̃_t = α_t·e^(p_t), β̃_t likewise, so that every
// exponent below is <= 0, as the forward's are. With e1, e2 the forward's
// e^(p_t−q_t), e^(u+k_t−q_t), f1, f2 its e^(p_t+w−p_(t+1)),
// e^(k_t−p_(t+1)), and r = gy_t/d_t, from t = T − 1 down to 0:
//   gv_t = r·e2 + f2·α̃_(t+1)
//   gk_t = r·e2·(v_t − y_t) + f2·(v_t·α̃_(t+1) + β̃_(t+1))
//   gu  += r·e2·(v_t − y_t);   gw += f1·(α̃_(t+1)·a_t + β̃_(t+1)·b_t)
//   α̃_t = r·e1 + f1·α̃_(t+1);   β̃_t = −r·y_t·e1 + f1·β̃_(t+1)
// (α̃_T = β̃_T = 0). The design, simple first:
//   - A block owns (batch, G channels), as K6's, and copies its k, v and
//     gy tiles into shared memory by cp.async; one thread a chain.
//   - A forward sweep rebuilds the state (a_t, b_t, p_t) before each step
//     into shared memory ([T][G] each, per thread its own column), then
//     the reverse sweep above recomputes y_t from it and writes gk, gv.
//   - gw and gu sum over the batch: each chain writes its (b, c) partial,
//     and a second kernel sums them over b in order, so that every output
//     repeats bit for bit (no atomics).
// 64 threads a block copy the tiles; the first G (4 or 8, vs_wkv_bwd
// refuses any other) run the chains.
constexpr int kBwdThreads = 64;

__global__ void __launch_bounds__(kBwdThreads)
wkv_bwd_kernel(const float* __restrict__ w, const float* __restrict__ u,
               const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ gy, float* __restrict__ gk,
               float* __restrict__ gv, float* __restrict__ part, int B, int T,
               int C, int G) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                 // [T][G] each
  float* vs = ks + T * G;
  float* gs = vs + T * G;
  float* as = gs + T * G;         // the state before each step
  float* bs = as + T * G;
  float* ps = bs + T * G;
  const int c0 = blockIdx.x * G, valid = min(G, C - c0);
  const int64_t base = static_cast<int64_t>(blockIdx.y) * T * C + c0;
  copy_tile(ks, k, base, T, C, G, valid);
  copy_tile(vs, v, base, T, C, G, valid);
  copy_tile(gs, gy, base, T, C, G, valid);
  cp_async_wait_all();
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= G) return;
  const bool live = c < valid;
  const float wc = live ? w[c0 + c] : 0.f, uc = live ? u[c0 + c] : 0.f;

  // forward sweep: the state before each step
  float aa = 0.f, bb = 0.f, pp = kNeg;
  for (int t = 0; t < T; ++t) {
    as[t * G + c] = aa;
    bs[t * G + c] = bb;
    ps[t * G + c] = pp;
    const float kt = ks[t * G + c], vt = vs[t * G + c];
    const float ww = pp + wc;
    const float q = fmaxf(ww, kt);
    const float e1 = expf(ww - q), e2 = expf(kt - q);
    aa = e1 * aa + e2 * vt;
    bb = e1 * bb + e2;
    pp = q;
  }

  // reverse sweep: the scaled adjoints of (A, B), p_(t+1) in pn
  float ga = 0.f, gb = 0.f, gwc = 0.f, guc = 0.f, pn = pp;
  for (int t = T - 1; t >= 0; --t) {
    const float kt = ks[t * G + c], vt = vs[t * G + c], g = gs[t * G + c];
    const float at = as[t * G + c], bt = bs[t * G + c], pt = ps[t * G + c];
    const float ww = uc + kt;
    const float q = fmaxf(pt, ww);
    const float e1 = expf(pt - q), e2 = expf(ww - q);
    const float d = e1 * bt + e2;
    const float r = g / d, y = (e1 * at + e2 * vt) / d;
    const float f1 = expf(pt + wc - pn), f2 = expf(kt - pn);
    const float gdir = r * e2 * (vt - y);
    if (live) {
      const int64_t o = base + static_cast<int64_t>(t) * C + c;
      gv[o] = r * e2 + f2 * ga;
      gk[o] = gdir + f2 * (vt * ga + gb);
    }
    guc += gdir;
    gwc += f1 * (ga * at + gb * bt);
    ga = r * e1 + f1 * ga;
    gb = f1 * gb - r * y * e1;
    pn = pt;
  }
  if (live) {
    const int64_t o = static_cast<int64_t>(blockIdx.y) * C + c0 + c;
    part[o] = gwc;                                   // [2][B][C]
    part[static_cast<int64_t>(B) * C + o] = guc;
  }
}

// gw, gu = the partials summed over b in order: part [2][B][C] → gwu [2][C].
__global__ void wkv_bwd_sum_kernel(const float* __restrict__ part,
                                   float* __restrict__ gwu, int B, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * C) return;
  const int which = i / C, c = i - which * C;
  const float* p = part + static_cast<int64_t>(which) * B * C + c;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += p[static_cast<int64_t>(b) * C];
  gwu[i] = s;
}

// w, u: (C,); k, v, gy, gk, gv: (B, T, C); part: (2, B, C) scratch; gwu:
// (2, C), gw then gu; all contiguous fp32 on the device. Blocks of G = 8
// or 4 channels (ops/wkv.py:wkv_bwd_channels).
extern "C" int vs_wkv_bwd(const float* w, const float* u, const float* k,
                          const float* v, const float* gy, float* gk,
                          float* gv, float* part, float* gwu, int B, int T,
                          int C, int G, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || T <= 0 || C <= 0 || (G != 4 && G != 8))
    return cudaErrorInvalidValue;
  const size_t smem = 6 * static_cast<size_t>(T) * G * sizeof(float);
  cudaError_t err = allow_smem(wkv_bwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((C + G - 1) / G),
                  static_cast<unsigned>(B));
  wkv_bwd_kernel<<<grid, kBwdThreads, smem, stream>>>(w, u, k, v, gy, gk, gv,
                                                      part, B, T, C, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_sum_kernel<<<(2 * C + 127) / 128, 128, 0, stream>>>(part, gwu, B,
                                                              C);
  return cudaGetLastError();
}
