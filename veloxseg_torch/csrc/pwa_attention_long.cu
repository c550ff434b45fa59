// K3b: the backward of the train paired-window attention (K2b's function)
// for long windows, with on-chip memory bounded whatever L is; fp32.
//
// Replaces: veloxseg_tpu/ops/pwa_attention.py:_train_bwd_rb_kernel
// (451-530), called through _train_bwd_pallas (635-649) when a window's
// full backward does not fit VMEM (L = 1024 at bench.py's 128³
// configuration). Its forward, K3f, is the train forward of every window
// length (pwa_attention_train.cu). Per window, with P = softmax(scale ·
// QᵀK + bias_h), the counter-hash keep mask M (common.cuh:keep_hash over
// the global id (wid·L + row)·L + col, wid over the true window count N,
// as K2 and _train_xla number them) and W = M·P/(1 − p):
//   forward   out = V·Wᵀ
//   backward  dV = dO·W,  dP = M·(dOᵀV)/(1 − p),
//             dS = P ⊙ (dP − rowsum(P ⊙ dP)),
//             dQ = scale·K·dSᵀ,  dK = scale·Q·dS,  dbias_h = Σ_(b, n) dS.
//
// What bounds it on this card: one window's scores are L² fp32 (4 MB at
// L = 1024), which fit neither registers nor shared memory, and at these
// widths (Cqk = Cv = 8) the function is a few GFLOP of fp32 work on a
// few tens of MB, so operations bound it. K2b keeps a (chunks, L, L) dbias
// slab in device memory; here nothing on chip grows with L. Three
// launches, none with atomics, so every sum (dbias too) is taken in a
// fixed order and repeats bit for bit. It takes K3f's out and lse, so
// P = exp(s − lse) needs no pass of its own and D = Σ_j P·dP = dO·out (with
// W = M·P/(1 − p)); each score, mask and dS is computed once:
//   prep     per row, lse in base 2 and D.
//   tiles    one block per (head, 128 rows, 128 columns of dbias) walks
//            the head's B·N windows in order with the dbias tile in
//            registers (8 × 4 × 2 per thread) and the bias tile in shared
//            memory; per window (tokens double-buffered by cp.async) and
//            64-column half, each thread forms 8 × 4 scores from the
//            staged q, k, dO, v (each shared-memory load feeds 4 or 8
//            FMAs), then dq (over the tile's columns) and dk, dv (over
//            its rows) are products over the dS and W tiles in shared
//            memory, written as per-tile partials.
//   reduce   dq, dk, dv: the ⌈L/128⌉ partials added in tile order.
// At the flagship (L = 1024, 288 windows) the grid is 2 × 8 × 8 = 128
// blocks and the partials are 3 × 8 × 9.4 MB, written and read once.
// Tensor cores are not used (ROADMAP: 3×TF32).
#include "common.cuh"

// Global window id of window w (over B·H·N), shifted by the batch offset.
__device__ __forceinline__ uint32_t global_wid(int64_t w, uint32_t off,
                                               int H, int N) {
  return static_cast<uint32_t>(w) +
         off * static_cast<uint32_t>(H) * static_cast<uint32_t>(N);
}

// ---------------------------------------------------------------------------
// K3b
// ---------------------------------------------------------------------------

constexpr int kBT = 128;             // dbias tile edge (rows and columns)
constexpr int kBHalf = kBT / 2;      // columns per pass over a tile
constexpr int kBThreads = 256;       // 16 × 16: 8 rows × 4 columns a pass
constexpr int kTS = kBT + 4;         // row stride of the [c][128] token tiles
constexpr int kBS = kBT + 4;         // row stride of the bias tile
constexpr int kDS = kBHalf + 4;      // row stride of the dS and W tiles
constexpr int kWinFloats = 4 * 8 * kTS + 2 * kBT;  // one window's stage

// K3b launch 1: per window and row, the forward's log-sum-exp in base 2
// and D = Σ_c dO·out (= Σ_j P·dP); stats: [window][2][L].
template <int CV>
__global__ void pwa_long_bwd_prep(const float* __restrict__ dout,
                                  const float* __restrict__ out,
                                  const float* __restrict__ lse,
                                  float* __restrict__ stats, int64_t W,
                                  int L) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= W * L) return;
  const int64_t w = i / L;
  const int l = static_cast<int>(i - w * L);
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < CV; ++c)
    d = fmaf(dout[(w * CV + c) * L + l], out[(w * CV + c) * L + l], d);
  stats[(w * 2) * L + l] = lse[i] * kLog2e;
  stats[(w * 2 + 1) * L + l] = d;
}

// Stage window w's tokens for row tile l0 (q, dO, statistics) and column
// tile m0 (k, v) into one stage buffer: [q | dO | k | v] as [c][kTS], then
// lse2 and D; past L everything reads 0.
__device__ __forceinline__ void stage_window(
    float* buf, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ stats, int64_t w, int L, int l0, int m0) {
  for (int i = threadIdx.x; i < 4 * 8 * kBT + 2 * kBT; i += kBThreads) {
    if (i < 4 * 8 * kBT) {
      const int arr = i >> 10, c = (i >> 7) & 7, j = i & (kBT - 1);
      const float* src = arr == 0 ? q : arr == 1 ? dout : arr == 2 ? k : v;
      const int t = (arr < 2 ? l0 : m0) + j;
      const bool ok = t < L;
      cp_async_f32(buf + (arr * 8 + c) * kTS + j,
                   src + (w * 8 + c) * L + (ok ? t : 0), ok);
    } else {
      const int k2 = i - 4 * 8 * kBT, which = k2 >> 7, j = k2 & (kBT - 1);
      const bool ok = l0 + j < L;
      cp_async_f32(buf + 4 * 8 * kTS + which * kBT + j,
                   stats + (w * 2 + which) * L + (ok ? l0 + j : 0), ok);
    }
  }
}

// K3b launch 2. Block (column tile J, row tile I, head h) walks the head's
// (b, n) windows in order. Per window and half of its 64 columns, thread
// (ty, tx) forms the 8 × 4 scores of rows ty·8 + i, columns tx·4 + j:
// s = q·k and dO·v from the staged tokens, P = 2^(s·scale·log2e +
// bias·log2e − lse2), the keep mask, dS = P·(dP − D) and W = M·P/(1 − p);
// it adds dS to its dbias elements (registers, across all windows) and
// writes dS and W to shared memory. Then dq (per row, this column tile's
// part), dk and dv (per column, this row tile's part) are products over the
// shared tiles; the partials go to part = [dq | dk | dv], each
// [tile][window][8][L]. The next window's tokens arrive by cp.async while
// this one is computed.
template <int CQK, int CV, bool DROP>
__global__ void __launch_bounds__(kBThreads, 1)
pwa_long_bwd_tiles(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias,
                   const int* __restrict__ seed,
                   const float* __restrict__ dout,
                   const float* __restrict__ stats,
                   float* __restrict__ part, float* __restrict__ dbias,
                   int B, int H, int N, int L, float scale, uint32_t thresh,
                   float inv_keep) {
  static_assert(CQK == 8 && CV == 8, "K3b's tiles are built for 8 + 8");
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                       // [kBT][kBS] bias·log2e
  float* stage = bs + kBT * kBS;          // 2 × kWinFloats
  float* dss = stage + 2 * kWinFloats;    // [kBT][kDS] dS of a half
  float* ws = dss + kBT * kDS;            // [kBT][kDS] W of a half
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.z;
  const int l0 = blockIdx.y * kBT, m0 = blockIdx.x * kBT;
  const int nT = gridDim.x;
  const int64_t W = static_cast<int64_t>(B) * H * N;
  const float* bh = bias + static_cast<int64_t>(h) * L * L;
  for (int i = tid; i < kBT * kBT; i += kBThreads) {
    const int r = i >> 7, m = i & (kBT - 1);
    const bool ok = l0 + r < L && m0 + m < L;
    bs[r * kBS + m] =
        ok ? bh[static_cast<int64_t>(l0 + r) * L + m0 + m] * kLog2e
           : -INFINITY;
  }
  const float sc2 = scale * kLog2e;
  const uint32_t uL = static_cast<uint32_t>(L);
  const uint32_t sd = DROP ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t off = DROP ? static_cast<uint32_t>(seed[1]) : 0u;
  float acc[2][8][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hf][i][j] = 0.f;
  float* dqp = part;
  float* dkp = part + static_cast<int64_t>(nT) * W * 8 * L;
  float* dvp = dkp + static_cast<int64_t>(nT) * W * 8 * L;
  const int pr = tid >> 1, cq = (tid & 1) * 4;  // dq row; dk, dv column

  const int nwin = B * N;
  stage_window(stage, q, k, v, dout, stats, static_cast<int64_t>(h) * N, L,
               l0, m0);
  for (int it = 0; it < nwin; ++it) {
    const int b = it / N, n = it - b * N;
    const int64_t w = (static_cast<int64_t>(b) * H + h) * N + n;
    float* cur = stage + (it & 1) * kWinFloats;
    cp_async_wait_all();
    __syncthreads();  // this window is staged; the last one is done with
                      // the other buffer and with dss, ws
    if (it + 1 < nwin) {
      const int b2 = (it + 1) / N, n2 = it + 1 - b2 * N;
      stage_window(stage + ((it + 1) & 1) * kWinFloats, q, k, v, dout, stats,
                   (static_cast<int64_t>(b2) * H + h) * N + n2, L, l0, m0);
    }
    const float* qT = cur;
    const float* dT = cur + 8 * kTS;
    const float* kT = cur + 16 * kTS;
    const float* vT = cur + 24 * kTS;
    const float* ls = cur + 32 * kTS;
    const float* Ds = ls + kBT;
    const uint32_t wbase = global_wid(w, off, H, N) * uL;
    float dqa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int mc = hf * kBHalf + tx * 4;  // first column in the tile
      float s[8][4], dp[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 qa = lds4(qT + c * kTS + ty * 8);
        const float4 qb = lds4(qT + c * kTS + ty * 8 + 4);
        const float4 da = lds4(dT + c * kTS + ty * 8);
        const float4 db = lds4(dT + c * kTS + ty * 8 + 4);
        const float4 kk = lds4(kT + c * kTS + mc);
        const float4 vv = lds4(vT + c * kTS + mc);
        const float qr[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float dr[8] = {da.x, da.y, da.z, da.w, db.x, db.y, db.z, db.w};
        const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
            dp[i][j] = fmaf(dr[i], vc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty * 8 + i;
        const float4 bb = lds4(bs + r * kBS + mc);
        const float bj[4] = {bb.x, bb.y, bb.z, bb.w};
        const float l2 = ls[r], dd = Ds[r];
        const uint32_t rowbase =
            (wbase + static_cast<uint32_t>(l0 + r)) * uL +
            static_cast<uint32_t>(m0 + mc);
        float dsv[4], wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(fmaf(s[i][j], sc2, bj[j]) - l2);
          float dpk = dp[i][j], wgt = p;
          if (DROP) {
            const bool keep =
                keep_hash(rowbase + static_cast<uint32_t>(j), sd) >= thresh;
            dpk = keep ? dpk * inv_keep : 0.f;
            wgt = keep ? p * inv_keep : 0.f;
          }
          dsv[j] = p * (dpk - dd);
          wv[j] = wgt;
          acc[hf][i][j] += dsv[j];
        }
        *reinterpret_cast<float4*>(dss + r * kDS + tx * 4) =
            make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
        *reinterpret_cast<float4*>(ws + r * kDS + tx * 4) =
            make_float4(wv[0], wv[1], wv[2], wv[3]);
      }
      __syncthreads();
      // dq of row pr over this half's columns (scaled in the reduce)
      for (int m = 0; m < kBHalf; m += 4) {
        const float4 d = lds4(dss + pr * kDS + m);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float4 kv = lds4(kT + (cq + cc) * kTS + hf * kBHalf + m);
          dqa[cc] = fmaf(d.x, kv.x, dqa[cc]);
          dqa[cc] = fmaf(d.y, kv.y, dqa[cc]);
          dqa[cc] = fmaf(d.z, kv.z, dqa[cc]);
          dqa[cc] = fmaf(d.w, kv.w, dqa[cc]);
        }
      }
      // dk (threads 0-127) and dv (128-255) of column pr % 64 over the
      // row tile
      {
        const bool is_v = tid >= kBT;
        const int m = pr & (kBHalf - 1);
        const float* A = is_v ? ws : dss;
        const float* T = is_v ? dT : qT;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int r = 0; r < kBT; r += 4) {
          const float s0 = A[r * kDS + m], s1 = A[(r + 1) * kDS + m];
          const float s2 = A[(r + 2) * kDS + m], s3 = A[(r + 3) * kDS + m];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 t = lds4(T + (cq + cc) * kTS + r);
            a[cc] = fmaf(s0, t.x, a[cc]);
            a[cc] = fmaf(s1, t.y, a[cc]);
            a[cc] = fmaf(s2, t.z, a[cc]);
            a[cc] = fmaf(s3, t.w, a[cc]);
          }
        }
        const int col = m0 + hf * kBHalf + m;
        if (col < L) {
          float* dst = (is_v ? dvp : dkp) +
                       ((static_cast<int64_t>(blockIdx.y) * W + w) * 8 + cq) *
                           L + col;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) dst[cc * L] = a[cc];
        }
      }
      if (hf == 0) __syncthreads();  // dss, ws are rewritten by half 1
    }
    if (l0 + pr < L) {
      float* dst = dqp + ((static_cast<int64_t>(blockIdx.x) * W + w) * 8 +
                          cq) * L + l0 + pr;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) dst[cc * L] = dqa[cc];
    }
  }
  float* dbh = dbias + static_cast<int64_t>(h) * L * L;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = l0 + ty * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + hf * kBHalf + tx * 4 + j;
        if (r < L && m < L) dbh[static_cast<int64_t>(r) * L + m] = acc[hf][i][j];
      }
    }
}

// K3b launch 3: dq = scale·Σ_J, dk = scale·Σ_I, dv = Σ_I of the partials,
// over the tiles in order.
__global__ void pwa_long_bwd_reduce(const float* __restrict__ part,
                                    float* __restrict__ dq,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int64_t n,
                                    int nT, float scale) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < 3 * n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int which = static_cast<int>(i / n);
    const int64_t e = i - which * n;
    const float* p = part + which * nT * n + e;
    float s = 0.f;
    for (int t = 0; t < nT; ++t) s += p[t * n];
    if (which == 0) dq[e] = s * scale;
    else if (which == 1) dk[e] = s * scale;
    else dv[e] = s;
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int CQK, int CV, bool DROP>
static cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                              const float* bias, const int* seed,
                              const float* dout, const float* out,
                              const float* lse, float* dq, float* dk,
                              float* dv, float* stats, float* part,
                              float* dbias, int B, int H, int N, int L,
                              float scale, uint32_t thresh, float inv_keep,
                              cudaStream_t stream) {
  const int64_t W = static_cast<int64_t>(B) * H * N;
  pwa_long_bwd_prep<CV><<<static_cast<unsigned>((W * L + 255) / 256), 256, 0,
                          stream>>>(dout, out, lse, stats, W, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem =
      (size_t)(kBT * kBS + 2 * kWinFloats + 2 * kBT * kDS) * sizeof(float);
  err = allow_smem(pwa_long_bwd_tiles<CQK, CV, DROP>, smem);
  if (err != cudaSuccess) return err;
  const unsigned nT = (L + kBT - 1) / kBT;
  pwa_long_bwd_tiles<CQK, CV, DROP>
      <<<dim3(nT, nT, static_cast<unsigned>(H)), kBThreads, smem, stream>>>(
          q, k, v, bias, seed, dout, stats, part, dbias, B, H, N, L, scale,
          thresh, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = W * CQK * L;
  pwa_long_bwd_reduce<<<1024, 256, 0, stream>>>(part, dq, dk, dv, n, nT,
                                                scale);
  return cudaGetLastError();
}

// The widths K3 is built for: the only long window of any configuration
// is bench.py's 128³ level 1, (Cqk, Cv) = (8, 8). Any other width returns
// cudaErrorInvalidValue (ops/pwa_attention.py:LONG_KERNEL_WIDTHS).
#define VS_ALL_WIDTHS(CASE, DROP) CASE(8, 8, DROP)

#define VS_BWD_CASE(CQ, CVV, DROP)                                         \
  if (Cqk == CQ && Cv == CVV)                                              \
    return launch_bwd<CQ, CVV, DROP>(q, k, v, bias, seed, dout, out, lse, \
                                     dq, dk, dv, stats, part, dbias, B, H, \
                                     N, L, scale, thresh, inv_keep, stream);

// K3b. q, k: (B, H, N, Cqk, L); v, dout: (B, H, N, Cv, L); bias: (H, L,
// L); seed: int32 [seed, batch_offset] on the device; thresh = 0: no
// dropout; out and lse: K3f's of the same call; dq, dk, dv like q, k,
// v; stats: B·H·N·2·L floats of scratch (lse in base 2 and D per row);
// part: 3·⌈L/128⌉·B·H·N·Cqk·L floats of scratch (the dq, dk, dv tile
// partials); dbias: (H, L, L), written whole. B·H·N must be > 0.
extern "C" int vs_pwa_attention_long_train_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const int* seed, const float* dout, const float* out, const float* lse,
    float* dq, float* dk, float* dv, float* stats, float* part,
    float* dbias, int B, int H, int N, int Cqk, int Cv, int L, float scale,
    unsigned int thresh, float inv_keep, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B * H * N == 0 || L == 0) return cudaErrorInvalidValue;
  if (thresh == 0) {
    VS_ALL_WIDTHS(VS_BWD_CASE, false)
  } else {
    VS_ALL_WIDTHS(VS_BWD_CASE, true)
  }
  return cudaErrorInvalidValue;
}
