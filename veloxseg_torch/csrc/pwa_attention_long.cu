// K3f and K3b: the train paired-window attention (K2f/K2b's function) for
// long windows, with on-chip memory bounded whatever L is; fp32.
//
// Replaces: veloxseg_tpu/ops/pwa_attention.py:_train_fwd_rb_kernel
// (410-448) and _train_bwd_rb_kernel (451-530), called through
// _train_fwd_pallas (594-602) and _train_bwd_pallas (635-649) when a
// window's full backward does not fit VMEM (L = 1024 at bench.py's 128³
// configuration). Per window, with P = softmax(scale · QᵀK + bias_h), the
// counter-hash keep mask M (common.cuh:keep_hash over the global id
// (wid·L + row)·L + col, wid over the true window count N, as K2 and
// _train_xla number them) and W = M·P/(1 − p):
//   forward   out = V·Wᵀ
//   backward  dV = dO·W,  dP = M·(dOᵀV)/(1 − p),
//             dS = P ⊙ (dP − rowsum(P ⊙ dP)),
//             dQ = scale·K·dSᵀ,  dK = scale·Q·dS,  dbias_h = Σ_(b, n) dS.
//
// What bounds it on this card: one window's scores are L² fp32 (4 MB at
// L = 1024), which fit neither registers nor shared memory, and at these
// widths (Cqk = Cv = 8) the function is a few GFLOP of fp32 work on a
// few tens of MB, so operations bound it. K2 stages a whole window's
// tokens in shared memory and its backward keeps a (chunks, L, L) dbias
// slab in device memory; here nothing on chip grows with L:
//   K3f      one block per (window, block of kRows query rows), one thread
//            per row with its q in registers; K, V and the block's bias
//            rows stream through shared memory in tiles of kTile columns;
//            the softmax is exact and online (running max and sum, the
//            kept-weight accumulator rescaled when the max grows).
//   K3b, three launches, none with atomics, so every sum (dbias too) is
//   taken in a fixed order and repeats bit for bit:
//     rows     as K3f's grid: a first online pass gives each row's max,
//              1/sum and D = Σ P·dP (saved, 3·L floats per window); a
//              second pass accumulates dq in registers.
//     columns  one block per (window, block of kRows key columns), one
//              thread per column with its k and v in registers; Q, dO
//              and the row statistics stream through shared memory in
//              tiles of kTile rows; dk and dv accumulate in registers.
//     dbias    one block per (head, kBiasTile × kBiasTile tile of dbias),
//              each thread owning kBiasTile/4 elements of one column in
//              registers; it walks the (b, n) windows of its head in
//              order, recomputing each element's dS from the saved row
//              statistics (the rows' q and dO staged in shared memory).
// The scores are recomputed four times in the backward (rows twice,
// columns, dbias) and once in the forward. Tensor cores are not used.
#include "common.cuh"

constexpr int kRows = 128;      // rows (K3f, rows) or columns per block
constexpr int kTile = 32;       // streamed columns (rows) per tile
constexpr int kBiasTile = 64;   // dbias tile edge
constexpr int kBiasThreads = 256;

// Stage a (C, tile) slice of one window's (C, L) tokens as [tile][C]
// (rows read as broadcasts); columns past L read 0.
template <int C>
__device__ __forceinline__ void stage_tokens(float* dst,
                                             const float* __restrict__ src,
                                             int L, int m0) {
  for (int i = threadIdx.x; i < C * kTile; i += blockDim.x) {
    const int c = i / kTile, j = i - c * kTile;
    const int m = m0 + j;
    dst[j * C + c] = m < L ? src[static_cast<int64_t>(c) * L + m] : 0.f;
  }
}

// Stage bias rows [l0, l0 + kRows) × columns [m0, m0 + kTile) of one head,
// row-major with a padded stride (kTile + 1) so that the threads of a warp,
// one row each, read different banks.
__device__ __forceinline__ void stage_bias(float* dst,
                                           const float* __restrict__ bh,
                                           int L, int l0, int m0) {
  for (int i = threadIdx.x; i < kRows * kTile; i += blockDim.x) {
    const int r = i / kTile, j = i - r * kTile;
    const int l = l0 + r, m = m0 + j;
    dst[r * (kTile + 1) + j] =
        (l < L && m < L) ? bh[static_cast<int64_t>(l) * L + m] : 0.f;
  }
}

// Global window id of window w (over B·H·N), shifted by the batch offset.
__device__ __forceinline__ uint32_t global_wid(int64_t w, uint32_t off,
                                               int H, int N) {
  return static_cast<uint32_t>(w) +
         off * static_cast<uint32_t>(H) * static_cast<uint32_t>(N);
}

// One tile of a row's logits s[j] = scale·q·k_j + bias (−inf past L).
template <int CQK>
__device__ __forceinline__ float tile_logits(float (&s)[kTile],
                                             const float (&qr)[CQK],
                                             const float* ks,
                                             const float* brow, int cols,
                                             float scale) {
  float tmax = -INFINITY;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    float d = 0.f;
#pragma unroll
    for (int c = 0; c < CQK; ++c) d = fmaf(qr[c], ks[j * CQK + c], d);
    s[j] = j < cols ? fmaf(d, scale, brow[j]) : -INFINITY;
    tmax = fmaxf(tmax, s[j]);
  }
  return tmax;
}

// ---------------------------------------------------------------------------
// K3f
// ---------------------------------------------------------------------------

template <int CQK, int CV, bool DROP>
__global__ void __launch_bounds__(kRows)
pwa_long_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias,
                    const int* __restrict__ seed, float* __restrict__ out,
                    int H, int N, int L, float scale, uint32_t thresh,
                    float inv_keep) {
  __shared__ float ks[kTile * CQK];
  __shared__ float vs[kTile * CV];
  __shared__ float bs[kRows * (kTile + 1)];
  const int64_t w = blockIdx.x;
  const int h = static_cast<int>((w / N) % H);
  const int l0 = blockIdx.y * kRows;
  const int l = l0 + threadIdx.x;
  const bool row_ok = l < L;
  const float* qw = q + w * CQK * L;
  const float* kw = k + w * CQK * L;
  const float* vw = v + w * CV * L;
  const float* bh = bias + static_cast<int64_t>(h) * L * L;
  const uint32_t uL = static_cast<uint32_t>(L);
  uint32_t sd = 0, rowbase = 0;
  if (DROP) {
    sd = static_cast<uint32_t>(seed[0]);
    rowbase = (global_wid(w, static_cast<uint32_t>(seed[1]), H, N) * uL +
               static_cast<uint32_t>(l)) * uL;
  }
  float qr[CQK];
#pragma unroll
  for (int c = 0; c < CQK; ++c) qr[c] = row_ok ? qw[c * L + l] : 0.f;

  float mx = -INFINITY, sum = 0.f, acc[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) acc[c] = 0.f;
  for (int m0 = 0; m0 < L; m0 += kTile) {
    __syncthreads();  // the previous tile is done with shared memory
    stage_tokens<CQK>(ks, kw, L, m0);
    stage_tokens<CV>(vs, vw, L, m0);
    stage_bias(bs, bh, L, l0, m0);
    __syncthreads();
    const int cols = min(kTile, L - m0);
    float s[kTile];
    const float tmax = tile_logits<CQK>(s, qr, ks,
                                        bs + threadIdx.x * (kTile + 1), cols,
                                        scale);
    if (tmax > mx) {  // rescale what was summed under the old max
      const float f = expf(mx - tmax);
      sum *= f;
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[c] *= f;
      mx = tmax;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float e = expf(s[j] - mx);  // 0 past L
      sum += e;
      if (DROP && keep_hash(rowbase + static_cast<uint32_t>(m0 + j), sd) <
                      thresh)
        continue;
#pragma unroll
      for (int c = 0; c < CV; ++c) acc[c] = fmaf(e, vs[j * CV + c], acc[c]);
    }
  }
  if (!row_ok) return;
  const float inv = (DROP ? inv_keep : 1.f) / sum;
  float* ow = out + w * CV * L;
#pragma unroll
  for (int c = 0; c < CV; ++c) ow[c * L + l] = acc[c] * inv;
}

// ---------------------------------------------------------------------------
// K3b, launch 1: row statistics and dq
// ---------------------------------------------------------------------------

template <int CQK, int CV, bool DROP>
__global__ void __launch_bounds__(kRows)
pwa_long_bwd_rows_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const int* __restrict__ seed,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ stats,
                         int H, int N, int L, float scale, uint32_t thresh,
                         float inv_keep) {
  __shared__ float ks[kTile * CQK];
  __shared__ float vs[kTile * CV];
  __shared__ float bs[kRows * (kTile + 1)];
  const int64_t w = blockIdx.x;
  const int h = static_cast<int>((w / N) % H);
  const int l0 = blockIdx.y * kRows;
  const int l = l0 + threadIdx.x;
  const bool row_ok = l < L;
  const float* kw = k + w * CQK * L;
  const float* vw = v + w * CV * L;
  const float* bh = bias + static_cast<int64_t>(h) * L * L;
  const float* brow = bs + threadIdx.x * (kTile + 1);
  const uint32_t uL = static_cast<uint32_t>(L);
  uint32_t sd = 0, rowbase = 0;
  if (DROP) {
    sd = static_cast<uint32_t>(seed[0]);
    rowbase = (global_wid(w, static_cast<uint32_t>(seed[1]), H, N) * uL +
               static_cast<uint32_t>(l)) * uL;
  }
  float qr[CQK], dr[CV];
#pragma unroll
  for (int c = 0; c < CQK; ++c) qr[c] = row_ok ? q[(w * CQK + c) * L + l] : 0.f;
#pragma unroll
  for (int c = 0; c < CV; ++c)
    dr[c] = row_ok ? dout[(w * CV + c) * L + l] : 0.f;

  // pass 1 (online): max, Σ e and Σ e·dP, rescaled as the max grows
  float mx = -INFINITY, sum = 0.f, edp = 0.f;
  for (int m0 = 0; m0 < L; m0 += kTile) {
    __syncthreads();
    stage_tokens<CQK>(ks, kw, L, m0);
    stage_tokens<CV>(vs, vw, L, m0);
    stage_bias(bs, bh, L, l0, m0);
    __syncthreads();
    float s[kTile];
    const float tmax =
        tile_logits<CQK>(s, qr, ks, brow, min(kTile, L - m0), scale);
    if (tmax > mx) {
      const float f = expf(mx - tmax);
      sum *= f;
      edp *= f;
      mx = tmax;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float e = expf(s[j] - mx);
      sum += e;
      if (DROP && keep_hash(rowbase + static_cast<uint32_t>(m0 + j), sd) <
                      thresh)
        continue;
      float dwv = 0.f;
#pragma unroll
      for (int c = 0; c < CV; ++c) dwv = fmaf(dr[c], vs[j * CV + c], dwv);
      edp = fmaf(e, DROP ? dwv * inv_keep : dwv, edp);
    }
  }
  const float inv = 1.f / sum;
  const float dd = edp * inv;
  if (row_ok) {
    float* st = stats + w * 3 * L;
    st[l] = mx;
    st[L + l] = inv;
    st[2 * L + l] = dd;
  }

  // pass 2: dS and dq
  float acc[CQK];
#pragma unroll
  for (int c = 0; c < CQK; ++c) acc[c] = 0.f;
  for (int m0 = 0; m0 < L; m0 += kTile) {
    __syncthreads();
    stage_tokens<CQK>(ks, kw, L, m0);
    stage_tokens<CV>(vs, vw, L, m0);
    stage_bias(bs, bh, L, l0, m0);
    __syncthreads();
    // no tile max is needed here: each logit is used where it is made
    // (a tile of them held in registers spills with the mask's branches)
    const int cols = min(kTile, L - m0);
#pragma unroll 4
    for (int j = 0; j < cols; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < CQK; ++c) d = fmaf(qr[c], ks[j * CQK + c], d);
      const float p = expf(fmaf(d, scale, brow[j]) - mx) * inv;
      float dp = 0.f;
      if (!DROP ||
          keep_hash(rowbase + static_cast<uint32_t>(m0 + j), sd) >= thresh) {
        float dwv = 0.f;
#pragma unroll
        for (int c = 0; c < CV; ++c) dwv = fmaf(dr[c], vs[j * CV + c], dwv);
        dp = DROP ? dwv * inv_keep : dwv;
      }
      const float ds = p * (dp - dd);
#pragma unroll
      for (int c = 0; c < CQK; ++c) acc[c] = fmaf(ds, ks[j * CQK + c], acc[c]);
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int c = 0; c < CQK; ++c) dq[(w * CQK + c) * L + l] = acc[c] * scale;
}

// ---------------------------------------------------------------------------
// K3b, launch 2: dk and dv
// ---------------------------------------------------------------------------

template <int CQK, int CV, bool DROP>
__global__ void __launch_bounds__(kRows)
pwa_long_bwd_cols_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const int* __restrict__ seed,
                         const float* __restrict__ dout,
                         const float* __restrict__ stats,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int N, int L, float scale, uint32_t thresh,
                         float inv_keep) {
  __shared__ float qs[kTile * CQK];
  __shared__ float dos[kTile * CV];
  __shared__ float st[3 * kTile];
  const int64_t w = blockIdx.x;
  const int h = static_cast<int>((w / N) % H);
  const int m = blockIdx.y * kRows + threadIdx.x;
  const bool col_ok = m < L;
  const float* qw = q + w * CQK * L;
  const float* dw = dout + w * CV * L;
  const float* sw = stats + w * 3 * L;
  const float* bh = bias + static_cast<int64_t>(h) * L * L;
  const uint32_t uL = static_cast<uint32_t>(L);
  uint32_t sd = 0, wbase = 0;
  if (DROP) {
    sd = static_cast<uint32_t>(seed[0]);
    wbase = global_wid(w, static_cast<uint32_t>(seed[1]), H, N) * uL;
  }
  float kc[CQK], vc[CV], dka[CQK], dva[CV];
#pragma unroll
  for (int c = 0; c < CQK; ++c) {
    kc[c] = col_ok ? k[(w * CQK + c) * L + m] : 0.f;
    dka[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    vc[c] = col_ok ? v[(w * CV + c) * L + m] : 0.f;
    dva[c] = 0.f;
  }
  for (int r0 = 0; r0 < L; r0 += kTile) {
    __syncthreads();
    stage_tokens<CQK>(qs, qw, L, r0);
    stage_tokens<CV>(dos, dw, L, r0);
    for (int i = threadIdx.x; i < 3 * kTile; i += blockDim.x) {
      const int which = i / kTile, j = i - which * kTile;
      st[i] = r0 + j < L ? sw[which * L + r0 + j] : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    const int rows = min(kTile, L - r0);
    for (int j = 0; j < rows; ++j) {
      const int l = r0 + j;
      const float* ql = qs + j * CQK;
      const float* dl = dos + j * CV;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < CQK; ++c) s = fmaf(ql[c], kc[c], s);
      const float p =
          expf(fmaf(s, scale, bh[static_cast<int64_t>(l) * L + m]) - st[j]) *
          st[kTile + j];
      float dp = 0.f;
      if (!DROP || keep_hash((wbase + static_cast<uint32_t>(l)) * uL +
                                 static_cast<uint32_t>(m),
                             sd) >= thresh) {
        const float wgt = DROP ? p * inv_keep : p;
        float dwv = 0.f;
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          dwv = fmaf(dl[c], vc[c], dwv);
          dva[c] = fmaf(wgt, dl[c], dva[c]);
        }
        dp = DROP ? dwv * inv_keep : dwv;
      }
      const float ds = p * (dp - st[2 * kTile + j]);
#pragma unroll
      for (int c = 0; c < CQK; ++c) dka[c] = fmaf(ds, ql[c], dka[c]);
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int c = 0; c < CQK; ++c) dk[(w * CQK + c) * L + m] = dka[c] * scale;
#pragma unroll
  for (int c = 0; c < CV; ++c) dv[(w * CV + c) * L + m] = dva[c];
}

// ---------------------------------------------------------------------------
// K3b, launch 3: dbias, summed over the windows of each head in order
// ---------------------------------------------------------------------------

constexpr int kBiasRowsPerThread = kBiasTile * kBiasTile / kBiasThreads;

template <int CQK, int CV, bool DROP>
__global__ void __launch_bounds__(kBiasThreads)
pwa_long_dbias_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ bias,
                      const int* __restrict__ seed,
                      const float* __restrict__ dout,
                      const float* __restrict__ stats,
                      float* __restrict__ dbias, int B, int H, int N, int L,
                      float scale, uint32_t thresh, float inv_keep) {
  __shared__ float qs[kBiasTile * CQK];
  __shared__ float dos[kBiasTile * CV];
  __shared__ float st[3 * kBiasTile];
  constexpr int kGroups = kBiasThreads / kBiasTile;  // row groups
  const int h = blockIdx.z;
  const int r0 = blockIdx.y * kBiasTile, c0 = blockIdx.x * kBiasTile;
  const int tx = threadIdx.x % kBiasTile, ty = threadIdx.x / kBiasTile;
  const int m = c0 + tx;
  const bool col_ok = m < L;
  const float* bh = bias + static_cast<int64_t>(h) * L * L;
  const uint32_t uL = static_cast<uint32_t>(L);
  const uint32_t sd = DROP ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t off = DROP ? static_cast<uint32_t>(seed[1]) : 0u;
  float bv[kBiasRowsPerThread], acc[kBiasRowsPerThread];
#pragma unroll
  for (int i = 0; i < kBiasRowsPerThread; ++i) {
    const int l = r0 + ty + kGroups * i;
    bv[i] = (col_ok && l < L) ? bh[static_cast<int64_t>(l) * L + m] : 0.f;
    acc[i] = 0.f;
  }
  for (int b = 0; b < B; ++b) {
    for (int n = 0; n < N; ++n) {
      const int64_t w = (static_cast<int64_t>(b) * H + h) * N + n;
      float kc[CQK], vc[CV];
#pragma unroll
      for (int c = 0; c < CQK; ++c)
        kc[c] = col_ok ? k[(w * CQK + c) * L + m] : 0.f;
#pragma unroll
      for (int c = 0; c < CV; ++c)
        vc[c] = col_ok ? v[(w * CV + c) * L + m] : 0.f;
      __syncthreads();  // the previous window is done with shared memory
      for (int i = threadIdx.x; i < CQK * kBiasTile; i += blockDim.x) {
        const int c = i / kBiasTile, j = i - c * kBiasTile;
        qs[j * CQK + c] = r0 + j < L ? q[(w * CQK + c) * L + r0 + j] : 0.f;
      }
      for (int i = threadIdx.x; i < CV * kBiasTile; i += blockDim.x) {
        const int c = i / kBiasTile, j = i - c * kBiasTile;
        dos[j * CV + c] = r0 + j < L ? dout[(w * CV + c) * L + r0 + j] : 0.f;
      }
      for (int i = threadIdx.x; i < 3 * kBiasTile; i += blockDim.x) {
        const int which = i / kBiasTile, j = i - which * kBiasTile;
        st[i] = r0 + j < L ? stats[(w * 3 + which) * L + r0 + j] : 0.f;
      }
      __syncthreads();
      const uint32_t wbase = global_wid(w, off, H, N) * uL;
#pragma unroll
      for (int i = 0; i < kBiasRowsPerThread; ++i) {
        const int j = ty + kGroups * i;
        const int l = r0 + j;
        const float* ql = qs + j * CQK;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CQK; ++c) s = fmaf(ql[c], kc[c], s);
        // rows past L have statistics 0 and contribute p·(dp − 0) of
        // zeroed tokens; they are never written
        const float p = expf(fmaf(s, scale, bv[i]) - st[j]) * st[kBiasTile + j];
        float dp = 0.f;
        if (!DROP || keep_hash((wbase + static_cast<uint32_t>(l)) * uL +
                                   static_cast<uint32_t>(m),
                               sd) >= thresh) {
          const float* dl = dos + j * CV;
          float dwv = 0.f;
#pragma unroll
          for (int c = 0; c < CV; ++c) dwv = fmaf(dl[c], vc[c], dwv);
          dp = DROP ? dwv * inv_keep : dwv;
        }
        acc[i] += p * (dp - st[2 * kBiasTile + j]);
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < kBiasRowsPerThread; ++i) {
    const int l = r0 + ty + kGroups * i;
    if (l < L) dbias[(static_cast<int64_t>(h) * L + l) * L + m] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int CQK, int CV, bool DROP>
static cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                              const float* bias, const int* seed, float* out,
                              int B, int H, int N, int L, float scale,
                              uint32_t thresh, float inv_keep,
                              cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(B) * H * N, (L + kRows - 1) / kRows);
  pwa_long_fwd_kernel<CQK, CV, DROP><<<grid, kRows, 0, stream>>>(
      q, k, v, bias, seed, out, H, N, L, scale, thresh, inv_keep);
  return cudaGetLastError();
}

template <int CQK, int CV, bool DROP>
static cudaError_t launch_bwd(const float* q, const float* k, const float* v,
                              const float* bias, const int* seed,
                              const float* dout, float* dq, float* dk,
                              float* dv, float* stats, float* dbias, int B,
                              int H, int N, int L, float scale,
                              uint32_t thresh, float inv_keep,
                              cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(B) * H * N, (L + kRows - 1) / kRows);
  pwa_long_bwd_rows_kernel<CQK, CV, DROP><<<grid, kRows, 0, stream>>>(
      q, k, v, bias, seed, dout, dq, stats, H, N, L, scale, thresh, inv_keep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pwa_long_bwd_cols_kernel<CQK, CV, DROP><<<grid, kRows, 0, stream>>>(
      q, k, v, bias, seed, dout, stats, dk, dv, H, N, L, scale, thresh,
      inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned tiles = (L + kBiasTile - 1) / kBiasTile;
  const dim3 bgrid(tiles, tiles, static_cast<unsigned>(H));
  pwa_long_dbias_kernel<CQK, CV, DROP><<<bgrid, kBiasThreads, 0, stream>>>(
      q, k, v, bias, seed, dout, stats, dbias, B, H, N, L, scale, thresh,
      inv_keep);
  return cudaGetLastError();
}

// The widths K3 is built for: the only long window of any configuration
// is bench.py's 128³ level 1, (Cqk, Cv) = (8, 8). Any other width returns
// cudaErrorInvalidValue (ops/pwa_attention.py:LONG_KERNEL_WIDTHS).
#define VS_ALL_WIDTHS(CASE, DROP) CASE(8, 8, DROP)

#define VS_FWD_CASE(CQ, CVV, DROP)                                         \
  if (Cqk == CQ && Cv == CVV)                                              \
    return launch_fwd<CQ, CVV, DROP>(q, k, v, bias, seed, out, B, H, N, L, \
                                     scale, thresh, inv_keep, stream);
#define VS_BWD_CASE(CQ, CVV, DROP)                                         \
  if (Cqk == CQ && Cv == CVV)                                              \
    return launch_bwd<CQ, CVV, DROP>(q, k, v, bias, seed, dout, dq, dk,    \
                                     dv, stats, dbias, B, H, N, L, scale,  \
                                     thresh, inv_keep, stream);

// K3f. q, k: (B, H, N, Cqk, L); v, out: (B, H, N, Cv, L); bias: (H, L, L);
// seed: int32 [seed, batch_offset] on the device; thresh = 0: no dropout.
extern "C" int vs_pwa_attention_long_train(
    const float* q, const float* k, const float* v, const float* bias,
    const int* seed, float* out, int B, int H, int N, int Cqk, int Cv, int L,
    float scale, unsigned int thresh, float inv_keep, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B * H * N == 0 || L == 0) return cudaSuccess;
  if (thresh == 0) {
    VS_ALL_WIDTHS(VS_FWD_CASE, false)
  } else {
    VS_ALL_WIDTHS(VS_FWD_CASE, true)
  }
  return cudaErrorInvalidValue;
}

// K3b. As K3f, plus dout like v; dq, dk, dv like q, k, v; stats:
// B·H·N·3·L floats of scratch (row max, 1/sum, D per window); dbias:
// (H, L, L), written whole. B·H·N must be > 0.
extern "C" int vs_pwa_attention_long_train_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const int* seed, const float* dout, float* dq, float* dk, float* dv,
    float* stats, float* dbias, int B, int H, int N, int Cqk, int Cv, int L,
    float scale, unsigned int thresh, float inv_keep, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B * H * N == 0 || L == 0) return cudaErrorInvalidValue;
  if (thresh == 0) {
    VS_ALL_WIDTHS(VS_BWD_CASE, false)
  } else {
    VS_ALL_WIDTHS(VS_BWD_CASE, true)
  }
  return cudaErrorInvalidValue;
}
