// K2b: backward of the train paired-window attention (K2f), fp32 or bf16
// (q, k, v, dO and dq, dk, dv; built with -DVS_BF16), for windows of
// L <= 512 tokens.
//
// Replaces: veloxseg_tpu/ops/pwa_attention.py:_train_bwd_kernel (344-404),
// called through _train_bwd_pallas (605-630) from the custom VJP
// window_attention_train (681-710). Per window, with P = softmax(scale ·
// QᵀK + bias_h), the counter-hash keep mask M (common.cuh:keep_hash over
// the global id (wid·L + row)·L + col, wid over the true window count N,
// as K2f and _train_xla number them) and W = M·P/(1 − p):
//   dV = dO·W,   dP = M·(dOᵀV)/(1 − p),   dS = P ⊙ (dP − D),
//   dQ = scale·K·dSᵀ,   dK = scale·Q·dS,   dbias_h = Σ_(b, n) dS,
// with D = rowsum(P ⊙ dP) = Σ_c dO·out. It takes K2f's out and its
// per-row log-sum-exp (lse), so P = exp(logit − lse) needs no softmax pass
// of its own, and each score, mask bit and dS is computed exactly once.
//
// What bounds it on this card: operations. At the flagship's level 0 (B 16,
// h 1, N 585, Cqk = Cv = 4, L 128) the function is 153 M scores at
// 3·Cqk + 2·Cv FMA, an exp and the 14-operation hash each, on ~40 MB of
// tokens; the (L, L) score tiles never reach device memory. The dbias sum
// runs over the B·N windows of each head, so a block that owns a dbias
// tile walks windows with the tile in registers (as K3b does,
// pwa_attention_long.cu). Three launches, no float atomics, so all four
// outputs repeat bit for bit:
//   prep   per window and row, lse in base 2 and D = Σ_c dO·out.
//   tiles  block (tile, head, window chunk): the T × T dbias tile (T = 64,
//          or 128; one tile per window at L <= 64, ragged edges masked)
//          stays in registers while the block walks its chunk of the
//          head's windows in order; the next window's tokens arrive by
//          cp.async while the current one is computed. 4·T threads; per
//          window and pass of 64 columns, thread (ty, tx) forms the 4 × 4
//          scores of rows ty·4 + i, columns tx·4 + j from the staged q, k,
//          dO, v (float4 loads, each feeding 4 FMAs), then dS and W go to
//          shared memory and dq (per row, over the pass's columns), dk and
//          dv (per column, over the tile's rows) are products over them.
//          With one tile per window dq, dk and dv are written whole; with
//          more they leave as per-tile partials. The dbias tile is written
//          once per block: whole with one chunk, else as a partial.
//   reduce the dq, dk, dv partials over the tiles and the dbias partials
//          over the chunks, each in order (only where there are partials).
// Tensor cores are not used (ROADMAP: 3×TF32).
//
// The bf16 form (T = bf16) is the same kernel: q, k, v and dO are converted
// to fp32 as they are staged, every product and sum is fp32, dq, dk and dv
// are rounded once to bf16 and dbias stays fp32, as _train_bwd_kernel
// writes them (pwa_attention.py:344-404, 614-630). It takes K2f's output
// in fp32 before its rounding (out32), so that D is the Pallas kernel's
// rowsum(P ⊙ dP) up to fp32 rounding.
#include "common.cuh"

constexpr int kPass = 64;          // columns per pass over a tile
constexpr int kDS = kPass + 4;     // row stride of the dS and W tiles

// K2b launch 1: per window and row, the forward's log-sum-exp in base 2
// and D = Σ_c dO·out (= Σ_j P·dP); stats: [window][2][L].
template <typename T, int CV>
__global__ void pwa_bwd_prep(const T* __restrict__ dout,
                             const float* __restrict__ out,
                             const float* __restrict__ lse,
                             float* __restrict__ stats, int64_t W, int L) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= W * L) return;
  const int64_t w = i / L;
  const int l = static_cast<int>(i - w * L);
  float d = 0.f;
#pragma unroll
  for (int c = 0; c < CV; ++c)
    d = fmaf(to_f32(dout[(w * CV + c) * L + l]), out[(w * CV + c) * L + l],
             d);
  stats[(w * 2) * L + l] = lse[i] * kLog2e;
  stats[(w * 2 + 1) * L + l] = d;
}

// One window's stage: q, dO of the row tile and k, v of the column tile as
// [c][T + 4], then the row tile's lse2 and D.
template <int CQK, int CV, int T>
struct Stage {
  static constexpr int kTS = T + 4;
  static constexpr int kFloats = (2 * CQK + 2 * CV) * kTS + 2 * T;
  static constexpr int kQ = 0, kD = CQK * kTS, kK = kD + CV * kTS,
                       kV = kK + CQK * kTS, kStats = kV + CV * kTS;
};

// Issue the copies of window w's tokens for row tile l0 and column tile m0
// into buf; past L everything reads 0.
template <typename E, int CQK, int CV, int T>
__device__ __forceinline__ void stage_window(
    float* buf, const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const E* __restrict__ dout,
    const float* __restrict__ stats, int64_t w, int L, int l0, int m0) {
  using St = Stage<CQK, CV, T>;
  constexpr int n = (2 * CQK + 2 * CV) * T + 2 * T;
  for (int i = threadIdx.x; i < n; i += 4 * T) {
    const int row = i / T, j = i - row * T;   // T is a power of two
    const E* src;
    int t, c;
    if (row < CQK) {
      src = q; c = row; t = l0 + j;
      src += (w * CQK + c) * L;
    } else if (row < CQK + CV) {
      src = dout; c = row - CQK; t = l0 + j;
      src += (w * CV + c) * L;
    } else if (row < 2 * CQK + CV) {
      src = k; c = row - CQK - CV; t = m0 + j;
      src += (w * CQK + c) * L;
    } else if (row < 2 * CQK + 2 * CV) {
      src = v; c = row - 2 * CQK - CV; t = m0 + j;
      src += (w * CV + c) * L;
    } else {
      c = row - 2 * CQK - 2 * CV;   // 0: lse2, 1: D
      const float* st = stats + (w * 2 + c) * L;
      t = l0 + j;
      const bool ok = t < L;
      cp_async_f32(buf + St::kStats + c * T + j, st + (ok ? t : 0), ok);
      continue;
    }
    const bool ok = t < L;
    stage1<E>(buf + row * St::kTS + j, src + (ok ? t : 0), ok);
  }
}

// K2b launch 2. Block (blockIdx.x = tile I·nT + J, blockIdx.y = head h,
// blockIdx.z = chunk) walks windows [chunk·per, min(B·N, +per)) of head h
// (window j is sample j / N, window j % N). Partials: part = [dq | dk | dv],
// each [tile][window][c][L] (dq over the column tiles J, dk and dv over the
// row tiles I; with one tile dq, dk, dv are written whole, scaled), and
// partb [chunk][h][L][L] (with one chunk dbias is written whole).
template <typename E, int CQK, int CV, int T, bool DROP>
__global__ void __launch_bounds__(4 * T, T == 64 ? 2 : 1)
pwa_bwd_tiles(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, const float* __restrict__ bias,
              const int* __restrict__ seed, const E* __restrict__ dout,
              const float* __restrict__ stats, E* __restrict__ dq,
              E* __restrict__ dk, E* __restrict__ dv,
              float* __restrict__ dbias, float* __restrict__ part,
              float* __restrict__ partb, int B, int H, int N, int L, int per,
              float scale, uint32_t thresh, float inv_keep) {
  static_assert(CQK <= 16, "one dq job a thread needs Cqk <= 16");
  using St = Stage<CQK, CV, T>;
  constexpr int NT = 4 * T;            // threads
  constexpr int kTS = St::kTS;
  constexpr int kBS = T + 4;           // row stride of the bias tile
  constexpr int kPasses = T / kPass;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                    // [T][kBS] bias·log2e
  float* stage = bs + T * kBS;         // 2 × St::kFloats
  float* dss = stage + 2 * St::kFloats;  // [T][kDS] dS of a pass
  float* ws = dss + T * kDS;           // [T][kDS] W of a pass
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nT = (L + T - 1) / T;
  const int I = blockIdx.x / nT, J = blockIdx.x - I * nT;
  const int h = blockIdx.y;
  const int l0 = I * T, m0 = J * T;
  const int BN = B * N;
  const int j0 = blockIdx.z * per, j1 = min(BN, j0 + per);
  const int64_t W = static_cast<int64_t>(B) * H * N;
  const float* bh = bias + static_cast<int64_t>(h) * L * L;
  for (int i = tid; i < T * T; i += NT) {
    const int r = i / T, m = i - r * T;
    const bool ok = l0 + r < L && m0 + m < L;
    bs[r * kBS + m] =
        ok ? bh[static_cast<int64_t>(l0 + r) * L + m0 + m] * kLog2e
           : -INFINITY;
  }
  const float sc2 = scale * kLog2e;
  const uint32_t uL = static_cast<uint32_t>(L);
  const uint32_t sd = DROP ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t off = DROP ? static_cast<uint32_t>(seed[1]) : 0u;
  float acc[kPasses][4][4];
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ps][i][j] = 0.f;
  const bool whole = nT == 1;
  const int64_t nq = W * CQK * L;
  float* dqp = part;                               // [nT][W][CQK][L]
  float* dkp = part + static_cast<int64_t>(nT) * nq;
  float* dvp = dkp + static_cast<int64_t>(nT) * nq;  // [nT][W][CV][L]
  // this thread's dq job: row pr of the tile, channels cq .. cq + 3
  const bool has_dq = tid < T * CQK / 4;
  const int pr = tid % T, cq = (tid / T) * 4;

  auto window = [&](int j) {
    const int b = j / N, n = j - b * N;
    return (static_cast<int64_t>(b) * H + h) * N + n;
  };
  if (j0 < j1)
    stage_window<E, CQK, CV, T>(stage, q, k, v, dout, stats, window(j0),
                                L, l0, m0);
  for (int j = j0; j < j1; ++j) {
    const int64_t w = window(j);
    const float* cur = stage + ((j - j0) & 1) * St::kFloats;
    cp_async_wait_all();
    __syncthreads();  // this window is staged; the last one is done with
                      // the other buffer and with dss, ws
    if (j + 1 < j1)
      stage_window<E, CQK, CV, T>(stage + ((j + 1 - j0) & 1) * St::kFloats,
                                  q, k, v, dout, stats, window(j + 1), L, l0,
                                  m0);
    const float* qT = cur + St::kQ;
    const float* dT = cur + St::kD;
    const float* kT = cur + St::kK;
    const float* vT = cur + St::kV;
    const float* ls = cur + St::kStats;
    const float* Ds = ls + T;
    const uint32_t wbase =
        (static_cast<uint32_t>(w) + off * static_cast<uint32_t>(H) *
                                        static_cast<uint32_t>(N)) * uL;
    float dqa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ps = 0; ps < kPasses; ++ps) {
      const int mc = ps * kPass + tx * 4;  // first column in the tile
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll
      for (int c = 0; c < CQK; ++c) {
        const float4 qa = lds4(qT + c * kTS + ty * 4);
        const float4 kk = lds4(kT + c * kTS + mc);
        const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
        const float kc[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s[i][jj] = fmaf(qr[i], kc[jj], s[i][jj]);
      }
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const float4 da = lds4(dT + c * kTS + ty * 4);
        const float4 vv = lds4(vT + c * kTS + mc);
        const float dr[4] = {da.x, da.y, da.z, da.w};
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            dp[i][jj] = fmaf(dr[i], vc[jj], dp[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float4 bb = lds4(bs + r * kBS + mc);
        const float bj[4] = {bb.x, bb.y, bb.z, bb.w};
        const float l2 = ls[r], dd = Ds[r];
        const uint32_t rowbase =
            (wbase + static_cast<uint32_t>(l0 + r)) * uL +
            static_cast<uint32_t>(m0 + mc);
        float dsv[4], wv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = exp2f(fmaf(s[i][jj], sc2, bj[jj]) - l2);
          float dpk = dp[i][jj], wgt = p;
          if (DROP) {
            const bool keep =
                keep_hash(rowbase + static_cast<uint32_t>(jj), sd) >= thresh;
            dpk = keep ? dpk * inv_keep : 0.f;
            wgt = keep ? p * inv_keep : 0.f;
          }
          dsv[jj] = p * (dpk - dd);
          wv[jj] = wgt;
          acc[ps][i][jj] += dsv[jj];
        }
        sts4(dss + r * kDS + tx * 4, dsv[0], dsv[1], dsv[2], dsv[3]);
        sts4(ws + r * kDS + tx * 4, wv[0], wv[1], wv[2], wv[3]);
      }
      __syncthreads();
      // dq of row pr over this pass's columns
      if (has_dq) {
        for (int m = 0; m < kPass; m += 4) {
          const float4 d = lds4(dss + pr * kDS + m);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 kv = lds4(kT + (cq + cc) * kTS + ps * kPass + m);
            dqa[cc] = fmaf(d.x, kv.x, dqa[cc]);
            dqa[cc] = fmaf(d.y, kv.y, dqa[cc]);
            dqa[cc] = fmaf(d.z, kv.z, dqa[cc]);
            dqa[cc] = fmaf(d.w, kv.w, dqa[cc]);
          }
        }
      }
      // dk (CQK/4 jobs a column) and dv (CV/4) of this pass's 64 columns
      // over the row tile; from the last thread down, away from the dq
      // jobs
      for (int jb = NT - 1 - tid; jb < kPass * (CQK + CV) / 4; jb += NT) {
        const bool is_v = jb >= kPass * CQK / 4;
        const int jv = is_v ? jb - kPass * CQK / 4 : jb;
        const int m = jv % kPass, c0 = (jv / kPass) * 4;
        const float* A = is_v ? ws : dss;
        const float* Tk = is_v ? dT : qT;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int r = 0; r < T; r += 4) {
          const float s0 = A[r * kDS + m], s1 = A[(r + 1) * kDS + m];
          const float s2 = A[(r + 2) * kDS + m], s3 = A[(r + 3) * kDS + m];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 t = lds4(Tk + (c0 + cc) * kTS + r);
            a[cc] = fmaf(s0, t.x, a[cc]);
            a[cc] = fmaf(s1, t.y, a[cc]);
            a[cc] = fmaf(s2, t.z, a[cc]);
            a[cc] = fmaf(s3, t.w, a[cc]);
          }
        }
        const int col = m0 + ps * kPass + m;
        if (col < L) {
          const int C = is_v ? CV : CQK;
          if (whole) {
            E* dst = (is_v ? dv : dk) + (w * C + c0) * L + col;
            const float f = is_v ? 1.f : scale;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              dst[cc * L] = from_f32<E>(a[cc] * f);
          } else {
            float* dst = (is_v ? dvp + static_cast<int64_t>(I) * W * CV * L
                               : dkp + static_cast<int64_t>(I) * nq) +
                         (w * C + c0) * L + col;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) dst[cc * L] = a[cc];
          }
        }
      }
      if (ps + 1 < kPasses) __syncthreads();  // dss, ws are rewritten
    }
    if (has_dq && l0 + pr < L) {
      if (whole) {
        E* dst = dq + (w * CQK + cq) * L + l0 + pr;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          dst[cc * L] = from_f32<E>(dqa[cc] * scale);
      } else {
        float* dst = dqp + static_cast<int64_t>(J) * nq +
                     (w * CQK + cq) * L + l0 + pr;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) dst[cc * L] = dqa[cc];
      }
    }
  }
  float* dbh = (gridDim.z == 1 ? dbias
                               : partb + static_cast<int64_t>(blockIdx.z) *
                                             H * L * L) +
               static_cast<int64_t>(h) * L * L;
#pragma unroll
  for (int ps = 0; ps < kPasses; ++ps)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = l0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int m = m0 + ps * kPass + tx * 4 + jj;
        if (r < L && m < L)
          dbh[static_cast<int64_t>(r) * L + m] = acc[ps][i][jj];
      }
    }
}

// K2b launch 3: dq = scale·Σ_J, dk = scale·Σ_I, dv = Σ_I of the partials
// over the tiles in order (nT > 1), rounded to E, and dbias = Σ of the
// chunk partials in order (chunks > 1). Elements [0, 2·nq + nv) are dq |
// dk | dv when nT > 1, the next nb dbias when chunks > 1.
template <typename E>
__global__ void pwa_bwd_reduce(const float* __restrict__ part,
                               const float* __restrict__ partb,
                               E* __restrict__ dq, E* __restrict__ dk,
                               E* __restrict__ dv,
                               float* __restrict__ dbias, int64_t nq,
                               int64_t nv, int nT, int64_t nb, int chunks,
                               float scale) {
  const int64_t ntok = nT > 1 ? 2 * nq + nv : 0;
  const int64_t n = ntok + (chunks > 1 ? nb : 0);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < ntok) {
      const int which = i < nq ? 0 : i < 2 * nq ? 1 : 2;
      const int64_t e = i - which * nq;
      const int64_t stride = which == 2 ? nv : nq;
      const float* p = part + which * nT * nq + e;
      float s = 0.f;
      for (int t = 0; t < nT; ++t) s += p[t * stride];
      if (which == 0) dq[e] = from_f32<E>(s * scale);
      else if (which == 1) dk[e] = from_f32<E>(s * scale);
      else dv[e] = from_f32<E>(s);
    } else {
      const int64_t e = i - ntok;
      const float* p = partb + e;
      float s[8];
      float t = 0.f;
      int c = 0;
      for (; c + 8 <= chunks; c += 8) {  // 8 loads in flight, added in order
#pragma unroll
        for (int u = 0; u < 8; ++u) s[u] = p[(c + u) * nb];
#pragma unroll
        for (int u = 0; u < 8; ++u) t += s[u];
      }
      for (; c < chunks; ++c) t += p[c * nb];
      dbias[e] = t;
    }
  }
}

// Shared memory of a tiles block, in bytes.
template <int CQK, int CV, int T>
constexpr size_t tiles_smem() {
  return static_cast<size_t>(T * (T + 4) + 2 * Stage<CQK, CV, T>::kFloats +
                             2 * T * kDS) * sizeof(float);
}

template <typename E, int CQK, int CV, int T, bool DROP>
static cudaError_t launch_tiles(const E* q, const E* k, const E* v,
                                const float* bias, const int* seed,
                                const E* dout, const float* stats, E* dq,
                                E* dk, E* dv, float* dbias,
                                float* part, float* partb, int B, int H,
                                int N, int L, int chunks, int per,
                                float scale, uint32_t thresh, float inv_keep,
                                cudaStream_t stream) {
  if constexpr (tiles_smem<CQK, CV, T>() > kMaxSmemBytes) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = tiles_smem<CQK, CV, T>();
    cudaError_t err = allow_smem(pwa_bwd_tiles<E, CQK, CV, T, DROP>, smem);
    if (err != cudaSuccess) return err;
    const unsigned nT = static_cast<unsigned>((L + T - 1) / T);
    pwa_bwd_tiles<E, CQK, CV, T, DROP>
        <<<dim3(nT * nT, static_cast<unsigned>(H),
                static_cast<unsigned>(chunks)),
           4 * T, smem, stream>>>(q, k, v, bias, seed, dout, stats, dq, dk,
                                  dv, dbias, part, partb, B, H, N, L, per,
                                  scale, thresh, inv_keep);
    return cudaGetLastError();
  }
}

template <typename E, int CQK, int CV>
static cudaError_t launch_bwd(const E* q, const E* k, const E* v,
                              const float* bias, const int* seed,
                              const E* dout, const float* out,
                              const float* lse, E* dq, E* dk, E* dv,
                              float* dbias, float* stats,
                              float* part, float* partb, int B, int H, int N,
                              int L, int T, int chunks, int per, float scale,
                              uint32_t thresh, float inv_keep,
                              cudaStream_t stream) {
  const int64_t W = static_cast<int64_t>(B) * H * N;
  pwa_bwd_prep<E, CV><<<static_cast<unsigned>((W * L + 255) / 256), 256, 0,
                        stream>>>(dout, out, lse, stats, W, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define VS_TILES(TT, DROP)                                                   \
  err = launch_tiles<E, CQK, CV, TT, DROP>(q, k, v, bias, seed, dout, stats, \
                                           dq, dk, dv, dbias, part, partb, B, \
                                           H, N, L, chunks, per, scale,       \
                                           thresh, inv_keep, stream);
  if (T == 64 && thresh == 0) { VS_TILES(64, false) }
  else if (T == 64) { VS_TILES(64, true) }
  else if (T == 128 && thresh == 0) { VS_TILES(128, false) }
  else if (T == 128) { VS_TILES(128, true) }
  else return cudaErrorInvalidValue;
#undef VS_TILES
  if (err != cudaSuccess) return err;
  const int nT = (L + T - 1) / T;
  if (nT == 1 && chunks == 1) return cudaSuccess;
  const int64_t nq = W * CQK * L, nv = W * CV * L;
  const int64_t nb = static_cast<int64_t>(H) * L * L;
  const int64_t n = (nT > 1 ? 2 * nq + nv : 0) + (chunks > 1 ? nb : 0);
  const int64_t want = (n + 255) / 256;
  pwa_bwd_reduce<E><<<static_cast<unsigned>(want < 4096 ? want : 4096), 256,
                      0, stream>>>(part, partb, dq, dk, dv, dbias, nq, nv,
                                   nT, nb, chunks, scale);
  return cudaGetLastError();
}

#define VS_CASE(CQ, CVV)                                                     \
  if (Cqk == CQ && Cv == CVV)                                                \
    return launch_bwd<Elem, CQ, CVV>(q, k, v, bias, seed, dout, out, lse, dq, \
                                     dk, dv, dbias, stats, part, partb, B, H, \
                                     N, L, T, chunks, per, scale, thresh,     \
                                     inv_keep, stream);

// q, k: (B, H, N, Cqk, L); v, dout: (B, H, N, Cv, L), Elem; out: (B, H, N,
// Cv, L) and lse: (B, H, N, L), float, K2f's output (before its rounding to
// Elem) and log-sum-exp of the same call; bias: (H, L, L), float; seed:
// int32 [seed, batch_offset] on the device; thresh = 0: no dropout. dq, dk,
// dv like q, k, v, Elem; dbias: (H, L, L), float. Scratch: stats B·H·N·2·L floats;
// part 2·nT·B·H·N·Cqk·L + nT·B·H·N·Cv·L floats (nT = ⌈L/T⌉; unused when
// nT = 1); partb chunks·H·L·L floats (unused when chunks = 1). The launch
// geometry (ops/pwa_attention.py:train_bwd_launch): tile edge T (64 or
// 128), `chunks` chunks of `per` windows of each head.
extern "C" int vs_pwa_attention_train_bwd(
    const Elem* q, const Elem* k, const Elem* v, const float* bias,
    const int* seed, const Elem* dout, const float* out, const float* lse,
    Elem* dq, Elem* dk, Elem* dv, float* dbias, float* stats, float* part,
    float* partb, int B, int H, int N, int Cqk, int Cv, int L, int T,
    int chunks, int per, float scale, unsigned int thresh, float inv_keep,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int bn = B * N;
  if (H <= 0 || L <= 0 || bn <= 0 || chunks < 1 || per < 1 ||
      static_cast<int64_t>(chunks - 1) * per >= bn ||
      static_cast<int64_t>(chunks) * per < bn)
    return cudaErrorInvalidValue;
  VS_CASE(4, 4) VS_CASE(4, 8) VS_CASE(4, 16) VS_CASE(4, 32)
  VS_CASE(8, 4) VS_CASE(8, 8) VS_CASE(8, 16) VS_CASE(8, 32)
  VS_CASE(16, 4) VS_CASE(16, 8) VS_CASE(16, 16) VS_CASE(16, 32)
  return cudaErrorInvalidValue;
}
