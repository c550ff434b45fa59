// K2b: backward of the train paired-window attention (K2f), fp32.
//
// Replaces: veloxseg_tpu/ops/pwa_attention.py:_train_bwd_kernel (344-404),
// called through _train_bwd_pallas (605-630) from the custom VJP
// window_attention_train (681-710). Per window, with P = softmax(scale ·
// QᵀK + bias_h), the counter-hash keep mask M (the same hash and global
// ids as K2f, recomputed, never stored) and W = M·P/(1 − p):
//   dV = dO·W,   dP = M·(dOᵀV)/(1 − p),   dS = P ⊙ (dP − rowsum(P ⊙ dP)),
//   dQ = scale·K·dSᵀ,   dK = scale·Q·dS,   dbias_h = Σ_(b, n) dS.
// Nothing but the inputs is saved by the forward: the softmax is
// recomputed here, as on the TPU.
//
// What bounds it on this card: like K1, the L×L scores, which never reach
// HBM. One block walks a chunk of windows of one head, one window at a
// time, with the window's K, V, Q and dO staged in shared memory as
// [L][C] (broadcast reads):
//   A. one thread per query row l (rows looped over the block's threads):
//      a max pass, then an exp pass that also sums e·dP, giving the row's
//      max, 1/sum and D_l = Σ_m P·dP (kept in shared memory), then a dS
//      pass that accumulates the row's dq in registers;
//   B. one thread per key column m: it walks every row l, recomputing the
//      score from the staged Q and the row statistics, and accumulates its
//      column's dk and dv in registers; it adds dS[l][m] into the block's
//      own dbias partial, a private (L, L) slab in global memory that only
//      this block touches (written at the chunk's first window, added to
//      after), read and written by consecutive threads at consecutive
//      addresses.
// A second launch sums the partials of each head over its chunks in a
// fixed order. dbias is therefore reduced without float atomics and
// repeats bit for bit from run to run. The scores are computed five times
// per window (three row passes, one column pass, plus the forward's two);
// at these widths (Cqk <= 16) recomputing is cheaper than storing an
// L = 432 window's 746 KB of scores. Tensor cores are not used.
#include "common.cuh"

constexpr int kBwdThreads = 256;

template <int CQK, int CV, bool DROP>
__global__ void __launch_bounds__(kBwdThreads)
pwa_attention_bwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         const int* __restrict__ seed,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, float* __restrict__ part,
                         int H, int N, int BN, int chunk, int L, float scale,
                         uint32_t thresh, float inv_keep) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [L][CQK]
  float* vs = ks + L * CQK;         // [L][CV]
  float* qs = vs + L * CV;          // [L][CQK]
  float* dos = qs + L * CQK;        // [L][CV]
  float* rmax = dos + L * CV;       // [L] row max of the logits
  float* rinv = rmax + L;           // [L] 1 / row sum of exp
  float* rdd = rinv + L;            // [L] D_l = Σ_m P·dP
  const int hh = blockIdx.y;
  const int j0 = blockIdx.x * chunk;
  const int j1 = min(j0 + chunk, BN);
  const int64_t LL = static_cast<int64_t>(L) * L;
  float* pc = part + (static_cast<int64_t>(hh) * gridDim.x + blockIdx.x) * LL;
  const float* bh = bias + hh * LL;
  const uint32_t sd = DROP ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t off = DROP ? static_cast<uint32_t>(seed[1]) : 0u;
  const uint32_t uL = static_cast<uint32_t>(L);
  if (j0 >= j1) {  // an empty chunk still owns its slab: zero it
    for (int64_t i = threadIdx.x; i < LL; i += blockDim.x) pc[i] = 0.f;
    return;
  }

  for (int j = j0; j < j1; ++j) {
    const int b = j / N, n = j - b * N;
    const int64_t w = (static_cast<int64_t>(b) * H + hh) * N + n;
    const uint32_t wid = static_cast<uint32_t>(w) +
                         off * static_cast<uint32_t>(H) *
                             static_cast<uint32_t>(N);
    const float* qw = q + w * CQK * L;
    const float* kw = k + w * CQK * L;
    const float* vw = v + w * CV * L;
    const float* dw = dout + w * CV * L;
    __syncthreads();  // the previous window is done with shared memory
    for (int i = threadIdx.x; i < CQK * L; i += blockDim.x) {
      const int c = i / L, m = i - c * L;
      ks[m * CQK + c] = kw[i];
      qs[m * CQK + c] = qw[i];
    }
    for (int i = threadIdx.x; i < CV * L; i += blockDim.x) {
      const int c = i / L, m = i - c * L;
      vs[m * CV + c] = vw[i];
      dos[m * CV + c] = dw[i];
    }
    __syncthreads();

    // A: rows -> row statistics and dq
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      float qr[CQK], dr[CV];
#pragma unroll
      for (int c = 0; c < CQK; ++c) qr[c] = qs[l * CQK + c];
#pragma unroll
      for (int c = 0; c < CV; ++c) dr[c] = dos[l * CV + c];
      const float* brow = bh + static_cast<int64_t>(l) * L;
      const uint32_t rowbase = (wid * uL + static_cast<uint32_t>(l)) * uL;
      float mx = -INFINITY;
      for (int m = 0; m < L; ++m) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CQK; ++c) s = fmaf(qr[c], ks[m * CQK + c], s);
        mx = fmaxf(mx, s * scale + brow[m]);
      }
      float sum = 0.f, edp = 0.f;
      for (int m = 0; m < L; ++m) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CQK; ++c) s = fmaf(qr[c], ks[m * CQK + c], s);
        const float e = expf(s * scale + brow[m] - mx);
        sum += e;
        if (DROP && keep_hash(rowbase + static_cast<uint32_t>(m), sd) < thresh)
          continue;
        float dwv = 0.f;
#pragma unroll
        for (int c = 0; c < CV; ++c) dwv = fmaf(dr[c], vs[m * CV + c], dwv);
        edp = fmaf(e, DROP ? dwv * inv_keep : dwv, edp);
      }
      const float inv = 1.f / sum;
      const float dd = edp * inv;
      rmax[l] = mx;
      rinv[l] = inv;
      rdd[l] = dd;
      float acc[CQK];
#pragma unroll
      for (int c = 0; c < CQK; ++c) acc[c] = 0.f;
      for (int m = 0; m < L; ++m) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CQK; ++c) s = fmaf(qr[c], ks[m * CQK + c], s);
        const float p = expf(s * scale + brow[m] - mx) * inv;
        float dp = 0.f;
        if (!DROP ||
            keep_hash(rowbase + static_cast<uint32_t>(m), sd) >= thresh) {
          float dwv = 0.f;
#pragma unroll
          for (int c = 0; c < CV; ++c) dwv = fmaf(dr[c], vs[m * CV + c], dwv);
          dp = DROP ? dwv * inv_keep : dwv;
        }
        const float ds = p * (dp - dd);
#pragma unroll
        for (int c = 0; c < CQK; ++c) acc[c] = fmaf(ds, ks[m * CQK + c], acc[c]);
      }
      float* dqw = dq + w * CQK * L;
#pragma unroll
      for (int c = 0; c < CQK; ++c) dqw[c * L + l] = acc[c] * scale;
    }
    __syncthreads();

    // B: columns -> dk, dv and this block's dbias partial
    const bool first = j == j0;
    for (int m = threadIdx.x; m < L; m += blockDim.x) {
      float kc[CQK], vc[CV], dka[CQK], dva[CV];
#pragma unroll
      for (int c = 0; c < CQK; ++c) {
        kc[c] = ks[m * CQK + c];
        dka[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        vc[c] = vs[m * CV + c];
        dva[c] = 0.f;
      }
      for (int l = 0; l < L; ++l) {
        const float* ql = qs + l * CQK;
        const float* dl = dos + l * CV;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < CQK; ++c) s = fmaf(ql[c], kc[c], s);
        const float p = expf(s * scale + bh[static_cast<int64_t>(l) * L + m]
                             - rmax[l]) * rinv[l];
        bool keep = true;
        if (DROP) {
          const uint32_t gid = (wid * uL + static_cast<uint32_t>(l)) * uL +
                               static_cast<uint32_t>(m);
          keep = keep_hash(gid, sd) >= thresh;
        }
        float dp = 0.f;
        if (keep) {
          const float wgt = DROP ? p * inv_keep : p;
          float dwv = 0.f;
#pragma unroll
          for (int c = 0; c < CV; ++c) {
            dwv = fmaf(dl[c], vc[c], dwv);
            dva[c] = fmaf(wgt, dl[c], dva[c]);
          }
          dp = DROP ? dwv * inv_keep : dwv;
        }
        const float ds = p * (dp - rdd[l]);
#pragma unroll
        for (int c = 0; c < CQK; ++c) dka[c] = fmaf(ds, ql[c], dka[c]);
        float* pe = pc + static_cast<int64_t>(l) * L + m;
        *pe = first ? ds : *pe + ds;
      }
      float* dkw = dk + w * CQK * L;
      float* dvw = dv + w * CV * L;
#pragma unroll
      for (int c = 0; c < CQK; ++c) dkw[c * L + m] = dka[c] * scale;
#pragma unroll
      for (int c = 0; c < CV; ++c) dvw[c * L + m] = dva[c];
    }
  }
}

// dbias[h][e] = Σ_chunk part[h][chunk][e], chunks in order.
__global__ void dbias_reduce(const float* __restrict__ part,
                             float* __restrict__ dbias, int H, int chunks,
                             int64_t LL) {
  const int64_t n = static_cast<int64_t>(H) * LL;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t h = i / LL, e = i - h * LL;
    const float* p = part + h * chunks * LL + e;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += p[c * LL];
    dbias[i] = s;
  }
}

template <int CQK, int CV, bool DROP>
static cudaError_t launch(const float* q, const float* k, const float* v,
                          const float* bias, const int* seed,
                          const float* dout, float* dq, float* dk, float* dv,
                          float* part, int B, int H, int N, int L, int chunks,
                          float scale, uint32_t thresh, float inv_keep,
                          cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(L) * (2 * CQK + 2 * CV + 3) * sizeof(float);
  cudaError_t err = allow_smem(pwa_attention_bwd_kernel<CQK, CV, DROP>, smem);
  if (err != cudaSuccess) return err;
  const int bn = B * N;
  const int chunk = (bn + chunks - 1) / chunks;
  const int threads = L >= kBwdThreads ? kBwdThreads : ((L + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(H));
  pwa_attention_bwd_kernel<CQK, CV, DROP><<<grid, threads, smem, stream>>>(
      q, k, v, bias, seed, dout, dq, dk, dv, part, H, N, bn, chunk, L, scale,
      thresh, inv_keep);
  return cudaGetLastError();
}

#define VS_CASE(CQ, CVV, DROP)                                             \
  if (Cqk == CQ && Cv == CVV)                                              \
    return launch<CQ, CVV, DROP>(q, k, v, bias, seed, dout, dq, dk, dv,    \
                                 part, B, H, N, L, chunks, scale, thresh,  \
                                 inv_keep, stream);
#define VS_ALL_WIDTHS(DROP)                                                \
  VS_CASE(4, 4, DROP) VS_CASE(4, 8, DROP) VS_CASE(4, 16, DROP)             \
  VS_CASE(4, 32, DROP) VS_CASE(8, 4, DROP) VS_CASE(8, 8, DROP)             \
  VS_CASE(8, 16, DROP) VS_CASE(8, 32, DROP) VS_CASE(16, 4, DROP)           \
  VS_CASE(16, 8, DROP) VS_CASE(16, 16, DROP) VS_CASE(16, 32, DROP)

static cudaError_t launch_widths(const float* q, const float* k,
                                 const float* v, const float* bias,
                                 const int* seed, const float* dout,
                                 float* dq, float* dk, float* dv, float* part,
                                 int B, int H, int N, int Cqk, int Cv, int L,
                                 int chunks, float scale, uint32_t thresh,
                                 float inv_keep, cudaStream_t stream) {
  if (thresh == 0) {
    VS_ALL_WIDTHS(false)
  } else {
    VS_ALL_WIDTHS(true)
  }
  return cudaErrorInvalidValue;
}

// q, k: (B, H, N, Cqk, L); v, dout: (B, H, N, Cv, L); bias: (H, L, L);
// seed: int32 [seed, batch_offset] on the device; dq, dk, dv like q, k, v;
// part: H·chunks·L·L floats of scratch (chunks of the B·N windows of each
// head, 1 <= chunks <= B·N); dbias: (H, L, L). thresh = 0: no dropout.
extern "C" int vs_pwa_attention_train_bwd(
    const float* q, const float* k, const float* v, const float* bias,
    const int* seed, const float* dout, float* dq, float* dk, float* dv,
    float* part, float* dbias, int B, int H, int N, int Cqk, int Cv, int L,
    int chunks, float scale, unsigned int thresh, float inv_keep,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (H == 0 || L == 0) return cudaSuccess;
  if (chunks < 1 || chunks > B * N) return cudaErrorInvalidValue;
  cudaError_t err = launch_widths(q, k, v, bias, seed, dout, dq, dk, dv, part,
                                  B, H, N, Cqk, Cv, L, chunks, scale, thresh,
                                  inv_keep, stream);
  if (err != cudaSuccess) return err;
  const int64_t n = static_cast<int64_t>(H) * L * L;
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  dbias_reduce<<<blocks, threads, 0, stream>>>(part, dbias, H, chunks,
                                               static_cast<int64_t>(L) * L);
  return cudaGetLastError();
}
