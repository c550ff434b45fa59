// K1: eval paired-window attention, and K2f: train paired-window attention
// with counter-hash weight dropout; fp32.
//
// Replaces: veloxseg_tpu/ops/pwa_attention.py:_attn_kernel (56-74), called
// through window_attention_pallas (77-133), and _train_fwd_kernel
// (322-342), called through _train_fwd_pallas (572-602). For every
// (batch, head, window) it computes out = V · softmax(scale · Qᵀ K +
// bias_h)ᵀ over the L tokens of the window, in the (B, h, N, C, L) token
// layout: q, k are (Cqk, L) and v, out (Cv, L) per window; bias is
// (h, L, L). K2f keeps each weight where keep_hash(gid, seed) >= thresh
// and scales it by 1/(1 − p), else drops it; gid = (wid·L + row)·L + col
// with wid = ((offset + b)·h + head)·N + n over the TRUE window count N
// (_train_xla, 666-673), so the mask does not depend on any blocking.
//
// What bounds it on this card: the L×L scores. At the AutoPET 96³ shapes
// (L = 54 and 432, Cqk <= 16, Cv <= 32) the function is a few hundred MFLOP
// per call and moves q, k, v, out once (a few MB), so the work is small
// either way; what a naive version would add is the (B, h, N, L, L) score
// and weight tensors in HBM (the plain version writes both). This kernel
// keeps scores out of HBM: one block per (window, block of query rows)
// stages the window's K and V in shared memory ([L][C], so each step reads
// one token's channels as a broadcast), and each thread owns one query row
// with q in registers. The row's scores are recomputed in a second pass
// instead of stored (an L = 432 row does not fit registers and a full L×L
// tile does not fit shared memory), so the softmax is exact (max pass,
// then exp-sum-and-accumulate pass) and never touches HBM. The dropout
// hash costs ~14 integer operations per score, in the second pass only.
// The bias row is read from global memory (L1/L2-resident: one head is
// 746 KB at L = 432) and not staged. Reads of q and writes of out are
// coalesced across the threads of a warp (consecutive query rows). Ragged
// N needs no padding: the grid has exactly B·h·N windows. Tensor cores are
// not used (wgmma and TMA come later).
#include "common.cuh"

template <int CQK, int CV, bool DROP>
__global__ void __launch_bounds__(128)
pwa_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ bias,
                     const int* __restrict__ seed, float* __restrict__ out,
                     int H, int N, int L, float scale, uint32_t thresh,
                     float inv_keep) {
  extern __shared__ float smem[];
  float* ks = smem;                // [L][CQK]
  float* vs = smem + L * CQK;      // [L][CV]
  const int64_t w = blockIdx.x;    // window id over (b, h, n)
  const int h = static_cast<int>((w / N) % H);
  const float* qw = q + w * CQK * L;
  const float* kw = k + w * CQK * L;
  const float* vw = v + w * CV * L;
  float* ow = out + w * CV * L;

  for (int i = threadIdx.x; i < CQK * L; i += blockDim.x) {
    const int c = i / L, m = i - c * L;
    ks[m * CQK + c] = kw[i];
  }
  for (int i = threadIdx.x; i < CV * L; i += blockDim.x) {
    const int c = i / L, m = i - c * L;
    vs[m * CV + c] = vw[i];
  }
  __syncthreads();

  const int l = blockIdx.y * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float qr[CQK];
#pragma unroll
  for (int c = 0; c < CQK; ++c) qr[c] = qw[c * L + l];
  const float* brow = bias + (static_cast<int64_t>(h) * L + l) * L;

  float mx = -INFINITY;
  for (int m = 0; m < L; ++m) {
    const float* km = ks + m * CQK;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CQK; ++c) s = fmaf(qr[c], km[c], s);
    mx = fmaxf(mx, s * scale + brow[m]);
  }

  uint32_t sd = 0, rowbase = 0;
  if (DROP) {
    sd = static_cast<uint32_t>(seed[0]);
    // global window id: this block's window, shifted by the batch offset
    const uint32_t wid = static_cast<uint32_t>(w) +
                         static_cast<uint32_t>(seed[1]) *
                             static_cast<uint32_t>(H) *
                             static_cast<uint32_t>(N);
    rowbase = (wid * static_cast<uint32_t>(L) + static_cast<uint32_t>(l)) *
              static_cast<uint32_t>(L);
  }
  float sum = 0.f;
  float acc[CV];
#pragma unroll
  for (int c = 0; c < CV; ++c) acc[c] = 0.f;
  for (int m = 0; m < L; ++m) {
    const float* km = ks + m * CQK;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CQK; ++c) s = fmaf(qr[c], km[c], s);
    const float p = expf(s * scale + brow[m] - mx);
    sum += p;
    if (DROP && keep_hash(rowbase + static_cast<uint32_t>(m), sd) < thresh)
      continue;
    const float* vm = vs + m * CV;
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[c] = fmaf(p, vm[c], acc[c]);
  }
  const float inv = (DROP ? inv_keep : 1.f) / sum;
#pragma unroll
  for (int c = 0; c < CV; ++c) ow[c * L + l] = acc[c] * inv;
}

template <int CQK, int CV, bool DROP>
static cudaError_t launch(const float* q, const float* k, const float* v,
                          const float* bias, const int* seed, float* out,
                          int B, int H, int N, int L, float scale,
                          uint32_t thresh, float inv_keep,
                          cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(L) * (CQK + CV) * sizeof(float);
  cudaError_t err = allow_smem(pwa_attention_kernel<CQK, CV, DROP>, smem);
  if (err != cudaSuccess) return err;
  const int threads = L >= 128 ? 128 : ((L + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(B) * H * N, (L + threads - 1) / threads);
  pwa_attention_kernel<CQK, CV, DROP><<<grid, threads, smem, stream>>>(
      q, k, v, bias, seed, out, H, N, L, scale, thresh, inv_keep);
  return cudaGetLastError();
}

#define VS_CASE(CQ, CVV, DROP)                                             \
  if (Cqk == CQ && Cv == CVV)                                              \
    return launch<CQ, CVV, DROP>(q, k, v, bias, seed, out, B, H, N, L,     \
                                 scale, thresh, inv_keep, stream);
#define VS_ALL_WIDTHS(DROP)                                                \
  VS_CASE(4, 4, DROP) VS_CASE(4, 8, DROP) VS_CASE(4, 16, DROP)             \
  VS_CASE(4, 32, DROP) VS_CASE(8, 4, DROP) VS_CASE(8, 8, DROP)             \
  VS_CASE(8, 16, DROP) VS_CASE(8, 32, DROP) VS_CASE(16, 4, DROP)           \
  VS_CASE(16, 8, DROP) VS_CASE(16, 16, DROP) VS_CASE(16, 32, DROP)

// K1.
extern "C" int vs_pwa_attention(const float* q, const float* k,
                                const float* v, const float* bias, float* out,
                                int B, int H, int N, int Cqk, int Cv, int L,
                                float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B * H * N == 0 || L == 0) return cudaSuccess;
  const int* seed = nullptr;
  const uint32_t thresh = 0;
  const float inv_keep = 1.f;
  VS_ALL_WIDTHS(false)
  return cudaErrorInvalidValue;
}

// K2f. seed: int32 [seed, batch_offset] on the device; thresh = 0 means
// no dropout (every hash is >= 0), which takes the instance without it.
extern "C" int vs_pwa_attention_train(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      const int* seed, float* out, int B,
                                      int H, int N, int Cqk, int Cv, int L,
                                      float scale, unsigned int thresh,
                                      float inv_keep, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B * H * N == 0 || L == 0) return cudaSuccess;
  if (thresh == 0) {
    VS_ALL_WIDTHS(false)
  } else {
    VS_ALL_WIDTHS(true)
  }
  return cudaErrorInvalidValue;
}
