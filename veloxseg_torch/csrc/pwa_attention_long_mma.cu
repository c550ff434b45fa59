// K3f's bf16 form: the train forward of the paired-window attention for
// windows longer than 512 tokens on bf16 q, k, v, one pass over each
// window, its products on the bf16 tensor cores (mma.sync). Built for bf16
// alone (-DVS_BF16); K3f's fp32 form is pwa_attention_train.cu's kernel.
//
// Replaces: veloxseg_tpu/ops/pwa_attention.py:_train_fwd_rb_kernel
// (410-448, called through _train_fwd_pallas, 572-602) on bf16 operands.
// Per (batch, head, window), in the (B, h, N, C, L) token layout (q, k:
// (8, L); v, out: (8, L); bias: (h, L, L) fp32):
//   W   = M ⊙ softmax(scale · QᵀK + bias_h) / (1 − p)
//   out = bf16(bf16(W) · Vᵀ)   (the product in fp32: _train_fwd_rb_kernel
//                               rounds the kept weights before ·V, 434-447)
// with the keep mask M of _train_xla (666-673) over the true window count
// (common.cuh:keep_hash, as pwa_attention_train.cu), each row's
// log-sum-exp lse, and out32 = W · Vᵀ of the unrounded weights in fp32,
// from which K3b forms D = rowsum(dO ⊙ out32) as the Pallas backward forms
// Σ P·dP (511-517).
//
// What bounds it on this card: operations. Per score 16 bf16 MACs on the
// tensor cores and ~25 fp32 and integer instructions (the logit, max, exp2,
// sum, the hash's ~11, the select, the weight's two roundings); the tokens
// and the bias are a few MB. A weight can be rounded only once its row's
// max and sum are known (bf16(e·c) is not bf16(e)·c), so the fp32 kernel's
// online softmax would take two passes over the window. Here a block holds
// a row's whole set of logits instead, as the Pallas kernel does:
//   - A block is (16 query rows, head, chunk of that head's windows); its
//     ⌈L/64⌉ warps each own 64 columns, so 16 × 1024 logits are 32 fp32
//     registers a lane (the mma accumulators of 8 n8 tiles). It stages its
//     bias rows once (cp.async) and walks the windows of its chunk.
//   - K and V (channel-major, raw bf16) and the block's q rows stream
//     through two stages by cp.async of 16 bytes, zero past L: the next
//     window arrives while this one is computed. Ragged L (not a multiple
//     of 8) stages by plain loads.
//   - S = QᵀK: mma m16n8k8 on q (the A operand, 16 rows × 8 channels) and
//     K (ldmatrix .trans from the [channel][column] stage). Products of
//     bf16 values are exact in fp32, as in the Pallas dot_general with
//     preferred_element_type f32; the logit in base 2 is one FMA of the
//     fp32 sum, scale·log2e and the bias row, which the block stages once
//     and multiplies by log2e (−inf past L, so that no score is tested).
//   - Each warp takes the max of its columns of a row (the quad's 4 lanes
//     by xor shuffles), 2^(logit − that max) and their sum over every
//     column, then sets the dropped weights to 0 (the hash once a score):
//     the SFU, the fp32 and the integer pipes work in one pass. The warps'
//     max and sum meet in shared memory behind one barrier and are merged
//     in a fixed order (the sums rescaled to the row's max); every warp
//     forms the same row max and sum.
//   - W = 2^(logit − max)·((1/(1 − p))/sum) of the kept weights, rounded
//     to bf16: hi = bf16(W), lo = bf16(W − hi). The
//     accumulators of two n8 tiles are the A operand of an m16n8k16
//     product with V (ldmatrix from the [channel][column] stage): out sums
//     hi·V, and out32 = hi·V + lo·V, the unrounded weights to 2^-17 of each
//     weight, on the tensor cores too (fp32 FMAs would cost 8 a score).
//   - The warps' partial products are added over the warps in a fixed
//     order, behind the next window's barriers (two buffers): two barriers
//     a window in all. No atomics: out, out32 and lse repeat bit for bit.
// Ragged L: tokens past L read 0 and the staged bias there is −inf, so the
// logits there are −inf; rows past L compute on zeros and are not written.
// Window ids advance by increments (no division a window), and each thread
// keeps its copy offsets. L up to 1024 (16 warps): a longer window's
// logits do not fit the registers of one block.
#include "mma.cuh"

constexpr int kRows = 16;       // query rows of a block (one m16 tile)
constexpr int kTiles = 8;       // n8 tiles of a warp
constexpr int kCols = 8 * kTiles;  // columns of a warp
constexpr int kMaxWarps = 16;   // warps of a block: L <= 1024
constexpr int kC = 8;           // Cqk = Cv (LONG_KERNEL_WIDTHS)

// Shared memory of a block in bytes (ops/pwa_attention.py:
// _k3f_mma_smem_bytes): the bias rows ([16][lp + 8] fp32), two stages of
// K and V ([8][lp + 8] bf16 each) and q ([8][16] bf16), the row max and sum
// per warp ([16][16] fp32 each), the warps' partial products
// ([warps][16][8] fp32, hi and lo, for two windows). lp = 64 × warps; the row strides of 8
// elements past lp put the rows that one ldmatrix or float2 load touches in
// other banks.
__host__ __device__ inline int mma_stride(int warps) {
  return warps * kCols + 8;
}
__host__ __device__ inline size_t long_mma_smem_bytes(int warps) {
  const int st = mma_stride(warps);
  return 4 * static_cast<size_t>(kRows) * st +
         2 * (2 * static_cast<size_t>(2 * kC) * st + 2 * kC * kRows) +
         4 * 2 * kRows * kMaxWarps + 4 * 4 * static_cast<size_t>(warps) *
                                         kRows * kC;
}

// 2^x by the SFU alone (ex2.approx.ftz); here x <= 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool DROP>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
pwa_long_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const float* __restrict__ bias,
                        const int* __restrict__ seed,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ out32, float* __restrict__ lse,
                        int B, int H, int N, int L, int per, float scale,
                        uint32_t thresh, float inv_keep) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = blockDim.x >> 5, st = mma_stride(nw), lp = nw * kCols;
  float* bs = reinterpret_cast<float*>(smem_raw);       // [16][st]
  bf16* stage = reinterpret_cast<bf16*>(bs + kRows * st);
  const int sst = 2 * kC * st + kC * kRows;             // a stage, bf16
  float* red_max = reinterpret_cast<float*>(stage + 2 * sst);  // [16][16]
  float* red_sum = red_max + kRows * kMaxWarps;                // [16][16]
  float* red_hi = red_sum + kRows * kMaxWarps;   // 2 × [warps][16][8]
  float* red_lo = red_hi + 2 * nw * kRows * kC;  // 2 × [warps][16][8]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, l0 = blockIdx.x * kRows;
  const int j0 = blockIdx.z * per, j1 = min(B * N, j0 + per);
  if (j0 >= j1) return;
  const bool wide = (L & 7) == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v);
  const float* bh = bias + static_cast<int64_t>(h) * L * L;

  // the bias rows, once (16-byte copies where L % 4 == 0); zero past L
  {
    const bool bwide = (L & 3) == 0 && aligned16(bias);
    for (int r = warp; r < kRows; r += nw) {
      const int l = l0 + r;
      const float* src = bh + static_cast<int64_t>(l < L ? l : 0) * L;
      float* dst = bs + r * st;
      if (bwide) {
        for (int i = 4 * lane; i < lp; i += 128)
          cp_async_f32x4(dst + i, src + (i < L ? i : 0), l < L && i < L);
      } else {
        for (int i = lane; i < lp; i += 32)
          cp_async_f32(dst + i, src + (i < L ? i : 0), l < L && i < L);
      }
    }
  }
  // the merge slots of warps past the block's: max −inf, sum 0
  for (int i = tid; i < kRows * kMaxWarps; i += blockDim.x) {
    if (i % kMaxWarps >= nw) {
      red_max[i] = -INFINITY;
      red_sum[i] = 0.f;
    }
  }
  // window j's id (b·H + h)·N + n, kept by increments: no division in
  // the loop
  auto window_at = [&](int b, int n) {
    return (static_cast<int64_t>(b) * H + h) * N + n;
  };
  auto next = [&](int& b, int& n) {
    if (++n == N) {
      n = 0;
      ++b;
    }
  };
  // this thread's copies of a window (16-byte path): K and V rows r0 + 4u
  // (u < 4) at column cc of every stage row (lp / 8 = 8·warps copies a row,
  // 4 rows a pass of 32·warps threads)
  const int chunks = lp / 8, r0 = tid / chunks, cc = (tid - r0 * chunks) * 8;
  const bool cc_ok = cc < L;
  // the copies of window w into stage `buf`: K and V as [16][st] (K rows
  // 0-7, V rows 8-15), q as [8][16]
  auto stage_copy = [&](int64_t w, int buf) {
    bf16* kv = stage + buf * sst;
    bf16* qs = kv + 2 * kC * st;
    const bf16* kw = k + w * kC * L;
    const bf16* vw = v + w * kC * L;
    const bf16* qw = q + w * kC * L + l0;
    if (wide) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + 4 * u;
        const bf16* src = r < kC ? kw + r * L : vw + (r - kC) * L;
        cp_async16(kv + r * st + cc, src + (cc_ok ? cc : 0), cc_ok);
      }
      if (tid < 2 * kC) {  // q: two copies of 8 rows a channel
        const int c = tid >> 1, r = (tid & 1) * 8;
        const bool ok = l0 + r < L;
        cp_async16(qs + c * kRows + r, qw + c * L + (ok ? r : 0), ok);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int e = tid; e < 2 * kC * lp; e += blockDim.x) {
        const int r = e / lp, col = e - r * lp;
        const bf16* src = r < kC ? kw + r * L : vw + (r - kC) * L;
        kv[r * st + col] = col < L ? src[col] : zero;
      }
      if (tid < kC * kRows) {
        const int c = tid / kRows, r = tid - c * kRows;
        qs[c * kRows + r] = l0 + r < L ? qw[c * L + r] : zero;
      }
    }
  };
  int jb = j0 / N, jn = j0 - jb * N;  // window j's sample and window
  int64_t w = window_at(jb, jn), w_prev = 0;
  stage_copy(w, 0);
  // the bias rows in base 2 (·log2e), −inf past L: the logits past L come
  // out −inf with no test a score (K is 0 there)
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < kRows * lp; i += blockDim.x) {
    const int r = i / lp, c = i - r * lp;
    float* b = bs + r * st + c;
    *b = c < L ? *b * kLog2e : -INFINITY;
  }

  const float sc2 = scale * kLog2e;
  const uint32_t uL = static_cast<uint32_t>(L);
  const uint32_t sd = DROP ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t off = DROP ? static_cast<uint32_t>(seed[1]) : 0u;
  const float keep_scale = DROP ? inv_keep : 1.f;
  const int col0 = warp * kCols;       // this warp's first column
  const uint32_t wid0 = off * static_cast<uint32_t>(H) *
                        static_cast<uint32_t>(N);
  // window wf's out and out32 from its warps' products (buffer `rb` of
  // two), added in warp order: out = bf16(Σ hi·V), out32 = Σ hi·V + Σ lo·V
  auto finish = [&](int64_t wf, int rb) {
    if (tid >= kRows * kC) return;
    const float* rh = red_hi + rb * nw * kRows * kC;
    const float* rl = red_lo + rb * nw * kRows * kC;
    const int r = tid & (kRows - 1), c = tid >> 4, l = l0 + r;
    float a = 0.f, b = 0.f;
    for (int u = 0; u < nw; ++u) {
      a += rh[(u * kRows + r) * kC + c];
      b += rl[(u * kRows + r) * kC + c];
    }
    if (l < L) {
      out[(wf * kC + c) * L + l] = __float2bfloat16_rn(a);
      out32[(wf * kC + c) * L + l] = a + b;
    }
  };
  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    cp_async_wait_all();
    __syncthreads();  // window j is in; every warp is done with window j − 1
    int nb = jb, nn = jn;
    next(nb, nn);
    if (j + 1 < j1) stage_copy(window_at(nb, nn), buf ^ 1);
    const bf16* kv = stage + buf * sst;
    const bf16* qs = kv + 2 * kC * st;
    // q as the A operand: rows g, g + 8; channels 2t, 2t + 1
    const auto qpair = [&](int r) {
      return static_cast<uint32_t>(
                 __bfloat16_as_ushort(qs[(2 * t) * kRows + r])) |
             (static_cast<uint32_t>(
                  __bfloat16_as_ushort(qs[(2 * t + 1) * kRows + r]))
              << 16);
    };
    const uint32_t qa0 = qpair(g), qa1 = qpair(g + 8);
    // S = QᵀK over this warp's 64 columns
    float s[kTiles][4];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < kTiles / 4; ++i4) {
      uint32_t kb[4];
      ldsm_x4_trans(kb, kv + (lane & 7) * st + col0 + 32 * i4 +
                            8 * (lane >> 3));
#pragma unroll
      for (int u = 0; u < 4; ++u) mma_k8(s[4 * i4 + u], qa0, qa1, kb[u]);
    }
    // logits in base 2 (−inf past L: the bias there); the row max of this
    // warp's columns
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kTiles; ++i) {
      const int c = col0 + 8 * i + 2 * t;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bs + (g + 8 * hr) * st + c);
        const float x0 = fmaf(s[i][2 * hr], sc2, bv.x);
        const float x1 = fmaf(s[i][2 * hr + 1], sc2, bv.y);
        s[i][2 * hr] = x0;
        s[i][2 * hr + 1] = x1;
        mx[hr] = fmaxf(mx[hr], fmaxf(x0, x1));
      }
    }
    // 2^(logit − the warp's max), their row sums over every column, then
    // the dropped weights set to 0 (the hash once a score)
    float sm[2] = {0.f, 0.f};
    uint32_t hc[2] = {0u, 0u};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      if (DROP)
        hc[hr] = ((static_cast<uint32_t>(w) + wid0) * uL +
                  static_cast<uint32_t>(l0 + g + 8 * hr)) *
                     uL * kHashGid +
                 sd * kHashSeed +
                 static_cast<uint32_t>(col0 + 2 * t) * kHashGid;
    }
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = fast_exp2(s[i][e] - mx[hr]);
        sm[hr] += p;
        s[i][e] = p;
        if (DROP) {
          const uint32_t x = hc[hr] + static_cast<uint32_t>(8 * i + (e & 1)) *
                                          kHashGid;
          if (hash_avalanche(x) < thresh) s[i][e] = 0.f;
        }
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sm[hr] += __shfl_xor_sync(0xffffffffu, sm[hr], 1);
      sm[hr] += __shfl_xor_sync(0xffffffffu, sm[hr], 2);
      if (t == 0) {
        red_max[(g + 8 * hr) * kMaxWarps + warp] = mx[hr];
        red_sum[(g + 8 * hr) * kMaxWarps + warp] = sm[hr];
      }
    }
    __syncthreads();
    // the row's max and sum over the warps, in a fixed order: lane t of a
    // quad takes warps 4t to 4t + 3, the quad adds by xor shuffles; every
    // warp forms the same values. This warp's weights are scaled by
    // 2^(its max − the max)·(1/(1 − p))/sum.
    float wsc[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = g + 8 * hr;
      const float4 m4 =
          *reinterpret_cast<const float4*>(red_max + row * kMaxWarps + 4 * t);
      const float4 s4 =
          *reinterpret_cast<const float4*>(red_sum + row * kMaxWarps + 4 * t);
      float m = fmaxf(fmaxf(m4.x, m4.y), fmaxf(m4.z, m4.w));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float tot = s4.x * fast_exp2(m4.x - m);
      tot += s4.y * fast_exp2(m4.y - m);
      tot += s4.z * fast_exp2(m4.z - m);
      tot += s4.w * fast_exp2(m4.w - m);
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
      wsc[hr] = fast_exp2(mx[hr] - m) * (keep_scale / tot);
      const int l = l0 + row;
      if (warp == 0 && t == 0 && l < L)
        lse[w * L + l] = (m + log2f(tot)) * kLn2;
    }
    if (j > j0) finish(w_prev, buf ^ 1);  // window j − 1's products are in
    // the kept weights, rounded (hi) and their remainder (lo), times V
    float acc_hi[4] = {0.f, 0.f, 0.f, 0.f}, acc_lo[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* vs = kv + kC * st;
#pragma unroll
    for (int i2 = 0; i2 < kTiles / 4; ++i2) {
      uint32_t vb[4];
      ldsm_x4(vb, vs + (lane & 7) * st + col0 + 32 * i2 + 8 * (lane >> 3));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {      // the n8 tiles of this k16 step
          const int i = 4 * i2 + 2 * kk + u;
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {  // rows g, g + 8
            const float w0 = s[i][2 * hr] * wsc[hr];
            const float w1 = s[i][2 * hr + 1] * wsc[hr];
            const uint32_t hi = pack_bf16(w0, w1);
            ahi[2 * u + hr] = hi;
            alo[2 * u + hr] = pack_bf16(w0 - bf16_lo(hi), w1 - bf16_hi(hi));
          }
        }
        mma_k16(acc_hi, ahi, vb[2 * kk], vb[2 * kk + 1]);
        mma_k16(acc_lo, alo, vb[2 * kk], vb[2 * kk + 1]);
      }
    }
    float* rh = red_hi + buf * nw * kRows * kC;
    float* rl = red_lo + buf * nw * kRows * kC;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int o = (warp * kRows + g + 8 * hr) * kC + 2 * t;
      *reinterpret_cast<float2*>(rh + o) =
          make_float2(acc_hi[2 * hr], acc_hi[2 * hr + 1]);
      *reinterpret_cast<float2*>(rl + o) =
          make_float2(acc_lo[2 * hr], acc_lo[2 * hr + 1]);
    }
    w_prev = w;
    w = window_at(nb, nn);
    jb = nb;
    jn = nn;
  }
  __syncthreads();
  finish(w_prev, (j1 - 1 - j0) & 1);
}

// K3f's bf16 form. q, k: (B, H, N, 8, L); v, out: (B, H, N, 8, L), bf16;
// bias: (H, L, L) fp32; seed: int32 [seed, batch_offset] on the device;
// thresh = 0: no dropout; out32: the product of the unrounded weights, fp32;
// lse: (B, H, N, L). Geometry (ops/pwa_attention.py: long_mma_launch):
// blocks of 16 rows and ⌈L/64⌉ warps, `chunks` chunks of `per` windows of
// each head. 512 < L <= 1024 on the main path; any L up to 1024 is taken.
extern "C" int vs_pwa_attention_long_train_mma(
    const Elem* q, const Elem* k, const Elem* v, const float* bias,
    const int* seed, Elem* out, float* out32, float* lse, int B, int H,
    int N, int Cqk, int Cv, int L, int chunks, int per, float scale,
    unsigned int thresh, float inv_keep, void* stream_ptr) {
  static_assert(!kIsF32<Elem>, "K3f's mma form is built for bf16 alone");
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int bn = B * N, warps = (L + kCols - 1) / kCols;
  if (Cqk != kC || Cv != kC || H <= 0 || L <= 0 || warps > kMaxWarps ||
      bn <= 0 || chunks < 1 || per < 1 ||
      static_cast<int64_t>(chunks - 1) * per >= bn ||
      static_cast<int64_t>(chunks) * per < bn)
    return cudaErrorInvalidValue;
  const size_t smem = long_mma_smem_bytes(warps);
  const dim3 grid(static_cast<unsigned>((L + kRows - 1) / kRows),
                  static_cast<unsigned>(H), static_cast<unsigned>(chunks));
  cudaError_t err;
  if (thresh == 0) {
    err = allow_smem(pwa_long_fwd_mma_kernel<false>, smem);
    if (err != cudaSuccess) return err;
    pwa_long_fwd_mma_kernel<false><<<grid, 32 * warps, smem, stream>>>(
        q, k, v, bias, seed, out, out32, lse, B, H, N, L, per, scale, thresh,
        inv_keep);
  } else {
    err = allow_smem(pwa_long_fwd_mma_kernel<true>, smem);
    if (err != cudaSuccess) return err;
    pwa_long_fwd_mma_kernel<true><<<grid, 32 * warps, smem, stream>>>(
        q, k, v, bias, seed, out, out32, lse, B, H, N, L, per, scale, thresh,
        inv_keep);
  }
  return cudaGetLastError();
}
