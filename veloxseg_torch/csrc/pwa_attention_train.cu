// K1, K2f and K3f: the forward of the paired-window attention, eval (K1)
// and train with counter-hash weight dropout (K2f, K3f), for every window
// length; fp32, and each also for bf16 q, k, v (built with -DVS_BF16).
//
// Replaces: veloxseg_tpu/ops/pwa_attention.py:_attn_kernel (56-74, K1,
// called through window_attention_pallas, 77-133), _train_fwd_kernel
// (322-341, K2f, L <= 512) and _train_fwd_rb_kernel (410-448, K3f,
// L > 512), called through _train_fwd_pallas (572-602). Per (batch, head,
// window), in the (B, h, N, C, L) token layout (q, k: (Cqk, L); v, out:
// (Cv, L); bias: (h, L, L)):
//   out = V · (M ⊙ softmax(scale · QᵀK + bias_h) / (1 − p))ᵀ,
// with the keep mask M = keep_hash(gid, seed) >= thresh over the global id
// gid = (wid·L + row)·L + col, wid = ((offset + b)·h + head)·N + n over
// the TRUE window count N (_train_xla, 666-673), and each row's
// log-sum-exp lse of its logits, which K2b (pwa_attention_bwd.cu) and K3b
// (pwa_attention_long.cu) take with out. K1 is the instance with neither:
// DROP false compiles the hash out, LSE false writes nothing but out.
//
// What bounds it on this card: operations. Per score it costs Cqk + Cv
// FMAs, the hash's ~11 integer instructions (train only), an exp2 and ~5
// more (bias, max, sum, select, rescale); the tokens and the bias are a
// few MB. A design where each thread owns one row and reads each key and
// value as a broadcast is bound instead by shared memory: a 16-byte load
// takes four wavefronts whatever its addresses, so Cqk + Cv wavefronts
// feed only 32 scores. Here each load feeds a register tile:
//   - A block is (row block, head, chunk of that head's windows). It
//     stages its bias rows once in shared memory (cp.async) and reuses
//     them for every window of its chunk; its S·W warps take S slabs of
//     rows of W windows at a time. K1 may instead read the bias through
//     L1 (LDG, for windows of one tile), so that a block waits on no bias
//     rows and holds only its window stages.
//   - A warp's 32 lanes are 8 row groups × 4 column lanes. A lane owns RM
//     rows (4, 2 or 1 by the widths) and, of every step of 32 columns,
//     columns [4x, 4x + 4) and [16 + 4x, 16 + 4x + 4) for lane x: per
//     step 8·RM scores, each 16-byte load of K or V feeding 4·RM FMAs.
//   - K, V (channel-major, 16-byte copies where L % 4 == 0) and each
//     window's q rows stream through two stages of 64 columns by cp.async:
//     the next tile arrives while this one is computed.
//   - q·scale·log2e stays in registers, so logits are in base 2 with one
//     FMA for the bias. Per step a lane takes the max of its 8 logits of
//     a row, rescales its sum and kept-weight accumulator once, and adds
//     ex2 weights (the SFU alone); the hash runs once per score, from a
//     per-row base plus a constant per column; dropped weights are a
//     select. At the end of a window the 4 column lanes of a row merge
//     their (max, sum, accumulator) by xor shuffles.
//   - The geometry (S, W, chunks) comes from the host
//     (ops/pwa_attention.py:train_fwd_launch).
// Ragged L: tokens and bias past L read 0 and the logits there are set to
// −inf in the last step (a select); rows past L compute on zeros and are
// not written. The running max starts at −1e30, not −inf, so that a lane
// with no column inside L (L < 16) merges as zero. Warps of a window slot
// past the chunk compute on stale data and write nothing. Tensor cores are
// not used.
//
// The bf16 forms (T = bf16: the JAX trainer's operands for K2f, the bf16
// eval forward's for K1) are the same kernel:
// q, k and v are converted to fp32 as they are staged (loaded at once, not
// by cp.async, which cannot widen), the scores, the softmax and the kept
// weights' product with V stay fp32 (the weights are not rounded:
// pwa_attention.py:324-341), and the output is rounded once to bf16. It
// also writes the output in fp32 before that rounding (out32), from which
// K2b forms D = rowsum(dO ⊙ out) as the Pallas backward forms it from
// unrounded weights. The bias and lse stay fp32. K1's bf16 form is
// _attn_kernel (56-74) on bf16 operands: fp32 inside, the weights not
// rounded before ·V (window_attention_xla rounds them; the Pallas kernel
// does not), the output rounded once; it writes no out32.
//
// K3f's bf16 form is its own kernel (pwa_attention_long_mma.cu): one pass
// over each window on the bf16 tensor cores; vs_pwa_attention_long_train
// is built for fp32 alone.
#include "common.cuh"

constexpr int kStep = 32;      // columns of one online-softmax step
constexpr int kTile = 64;      // columns of a stage (whole steps)
constexpr int kTX = 4;         // column lanes of a row group
constexpr int kTY = 8;         // row groups of a warp
constexpr int kMaxWarps = 16;  // warps of a block (S·W)
constexpr float kNoMax = -1e30f;
static_assert(kTile == 64, "the stage copies index a tile's row by shifts");

// Rows a lane owns, so that its q, accumulators and logits (RM·(Cqk +
// Cv + 8) floats) leave room in 128 registers: 4 at Cqk + Cv <= 8, 2 up to
// 24, else 1.
__host__ __device__ constexpr int rows_per_lane(int CQK, int CV) {
  return CQK + CV <= 8 ? 4 : CQK + CV <= 24 ? 2 : 1;
}

// Row stride of the staged bias: ⌈L/64⌉·64 + 16/RM, so that the two rows
// that one quarter-warp's 16-byte loads touch lie in other banks.
__host__ __device__ inline int bias_stride(int L, int RM) {
  return (L + kTile - 1) / kTile * kTile + 16 / RM;
}

// Floats one window takes in a stage: a tile of K and V, and the block's
// q rows (channel-major).
__host__ __device__ inline int window_floats(int rows, int CQK, int CV) {
  return kTile * (CQK + CV) + CQK * rows;
}

// Shared memory of a block, in floats (ops/pwa_attention.py:
// _k2f_smem_floats): the bias rows (none with LDG) and two stages of W
// windows.
static size_t fwd_smem_floats(int S, int W, int L, int CQK, int CV,
                              bool ldg) {
  const int RM = rows_per_lane(CQK, CV), rows = S * kTY * RM;
  return (ldg ? 0 : static_cast<size_t>(rows) * bias_stride(L, RM)) +
         2 * static_cast<size_t>(W) * window_floats(rows, CQK, CV);
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error ~2^-22; results
// below 2^-126 flush to 0). Here x <= 0: weights in [0, 1].
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One warp copies a bias row of n floats from src to dst by cp.async, 16
// bytes a copy where `wide`, zero from `valid` on (n and valid multiples of
// 4 when wide).
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n,
                                         int valid, bool wide, int lane) {
  if (wide) {
    for (int i = 4 * lane; i < n; i += 128)
      cp_async_f32x4(dst + i, src + (i < valid ? i : 0), i < valid);
  } else {
    for (int i = lane; i < n; i += 32)
      cp_async_f32(dst + i, src + (i < valid ? i : 0), i < valid);
  }
}

template <typename T, int CQK, int CV, bool DROP, bool LSE, bool LDG>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
pwa_train_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const float* __restrict__ bias,
                     const int* __restrict__ seed, T* __restrict__ out,
                     float* __restrict__ out32, float* __restrict__ lse,
                     int B, int H, int N, int L,
                     int S, int W, int per, float scale, uint32_t thresh,
                     float inv_keep) {
  constexpr int RM = rows_per_lane(CQK, CV);
  extern __shared__ __align__(16) float smem[];
  const int rows = S * kTY * RM, bst = LDG ? 0 : bias_stride(L, RM);
  const int wf = window_floats(rows, CQK, CV);
  float* bs = smem;                 // [rows][bst] bias (none with LDG)
  float* stage = bs + rows * bst;   // 2 × W × [K | V | q]
  const int tid = threadIdx.x, nwarps = blockDim.x >> 5, lane = tid & 31;
  const int warp = tid >> 5, slab = warp % S, wl = warp / S;
  const int tx = lane & (kTX - 1), ty = lane / kTX;
  const int r0 = (slab * kTY + ty) * RM;  // this lane's first row
  const int h = blockIdx.y, l0 = blockIdx.x * rows;
  const int j0 = blockIdx.z * per, j1 = min(B * N, j0 + per);
  const bool wide = (L & 3) == 0;  // rows of q, k, v, bias 16-byte aligned
  const int lb = (L + kTile - 1) / kTile * kTile;
  const float* bh = bias + static_cast<int64_t>(h) * L * L;
  if (!LDG) {  // the bias rows, a warp a row
    for (int r = warp; r < rows; r += nwarps) {
      const bool ok = l0 + r < L;
      copy_row(bs + r * bst, bh + static_cast<int64_t>(ok ? l0 + r : 0) * L,
               lb, ok ? L : 0, wide, lane);
    }
  }
  auto window = [&](int j) {
    const int b = j / N, n = j - b * N;
    return (static_cast<int64_t>(b) * H + h) * N + n;
  };
  const int tiles = lb / kTile;
  const int nstage = (j1 - j0 + W - 1) / W * tiles;
  // Issue the copies of stage `it` (batch it / tiles of W windows, tile
  // it % tiles) that this warp's window slot needs: its window's
  // K and V columns of the tile as [C][64] and, with the window's first
  // stage, its q rows as [Cqk][rows], shared by the slot's S warps.
  auto stage_copy = [&](int it) {
    const int bt = it / tiles, t = it - bt * tiles, m0 = t * kTile;
    const int j = j0 + bt * W + wl;
    if (j >= j1) return;
    const int64_t w = window(j);
    float* buf = stage + ((it & 1) * W + wl) * wf;
    const T* kw = k + w * CQK * L + m0;
    const T* vw = v + w * CV * L + m0;
    const int valid = min(kTile, L - m0);
    const int shift = wide ? 4 : 6;  // log2 of the copies a row
    for (int e = slab * 32 + lane; e < (CQK + CV) << shift; e += S * 32) {
      const int r = e >> shift, col = (e & ((1 << shift) - 1)) << (6 - shift);
      const T* src = r < CQK ? kw + r * L : vw + (r - CQK) * L;
      const bool ok = col < valid;
      if (wide)
        stage4<T>(buf + r * kTile + col, src + (ok ? col : 0), ok);
      else
        stage1<T>(buf + r * kTile + col, src + (ok ? col : 0), ok);
    }
    if (t != 0) return;
    const T* qw = q + w * CQK * L + l0;
    float* qb = buf + kTile * (CQK + CV);
    const int qvalid = min(rows, L - l0), qrow = wide ? rows / 4 : rows;
    for (int e = slab * 32 + lane; e < CQK * qrow; e += S * 32) {
      const int c = e / qrow, r = (e - c * qrow) * (wide ? 4 : 1);
      const bool ok = r < qvalid;
      if (wide)
        stage4<T>(qb + c * rows + r, qw + c * L + (ok ? r : 0), ok);
      else
        stage1<T>(qb + c * rows + r, qw + c * L + (ok ? r : 0), ok);
    }
  };
  if (nstage > 0) stage_copy(0);

  const float sc2 = scale * kLog2e;
  const uint32_t uL = static_cast<uint32_t>(L);
  const uint32_t sd = DROP ? static_cast<uint32_t>(seed[0]) : 0u;
  const uint32_t off = DROP ? static_cast<uint32_t>(seed[1]) : 0u;
  const float keep_scale = DROP ? inv_keep : 1.f;
  float qr[RM][CQK], acc[RM][CV], mx[RM], sum[RM];
  uint32_t hb[RM];
  for (int it = 0; it < nstage; ++it) {
    const int bt = it / tiles, t = it - bt * tiles;
    const int j = j0 + bt * W + wl;  // this warp's window (none past j1)
    cp_async_wait_all();
    __syncthreads();  // this stage is in; the last one is done with the
                      // other buffer
    if (it + 1 < nstage) stage_copy(it + 1);
    const float* ks = stage + ((it & 1) * W + wl) * wf;
    const float* vs = ks + kTile * CQK;
    if (t == 0) {  // a new window: its q rows, fresh statistics
      const float* qs = ks + kTile * (CQK + CV) + r0;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int c = 0; c < CQK; ++c) qr[i][c] = qs[c * rows + i] * sc2;
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[i][c] = 0.f;
        mx[i] = kNoMax;
        sum[i] = 0.f;
      }
      if (DROP) {
        const uint32_t wid =
            static_cast<uint32_t>(j < j1 ? window(j) : 0) +
            off * static_cast<uint32_t>(H) * static_cast<uint32_t>(N);
#pragma unroll
        for (int i = 0; i < RM; ++i)
          hb[i] = ((wid * uL + static_cast<uint32_t>(l0 + r0 + i)) * uL) *
                      kHashGid +
                  sd * kHashSeed;
      }
    }
    // per step of 32 columns, this lane's 8: c0 + {0..3}, c0 + 16 + {0..3}
#pragma unroll 1
    for (int u = 0; u < kTile / kStep; ++u) {
      const int ct = u * kStep + kTX * tx, c0 = t * kTile + ct;
      float s[RM][8];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll
      for (int c = 0; c < CQK; ++c) {
        const float4 ka = lds4(ks + c * kTile + ct);
        const float4 kb = lds4(ks + c * kTile + 16 + ct);
        const float kc[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            s[i][jj] = fmaf(qr[i][c], kc[jj], s[i][jj]);
      }
      const bool ragged = c0 - kTX * tx + kStep > L;  // the same for all
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        float bj[8];
        if (LDG) {  // through L1, row and columns clamped into the head
          const float* brow =
              bh + static_cast<int64_t>(min(l0 + r0 + i, L - 1)) * L;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            bj[jj] = __ldg(brow + min(c0 + (jj < 4 ? jj : 12 + jj), L - 1));
        } else {
          const float* brow = bs + (r0 + i) * bst + c0;
          const float4 ba = lds4(brow), bb = lds4(brow + 16);
          bj[0] = ba.x; bj[1] = ba.y; bj[2] = ba.z; bj[3] = ba.w;
          bj[4] = bb.x; bj[5] = bb.y; bj[6] = bb.z; bj[7] = bb.w;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          s[i][jj] = fmaf(bj[jj], kLog2e, s[i][jj]);
          if (ragged && c0 + (jj < 4 ? jj : 12 + jj) >= L) s[i][jj] = -INFINITY;
        }
        const float tmax = fmaxf(
            fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])),
            fmaxf(fmaxf(s[i][4], s[i][5]), fmaxf(s[i][6], s[i][7])));
        const float mn = fmaxf(mx[i], tmax);
        const float f = fast_exp2(mx[i] - mn);  // 0 at the first tile
        mx[i] = mn;
#pragma unroll
        for (int c = 0; c < CV; ++c) acc[i][c] *= f;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[i][jj] = fast_exp2(s[i][jj] - mn);
        sum[i] = fmaf(sum[i], f,  // the weights; 0 past L
                      ((s[i][0] + s[i][1]) + (s[i][2] + s[i][3])) +
                          ((s[i][4] + s[i][5]) + (s[i][6] + s[i][7])));
        if (DROP) {  // the kept weights
          const uint32_t xb = hb[i] + static_cast<uint32_t>(c0) * kHashGid;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const uint32_t col = jj < 4 ? jj : 12 + jj;
            if (hash_avalanche(xb + col * kHashGid) < thresh) s[i][jj] = 0.f;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const float4 va = lds4(vs + c * kTile + ct);
        const float4 vb = lds4(vs + c * kTile + 16 + ct);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          float a = acc[i][c];
          a = fmaf(s[i][0], va.x, a);
          a = fmaf(s[i][1], va.y, a);
          a = fmaf(s[i][2], va.z, a);
          a = fmaf(s[i][3], va.w, a);
          a = fmaf(s[i][4], vb.x, a);
          a = fmaf(s[i][5], vb.y, a);
          a = fmaf(s[i][6], vb.z, a);
          acc[i][c] = fmaf(s[i][7], vb.w, a);
        }
      }
    }
    if (t + 1 < tiles) continue;
    // the window is done: merge the 4 column lanes of each row (xor 1,
    // then 2), then out = acc·(1/(1 − p))/sum and lse in base e
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float m = mx[i];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float f = fast_exp2(mx[i] - m);
      float tot = sum[i] * f;
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        float a = acc[i][c] * f;
        a += __shfl_xor_sync(0xffffffffu, a, 1);
        a += __shfl_xor_sync(0xffffffffu, a, 2);
        acc[i][c] = a;
      }
      const int l = l0 + r0 + i;
      if (j >= j1 || l >= L) continue;
      const int64_t w = window(j);
      if (LSE && tx == 0) lse[w * L + l] = (m + log2f(tot)) * kLn2;
      const float inv = keep_scale / tot;
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        if ((c & (kTX - 1)) != tx) continue;
        const float o = acc[i][c] * inv;
        out[(w * CV + c) * L + l] = from_f32<T>(o);
        if (!kIsF32<T> && LSE) out32[(w * CV + c) * L + l] = o;
      }
    }
  }
}

template <typename T, int CQK, int CV, bool DROP, bool LSE, bool LDG>
static cudaError_t launch(const T* q, const T* k, const T* v,
                          const float* bias, const int* seed, T* out,
                          float* out32, float* lse, int B, int H, int N,
                          int L, int S, int W, int chunks, int per,
                          float scale, uint32_t thresh, float inv_keep,
                          cudaStream_t stream) {
  auto kernel = pwa_train_fwd_kernel<T, CQK, CV, DROP, LSE, LDG>;
  const size_t smem = fwd_smem_floats(S, W, L, CQK, CV, LDG) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = S * kTY * rows_per_lane(CQK, CV);
  const dim3 grid(static_cast<unsigned>((L + rows - 1) / rows),
                  static_cast<unsigned>(H), static_cast<unsigned>(chunks));
  kernel<<<grid, 32 * S * W, smem, stream>>>(q, k, v, bias, seed, out, out32,
                                             lse, B, H, N, L, S, W, per,
                                             scale, thresh, inv_keep);
  return cudaGetLastError();
}

#define VS_CASE(CQ, CVV)                                                    \
  if (Cqk == CQ && Cv == CVV)                                               \
    return thresh == 0                                                      \
               ? launch<Elem, CQ, CVV, false, true, false>(                 \
                     q, k, v, bias, seed, out, out32, lse, B, H, N, L, S,   \
                     W, chunks, per, scale, thresh, inv_keep, stream)       \
               : launch<Elem, CQ, CVV, true, true, false>(                  \
                     q, k, v, bias, seed, out, out32, lse, B, H, N, L, S,   \
                     W, chunks, per, scale, thresh, inv_keep, stream);

// The checks both entry points share: a launch geometry that covers every
// row and window once, within a block's threads.
static bool geometry_ok(int B, int H, int N, int L, int S, int W, int chunks,
                        int per) {
  const int bn = B * N;
  return H > 0 && L > 0 && bn > 0 && S >= 1 && W >= 1 &&
         S * W <= kMaxWarps && chunks >= 1 && per >= 1 &&
         static_cast<int64_t>(chunks - 1) * per < bn &&
         static_cast<int64_t>(chunks) * per >= bn;
}

// q, k: (B, H, N, Cqk, L); v, out: (B, H, N, Cv, L), Elem; bias: (H, L,
// L), float; seed: int32 [seed, batch_offset] on the device; thresh = 0: no
// dropout (the instance without the hash); out32: the output in fp32
// before its rounding to Elem (written by the bf16 form only); lse: (B, H,
// N, L), each row's log-sum-exp of its logits. Geometry
// (ops/pwa_attention.py: train_fwd_launch): blocks of S·8·RM rows and S·W
// warps, `chunks` chunks of `per` windows of each head.
//
// K2f: every (Cqk, Cv) of KERNEL_WIDTHS, fp32 and bf16.
extern "C" int vs_pwa_attention_train(
    const Elem* q, const Elem* k, const Elem* v, const float* bias,
    const int* seed, Elem* out, float* out32, float* lse, int B, int H,
    int N, int Cqk, int Cv, int L, int S, int W, int chunks, int per,
    float scale, unsigned int thresh, float inv_keep, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, H, N, L, S, W, chunks, per))
    return cudaErrorInvalidValue;
  VS_CASE(4, 4) VS_CASE(4, 8) VS_CASE(4, 16) VS_CASE(4, 32)
  VS_CASE(8, 4) VS_CASE(8, 8) VS_CASE(8, 16) VS_CASE(8, 32)
  VS_CASE(16, 4) VS_CASE(16, 8) VS_CASE(16, 16) VS_CASE(16, 32)
  return cudaErrorInvalidValue;
}

#define VS_EVAL_CASE(CQ, CVV)                                               \
  if (Cqk == CQ && Cv == CVV)                                               \
    return ldg ? launch<Elem, CQ, CVV, false, false, true>(                 \
                     q, k, v, bias, nullptr, out, nullptr, nullptr, B, H,   \
                     N, L, S, W, chunks, per, scale, 0u, 1.f, stream)       \
               : launch<Elem, CQ, CVV, false, false, false>(                \
                     q, k, v, bias, nullptr, out, nullptr, nullptr, B, H,   \
                     N, L, S, W, chunks, per, scale, 0u, 1.f, stream);

// K1: the eval instance, every (Cqk, Cv) of KERNEL_WIDTHS at every L, fp32
// and bf16 (q, k, v and out of Elem; bias float): no dropout, no lse; the
// geometry as above (ops/pwa_attention.py: eval_fwd_launch), ldg != 0: the
// bias read through L1, not staged.
extern "C" int vs_pwa_attention(const Elem* q, const Elem* k, const Elem* v,
                                const float* bias, Elem* out, int B, int H,
                                int N, int Cqk, int Cv, int L, int S, int W,
                                int chunks, int per, int ldg, float scale,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, H, N, L, S, W, chunks, per))
    return cudaErrorInvalidValue;
  VS_EVAL_CASE(4, 4) VS_EVAL_CASE(4, 8) VS_EVAL_CASE(4, 16)
  VS_EVAL_CASE(4, 32) VS_EVAL_CASE(8, 4) VS_EVAL_CASE(8, 8)
  VS_EVAL_CASE(8, 16) VS_EVAL_CASE(8, 32) VS_EVAL_CASE(16, 4)
  VS_EVAL_CASE(16, 8) VS_EVAL_CASE(16, 16) VS_EVAL_CASE(16, 32)
  return cudaErrorInvalidValue;
}

#ifndef VS_BF16
// K3f: the same kernel for windows longer than 512 tokens, at the widths
// K3b is built for (LONG_KERNEL_WIDTHS: (8, 8)); fp32 (the bf16 form is
// pwa_attention_long_mma.cu).
extern "C" int vs_pwa_attention_long_train(
    const Elem* q, const Elem* k, const Elem* v, const float* bias,
    const int* seed, Elem* out, float* out32, float* lse, int B, int H,
    int N, int Cqk, int Cv, int L, int S, int W, int chunks, int per,
    float scale, unsigned int thresh, float inv_keep, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!geometry_ok(B, H, N, L, S, W, chunks, per))
    return cudaErrorInvalidValue;
  VS_CASE(8, 8)
  return cudaErrorInvalidValue;
}
#endif
