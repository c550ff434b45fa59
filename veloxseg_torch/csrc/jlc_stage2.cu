// K5f and K5b: JLC stage 2 forward and backward, channels-first
// (B, C, D, H, W); fp32, and bf16 where built with -DVS_BF16.
//
//   out = out1 + W2 · GELU(W1 · InstanceNorm(out1) + b1) + b2
//
// Replaces: veloxseg_tpu/ops/fused_jlc.py:_k2_kernel (177-192), called
// through _k2_fwd (297-312). Two launches, three where the hidden
// dimension is split:
//   1. plane_stats_kernel (common.cuh): deterministic per-(b, c) mean and
//      rstd of out1 (eps 1e-5, max(var, 0)), sums in double in a fixed
//      order; K5b takes them.
//   2. jlc_stage2_mlp: the channel MLP on tiles of VT voxels of the
//      flattened (b, voxel) index (a tile may span samples: the plane
//      statistics are a per-(b, c) lookup), VT·C = 4096 floats (VT 32 to
//      256). Block (k, s) walks a contiguous range of tiles with hidden
//      slice s (E·C split in `slices` parts of HS rows where W1 and W2 do
//      not fit a block, or where too few tiles would leave SMs idle); it
//      stages W1ᵀ and W2ᵀ of its slice once, the next tile's out1 arrives by
//      cp.async while one is computed. Per tile: ẑ = IN(out1) in shared
//      memory as [C][VT + 4]; h = GELU(W1·ẑ + b1) in 4 hidden × 4 voxel
//      register tiles, then W2·h in 4 channel × 4 voxel tiles, each float4
//      shared-memory load feeding 4 FMAs. With one slice it writes out =
//      out1 + (W2·h + b2); with more each slice writes its part of W2·h.
//   3. jlc_stage2_sum (slices > 1 only): out = out1 + (Σ_s part_s + b2), the
//      slices added in order.
// No float atomics: the output and the statistics repeat bit for bit.
//
// What bounds it on this card: operations and bytes about equally. It does
// 4·C·E·C FLOP per voxel (E = 2..3) on the fp32 FMA pipes and reads out1
// once and writes out once (the stats pass reads out1 a second time): at
// the flagship's level 0 (B 16, C 16, 32³) 1.6 GFLOP on 67 MB. The matrix
// products stay in this kernel, as they were inside the TPU kernel's body.
//
// K5b replaces veloxseg_tpu/ops/fused_jlc.py:_k2_bwd_kernel (194-245),
// called through _k2_bwd (315-343). Given g, the cotangent of out, it
// recomputes ŷ = IN(out1), z1p = W1·ŷ + b1 and z1 = GELU(z1p), then
//   db2 = Σ g,  dW2 = Σ g·z1ᵀ,  dz1 = (W2ᵀ g) ⊙ GELU'(z1p),  db1 = Σ dz1,
//   dW1 = Σ dz1·ŷᵀ,  dz = W1ᵀ dz1,
//   dx = g + rstd·(dz − mean(dz) − ŷ·mean(dz·ŷ)),
// sums over batch and voxels. The plane statistics are K5f's (the stage
// Function keeps them). Two launches:
//   1. jlc_mlp_bwd_tiles: the weight gradients as split-K products over
//      voxels. Block (k, s) walks a contiguous range of (b, 64-voxel tile)
//      units with hidden slice s (E·C split in `slices` parts of HS rows
//      where W1, W2 and the tiles would not fit one block: eight slices of
//      32 at 128 channels, two of 64 at 64) and keeps its part of dW1, dW2,
//      db1, db2 in registers across the whole range; it writes its partial
//      once.
//      Per tile: ŷ and g staged as [C][64] (+4 pad); the weight slices
//      (W1ᵀ, W1, W2) staged once per block; every thread computes 4×4
//      register tiles (4 hidden × 4 voxels for W1·ŷ and W2ᵀ·g, 4 channels
//      × 4 voxels for W1ᵀ·dz1, 4 hidden × 4 channels for dW1 and dW2), each
//      float4 shared-memory load feeding 4 FMAs. dz (one slab per slice)
//      goes to HBM with the tile's per-channel sums of dz and dz·ŷ, reduced
//      over the tile's 16 lanes by xor shuffles in a fixed order.
//   2. jlc_stage2_bwd_planes: its first blocks sum the weight partials over
//      the chunks in order; the rest form dx in one elementwise pass per
//      (b, c) plane part, mean(dz) and mean(dz·ŷ) summed in double from
//      the per-tile sums in a fixed order.
// It takes C a multiple of 8 and E·C of 4 (the wrapper pads other widths
// with zero channels and hidden rows) and C up to 200: beyond, the two
// stage buffers of x and g do not fit a block beside the weight slices.
// No float atomics: everything repeats bit for bit. The products run on
// the fp32 FMA pipes (tensor cores: ROADMAP); they stay in this kernel, as
// they were inside the TPU kernel's body.
// Bound: ~10·C·E·C FLOP per voxel (E = 2..3) for the five products; in HBM
// out1, g, dx once (dz adds a round trip).
//
// K5f's bf16 form is its own kernel on the bf16 tensor cores
// (jlc_stage2_mma.cu); vs_jlc_stage2 is built for fp32 alone. K5b's bf16
// form (T = bf16: out1, g, the weights, dx and the weight gradients; the
// statistics and every scratch buffer stay fp32) is the same kernels,
// staging bf16 by plain loads (cp.async cannot widen) into the fp32
// shared-memory tiles, and rounding where the Pallas kernel rounds
// (_k2_bwd_kernel, 194-243): z =
// bf16(ŷ), z1pb = bf16(W1·z + b1), z1 = gelu_in<bf16>(z1pb), dz1 =
// (W2ᵀg)·GELU'(z1pb) in fp32 (db1 sums it), dz1b = bf16(dz1) feeds dW1 =
// Σ dz1b·zᵀ and dz = W1ᵀ·dz1b; the IN backward takes the unrounded ŷ; dx
// = bf16(g + bf16(din)); dW1, db1, dW2, db2 summed in fp32 and rounded once
// (fused_jlc.py:375-377). Values rounded to bf16 inside a product (z, dz1b)
// are rounded where the product reads them from shared memory.
#include "common.cuh"

__device__ __forceinline__ float f4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Four fp32 values rounded to T and back (the identity for float).
template <typename T>
__device__ __forceinline__ float4 round_to4(float4 v) {
  if constexpr (kIsF32<T>) {
    return v;
  } else {
    return make_float4(round_to<T>(v.x), round_to<T>(v.y), round_to<T>(v.z),
                       round_to<T>(v.w));
  }
}

constexpr int kMlpThreads = 256;

// Shared memory of a K5f MLP block, in floats (host and device agree;
// ops/fused_jlc.py:stage2_fwd_launch keeps it within a block's 227 KB):
// W1ᵀ and W2ᵀ slices, b1 and b2, two stage buffers of ẑ, the hidden tile.
__host__ __device__ inline int mlp_fwd_smem_floats(int C, int HS, int VT) {
  return 2 * HS * C + HS + C + 2 * C * (VT + 4) + HS * (VT + 4);
}

// Issue the copies of tile `tile`'s out1 into zs ([C][VT + 4]); voxels past
// B·S read 0. Thread tid always handles voxel (group) tid % (VT or VT/4):
// VT divides 256.
template <typename T>
__device__ __forceinline__ void stage_fwd_tile(float* zs,
                                               const T* __restrict__ x,
                                               int64_t tile, int C, int VT,
                                               int64_t S, int64_t BS) {
  const int VS = VT + 4;
  if ((S & 3) == 0) {  // 16-byte copies: a group of 4 lies in one sample
    const int g = VT / 4, t = (threadIdx.x % g) * 4;
    const int64_t u = tile * VT + t;
    const bool ok = u < BS;
    const int64_t b = ok ? u / S : 0, v = ok ? u - b * S : 0;
    const T* src = x + b * C * S + v;
    for (int c = threadIdx.x / g; c < C; c += kMlpThreads / g)
      stage4<T>(zs + c * VS + t, src + c * S, ok);
  } else {
    const int t = threadIdx.x % VT;
    const int64_t u = tile * VT + t;
    const bool ok = u < BS;
    const int64_t b = ok ? u / S : 0, v = ok ? u - b * S : 0;
    const T* src = x + b * C * S + v;
    for (int c = threadIdx.x / VT; c < C; c += kMlpThreads / VT)
      stage1<T>(zs + c * VS + t, src + c * S, ok);
  }
}

// K5f launch 2. Block (blockIdx.x = chunk k, blockIdx.y = slice s) walks
// tiles [k·per, min(tiles, (k + 1)·per)); tile i holds flattened voxels
// u = i·VT + t, sample u / S, voxel u % S. part: slices·B·C·S floats (only
// with more than one slice).
template <typename T>
__global__ void __launch_bounds__(kMlpThreads)
jlc_stage2_mlp(const T* __restrict__ x, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2,
               const T* __restrict__ b2, const float* __restrict__ mean,
               const float* __restrict__ rstd, T* __restrict__ out,
               float* __restrict__ part, int B, int C, int HID, int HS,
               int64_t S, int VT, int tiles, int per) {
  extern __shared__ __align__(16) float sm[];
  const int VS = VT + 4;
  float* w1t = sm;                   // [C][HS]  W1ᵀ slice
  float* w2t = w1t + HS * C;         // [HS][C]  W2ᵀ slice
  float* stg = w2t + HS * C;         // 2 × [C][VS] out1 → ẑ
  float* hs = stg + 2 * C * VS;      // [HS][VS] GELU(W1·ẑ + b1)
  float* b1s = hs + HS * VS;         // [HS]
  float* b2s = b1s + HS;             // [C]
  const int tid = threadIdx.x;
  const int s = blockIdx.y, nsl = gridDim.y, e0 = s * HS;
  const int i0 = blockIdx.x * per, i1 = min(tiles, i0 + per);
  const int64_t BS = static_cast<int64_t>(B) * S;

  if (i0 < i1) stage_fwd_tile(stg, x, i0, C, VT, S, BS);
  for (int i = tid; i < HS * C; i += kMlpThreads) {
    const int e = i / C, c = i - e * C;
    w1t[c * HS + e] = to_f32(w1[static_cast<int64_t>(e0 + e) * C + c]);
  }
  for (int i = tid; i < HS * C; i += kMlpThreads) {
    const int c = i / HS, e = i - c * HS;
    w2t[e * C + c] = to_f32(w2[static_cast<int64_t>(c) * HID + e0 + e]);
  }
  for (int i = tid; i < HS; i += kMlpThreads) b1s[i] = to_f32(b1[e0 + i]);
  for (int i = tid; i < C; i += kMlpThreads) b2s[i] = to_f32(b2[i]);

  const int g4 = VT / 4;             // 4-voxel groups of a tile
  for (int it = i0; it < i1; ++it) {
    float* zs = stg + ((it - i0) & 1) * C * VS;
    cp_async_wait_all();
    __syncthreads();  // this tile is staged; the last one is done with the
                      // other buffer and with hs
    if (it + 1 < i1)
      stage_fwd_tile(stg + ((it + 1 - i0) & 1) * C * VS, x, it + 1, C, VT, S,
                     BS);
    {  // out1 → ẑ in place, rounded to T; voxels past B·S stay 0
      const int t = tid % VT;
      const int64_t u = static_cast<int64_t>(it) * VT + t;
      if (u < BS) {
        const int b = static_cast<int>(u / S);
        for (int c = tid / VT; c < C; c += kMlpThreads / VT) {
          float* p = zs + c * VS + t;
          *p = round_to<T>((*p - mean[b * C + c]) * rstd[b * C + c]);
        }
      }
    }
    __syncthreads();
    // h = GELU(W1·ẑ + b1) in T: 4 hidden × 4 voxels per job
    for (int j = tid; j < (HS / 4) * g4; j += kMlpThreads) {
      const int e4 = j / g4, t4 = j - e4 * g4;
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) a[r][k] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float4 wv = lds4(w1t + c * HS + e4 * 4);
        const float4 zv = lds4(zs + c * VS + t4 * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[r][k] = fmaf(f4(wv, r), f4(zv, k), a[r][k]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = e4 * 4 + r;
        const float bb = b1s[e];
        sts4(hs + e * VS + t4 * 4, gelu_in<T>(a[r][0] + bb),
             gelu_in<T>(a[r][1] + bb), gelu_in<T>(a[r][2] + bb),
             gelu_in<T>(a[r][3] + bb));
      }
    }
    __syncthreads();
    // W2·h: 4 channels × 4 voxels per job
    for (int j = tid; j < (C / 4) * g4; j += kMlpThreads) {
      const int c4 = j / g4, t4 = j - c4 * g4;
      float a[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) a[r][k] = 0.f;
      for (int e = 0; e < HS; ++e) {
        const float4 wv = lds4(w2t + e * C + c4 * 4);
        const float4 hv = lds4(hs + e * VS + t4 * 4);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[r][k] = fmaf(f4(wv, r), f4(hv, k), a[r][k]);
      }
      const int64_t u = static_cast<int64_t>(it) * VT + t4 * 4;
      if ((S & 3) == 0) {  // the group of 4 lies in one sample
        if (u >= BS) continue;
        const int64_t b = u / S, v = u - b * S;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = c4 * 4 + r;
          const int64_t o = (b * C + c) * S + v;
          if (nsl == 1) {  // out = x + z2, z2 = W2·h + b2 rounded to T
            const float4 xv = load4<T>(x + o);
            const float bb = b2s[c];
            store4<T>(out + o,
                      make_float4(xv.x + round_to<T>(a[r][0] + bb),
                                  xv.y + round_to<T>(a[r][1] + bb),
                                  xv.z + round_to<T>(a[r][2] + bb),
                                  xv.w + round_to<T>(a[r][3] + bb)));
          } else {
            *reinterpret_cast<float4*>(part + s * BS * C + o) =
                make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (u + k >= BS) break;
          const int64_t b = (u + k) / S, v = u + k - b * S;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = c4 * 4 + r;
            const int64_t o = (b * C + c) * S + v;
            if (nsl == 1)
              out[o] = from_f32<T>(to_f32(x[o]) +
                                   round_to<T>(a[r][k] + b2s[c]));
            else part[s * BS * C + o] = a[r][k];
          }
        }
      }
    }
  }
}

// K5f launch 3 (slices > 1): out = out1 + (Σ_s part_s + b2), in slice order
// (Σ_s part_s + b2 rounded to T before the residual).
template <typename T>
__global__ void jlc_stage2_sum(const T* __restrict__ x,
                               const float* __restrict__ part,
                               const T* __restrict__ b2, T* __restrict__ out,
                               int C, int64_t S, int64_t n, int nsl) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float a = part[i];
    for (int s = 1; s < nsl; ++s) a += part[s * n + i];
    out[i] = from_f32<T>(to_f32(x[i]) +
                         round_to<T>(a + to_f32(b2[(i / S) % C])));
  }
}

#ifndef VS_BF16
// K5f. x = out1: (B, C, D, H, W); w1: (HID, C); b1: (HID,); w2: (C, HID);
// b2: (C,); out: like x (all Elem); mean, rstd: B·C floats (written; K5b
// takes them); part: slices·B·C·S floats of scratch (slices > 1). The
// launch geometry (ops/fused_jlc.py:stage2_fwd_launch): HS hidden rows per
// slice, VT voxels per tile (32 to 256, a power of two), chunks of `per`
// tiles.
extern "C" int vs_jlc_stage2(const Elem* x, const Elem* w1, const Elem* b1,
                             const Elem* w2, const Elem* b2, float* mean,
                             float* rstd, Elem* out, float* part, int B,
                             int C, int HID, int S, int HS, int VT,
                             int chunks, int per, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0) return cudaSuccess;
  const int64_t bs = static_cast<int64_t>(B) * S;
  const int64_t tiles = (bs + VT - 1) / VT;
  if (C % 4 || HS % 4 || HS <= 0 || HID % HS ||
      (VT != 32 && VT != 64 && VT != 128 && VT != 256) || chunks < 1 ||
      per < 1 || static_cast<int64_t>(chunks - 1) * per >= tiles ||
      static_cast<int64_t>(chunks) * per < tiles)
    return cudaErrorInvalidValue;
  plane_stats_kernel<<<B * C, kStatsThreads, 0, stream>>>(x, S, 1e-5f, mean,
                                                          rstd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)mlp_fwd_smem_floats(C, HS, VT) * sizeof(float);
  err = allow_smem(jlc_stage2_mlp<Elem>, smem);
  if (err != cudaSuccess) return err;
  const int nsl = HID / HS;
  jlc_stage2_mlp<Elem><<<dim3(chunks, nsl), kMlpThreads, smem, stream>>>(
      x, w1, b1, w2, b2, mean, rstd, out, part, B, C, HID, HS, S, VT,
      static_cast<int>(tiles), per);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsl == 1) return err;
  const int64_t n = bs * C;
  const int64_t want = (n + 255) / 256;
  jlc_stage2_sum<Elem><<<static_cast<unsigned>(want < 4096 ? want : 4096),
                         256, 0, stream>>>(x, part, b2, out, C, S, n, nsl);
  return cudaGetLastError();
}
#endif

constexpr int kBwdThreads = 256;
constexpr int kVT = 64;          // voxels per K5b tile
constexpr int kVS = kVT + 4;     // row stride of [row][voxel] tiles (float4,
                                 // and rows 4 banks apart)
constexpr int kMaxSliceWork = 8192;  // HS·C: at most 4 weight jobs a thread

// Shared memory of a K5b tiles block, in floats (host and device agree;
// ops/fused_jlc.py:stage2_bwd_launch keeps it within a block's 227 KB).
__host__ __device__ inline int mlp_bwd_smem_floats(int C, int HS, int TP) {
  const int n = 3 * HS * C + 4 * C * kVS + 2 * HS * kVS + HS;
  const int red = TP > 1 ? kBwdThreads * 16 : 0;
  return n > red ? n : red;
}

// Issue the copies of unit (b, v0)'s x and g into one stage buffer, [C][kVS]
// each; voxels past S read 0.
template <typename T>
__device__ __forceinline__ void stage_tile(float* xs, float* gs,
                                           const T* __restrict__ x,
                                           const T* __restrict__ g,
                                           int b, int64_t v0, int C,
                                           int64_t S) {
  const int64_t base = (int64_t)b * C * S;
  if ((S & 3) == 0) {  // 16-byte copies: a group of 4 is all in or all out
    for (int i = threadIdx.x; i < C * (kVT / 4); i += kBwdThreads) {
      const int c = i / (kVT / 4), t = (i - c * (kVT / 4)) * 4;
      const bool ok = v0 + t < S;
      const int64_t o = base + c * S + (ok ? v0 + t : 0);
      stage4<T>(xs + c * kVS + t, x + o, ok);
      stage4<T>(gs + c * kVS + t, g + o, ok);
    }
  } else {
    for (int i = threadIdx.x; i < C * kVT; i += kBwdThreads) {
      const int c = i / kVT, t = i - c * kVT;
      const bool ok = v0 + t < S;
      const int64_t o = base + c * S + (ok ? v0 + t : 0);
      stage1<T>(xs + c * kVS + t, x + o, ok);
      stage1<T>(gs + c * kVS + t, g + o, ok);
    }
  }
}

// K5b launch 1. Block (blockIdx.x = chunk k, blockIdx.y = slice s) walks
// units [k·per, min(units, (k + 1)·per)); unit u is sample u / tps, voxels
// [(u % tps)·64, +64). dz: slices·B·C·S floats; tsum: units·slices·C·2;
// part: chunks·(2·HID·C + HID + C), [dW1 (HID·C) | dW2 (C·HID) | db1 | db2].
// Weight jobs: HS·C/8 4×4 tiles (half dW1, half dW2); TP threads split a
// tile's 64 voxels when there are fewer jobs than threads (JPT = 1), and
// add their sums in tp order at the end. The next unit's x and g arrive by
// cp.async (two stage buffers) while a unit is computed.
template <typename T, int JPT>
__global__ void __launch_bounds__(kBwdThreads, JPT == 1 ? 2 : 1)
jlc_mlp_bwd_tiles(const T* __restrict__ x, const T* __restrict__ w1,
                  const T* __restrict__ b1, const T* __restrict__ w2,
                  const T* __restrict__ g, const float* __restrict__ mean,
                  const float* __restrict__ rstd, float* __restrict__ dz,
                  float* __restrict__ tsum, float* __restrict__ part, int B,
                  int C, int HID, int HS, int64_t S, int tps, int units,
                  int per, int TP) {
  extern __shared__ __align__(16) float sm[];
  float* w1t = sm;                   // [C][HS]  W1ᵀ slice
  float* w1n = w1t + HS * C;         // [HS][C]  W1 slice
  float* w2s = w1n + HS * C;         // [C][HS]  W2 slice
  float* stg = w2s + HS * C;         // 2 × ([C][kVS] x → ŷ, [C][kVS] g)
  float* z1s = stg + 4 * C * kVS;    // [HS][kVS] GELU(z1p)
  float* d1s = z1s + HS * kVS;       // [HS][kVS] dz1
  float* b1s = d1s + HS * kVS;       // [HS]
  const int tid = threadIdx.x;
  const int s = blockIdx.y, nsl = gridDim.y, e0 = s * HS;
  const int u0 = blockIdx.x * per, u1 = min(units, u0 + per);

#pragma unroll 4
  for (int i = tid; i < HS * C; i += kBwdThreads) {
    const int e = i / C, c = i - e * C;
    const float w = to_f32(w1[(int64_t)(e0 + e) * C + c]);
    w1n[i] = w;
    w1t[c * HS + e] = w;
  }
#pragma unroll 4
  for (int i = tid; i < C * HS; i += kBwdThreads) {
    const int c = i / HS, e = i - c * HS;
    w2s[i] = to_f32(w2[(int64_t)c * HID + e0 + e]);
  }
  for (int i = tid; i < HS; i += kBwdThreads) b1s[i] = to_f32(b1[e0 + i]);

  // weight jobs of this thread: job = tid / TP + q·(256 / TP)
  const int jobs = HS * C / 8, half = jobs / 2, c4n = C / 4, h4n = HS / 4;
  const int tp = tid % TP, jstride = kBwdThreads / TP;
  const int tlen = kVT / TP, tb = tp * tlen;
  float acc[JPT][4][4];
#pragma unroll
  for (int q = 0; q < JPT; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[q][i][k] = 0.f;
  float db1a = 0.f, db2a = 0.f;

  if (u0 < u1)
    stage_tile(stg, stg + C * kVS, x, g, u0 / tps,
               (int64_t)(u0 % tps) * kVT, C, S);
  for (int u = u0; u < u1; ++u) {
    const int b = u / tps;
    const int64_t v0 = (int64_t)(u - b * tps) * kVT;
    float* ys = stg + ((u - u0) & 1) * 2 * C * kVS;
    float* gs = ys + C * kVS;
    cp_async_wait_all();
    __syncthreads();  // this unit is staged; the last one is done with the
                      // other buffer, z1s and d1s
    if (u + 1 < u1) {
      float* nx = stg + ((u + 1 - u0) & 1) * 2 * C * kVS;
      stage_tile(nx, nx + C * kVS, x, g, (u + 1) / tps,
                 (int64_t)((u + 1) % tps) * kVT, C, S);
    }
    for (int i = tid; i < C * kVT; i += kBwdThreads) {  // x → ŷ in place
      const int c = i / kVT, t = i - c * kVT;
      float* p = ys + c * kVS + t;
      // voxels past the end contribute nothing (g reads 0 there too)
      *p = v0 + t < S ? (*p - mean[b * C + c]) * rstd[b * C + c] : 0.f;
    }
    __syncthreads();
    // z1p = W1·z + b1 (z = ŷ rounded to T) and W2ᵀ·g: 4 hidden × 4
    // voxels per job
    for (int j = tid; j < h4n * 16; j += kBwdThreads) {
      const int e4 = j >> 4, t4 = j & 15;
      float zp[4][4], gw[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) zp[i][k] = gw[i][k] = 0.f;
      for (int c = 0; c < C; ++c) {
        const float4 wa = lds4(w1t + c * HS + e4 * 4);
        const float4 wb = lds4(w2s + c * HS + e4 * 4);
        const float4 yv = round_to4<T>(lds4(ys + c * kVS + t4 * 4));
        const float4 gv = lds4(gs + c * kVS + t4 * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            zp[i][k] = fmaf(f4(wa, i), f4(yv, k), zp[i][k]);
            gw[i][k] = fmaf(f4(wb, i), f4(gv, k), gw[i][k]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = e4 * 4 + i;
        float z[4], d[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // z1pb = z1p rounded to T
          const float p = round_to<T>(zp[i][k] + b1s[e]);
          z[k] = gelu_in<T>(p);
          d[k] = gw[i][k] * gelu_grad(p);
        }
        sts4(z1s + e * kVS + t4 * 4, z[0], z[1], z[2], z[3]);
        sts4(d1s + e * kVS + t4 * 4, d[0], d[1], d[2], d[3]);
      }
    }
    __syncthreads();
    // dz = W1ᵀ·dz1b (this slice's part; dz1b = dz1 rounded to T): 4
    // channels × 4 voxels per job, and
    // the tile's per-channel sums of dz and dz·ŷ (C % 8 == 0: whole warps).
    // Its jobs start at the last warp, the weight jobs below at the first,
    // so that where there are few of each they run on different warps.
    for (int j = kBwdThreads - 1 - tid; j < c4n * 16; j += kBwdThreads) {
      const int c4 = j >> 4, t4 = j & 15;
      float a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) a[i][k] = 0.f;
      for (int e = 0; e < HS; ++e) {
        const float4 wv = lds4(w1n + e * C + c4 * 4);
        const float4 dv = round_to4<T>(lds4(d1s + e * kVS + t4 * 4));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[i][k] = fmaf(f4(wv, i), f4(dv, k), a[i][k]);
      }
      const int64_t v = v0 + t4 * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c4 * 4 + i;
        float* dst = dz + ((int64_t)(s * B + b) * C + c) * S + v;
        if ((S & 3) == 0) {
          if (v < S) sts4(dst, a[i][0], a[i][1], a[i][2], a[i][3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (v + k < S) dst[k] = a[i][k];
        }
        const float4 yv = lds4(ys + c * kVS + t4 * 4);
        float s1 = (a[i][0] + a[i][1]) + (a[i][2] + a[i][3]);
        float s2 = fmaf(a[i][0], yv.x, a[i][1] * yv.y) +
                   fmaf(a[i][2], yv.z, a[i][3] * yv.w);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (t4 == 0) {
          float* ts = tsum + (((int64_t)u * nsl + s) * C + c) * 2;
          ts[0] = s1;
          ts[1] = s2;
        }
      }
    }
    // dW1 += dz1b·zᵀ, dW2 += g·z1ᵀ: job (a4, c4) owns rows a4 + i·HS/4 and
    // channels c4 + k·C/4 (interleaved, so neighbouring lanes read
    // neighbouring rows)
#pragma unroll
    for (int q = 0; q < JPT; ++q) {
      const int jid = tid / TP + q * jstride;
      if (jid >= jobs) continue;
      const bool second = jid >= half;
      const int r = second ? jid - half : jid;
      const int a4 = r / c4n, c4 = r - a4 * c4n;
      const float* A = second ? z1s : d1s;
      const float* Bm = second ? gs : ys;
      // dz1 and ŷ rounded to T for dW1 (z1 and g hold T values already)
      const bool rnd = !kIsF32<T> && !second;
      for (int t = tb; t < tb + tlen; t += 4) {
        float4 av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = lds4(A + (a4 + i * h4n) * kVS + t);
          bv[i] = lds4(Bm + (c4 + i * c4n) * kVS + t);
          if (rnd) {
            av[i] = round_to4<T>(av[i]);
            bv[i] = round_to4<T>(bv[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float v = acc[q][i][k];
            v = fmaf(av[i].x, bv[k].x, v);
            v = fmaf(av[i].y, bv[k].y, v);
            v = fmaf(av[i].z, bv[k].z, v);
            v = fmaf(av[i].w, bv[k].w, v);
            acc[q][i][k] = v;
          }
      }
    }
    if (tid < HS) {
      for (int t = 0; t < kVT; t += 4) {
        const float4 d = lds4(d1s + tid * kVS + t);
        db1a += (d.x + d.y) + (d.z + d.w);
      }
    } else if (s == 0 && tid < HS + C) {
      for (int t = 0; t < kVT; t += 4) {
        const float4 d = lds4(gs + (tid - HS) * kVS + t);
        db2a += (d.x + d.y) + (d.z + d.w);
      }
    }
  }

  // the voxel parts of a job added in tp order (TP > 1 only with JPT = 1)
  if (TP > 1) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) sm[tid * 16 + i * 4 + k] = acc[0][i][k];
    __syncthreads();
    if (tp == 0) {
      for (int p = 1; p < TP; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[0][i][k] += sm[(tid + p) * 16 + i * 4 + k];
    }
  }
  const int64_t slab = 2LL * HID * C + HID + C;
  float* pc = part + (int64_t)blockIdx.x * slab;
  if (tp == 0) {
#pragma unroll
    for (int q = 0; q < JPT; ++q) {
      const int jid = tid / TP + q * jstride;
      if (jid >= jobs) continue;
      const bool second = jid >= half;
      const int r = second ? jid - half : jid;
      const int a4 = r / c4n, c4 = r - a4 * c4n;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + a4 + i * h4n, c = c4 + k * c4n;
          if (second)
            pc[(int64_t)HID * C + (int64_t)c * HID + e] = acc[q][i][k];
          else
            pc[(int64_t)e * C + c] = acc[q][i][k];
        }
    }
  }
  if (tid < HS) pc[2LL * HID * C + e0 + tid] = db1a;
  else if (s == 0 && tid < HS + C) pc[2LL * HID * C + HID + tid - HS] = db2a;
}

// K5b launch 2. Blocks [0, nred): the weight partials summed over the
// chunks in order. Block nred + p·ysplit + y: plane p = b·C + c, voxels
// [y·vchunk, +vchunk): dx = g + r·(Σ_s dz_s − m1 − ŷ·m2), with m1, m2 the
// plane's means of dz and dz·ŷ from the per-tile sums (double, fixed order);
// for T = bf16 din rounded before the residual, dx rounded, the weight
// gradients rounded once.
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
jlc_stage2_bwd_planes(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ dz,
                      const float* __restrict__ tsum,
                      const float* __restrict__ part,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      T* __restrict__ dw1, T* __restrict__ dw2,
                      T* __restrict__ db1, T* __restrict__ db2,
                      int B, int C, int HID, int64_t S, int tps, int nsl,
                      int chunks, int nred, int ysplit, int64_t vchunk) {
  const int64_t hc = (int64_t)HID * C;
  if ((int)blockIdx.x < nred) {  // one element a thread, loads batched
    const int64_t slab = 2 * hc + HID + C;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= slab) return;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < chunks; ++k) s += part[k * slab + i];
    const T v = from_f32<T>(s);
    if (i < hc) dw1[i] = v;
    else if (i < 2 * hc) dw2[i - hc] = v;
    else if (i < 2 * hc + HID) db1[i - 2 * hc] = v;
    else db2[i - 2 * hc - HID] = v;
    return;
  }
  const int q = blockIdx.x - nred;
  const int p = q / ysplit, y = q - p * ysplit;
  const int b = p / C, c = p - b * C;
  double s1 = 0.0, s2 = 0.0;
  const int n = tps * nsl;  // (tile, slice) sums of sample b, in order
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* ts = tsum + (((int64_t)b * tps * nsl + i) * C + c) * 2;
    s1 += ts[0];
    s2 += ts[1];
  }
  block_sum2(s1, s2);
  const float m1 = static_cast<float>(s1 / static_cast<double>(S));
  const float m2 = static_cast<float>(s2 / static_cast<double>(S));
  const float m = mean[p], r = rstd[p];
  const int64_t lo = y * vchunk, hi = min(S, lo + vchunk);
  const int64_t plane = (int64_t)B * C * S;
  for (int64_t v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    const int64_t o = (int64_t)p * S + v;
    float d = dz[o];
    for (int sl = 1; sl < nsl; ++sl) d += dz[sl * plane + o];
    const float yh = (to_f32(x[o]) - m) * r;
    dx[o] = from_f32<T>(to_f32(g[o]) + round_to<T>(r * (d - m1 - yh * m2)));
  }
}

// K5b. x = out1, g: (B, C, D, H, W); w1: (HID, C); b1: (HID,); w2:
// (C, HID); dx: like x; dw1: (HID, C); db1: (HID,); dw2: (C, HID); db2:
// (C,) (all Elem); mean, rstd: B·C floats, K5f's statistics; dz:
// slices·B·C·S floats, tsum: units·slices·C·2, part: chunks·(2·HID·C +
// HID + C) (fp32 scratch). The launch geometry (ops/fused_jlc.py:stage2_bwd_launch): HS
// hidden rows per slice, chunks of `per` units, TP voxel parts per weight
// job, JPT weight jobs per thread, ysplit blocks per plane in the planes
// launch.
extern "C" int vs_jlc_stage2_bwd(const Elem* x, const Elem* w1,
                                 const Elem* b1, const Elem* w2,
                                 const Elem* g, const float* mean,
                                 const float* rstd, float* dz, float* tsum,
                                 float* part, Elem* dx, Elem* dw1,
                                 Elem* db1, Elem* dw2, Elem* db2, int B,
                                 int C, int HID, int S, int HS, int chunks,
                                 int per, int TP, int JPT, int ysplit,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0) return cudaSuccess;
  const int tps = (S + kVT - 1) / kVT;
  const int units = B * tps;
  const int jobs = HS * C / 8;
  if (C % 8 || HS % 4 || HS <= 0 || HID % HS || HS * C > kMaxSliceWork ||
      HS + C > kBwdThreads || TP < 1 || kVT % (4 * TP) ||
      (TP > 1 && JPT != 1) || JPT * (kBwdThreads / TP) < jobs ||
      chunks < 1 || per < 1 || (int64_t)(chunks - 1) * per >= units ||
      (int64_t)chunks * per < units || ysplit < 1)
    return cudaErrorInvalidValue;
  const int nsl = HID / HS;
  cudaError_t err;
  const size_t smem = (size_t)mlp_bwd_smem_floats(C, HS, TP) * sizeof(float);
  const dim3 grid(chunks, nsl);
#define VS_K5B_TILES(J)                                                      \
  if (JPT == J) {                                                            \
    err = allow_smem(jlc_mlp_bwd_tiles<Elem, J>, smem);                      \
    if (err != cudaSuccess) return err;                                      \
    jlc_mlp_bwd_tiles<Elem, J><<<grid, kBwdThreads, smem, stream>>>(         \
        x, w1, b1, w2, g, mean, rstd, dz, tsum, part, B, C, HID, HS, S, tps, \
        units, per, TP);                                                     \
  } else
  VS_K5B_TILES(1) VS_K5B_TILES(2) VS_K5B_TILES(4) return cudaErrorInvalidValue;
#undef VS_K5B_TILES
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t slab = 2LL * HID * C + HID + C;
  const int nred = (int)((slab + kStatsThreads - 1) / kStatsThreads);
  const int64_t vchunk = (S + ysplit - 1) / ysplit;
  jlc_stage2_bwd_planes<Elem>
      <<<nred + B * C * ysplit, kStatsThreads, 0, stream>>>(
      x, g, dz, tsum, part, mean, rstd, dx, dw1, dw2, db1, db2, B, C, HID, S,
      tps, nsl, chunks, nred, ysplit, vchunk);
  return cudaGetLastError();
}
