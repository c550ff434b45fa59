// K5f's bf16 form: JLC stage 2's forward, channels-first (B, C, D, H, W),
// its channel MLP on the bf16 tensor cores (mma.sync). Built for bf16
// alone (-DVS_BF16); the fp32 form and K5b are jlc_stage2.cu's.
//
//   out = bf16(x + z2),  z2 = bf16(W2 · h + b2),  h = gelu_in<bf16>(z1),
//   z1 = bf16(W1 · z + b1),  z = bf16((x − μ)·r)
//
// Replaces: veloxseg_tpu/ops/fused_jlc.py:_k2_kernel (177-192, called
// through _k2_fwd, 297-312) on bf16 operands, every rounding point of it:
// z, z1 (inside gelu_in), Φ(z1) and h, z2, and the residual sum. Two
// launches:
//   1. plane_stats_kernel (common.cuh), as jlc_stage2.cu launches it: the
//      per-(b, c) mean and rstd of x in double, in a fixed order; K5b takes
//      them, so they stay the fp32 form's bit for bit.
//   2. jlc_stage2_mma_kernel: the MLP with voxels as the M dimension,
//        z1ᵀ[16 × E·C] = zᵀ[16 × C] · W1ᵀ,   z2ᵀ[16 × C] = hᵀ[16 × E·C] · W2ᵀ,
//      in m16n8k16 products (bf16 operands, fp32 sums). A warp takes 16
//      voxels at a time: zᵀ is its A operand (ldmatrix .trans from the
//      [channel][voxel] tile), W1 and W2 sit in shared memory as bf16 and
//      are read as B operands by ldmatrix. Per 16 hidden rows the first
//      product's accumulators, after the bias, the rounding and the GELU,
//      are packed in pairs into the second product's A operand in the
//      registers: the hidden tile never leaves them.
// A block of 4 warps walks a contiguous range of tiles of VT voxels of the
// flattened (b, voxel) index (a tile may span samples: the statistics are a
// per-(b, c) lookup); the next tile's x arrives by cp.async of 16 raw bytes
// (S a multiple of 8; plain loads otherwise, as at 3³) while one is
// computed. Per tile: ẑ = bf16((x − μ)·r) into its own buffer, the MLP, z2
// into that buffer, then out = bf16(x + z2) in rows of 16 bytes. Where few
// voxel tiles would leave SMs idle (the 6³ and 3³ levels), `hsplit` warps
// share 16 voxels, each over E·C/hsplit hidden rows, and their fp32
// partials of W2·h are added in warp order in shared memory before b2 (as
// the fp32 form adds its slices before b2): one launch for the MLP at every
// width, no partials in HBM and no third launch.
// The weights of both products take 2·C·E·C bf16 values (128 KB at C 128,
// E·C 256) and fit one block beside the tiles.
// What bounds it on this card: bytes at the 24³ level (x read twice, out
// written once), latency and launches at the others; the 4·C·E·C operations
// per voxel take ~1/300 of the time the bytes do on the tensor cores.
// C is 16, 32, 64 or 128 (the wrapper pads other widths with zero channels)
// and E·C a multiple of 16. No atomics: out repeats bit for bit.
#include "mma.cuh"

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Shared memory of a block in bytes (ops/fused_jlc.py:_k5f_mma_smem_bytes):
// W1 [E·C][C + 8] and W2 [C][E·C + 8] in bf16, two stages of x and the ẑ/z2
// buffer [C][VT + 8] in bf16, b1 and b2 in fp32, and with hsplit > 1 the
// partials [hsplit][VT][C] in fp32. The row strides of 8 elements past the
// row put the 8 rows one ldmatrix reads in other banks.
__host__ __device__ inline size_t mma_stage2_smem_bytes(int C, int HID,
                                                        int VT, int hsplit) {
  return 2 * (static_cast<size_t>(HID) * (C + 8) +
              static_cast<size_t>(C) * (HID + 8) + 3 * C * (VT + 8)) +
         4 * (HID + C) +
         (hsplit > 1 ? 4 * static_cast<size_t>(hsplit) * VT * C : 0);
}

// rows × cols bf16 values from src (row stride sstr) to shared dst (row
// stride dstr); 16-byte copies where `wide`.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int dstr,
                                           const __nv_bfloat16* src, int sstr,
                                           int rows, int cols, bool wide) {
  if (wide) {
    const int per = cols / 8;
    for (int e = threadIdx.x; e < rows * per; e += kThreads) {
      const int r = e / per, c = (e - r * per) * 8;
      cp_async16(dst + r * dstr + c, src + static_cast<int64_t>(r) * sstr + c,
                 true);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * dstr + c] = src[static_cast<int64_t>(r) * sstr + c];
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
jlc_stage2_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w1,
                      const __nv_bfloat16* __restrict__ b1,
                      const __nv_bfloat16* __restrict__ w2,
                      const __nv_bfloat16* __restrict__ b2,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      __nv_bfloat16* __restrict__ out, int B, int HID, int S,
                      int VT, int hsplit, int tiles, int per) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w1s = C + 8, w2s = HID + 8, vs = VT + 8;
  bf16* w1t = reinterpret_cast<bf16*>(smem_raw);  // [HID][C + 8]
  bf16* w2t = w1t + HID * w1s;                    // [C][HID + 8]
  bf16* stg = w2t + C * w2s;                      // 2 × [C][VT + 8] x
  bf16* zs = stg + 2 * C * vs;                    // [C][VT + 8] ẑ, then z2
  float* b1s = reinterpret_cast<float*>(zs + C * vs);  // [HID]
  float* b2s = b1s + HID;                              // [C]
  float* red = b2s + C;                   // [hsplit][VT][C] (hsplit > 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int i0 = blockIdx.x * per, i1 = min(tiles, i0 + per);
  if (i0 >= i1) return;
  const int BS = B * S;  // below 2^31 (the entry point checks)
  const bool wide = (S & 7) == 0 && aligned16(x) && aligned16(out);

  // the tile `it`'s x into stage buffer `buf`; zero past B·S
  auto stage_tile = [&](int it, int buf) {
    bf16* dst = stg + buf * C * vs;
    if (wide) {  // 16-byte copies: a group of 8 voxels lies in one sample
      const int groups = VT / 8;
      for (int e = tid; e < C * groups; e += kThreads) {
        const int c = e / groups, t8 = (e - c * groups) * 8;
        const int u = it * VT + t8;
        const bool ok = u < BS;
        const int b = ok ? u / S : 0, v = ok ? u - b * S : 0;
        cp_async16(dst + c * vs + t8,
                   x + (static_cast<int64_t>(b) * C + c) * S + v, ok);
      }
    } else {
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int e = tid; e < C * VT; e += kThreads) {
        const int c = e / VT, tt = e - c * VT;
        const int u = it * VT + tt;
        const int b = u < BS ? u / S : 0, v = u - b * S;
        dst[c * vs + tt] =
            u < BS ? x[(static_cast<int64_t>(b) * C + c) * S + v] : zero;
      }
    }
  };
  stage_tile(i0, 0);
  {
    const bool wwide = aligned16(w1) && aligned16(w2);
    stage_rows(w1t, w1s, w1, C, HID, C, wwide);
    stage_rows(w2t, w2s, w2, HID, C, HID, wwide);
    for (int i = tid; i < HID; i += kThreads) b1s[i] = to_f32(b1[i]);
    for (int i = tid; i < C; i += kThreads) b2s[i] = to_f32(b2[i]);
  }
  // warp (slot, part): 16 voxels of each of the slot's m16 tiles, hidden
  // rows [e_lo, e_lo + hp)
  const int slots = kWarps / hsplit, slot = warp / hsplit;
  const int part = warp - slot * hsplit, hp = HID / hsplit, e_lo = part * hp;
  const int mt = VT / (16 * slots);  // m16 tiles of a slot

  for (int it = i0; it < i1; ++it) {
    const int buf = (it - i0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile it (and the weights) are in; tile it − 1 is done
    if (it + 1 < i1) stage_tile(it + 1, buf ^ 1);
    const bf16* xs = stg + buf * C * vs;
    // ẑ = bf16((x − μ)·r), 0 past B·S (in groups of 8 voxels of one
    // sample where S % 8 == 0)
    if (wide) {
      const int groups = VT / 8;
      for (int e = tid; e < C * groups; e += kThreads) {
        const int c = e / groups, t8 = (e - c * groups) * 8;
        const int u = it * VT + t8;
        uint4 zv = make_uint4(0u, 0u, 0u, 0u);
        if (u < BS) {
          const int bc = (u / S) * C + c;
          const float mu = __ldg(mean + bc), r = __ldg(rstd + bc);
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + c * vs + t8);
          const uint32_t* xp = reinterpret_cast<const uint32_t*>(&xv);
          uint32_t* zp = reinterpret_cast<uint32_t*>(&zv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            zp[i] = pack_bf16((bf16_lo(xp[i]) - mu) * r,
                              (bf16_hi(xp[i]) - mu) * r);
        }
        *reinterpret_cast<uint4*>(zs + c * vs + t8) = zv;
      }
    } else {
      for (int e = tid; e < C * VT; e += kThreads) {
        const int c = e / VT, tt = e - c * VT;
        const int u = it * VT + tt;
        float z = 0.f;
        if (u < BS) {
          const int bc = (u / S) * C + c;
          z = (to_f32(xs[c * vs + tt]) - __ldg(mean + bc)) * __ldg(rstd + bc);
        }
        zs[c * vs + tt] = __float2bfloat16_rn(z);
      }
    }
    __syncthreads();
    for (int m = 0; m < mt; ++m) {
      const int v0 = (slot * mt + m) * 16;  // the warp's first voxel
      // ẑᵀ as the A operand of each k16 step over the channels
      uint32_t za[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        ldsm_x4_trans(za[kk], zs + (16 * kk + 8 * (mi >> 1) + mr) * vs + v0 +
                                  8 * (mi & 1));
      float acc[C / 8][4];
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int e16 = e_lo; e16 < e_lo + hp; e16 += 16) {
        // z1ᵀ of 16 hidden rows: two n8 tiles
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk) {
          uint32_t wb[4];
          ldsm_x4(wb, w1t + (e16 + 8 * (mi >> 1) + mr) * w1s + 16 * kk +
                          8 * (mi & 1));
          mma_k16(d[0], za[kk], wb[0], wb[1]);
          mma_k16(d[1], za[kk], wb[2], wb[3]);
        }
        // h = gelu_in<bf16>(z1 + b1), exactly bf16: the A operand of W2
        uint32_t ha[4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = e16 + 8 * u + 2 * t;
          const float c0 = b1s[e], c1 = b1s[e + 1];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            ha[2 * u + hr] =
                pack_bf16(gelu_in<bf16>(d[u][2 * hr] + c0),
                          gelu_in<bf16>(d[u][2 * hr + 1] + c1));
        }
#pragma unroll
        for (int j2 = 0; j2 < C / 16; ++j2) {
          uint32_t wb[4];
          ldsm_x4(wb, w2t + (16 * j2 + 8 * (mi >> 1) + mr) * w2s + e16 +
                          8 * (mi & 1));
          mma_k16(acc[2 * j2], ha, wb[0], wb[1]);
          mma_k16(acc[2 * j2 + 1], ha, wb[2], wb[3]);
        }
      }
      // z2 = bf16(W2·h + b2) into the warp's own voxels of zs, or its
      // partial to the slot's sum
#pragma unroll
      for (int j = 0; j < C / 8; ++j) {
        const int c = 8 * j + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int vv = v0 + g + 8 * hr;
          if (hsplit == 1) {
            zs[c * vs + vv] = __float2bfloat16_rn(acc[j][2 * hr] + b2s[c]);
            zs[(c + 1) * vs + vv] =
                __float2bfloat16_rn(acc[j][2 * hr + 1] + b2s[c + 1]);
          } else {
            *reinterpret_cast<float2*>(red + (part * VT + vv) * C + c) =
                make_float2(acc[j][2 * hr], acc[j][2 * hr + 1]);
          }
        }
      }
    }
    __syncthreads();
    if (hsplit > 1) {  // the parts added in warp order, then b2
      for (int e = tid; e < C * VT; e += kThreads) {
        const int c = e / VT, vv = e - c * VT;
        float a = red[vv * C + c];
        for (int p = 1; p < hsplit; ++p) a += red[(p * VT + vv) * C + c];
        zs[c * vs + vv] = __float2bfloat16_rn(a + b2s[c]);
      }
      __syncthreads();
    }
    // out = bf16(x + z2)
    if (wide) {
      const int groups = VT / 8;
      for (int e = tid; e < C * groups; e += kThreads) {
        const int c = e / groups, t8 = (e - c * groups) * 8;
        const int u = it * VT + t8;
        if (u >= BS) continue;
        const int b = u / S, v = u - b * S;
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + c * vs + t8);
        const uint4 zv = *reinterpret_cast<const uint4*>(zs + c * vs + t8);
        const uint32_t* xp = reinterpret_cast<const uint32_t*>(&xv);
        const uint32_t* zp = reinterpret_cast<const uint32_t*>(&zv);
        uint4 o;
        uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          op[i] = pack_bf16(bf16_lo(xp[i]) + bf16_lo(zp[i]),
                            bf16_hi(xp[i]) + bf16_hi(zp[i]));
        *reinterpret_cast<uint4*>(
            out + (static_cast<int64_t>(b) * C + c) * S + v) = o;
      }
    } else {
      for (int e = tid; e < C * VT; e += kThreads) {
        const int c = e / VT, tt = e - c * VT;
        const int u = it * VT + tt;
        if (u >= BS) continue;
        const int b = u / S, v = u - b * S;
        out[(static_cast<int64_t>(b) * C + c) * S + v] = __float2bfloat16_rn(
            to_f32(xs[c * vs + tt]) + to_f32(zs[c * vs + tt]));
      }
    }
  }
}

template <int C>
static cudaError_t launch_mlp(const Elem* x, const Elem* w1, const Elem* b1,
                              const Elem* w2, const Elem* b2,
                              const float* mean, const float* rstd,
                              Elem* out, int B, int HID, int S, int VT,
                              int hsplit, int tiles, int chunks, int per,
                              cudaStream_t stream) {
  const size_t smem = mma_stage2_smem_bytes(C, HID, VT, hsplit);
  cudaError_t err = allow_smem(jlc_stage2_mma_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  jlc_stage2_mma_kernel<C><<<chunks, kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, mean, rstd, out, B, HID, S, VT, hsplit, tiles, per);
  return cudaGetLastError();
}

// K5f's bf16 form. x = out1: (B, C, D, H, W); w1: (HID, C); b1: (HID,);
// w2: (C, HID); b2: (C,); out: like x (all bf16); mean, rstd: B·C floats
// (written; K5b takes them). The launch geometry
// (ops/fused_jlc.py:stage2_mma_launch): tiles of VT voxels (a multiple of
// 16·4/hsplit up to 256; 16·4/hsplit where hsplit > 1), hsplit warps of a
// block sharing 16 voxels, chunks of `per` tiles.
extern "C" int vs_jlc_stage2_mma(const Elem* x, const Elem* w1,
                                 const Elem* b1, const Elem* w2,
                                 const Elem* b2, float* mean, float* rstd,
                                 Elem* out, int B, int C, int HID, int S,
                                 int VT, int hsplit, int chunks, int per,
                                 void* stream_ptr) {
  static_assert(!kIsF32<Elem>, "K5f's mma form is built for bf16 alone");
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0) return cudaSuccess;
  const int64_t bs = static_cast<int64_t>(B) * S;
  const int64_t tiles = (bs + VT - 1) / VT;
  const bool hs_ok = hsplit == 1 || hsplit == 2 || hsplit == 4;
  const bool c_ok = C == 16 || C == 32 || C == 64 || C == 128;
  if (!hs_ok || !c_ok || bs + 256 > 0x7FFFFFFF || HID <= 0 || HID % (16 * hsplit) ||
      VT <= 0 || VT > 256 || VT % (16 * (kWarps / hsplit)) ||
      (hsplit > 1 && VT != 16 * (kWarps / hsplit)) || chunks < 1 ||
      per < 1 || static_cast<int64_t>(chunks - 1) * per >= tiles ||
      static_cast<int64_t>(chunks) * per < tiles)
    return cudaErrorInvalidValue;
  plane_stats_kernel<<<B * C, kStatsThreads, 0, stream>>>(x, S, 1e-5f, mean,
                                                          rstd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nt = static_cast<int>(tiles);
  switch (C) {
    case 16:
      return launch_mlp<16>(x, w1, b1, w2, b2, mean, rstd, out, B, HID, S, VT,
                            hsplit, nt, chunks, per, stream);
    case 32:
      return launch_mlp<32>(x, w1, b1, w2, b2, mean, rstd, out, B, HID, S, VT,
                            hsplit, nt, chunks, per, stream);
    case 64:
      return launch_mlp<64>(x, w1, b1, w2, b2, mean, rstd, out, B, HID, S, VT,
                            hsplit, nt, chunks, per, stream);
    case 128:
      return launch_mlp<128>(x, w1, b1, w2, b2, mean, rstd, out, B, HID, S,
                             VT, hsplit, nt, chunks, per, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
