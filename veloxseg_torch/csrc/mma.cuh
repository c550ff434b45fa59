// Warp-level bf16 tensor-core helpers (mma.sync, ldmatrix, cp.async of
// raw bytes) for the kernels that run their products on Hopper's bf16
// tensor cores: K3f's and K5f's bf16 forms (pwa_attention_long_mma.cu,
// jlc_stage2_mma.cu).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8/k16"),
// with g = lane / 4 and t = lane % 4:
//   A (16 × K, row-major): register i holds rows g (i even) or g + 8 (i
//     odd), columns 2t, 2t + 1 (+ 8 for registers 2, 3 of k16);
//   B (K × 8): register i holds rows 2t, 2t + 1 (+ 8 for register 1 of
//     k16), column g;
//   C, D (16 × 8, fp32): d0, d1 row g, columns 2t, 2t + 1; d2, d3 row
//     g + 8.
// So the accumulators of two neighbouring n8 tiles, rounded to bf16 and
// packed in pairs, are the A operand of a k16 product (the hidden tile of
// an MLP, attention weights before ·V) without leaving the registers.
#pragma once

#include "common.cuh"

// Two fp32 values rounded to bf16 (to nearest even) in one register:
// `lo` in the low half (the lower column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// d += a·b, m16n8k8, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d += a·b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 × 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i gets
// matrix i in the fragment layout (row g, columns 2t, 2t + 1). `trans`:
// transposed (row 2t and 2t + 1, column g), a B operand from a matrix
// stored with its K dimension as rows.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 raw bytes from global to shared memory by cp.async, zero where
// `valid` is false (complete after cp_async_wait_all).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Whether pointers are 16-byte aligned (the cp.async staging's condition).
__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
