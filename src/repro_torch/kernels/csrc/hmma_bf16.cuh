// bf16 tensor-core building blocks of row 10's forward
// (flash_attention.cu): ldmatrix loads of 8 x 8 bf16 matrices from shared
// memory, the m16n8k16 HMMA with f32 sums, 2^x on the special-function
// unit and bf16 packing (the last two also row 10's backward's,
// flash_attention_bwd.cu, whose products are wgmma_tma.cuh's).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "cp_async.cuh"

// Four 8 x 8 bf16 matrices from shared memory, lane i giving the address
// of row i % 8 of matrix i / 8; register j holds matrix j's (lane / 4,
// 2 (lane % 4) + {0, 1}), or with .trans its (2 (lane % 4) + {0, 1},
// lane / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b for one 16 x 8 x 16 bf16 product with f32 sums.  With g =
// lane / 4, t = lane % 4: a = A(g, 2t..) A(g+8, 2t..) A(g, 2t+8..)
// A(g+8, 2t+8..), b = B(2t.., g) B(2t+8.., g), d = D(g, 2t..) D(g+8, 2t..).
__device__ __forceinline__ void hmma_16x8x16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (ex2.approx.ftz.f32: about 2 ulp;
// results below 2^-126 flush to 0, and 2^-1e30 is 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16 and packed, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
