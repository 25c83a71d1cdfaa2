// Building blocks of the mma.sync bf16 kernels (conv3x3_bn_relu.cu and
// deform_conv.cu): asynchronous copies global -> shared (cp.async), 8x8
// matrix loads from shared memory (ldmatrix) and the warp-wide bf16 product
// mma.sync.m16n8k16 with fp32 sums; hopper.cuh takes smem_u32, pack_bf16 and
// exp2_ftz from here.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of 2 bf16: (g, 2t..2t+1), (g + 8, 2t..),
//     (g, 8 + 2t..), (g + 8, 8 + 2t..);
//   B (16 x 8, k x n), 2 registers: (k = 2t..2t+1, n = g), (k = 8 + 2t.., n = g);
//   C (16 x 8, fp32), 4 floats: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// So the C fragments of two neighbouring n8 tiles, rounded to bf16 in pairs,
// are the A fragment of one k16 step (pack_bf16 below).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; the bytes past src_bytes (all 16
// when it is 0) are written as zeros. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; the bytes past src_bytes are zeros. 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned), r[j] receives matrix j's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The same, each matrix transposed on the way: lane t receives elements
// (rows 2(t%4), 2(t%4)+1; column t/4) of the stored matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b on the tensor cores: a 16x16 bf16, b 16x8 bf16, c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16, lo in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one MUFU.EX2 (exp2f adds a range fix-up for denormal results); x <= 0
// here, and results below 2^-126 flush to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
