// Warp-level pieces shared by the tensor-core kernels (gemm.cu, matern_gp.cu)
// on Hopper (sm_90a): cp.async 16-byte copies into shared memory, the
// mma.sync m16n8k8 TF32 product and the 3xTF32 split that keeps fp32
// accuracy on the TF32 tensor cores.
//
// 3xTF32: a fp32 value x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big), both exact TF32 values (10-bit mantissa), so x = big +
// small to about 2^-22 |x|. A product a*b is summed as a_small*b_big +
// a_big*b_small + a_big*b_big, small terms first so that they are not lost
// below the big term's rounding; a_small*b_small (about 2^-22 |ab|) is
// dropped. The accumulator is fp32 throughout, but the tensor cores round
// each mma's sum toward zero: a long chain of mma into one accumulator
// drifts one way, so callers sum short chains into fresh fragments and add
// those on the CUDA cores, rounded to nearest.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4:
//   A (16x8, row-major):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                         a3 = A[g+8][t+4]
//   B (8x8, "col"):       b0 = B[t][g],  b1 = B[t+4][g]   (B indexed [k][n])
//   C (16x8, fp32):       c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t],
//                         c3 = C[g+8][2t+1]
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are in flight.
// wait_group takes an immediate, so n is dispatched over 0..2.
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

// cvt.rna.tf32.f32's result for finite x, in two integer operations: add
// half of the 13 dropped bits to the magnitude (a carry rounds up, ties
// away from zero), then clear them.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small, both TF32 (round to nearest, ties away, as cvt.rna)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// c += a * b on the TF32 tensor cores, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b to fp32 accuracy: the two small products first, then big*big
__device__ __forceinline__ void mma_tf32x3(float* c, const uint32_t* a_big,
                                           const uint32_t* a_small,
                                           const uint32_t* b_big,
                                           const uint32_t* b_small) {
  mma_tf32(c, a_small, b_big);
  mma_tf32(c, a_big, b_small);
  mma_tf32(c, a_big, b_big);
}

// The split A fragment of the 16x8 tile at As (row-major, row stride lda
// floats): rows g, g+8 and columns t, t+4 of the tile.
__device__ __forceinline__ void load_a_tf32x3(const float* As, int lda,
                                              int lane, uint32_t* big,
                                              uint32_t* small) {
  const float* p = As + (lane >> 2) * lda + (lane & 3);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * lda], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * lda + 4], big[3], small[3]);
}

// The split B fragment of the 8x8 tile at Bs (indexed [k][n], row stride
// ldb floats): k = t, t+4 and column n = g.
__device__ __forceinline__ void load_b_tf32x3(const float* Bs, int ldb,
                                              int lane, uint32_t* big,
                                              uint32_t* small) {
  const float* p = Bs + (lane & 3) * ldb + (lane >> 2);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4 * ldb], big[1], small[1]);
}

}  // namespace tc
