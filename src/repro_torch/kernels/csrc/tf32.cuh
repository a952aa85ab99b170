// float32 products on the TF32 tensor cores in float32 accuracy (3xTF32),
// shared by the SSD kernel and the float32 flash kernel.
//
// A single TF32 product keeps ~11 bits of each operand. Each float32
// operand is split into hi = tf32(a) and lo = tf32(a - hi), and the
// accumulator takes lo.hi + hi.lo + hi.hi, small terms first, which keeps
// about 21 bits a product (lo.lo, some 2^-22 of a product, is left out).
// `kernels/ref.py::mm_3xtf32` computes the same on the CPU.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// float32 -> the nearest TF32 value (ties away from zero): the low 13
// mantissa bits, which the tensor core ignores, become zero
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], hi[e], lo[e]);
}
__device__ __forceinline__ uint2 split2(float x) {
  uint2 r;
  split(x, r.x, r.y);
  return r;
}

// c (16 x 8) += a (16 x 8, row-major) . b (8 x 8, k-major), TF32 in, f32
// out. Not volatile: a pure function of its operands, which the compiler
// may schedule among the others.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c[c0 + nt] += a . b[nt] for NT n-tiles, a = ah + al and b = (bh, bl)
// pairs (b0: k rows 0-3, b1: 4-7), in three passes over the n-tiles, the
// small terms first, so that no product waits on the one before it. c0 is
// a constant once the caller's loops are unrolled.
template <int NT, int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint2 (&b0)[NT],
                                     const uint2 (&b1)[NT], int c0 = 0) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(c[c0 + nt], al, b0[nt].x, b1[nt].x);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(c[c0 + nt], ah, b0[nt].y, b1[nt].y);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_tf32(c[c0 + nt], ah, b0[nt].x, b1[nt].x);
}

}  // namespace repro
