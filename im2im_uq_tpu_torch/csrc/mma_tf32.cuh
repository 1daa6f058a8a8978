// Tensor-core helpers of the backward conv kernels (K5 in wgrad3x3.cu, K6 in
// dgrad3x3.cu), for sm_90a: 3xTF32 products with mma.sync, and cp.async
// staging into shared memory.
//
// 3xTF32. A TF32 value keeps 10 explicit mantissa bits, so one pass of TF32
// products loses about three decimal digits against float32. Each float32
// operand v is split when its fragment is loaded into hi = tf32(v) and
// lo = v - hi (see split), and a product is accumulated as lo_a*hi_b +
// hi_a*lo_b + hi_a*hi_b in float32, always in that order: only lo_a*lo_b
// (about 2^-22 of the product) and lo's bits below TF32 are dropped. The
// tensor cores run it at a third of their TF32 rate, 165 TFLOP/s of
// float32-accurate products on an H100 SXM, against 67 TFLOP/s of FFMA.
// The tensor core's own float32 accumulation drops low bits of its sums,
// so no accumulator runs deep: K5 sends each k-step's products through a
// fresh accumulator (mma3_fresh), K6 each chunk's (27 mma into a partial
// zeroed per chunk), and both add them to their sums in float32.
//
// mma.sync.m16n8k8 fragment layout (PTX ISA, "Matrix Fragments for
// mma.m16n8k8", .tf32), with gid = lane / 4 and tig = lane % 4:
//   A (16 x 8, row major):  a0 (gid, tig), a1 (gid + 8, tig),
//                           a2 (gid, tig + 4), a3 (gid + 8, tig + 4);
//   B (8 x 8, k x n):       b0 (tig, gid), b1 (tig + 4, gid);
//   C (16 x 8):             c0 (gid, 2 tig), c1 (gid, 2 tig + 1),
//                           c2 (gid + 8, 2 tig), c3 (gid + 8, 2 tig + 1).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

struct Split {
  uint32_t hi, lo;
};

// hi: v rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives), by an integer add on the bit pattern, which runs
// at the full integer rate where cvt does not; lo = v - hi exactly. lo is
// passed as it is: the tensor core reads the top 19 bits of a .tf32
// operand, so lo enters the product truncated to TF32, within 2^-21 of v.
__device__ __forceinline__ Split split(float v) {
  const uint32_t hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  return {hi, __float_as_uint(v - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// c += a * b in 3xTF32 through a fresh accumulator (its first product
// reads a zero C), added to c rounded to nearest
__device__ __forceinline__ void mma3_fresh(float (&c)[4], const Split (&a)[4],
                                           const Split (&b)[2]) {
  float t[4];
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
      : "r"(a[0].lo), "r"(a[1].lo), "r"(a[2].lo), "r"(a[3].lo), "r"(b[0].hi), "r"(b[1].hi),
        "f"(z));
  mma(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += t[r];
}

// 4-byte asynchronous copy global -> shared; reads nothing and writes 0 when
// !valid (src must still be a mapped address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned); reads
// nothing and writes 0 when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

}  // namespace tc
