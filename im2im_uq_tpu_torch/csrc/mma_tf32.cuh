// Tensor-core helpers of the conv kernels (K5 in wgrad3x3.cu; K3/K4 in
// conv3x3.cu and K6 in dgrad3x3.cu through conv3x3_tc.cuh), for sm_90a:
// 3xTF32 products with mma.sync (K5) and wgmma (K3/K4/K6), and cp.async
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
// fresh accumulator (mma3_fresh), K3/K4/K6 each chunk's (27 k-steps into
// a partial zeroed per chunk), and all add them to their sums in float32.
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

// wgmma (sm_90a): the warpgroup's asynchronous products, A from registers
// (per warp the fragment layout of mma.m16n8k8's A, rows 16 w .. 16 w + 15
// of the m64 tile for warp w of the warpgroup), B from shared memory
// through a descriptor, D in registers (per warp and 8-column group j the
// layout of mma.m16n8k8's C: d[4 j + r]).

// Descriptor of a K-major B tile without swizzle at p: lbo bytes between
// core matrices adjacent in K, sbo bytes between those adjacent in N.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d += a * b, m64n32k8, TF32 operands, float32 accumulation
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// orders this thread's register writes before the wgmma that read them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most n of the warpgroup's committed wgmma groups are pending
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// keeps a register that an issued wgmma reads or writes alive and in place
// up to this point (after the wait that ends that wgmma)
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// makes this thread's shared-memory stores visible to the async proxy
// (wgmma's reads of shared memory)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace tc
