// TMA and mbarrier helpers for the wgmma kernels fed by TMA, for
// sm_90a: K3-K6 in bf16 (conv3x3_bf16.cu), K5 and K6 in float32
// (wgrad3x3_tma.cu, dgrad3x3_tma.cu) and P2-P5's TMA path in both dtypes
// (conv3x3_nhwc.cu). The tensor maps are encoded through libcuda's
// cuTensorMapEncodeTiled, reached through the runtime, so the library
// links no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tmak {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// arrive on `bar` where `on` (a predicate inside the instruction: the
// consumers' code stays free of branches that ptxas would take as divergent
// around their wgmma)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(bar)),
      "r"(static_cast<int>(on))
      : "memory");
}

// wait until the phase of `bar` with this parity has completed (the loop
// inside the asm, for the same reason)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the box at (c0, c1, c2, c3) of a 4-d tensor map into shared memory,
// reported to `bar`; coordinates outside the tensor read as 0
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// the box at (c0, c1, c2, c3) of a 4-d tensor map from shared memory, as a
// bulk group of this thread; the parts outside the tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%1, %2, %3, %4}], [%5];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(src))
      : "memory");
}

// commit this thread's bulk stores, and wait until they have read their
// shared memory
__device__ __forceinline__ void bulk_store_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\ncp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// `bytes` (a multiple of 16) contiguous bytes into shared memory, reported
// to `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// barrier 1 over the first `threads` threads of the block (the consumers;
// the producer warp has left)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// the register budgets of the float32 kernels' roles (wgrad3x3_tma.cu,
// dgrad3x3_tma.cu): a producer warpgroup gives up registers, the two
// consumer warpgroups take them
__device__ __forceinline__ void setmaxnreg_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// *p = v where `on`, predicated inside the instruction (no memory clobber:
// an epilogue's loads may be issued ahead of its stores)
__device__ __forceinline__ void store_if(float* p, float v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.f32 [%0], %1;\n}\n" ::"l"(p),
      "f"(v), "r"(static_cast<int>(on)));
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 NHWC tensor (b, h, w, c), c a multiple of 8 and
// the base 16-byte aligned, read in boxes of bc channels x bw columns x bh
// rows of one image, zero outside the tensor: bc = 8, or 64 with the
// 128-byte swizzle (16-byte chunk j of a box row lands at chunk j ^ (bits
// 7-9 of its shared-memory address), the layout wgmma reads as swizzled).
// With type FLOAT32: a float32 tensor, c a multiple of 4, boxes of bc = 8
// channels (32 bytes a pixel), no swizzle.
inline cudaError_t nhwc_map(CUtensorMap* map, const void* base, int b, int h, int w, int c,
                            int bw, int bh, int bc = 8,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t row = static_cast<cuuint64_t>(c) * size;
  const cuuint64_t strides[3] = {row, row * w, row * w * h};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bc), static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             bc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The tensor map of a bf16 NCHW tensor (b, c, h, w), w a multiple of 8 and
// the base 16-byte aligned, in boxes of bw columns x bh rows x bc channels
// of one image (bw a multiple of 8), zero outside the tensor. With type
// FLOAT32: a float32 tensor, w and bw multiples of 4 (K5's and K6's
// float32 paths, wgrad3x3_tma.cu and dgrad3x3_tma.cu).
inline cudaError_t nchw_map(CUtensorMap* map, const void* base, int b, int c, int h, int w,
                            int bw, int bh, int bc,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(b)};
  const cuuint64_t size = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t row = static_cast<cuuint64_t>(w) * size;
  const cuuint64_t strides[3] = {row, row * h, row * h * c};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(bc), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace tmak
