// K1b: backward of the 2x bilinear upsample with align_corners=True, NCHW,
// for sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_resize.py
// `_upsample2x_bwd_raw` / `_bwd_kernel` (the custom VJP of the fused decoder
// upsample).
//
// What it computes: the transpose of K1 (csrc/upsample2x.cu). Along one axis
// of n inputs and 2n outputs,
//   dx[m] = a1[m]*g[2m] + a3[m]*g[2m+2] + a2[m]*g[2m+1] + a0[m]*g[2m-1]
// with a0[m] = fo[m-1], a1[m] = fe[m], a2[m] = 1 - fo[m], a3[m] = 1 - fe[m+1]
// (pallas_resize.py:281-287), from the forward's phase weights fe/fo. The
// wrapper passes the four tables per axis as one small f32 array
// [a0 | a1 | a2 | a3]. a0[0] = 0 and a3[n-1] = 0, so the taps at 2m-1 < 0
// and 2m+2 > 2n-1 are clamped onto real elements with a weight of exactly 0
// (the same elements as the plain version's, so even a zero's sign agrees).
// The W axis is reduced first (one partial sum per cotangent row), then the
// H axis, each as the same four-term sum in the same order as the plain
// version `upsample2x_bwd_plain`.
//
// What bounds it: bytes. It reads the cotangent once (4|dx| elements) and
// writes dx once; 16 multiply-adds per output are far below the card's
// compute rate.
//
// Design: the gather form, with no atomics. One thread per dx element reads
// its 4x4 window of the cotangent (rows 2i-1..2i+2, columns 2j-1..2j+2,
// clamped), accumulates in f32 and stores once in the tensor's dtype.
// Neighbouring threads own neighbouring columns, so each row's loads are
// coalesced and the overlap between windows is served by L1. The TPU
// kernel's row tiles, W%8 gate, 128-lane channel pad and banded (2W, W)
// matmul were Mosaic workarounds and are gone: every shape runs, including
// H or W = 1. The arithmetic uses explicitly rounded intrinsics, so no
// multiply-add is contracted and the result is bit-identical to the plain
// version, which runs the same multiplies and adds as separate f32 ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ((a1*v1 + a3*v3) + a2*v2) + a0*v0, rounded after every operation.
__device__ __forceinline__ float taps(float a0, float a1, float a2, float a3, float v0,
                                      float v1, float v2, float v3) {
  float s = __fadd_rn(__fmul_rn(a1, v1), __fmul_rn(a3, v3));
  s = __fadd_rn(s, __fmul_rn(a2, v2));
  return __fadd_rn(s, __fmul_rn(a0, v0));
}

template <typename T>
__global__ void upsample2x_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx,
                                      const float* __restrict__ ah,  // [a0|a1|a2|a3] over h
                                      const float* __restrict__ aw,  // [a0|a1|a2|a3] over w
                                      int64_t planes, int h, int w) {
  const int64_t total = planes * h * w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int h2 = 2 * h, w2 = 2 * w;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int j = static_cast<int>(idx % w);
    const int64_t t = idx / w;
    const int i = static_cast<int>(t % h);
    const int64_t plane = t / h;
    const T* gp = g + plane * h2 * w2;

    // clamped taps, as the plain version clamps them: 2m-1 -> 1 at m = 0
    // (the first odd output), 2m+2 -> 2m at m = n-1 (the last even output)
    const int c0 = j > 0 ? 2 * j - 1 : 1;
    const int c3 = j < w - 1 ? 2 * j + 2 : 2 * j;
    const float aw0 = aw[j], aw1 = aw[w + j], aw2 = aw[2 * w + j], aw3 = aw[3 * w + j];
    const int rows[4] = {i > 0 ? 2 * i - 1 : 1, 2 * i, 2 * i + 1, i < h - 1 ? 2 * i + 2 : 2 * i};
    float part[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T* row = gp + static_cast<int64_t>(rows[k]) * w2;
      part[k] = taps(aw0, aw1, aw2, aw3, load_f32(row + c0), load_f32(row + 2 * j),
                     load_f32(row + 2 * j + 1), load_f32(row + c3));
    }
    const float d = taps(ah[i], ah[h + i], ah[2 * h + i], ah[3 * h + i], part[0], part[1],
                         part[2], part[3]);
    store(dx + idx, d);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loop covers the rest

template <typename T>
int launch(const void* g, void* dx, const void* ah, const void* aw, int64_t planes, int h,
           int w, cudaStream_t stream) {
  const int64_t total = planes * h * w;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  upsample2x_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<const float*>(ah),
      static_cast<const float*>(aw), planes, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (planes, 2h, 2w) contiguous; dx: (planes, h, w) contiguous, same dtype.
// ah: (4h,) f32 device table [a0 | a1 | a2 | a3] over h; aw: (4w,) over w.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int im2im_upsample2x_bwd(const void* g, void* dx, const void* ah, const void* aw,
                                    long long planes, int h, int w, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, dx, ah, aw, planes, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, dx, ah, aw, planes, h, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
