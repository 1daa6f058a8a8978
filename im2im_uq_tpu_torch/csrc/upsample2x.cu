// K1: 2x bilinear upsample with align_corners=True, NCHW, for sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_resize.py
// `_upsample2x_fwd_raw` / `_fwd_kernel` (the fused decoder upsample).
//
// What it computes: for an input plane of n rows, output row 2m is
// x[m-1] + (x[m] - x[m-1]) * fe[m] and output row 2m+1 is
// x[m] + (x[m+1] - x[m]) * fo[m], with the phase weights fe/fo of
// `_phase_weights` (pallas_resize.py:59-73) passed in as small f32 tables.
// The taps at m-1 < 0 and m+1 > n-1 are clamped; their weight is exactly 0
// there (fe[0] = 1, fo[n-1] = 0), so clamping changes nothing. The lerp runs
// along H first and then along W, like resize_bilinear_align_corners.
//
// What bounds it: bytes. Each output element costs a few flops, and the
// call reads the input once and writes four times as much.
//
// Design: one thread per 2x2 output quad. A thread reads its 3x3 input
// neighbourhood (the neighbours' reads hit L1/L2), does both lerps in f32,
// and writes two 2-element vectors, one per output row; neighbouring
// threads own neighbouring quads along W, so the stores are coalesced.
// The TPU kernel's shape gates (W%8, C>=32, row tiles) and its banded
// W-axis matmul were Mosaic workarounds and are gone: every shape runs.
//
// Numerics: f32 arithmetic with one rounding at the store. The lerps use
// explicitly rounded intrinsics, so no multiply-add is contracted and the
// result is bit-identical to the plain PyTorch version (which runs the same
// subtract, multiply and add as separate f32 operations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a + (b - a) * f, rounded after every operation (no FMA contraction).
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

template <typename T>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  const float* __restrict__ wh,  // fe_h[h], fo_h[h]
                                  const float* __restrict__ ww,  // fe_w[w], fo_w[w]
                                  int64_t planes, int h, int w) {
  const int64_t total = planes * h * w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int j = static_cast<int>(idx % w);
    const int64_t t = idx / w;
    const int i = static_cast<int>(t % h);
    const int64_t plane = t / h;

    const T* xp = x + plane * h * w;
    const T* row_m = xp + static_cast<int64_t>(i > 0 ? i - 1 : 0) * w;
    const T* row_c = xp + static_cast<int64_t>(i) * w;
    const T* row_p = xp + static_cast<int64_t>(i < h - 1 ? i + 1 : h - 1) * w;
    const int jm = j > 0 ? j - 1 : 0;
    const int jp = j < w - 1 ? j + 1 : w - 1;

    const float feh = wh[i], foh = wh[h + i];
    const float few = ww[j], fow = ww[w + j];

    // H pass at the three input columns jm, j, jp.
    float even[3], odd[3];
    const int cols[3] = {jm, j, jp};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float m = load_f32(row_m + cols[k]);
      const float c = load_f32(row_c + cols[k]);
      const float p = load_f32(row_p + cols[k]);
      even[k] = lerp(m, c, feh);
      odd[k] = lerp(c, p, foh);
    }

    // W pass: output columns 2j (phase even) and 2j+1 (phase odd).
    T* out = y + plane * 4 * h * w + static_cast<int64_t>(2 * i) * (2 * w) + 2 * j;
    store_pair(out, lerp(even[0], even[1], few), lerp(even[1], even[2], fow));
    store_pair(out + 2 * w, lerp(odd[0], odd[1], few), lerp(odd[1], odd[2], fow));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loop covers the rest

template <typename T>
int launch(const void* x, void* y, const void* wh, const void* ww, int64_t planes,
           int h, int w, cudaStream_t stream) {
  const int64_t total = planes * h * w;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  upsample2x_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(wh),
      static_cast<const float*>(ww), planes, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (planes, h, w) contiguous; y: (planes, 2h, 2w) contiguous, same dtype.
// wh: (2h,) f32 device table [fe_h | fo_h]; ww: (2w,) f32 [fe_w | fo_w].
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int im2im_upsample2x(const void* x, void* y, const void* wh, const void* ww,
                                long long planes, int h, int w, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, wh, ww, planes, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, wh, ww, planes, h, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
