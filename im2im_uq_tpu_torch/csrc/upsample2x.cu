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
// Numerics, float32: f32 arithmetic with one rounding at the store. The
// lerps use explicitly rounded intrinsics, so no multiply-add is contracted
// and the result is bit-identical to the plain PyTorch version (which runs
// the same subtract, multiply and add as separate f32 operations).
//
// Numerics, bfloat16: the TPU kernel's function (pallas_resize.py:158-181).
// The H-axis lerps run in bf16, each subtract, multiply and add rounded to
// bf16 (done in f32 and rounded: f32's 24 bits are more than twice bf16's 8
// plus 2, so the double rounding is exact), with the phase weights rounded
// to bf16 and zero rows beyond the edges. The W axis is the TPU kernel's
// matmul against the bf16 entries of `_col_transpose_matrix(W)`: each output
// column has two taps, whose products of two bf16 values are exact in f32,
// added once in f32 and rounded once to bf16, so the order of the taps
// cannot change the bits. For bf16 the W table holds those four tap
// weights per input column (already rounded to bf16) instead of fe/fo.

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

// a + (b - a) * f, rounded after every operation (no FMA contraction).
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

__global__ void upsample2x_kernel(const float* __restrict__ x, float* __restrict__ y,
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

    const float* xp = x + plane * h * w;
    const float* row_m = xp + static_cast<int64_t>(i > 0 ? i - 1 : 0) * w;
    const float* row_c = xp + static_cast<int64_t>(i) * w;
    const float* row_p = xp + static_cast<int64_t>(i < h - 1 ? i + 1 : h - 1) * w;
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
    float* out = y + plane * 4 * h * w + static_cast<int64_t>(2 * i) * (2 * w) + 2 * j;
    store_pair(out, lerp(even[0], even[1], few), lerp(even[1], even[2], fow));
    store_pair(out + 2 * w, lerp(odd[0], odd[1], few), lerp(odd[1], odd[2], fow));
  }
}

// bf16 value of v, as a float (round to nearest even)
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a + (b - a) * f in bf16: every operation rounded to bf16.
__device__ __forceinline__ float lerp_bf16(float a, float b, float f) {
  return bf16r(__fadd_rn(a, bf16r(__fmul_rn(bf16r(__fsub_rn(b, a)), f))));
}

// p * a + q * b of bf16 values: both products exact in f32, one f32 add, one
// rounding to bf16.
__device__ __forceinline__ float taps_bf16(float p, float a, float q, float b) {
  return bf16r(__fadd_rn(__fmul_rn(p, a), __fmul_rn(q, b)));
}

__global__ void upsample2x_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                       __nv_bfloat16* __restrict__ y,
                                       const float* __restrict__ wh,  // fe_h[h], fo_h[h], bf16
                                       const float* __restrict__ ww,  // 4 taps x w, bf16
                                       int64_t planes, int h, int w) {
  const int64_t total = planes * h * w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int j = static_cast<int>(idx % w);
    const int64_t t = idx / w;
    const int i = static_cast<int>(t % h);
    const int64_t plane = t / h;

    const __nv_bfloat16* row_c = x + (plane * h + i) * w;
    const int jm = j > 0 ? j - 1 : 0;
    const int jp = j < w - 1 ? j + 1 : w - 1;
    const float feh = wh[i], foh = wh[h + i];

    // H pass at the three input columns jm, j, jp; zero rows past the edges
    float even[3], odd[3];
    const int cols[3] = {jm, j, jp};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float m = i > 0 ? load_f32(row_c - w + cols[k]) : 0.0f;
      const float c = load_f32(row_c + cols[k]);
      const float p = i < h - 1 ? load_f32(row_c + w + cols[k]) : 0.0f;
      even[k] = lerp_bf16(m, c, feh);
      odd[k] = lerp_bf16(c, p, foh);
    }

    // W pass: column 2j reads columns j - 1 and j, column 2j + 1 reads j and
    // j + 1; a tap past the edge has weight 0
    const float ep = ww[j], ec = ww[w + j], oc = ww[2 * w + j], on = ww[3 * w + j];
    __nv_bfloat16* out = y + plane * 4 * h * w + static_cast<int64_t>(2 * i) * (2 * w) + 2 * j;
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(
        taps_bf16(ep, even[0], ec, even[1]), taps_bf16(oc, even[1], on, even[2]));
    *reinterpret_cast<__nv_bfloat162*>(out + 2 * w) = __floats2bfloat162_rn(
        taps_bf16(ep, odd[0], ec, odd[1]), taps_bf16(oc, odd[1], on, odd[2]));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loop covers the rest

inline unsigned blocks_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// x: (planes, h, w) contiguous; y: (planes, 2h, 2w) contiguous, same dtype.
// dtype 0 = float32: wh (2h,) f32 device table [fe_h | fo_h], ww (2w,)
// [fe_w | fo_w]. dtype 1 = bfloat16: wh (2h,) the same weights rounded to
// bf16, ww (4w,) the W taps per input column j, rounded to bf16: [weight of
// j - 1 in column 2j | of j in 2j | of j in 2j + 1 | of j + 1 in 2j + 1].
// Returns a cudaError_t value (0 = ok).
extern "C" int im2im_upsample2x(const void* x, void* y, const void* wh, const void* ww,
                                long long planes, int h, int w, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(planes * h * w);
  const auto* whf = static_cast<const float*>(wh);
  const auto* wwf = static_cast<const float*>(ww);
  if (dtype == 0)
    upsample2x_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), whf, wwf, planes, h, w);
  else if (dtype == 1)
    upsample2x_bf16_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), whf, wwf, planes,
        h, w);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
