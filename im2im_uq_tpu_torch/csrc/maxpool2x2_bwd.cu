// K7: backward of the 2x2 stride-2 max pool (floor on odd sizes), NCHW, for
// sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_pool.py `_pool_bwd_raw` /
// `_pool_bwd_kernel`.
//
// What it computes: for each pooled output (i, j) with cotangent g[i, j],
//   dx[2i+di, 2j+dj] = g[i, j] at the first element of the 2x2 window, in
//   row-major order, that equals the window's max, and 0 at the other three;
// the rows and columns that floor pooling drops on odd sizes get 0. This is
// the first-match rule of the TPU kernel (pallas_pool.py:91-109) and of
// torch's own max_pool2d backward. The max is recomputed from x (fmaxf, so
// a NaN never wins; an all-NaN window gets 0 everywhere, as in the plain
// version `max_pool2x2_bwd_plain`). No arithmetic touches g: dx holds g's
// values bit for bit.
//
// What bounds it: bytes. It reads x (|dx| elements) and g (|dx|/4) once and
// writes dx once; the compares are free beside that.
//
// Design: one thread per 2x2 block of x, over ceil(H/2) x ceil(W/2) blocks,
// so the thread that owns a window also writes its zeros, and the partial
// blocks on an odd edge only write zeros: no memset, no second pass.
// Neighbouring threads own neighbouring blocks along W, so loads and stores
// are coalesced. The TPU kernel's W%8 and C%128 gates, its row tiles and its
// banded expansion matmul were Mosaic workarounds and are gone: every shape
// runs, including H or W = 1 (where nothing is pooled and dx is all zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16_rn(0.0f); }

template <typename T>
__global__ void maxpool2x2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                                      T* __restrict__ dx, int64_t planes, int h, int w) {
  const int ho = h / 2, wo = w / 2;              // pooled size (floor)
  const int hb = (h + 1) / 2, wb = (w + 1) / 2;  // 2x2 blocks covering x
  const int64_t total = planes * hb * wb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int jb = static_cast<int>(idx % wb);
    const int64_t t = idx / wb;
    const int ib = static_cast<int>(t % hb);
    const int64_t plane = t / hb;
    const int64_t top = plane * h * w + static_cast<int64_t>(2 * ib) * w + 2 * jb;
    T* d0 = dx + top;  // row 2i of the window
    T* d1 = d0 + w;    // row 2i+1
    const T z = zero<T>();
    if (ib < ho && jb < wo) {
      const T* x0 = x + top;
      const T* x1 = x0 + w;
      const float v00 = as_f32(x0[0]), v01 = as_f32(x0[1]);
      const float v10 = as_f32(x1[0]), v11 = as_f32(x1[1]);
      const T gv = g[plane * ho * wo + static_cast<int64_t>(ib) * wo + jb];
      const float m = fmaxf(fmaxf(v00, v01), fmaxf(v10, v11));
      const int k = v00 == m ? 0 : v01 == m ? 1 : v10 == m ? 2 : v11 == m ? 3 : 4;
      d0[0] = k == 0 ? gv : z;
      d0[1] = k == 1 ? gv : z;
      d1[0] = k == 2 ? gv : z;
      d1[1] = k == 3 ? gv : z;
    } else {
      // a block cut by floor pooling: zeros for the elements that exist
      const bool col = 2 * jb + 1 < w, row = 2 * ib + 1 < h;
      d0[0] = z;
      if (col) d0[1] = z;
      if (row) {
        d1[0] = z;
        if (col) d1[1] = z;
      }
    }
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loop covers the rest

template <typename T>
int launch(const void* x, const void* g, void* dx, int64_t planes, int h, int w,
           cudaStream_t stream) {
  const int64_t total = planes * ((h + 1) / 2) * ((w + 1) / 2);
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  maxpool2x2_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), planes, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dx: (planes, h, w) contiguous; g: (planes, h/2, w/2) contiguous; one
// dtype. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value.
extern "C" int im2im_maxpool2x2_bwd(const void* x, const void* g, void* dx, long long planes,
                                    int h, int w, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, g, dx, planes, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, g, dx, planes, h, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
