// K2: the RCPS fraction-missed loss table, for sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_kernels.py
// `_loss_table_padded` / `_loss_table_kernel`.
//
// What it computes: for each example n and each lambda l,
//   table[n, l] = #{pixels: (a > 1e-6 & lam*dl < a) | (b > 1e-6 & lam*du < b)} / P
// with a = pred - label and b = -a, the strict comparisons and the two
// COLLAPSE_EPS guards of the TPU kernel (pallas_kernels.py:62-73).
//
// What bounds it: compares, not bytes. N*P*L is about 1.3e10 at the
// calibration shapes (128 x 320^2 x 1000), while the four (N, P) maps are
// read from device memory only once per lambda block.
//
// Design: a block owns one example and a block of kThreads lambda values,
// one per thread. It stages tiles of pixels in shared memory as one float4
// per pixel, (a or -inf, dl, b or -inf, du): a side whose guard fails gets
// -inf, so `lam * slope < -inf` is false for every value, exactly as the
// guard would make it. Each thread then walks the tile (a broadcast read)
// and counts its misses in an integer register. No atomics, no padding:
// the ragged pixel and lambda edges are masked here, and the count is
// exact and deterministic. The output is float(count) / float(P), the
// same f32 division as the JAX package's counts / num_px.
//
// `lam * dl < a` compares a product with a value; there is no add for the
// compiler to contract into an FMA, so the default -fmad changes nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // lambdas per block, one per thread
constexpr int kTile = 1024;    // pixels staged per step: 16 KiB of float4
constexpr float kCollapseEps = 1e-6f;

__global__ void loss_table_kernel(const float* __restrict__ pred,
                                  const float* __restrict__ label,
                                  const float* __restrict__ dl,
                                  const float* __restrict__ du,
                                  const float* __restrict__ lam, float* __restrict__ out,
                                  int64_t num_px, int num_lam) {
  __shared__ float4 tile[kTile];
  const int64_t base = static_cast<int64_t>(blockIdx.y) * num_px;
  const int li = blockIdx.x * kThreads + threadIdx.x;
  const float my_lam = li < num_lam ? lam[li] : 0.0f;
  const float neg_inf = -__int_as_float(0x7f800000);

  unsigned int count = 0;
  for (int64_t start = 0; start < num_px; start += kTile) {
    const int m = static_cast<int>(num_px - start < kTile ? num_px - start : kTile);
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const int64_t q = base + start + k;
      const float a = pred[q] - label[q];
      const float b = -a;
      tile[k] = make_float4(a > kCollapseEps ? a : neg_inf, dl[q],
                            b > kCollapseEps ? b : neg_inf, du[q]);
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float4 t = tile[k];
      count += static_cast<unsigned int>((my_lam * t.y < t.x) | (my_lam * t.w < t.z));
    }
    __syncthreads();
  }
  if (li < num_lam) {
    out[static_cast<int64_t>(blockIdx.y) * num_lam + li] =
        static_cast<float>(count) / static_cast<float>(num_px);
  }
}

}  // namespace

// pred, label, dl, du: (n, num_px) f32 contiguous; lam: (num_lam,) f32;
// out: (n, num_lam) f32. Returns a cudaError_t value (0 = ok).
extern "C" int im2im_loss_table(const void* pred, const void* label, const void* dl,
                                const void* du, const void* lam, void* out, int n,
                                long long num_px, int num_lam, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || num_px <= 0 || num_lam <= 0 || n > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((num_lam + kThreads - 1) / kThreads, n);
  loss_table_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(label),
      static_cast<const float*>(dl), static_cast<const float*>(du),
      static_cast<const float*>(lam), static_cast<float*>(out), num_px, num_lam);
  return static_cast<int>(cudaGetLastError());
}
