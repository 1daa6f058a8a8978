// P1: per-channel sums of x and x^2 over the rows of an NHWC tensor, for
// sm_90a.
//
// Replaces the TPU kernel benchmarks/bench_moments.py `pallas_moments` /
// `_moments_kernel` (the probe of BatchNorm's statistics).
//
// What it computes: for x viewed as (n, C), n = B * H * W rows of C
// contiguous channels, float32 or bfloat16,
//   sums[0][c] = sum over rows of x[r][c],  sums[1][c] = sum of x[r][c]^2,
// in float32 (bfloat16 is widened on load). The wrapper (ops/moments.py)
// finishes mean = sums[0] / n and var = sums[1] / n - mean^2 in float32, the
// probe's single-pass formula.
//
// What bounds it: bytes. x is read once (0.25 ms for (32, 320, 320, 64)
// float32 at 3.35 TB/s); the adds are free beside that.
//
// Design: the TPU kernel walks 2048-row tiles in order on one core and
// carries the sums in its output block. Here blocks run in parallel on 132
// SMs, so nothing carries over between them:
// - each block takes a fixed contiguous range of rows; its threads form a
//   (rows x columns) grid over that range, a column being one 16-byte vector
//   of a row (4 float32 or 8 bfloat16 channels) where a row is a whole
//   number of vectors, else one channel (the scalar path: C = 1, 3, ...);
//   neighbouring threads read neighbouring addresses;
// - each thread keeps its column's partial sums in float32 registers over
//   the rows it visits, then the block combines its rows in a fixed-order
//   tree in shared memory and writes a (blocks, 2, C) partial buffer;
// - a second kernel sums that buffer over the blocks in ascending order.
// No float atomics: two runs give the same bits. The grid fills the SMs
// several times over (moments_blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// A column of kVec channels: one 16-byte load (kVec > 1) or one element.
template <typename T, int kVec>
__device__ __forceinline__ void load(const T* p, float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    v[0] = widen(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = widen(e[i]);
  }
}

// part[block][0][c], part[block][1][c]: the block's sums over its rows
// [r0, r1). cols = C / kVec columns; the threads form rows_t = kThreads /
// cols_t rows of cols_t = min(cols, kThreads) columns and loop over the
// columns in steps of cols_t.
template <typename T, int kVec>
__global__ void moments_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                                       int64_t n, int c, int64_t rows_per_block) {
  extern __shared__ float red[];  // [rows_t][2][cols_t * kVec]
  const int cols = c / kVec;
  const int cols_t = cols < kThreads ? cols : kThreads;
  const int rows_t = kThreads / cols_t;
  const int tcol = threadIdx.x % cols_t, trow = threadIdx.x / cols_t;
  const bool active = trow < rows_t;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;
  const int width = cols_t * kVec;  // floats of one sum in a row of red
  for (int j0 = 0; j0 < cols; j0 += cols_t) {
    const int j = j0 + tcol;
    float s[kVec], q[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) s[i] = q[i] = 0.0f;
    if (active && j < cols) {
      for (int64_t r = r0 + trow; r < r1; r += rows_t) {
        float v[kVec];
        load<T, kVec>(x + r * c + static_cast<int64_t>(j) * kVec, v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          s[i] += v[i];
          q[i] = __fmaf_rn(v[i], v[i], q[i]);
        }
      }
    }
    if (active) {
      float* mine = red + trow * 2 * width + tcol * kVec;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        mine[i] = s[i];
        mine[width + i] = q[i];
      }
    }
    __syncthreads();
    // fixed-order tree over the rows of red: row i += row i + half
    for (int m = rows_t; m > 1;) {
      const int half = (m + 1) / 2;
      const int span = (m - half) * 2 * width;
      for (int e = threadIdx.x; e < span; e += kThreads) red[e] += red[e + half * 2 * width];
      __syncthreads();
      m = half;
    }
    for (int e = threadIdx.x; e < 2 * width; e += kThreads) {
      const int which = e / width, ch = j0 * kVec + e % width;
      if (ch < c) part[(static_cast<int64_t>(blockIdx.x) * 2 + which) * c + ch] = red[e];
    }
    __syncthreads();
  }
}

// sums[i] = sum over blocks b ascending of part[b][i], i < 2 C
__global__ void moments_final_kernel(const float* __restrict__ part, float* __restrict__ sums,
                                     int blocks, int two_c) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < two_c; i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += part[static_cast<int64_t>(b) * two_c + i];
    sums[i] = s;
  }
}

int vec_of(int dtype) { return dtype == 0 ? 4 : 8; }

template <typename T, int kVec>
cudaError_t launch(const void* x, float* part, float* sums, int64_t n, int c, int blocks,
                   cudaStream_t s) {
  const int cols = c / kVec;
  const int cols_t = cols < kThreads ? cols : kThreads;
  const int rows_t = kThreads / cols_t;
  const int bytes = rows_t * 2 * cols_t * kVec * static_cast<int>(sizeof(float));
  auto kernel = moments_partial_kernel<T, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int64_t per = (n + blocks - 1) / blocks;
  kernel<<<blocks, kThreads, bytes, s>>>(static_cast<const T*>(x), part, n, c, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int two_c = 2 * c;
  moments_final_kernel<<<(two_c + 127) / 128, 128, 0, s>>>(part, sums, blocks, two_c);
  return cudaGetLastError();
}

}  // namespace

// The number of blocks (rows of the partial buffer) for n rows on
// `device`: the SMs several times over, at most one per row.
extern "C" int im2im_moments_blocks(long long n, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      sms <= 0)
    sms = 132;
  const long long want = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(n < want ? (n > 0 ? n : 1) : want);
}

// x: (n, c) contiguous, dtype 0 = float32, 1 = bfloat16; vec: each row is a
// whole number of 16-byte vectors and x is 16-byte aligned; part: (blocks, 2,
// c) float32 scratch, blocks = im2im_moments_blocks(n, device); sums: (2,
// c) float32. Returns a cudaError_t value.
extern "C" int im2im_moments(const void* x, void* part, void* sums, long long n, int c,
                             int blocks, int dtype, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || c <= 0 || blocks <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && c % vec_of(dtype) != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(sums);
  if (dtype == 0)
    return static_cast<int>(vec ? launch<float, 4>(x, p, out, n, c, blocks, s)
                                : launch<float, 1>(x, p, out, n, c, blocks, s));
  return static_cast<int>(vec ? launch<__nv_bfloat16, 8>(x, p, out, n, c, blocks, s)
                              : launch<__nv_bfloat16, 1>(x, p, out, n, c, blocks, s));
}
