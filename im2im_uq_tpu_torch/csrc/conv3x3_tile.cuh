// The shared core of the 3x3 same-padding convolution kernels (K3, K4 in
// conv3x3.cu), NCHW, float32, for sm_90a; K5 and K6 take affine_relu
// and reduce_rows from here.
//
// One block of 256 threads computes one output tile: 64 output channels x
// 8 rows x 32 columns of one image. Lane l of warp k owns column x0 + l,
// the 8 rows y0..y0+7 and the 8 channels co0 + 8k .. co0 + 8k + 7: 64 f32
// accumulators in registers. The input channels are walked in chunks of 8:
// the block stages the chunk's (8, 10, 34) input halo and its (8 x 9, 64)
// weights in shared memory, then every thread runs FFMA over them, reading
// each halo column once per (channel, dw) for the three dh taps and the
// eight rows, and each weight vector as two broadcast 16-byte loads.
// Accumulation is plain f32 FFMA (no tensor cores, no TF32), in a fixed
// order: channel chunks ascending, then channel, dw, dh. Taps outside the
// image read 0.
//
// The caller chooses two things at compile time:
// - kPrologue: apply relu(x * scale + shift) to the staged input, to the
//   elements inside the image only, so the zero frame stays zero when
//   shift > 0 (K4's folded BatchNorm + ReLU of the previous layer);
// - kFlip: read the weight as the transposed, spatially flipped kernel of a
//   forward convolution, by index arithmetic, with no copy.
//
// Cross-block sums (K4's stats, K6's reductions, K5's split-K) are written
// as per-block partials and summed by reduce_rows in a fixed order: no
// float atomics, so two runs give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace conv3x3 {

constexpr int kThreads = 256;  // 8 warps
constexpr int kTileW = 32;     // output columns per block, one per lane
constexpr int kTileH = 8;      // output rows per block, all in each thread
constexpr int kCoTile = 64;    // output channels per block, 8 per warp
constexpr int kCoPerWarp = 8;
constexpr int kCiChunk = 8;    // input channels staged per step
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kXsPlane = kHaloH * kHaloW;
// weight rows padded to 68 floats: 16-byte aligned for the vector loads,
// and at most 4-way bank conflicts when the tile is stored
constexpr int kWsStride = kCoTile + 4;

struct __align__(16) Smem {
  float ws[kCiChunk * 9 * kWsStride];  // [ci * 9 + tap][co]; 16-byte aligned rows
  float xs[kCiChunk * kXsPlane];       // [ci][row][col] of the halo
};

inline int tiles_w(int w) { return (w + kTileW - 1) / kTileW; }
inline int tiles_h(int h) { return (h + kTileH - 1) / kTileH; }

__device__ __forceinline__ float affine_relu(float v, float scale, float shift) {
  // rounded as the plain version's x * scale + shift (no FMA contraction)
  return fmaxf(__fadd_rn(__fmul_rn(v, scale), shift), 0.0f);
}

// Stage input channels [ci0, ci0 + 8) of the tile's halo and their weights.
// in: (ci_total, h, w) of one image. weight: the forward kernel, (co_total,
// ci_total, 3, 3) when !kFlip, (ci_total, co_total, 3, 3) when kFlip.
template <bool kPrologue, bool kFlip>
__device__ __forceinline__ void stage(const float* __restrict__ in,
                                      const float* __restrict__ weight,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ shift, int ci_total,
                                      int co_total, int h, int w, int y0, int x0, int co0,
                                      int ci0, Smem& sm) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kCiChunk * kXsPlane; e += kThreads) {
    const int ci = ci0 + e / kXsPlane;
    const int rem = e % kXsPlane;
    const int gy = y0 - 1 + rem / kHaloW;
    const int gx = x0 - 1 + rem % kHaloW;
    float v = 0.0f;
    if (ci < ci_total && gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = in[(static_cast<int64_t>(ci) * h + gy) * w + gx];
      if (kPrologue) v = affine_relu(v, scale[ci], shift[ci]);
    }
    sm.xs[e] = v;
  }
  for (int e = tid; e < kCiChunk * 9 * kCoTile; e += kThreads) {
    int ci_l, co_l, tap;
    int64_t src;
    if (kFlip) {
      // contiguous (co, tap) runs of weight[ci]: W[ci][co][8 - tap]
      ci_l = e / (9 * kCoTile);
      const int r = e % (9 * kCoTile);
      co_l = r / 9;
      tap = 8 - r % 9;
      src = (static_cast<int64_t>(ci0 + ci_l) * co_total + co0 + co_l) * 9 + r % 9;
    } else {
      // contiguous (ci, tap) runs of weight[co]: W[co][ci][tap]
      co_l = e / (9 * kCiChunk);
      const int k = e % (9 * kCiChunk);
      ci_l = k / 9;
      tap = k % 9;
      src = (static_cast<int64_t>(co0 + co_l) * ci_total + ci0) * 9 + k;
    }
    const bool ok = ci0 + ci_l < ci_total && co0 + co_l < co_total;
    sm.ws[(ci_l * 9 + tap) * kWsStride + co_l] = ok ? weight[src] : 0.0f;
  }
}

// acc[j][r] += the tile's conv for channel co0 + 8 * warp + j, row y0 + r,
// column x0 + lane, over every input channel.
template <bool kPrologue, bool kFlip>
__device__ __forceinline__ void accumulate(const float* __restrict__ in,
                                           const float* __restrict__ weight,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ shift, int ci_total,
                                           int co_total, int h, int w, int y0, int x0,
                                           int co0, Smem& sm,
                                           float (&acc)[kCoPerWarp][kTileH]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int ci0 = 0; ci0 < ci_total; ci0 += kCiChunk) {
    __syncthreads();  // the previous chunk is consumed
    stage<kPrologue, kFlip>(in, weight, scale, shift, ci_total, co_total, h, w, y0, x0, co0,
                            ci0, sm);
    __syncthreads();
#pragma unroll 1
    for (int ci = 0; ci < kCiChunk; ++ci) {
      const float* xp = sm.xs + ci * kXsPlane + lane;
      const float* wp = sm.ws + ci * 9 * kWsStride + warp * kCoPerWarp;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        float v[kHaloH];
#pragma unroll
        for (int r = 0; r < kHaloH; ++r) v[r] = xp[r * kHaloW + dw];
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const float4 wa = *reinterpret_cast<const float4*>(wp + (dh * 3 + dw) * kWsStride);
          const float4 wb =
              *reinterpret_cast<const float4*>(wp + (dh * 3 + dw) * kWsStride + 4);
          const float wv[kCoPerWarp] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < kCoPerWarp; ++j)
#pragma unroll
            for (int r = 0; r < kTileH; ++r) acc[j][r] = fmaf(wv[j], v[r + dh], acc[j][r]);
        }
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // a fixed butterfly: the same bits on every run
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out[g * cols + i] = sum over r < rows of part[(g * rows + r) * cols + i],
// r ascending: the fixed-order second pass of every cross-block sum. (A
// template, so that every source including this header may instantiate it.)
template <int = 0>
__global__ void reduce_rows(const float* __restrict__ part, float* __restrict__ out,
                            int64_t groups, int64_t rows, int64_t cols) {
  const int64_t total = groups * cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t g = i / cols;
    const float* p = part + g * rows * cols + i % cols;
    float s = 0.0f;
    for (int64_t r = 0; r < rows; ++r) s += p[r * cols];
    out[i] = s;
  }
}

inline cudaError_t launch_reduce_rows(const float* part, float* out, int64_t groups,
                                      int64_t rows, int64_t cols, cudaStream_t stream) {
  const int64_t total = groups * cols;
  int64_t blocks = (total + 255) / 256;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the grid-stride loop covers the rest
  reduce_rows<><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(part, out, groups, rows, cols);
  return cudaGetLastError();
}

}  // namespace conv3x3
