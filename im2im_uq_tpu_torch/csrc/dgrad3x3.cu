// K6: the input gradient of K4, NCHW, float32, for sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_conv_bwd.py
// `dgrad3x3_pallas_raw` (`_dgrad_kernel`).
//
// What it computes, for the cotangent g (B, Cout, H, W) of a 3x3
// same-padding conv with weight W (Cout, Cin, 3, 3) over the input x:
//   da[b, c, y, x] = sum over co, dh, dw of g[b, co, y + 1 - dh, x + 1 - dw]
//                    * W[co, c, dh, dw]  (0 outside the image),
// the conv of g with the transposed, spatially flipped kernel. With the
// prologue (the forward applied relu(x * scale + shift) to its input), the
// epilogue recomputes the ReLU mask from the raw x, strictly
// x * scale + shift > 0, and writes
//   dam = da * mask,  dx = dam * scale,
// with the per-channel reductions red[0][c] = sum of dam * x and red[1][c] =
// sum of dam (the gradients of scale and shift). Without it, dx = da and
// red is not written.
//
// What bounds it: operations, as K3/K4 (the same FLOPs as the forward).
// Design: the forward's tile core (conv3x3_tile.cuh) with the weight read
// flipped and transposed by index arithmetic, no copy; the mask, the scale
// and the reductions ride the epilogue, so the activation is never written
// and read back. The reductions are per-block partials (a warp butterfly
// per channel) summed over all blocks in a second fixed-order pass: no
// float atomics. The TPU kernel's gates (128-aligned channels, the row
// tile, f32 C <= 256 in bwd_eligible) and the XLA fallback beside them are
// gone: every shape runs.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 2)
    dgrad3x3_kernel(const float* __restrict__ g, const float* __restrict__ weight,
                    const float* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ dx,
                    float* __restrict__ part, int cin, int cout, int h, int w, int ntw) {
  __shared__ Smem sm;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kCoTile;  // this block's channels of x
  const int tile = blockIdx.x;
  const int y0 = (tile / ntw) * kTileH;
  const int x0 = (tile % ntw) * kTileW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t plane = static_cast<int64_t>(h) * w;

  float acc[kCoPerWarp][kTileH];
#pragma unroll
  for (int j = 0; j < kCoPerWarp; ++j)
#pragma unroll
    for (int r = 0; r < kTileH; ++r) acc[j][r] = 0.0f;
  // the conv over g's cout channels into x's cin channels
  accumulate<false, true>(g + b * cout * plane, weight, nullptr, nullptr, cout, cin, h, w, y0,
                          x0, c0, sm, acc);

  const int xx = x0 + lane;
  const int ntiles = gridDim.x;
#pragma unroll
  for (int j = 0; j < kCoPerWarp; ++j) {
    const int c = c0 + warp * kCoPerWarp + j;  // the same in the whole warp
    if (c >= cin) break;
    const int64_t base = (static_cast<int64_t>(b) * cin + c) * plane;
    if (!kPrologue) {
#pragma unroll
      for (int r = 0; r < kTileH; ++r) {
        const int yy = y0 + r;
        if (yy < h && xx < w) dx[base + static_cast<int64_t>(yy) * w + xx] = acc[j][r];
      }
      continue;
    }
    const float sc = scale[c], sh = shift[c];
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
      const int yy = y0 + r;
      if (yy < h && xx < w) {
        const int64_t i = base + static_cast<int64_t>(yy) * w + xx;
        const float xv = x[i];
        const float dam = __fadd_rn(__fmul_rn(xv, sc), sh) > 0.0f ? acc[j][r] : 0.0f;
        dx[i] = __fmul_rn(dam, sc);
        s0 = fmaf(dam, xv, s0);
        s1 += dam;
      }
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      float* p = part + (static_cast<int64_t>(b) * ntiles + tile) * 2 * cin + c;
      p[0] = s0;
      p[cin] = s1;
    }
  }
}

}  // namespace

// Floats of scratch that im2im_dgrad3x3 needs for its reduction partials.
extern "C" long long im2im_dgrad3x3_scratch(int b, int cin, int h, int w) {
  return static_cast<long long>(b) * tiles_w(w) * tiles_h(h) * 2 * cin;
}

// K6. g (b, cout, h, w), weight (cout, cin, 3, 3) the forward kernel, x
// (b, cin, h, w) the forward's raw input, dx (b, cin, h, w); float32,
// contiguous. With prologue != 0: scale, shift (cin), part
// (im2im_dgrad3x3_scratch floats) and red (2, cin) are used and red is
// written. Returns a cudaError_t value.
extern "C" int im2im_dgrad3x3(const void* g, const void* weight, const void* x,
                              const void* scale, const void* shift, void* dx, void* part,
                              void* red, int b, int cin, int cout, int h, int w, int prologue,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntw = tiles_w(w);
  const int ntiles = ntw * tiles_h(h);
  const dim3 grid(static_cast<unsigned>(ntiles),
                  static_cast<unsigned>((cin + kCoTile - 1) / kCoTile), static_cast<unsigned>(b));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* wf = static_cast<const float*>(weight);
  const auto* xf = static_cast<const float*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* pf = static_cast<float*>(part);
  if (!prologue) {
    dgrad3x3_kernel<false><<<grid, kThreads, 0, s>>>(gf, wf, xf, sc, sh,
                                                     static_cast<float*>(dx), pf, cin, cout, h,
                                                     w, ntw);
    return static_cast<int>(cudaGetLastError());
  }
  dgrad3x3_kernel<true><<<grid, kThreads, 0, s>>>(gf, wf, xf, sc, sh, static_cast<float*>(dx),
                                                  pf, cin, cout, h, w, ntw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_reduce_rows(pf, static_cast<float*>(red), 1, static_cast<int64_t>(b) * ntiles,
                         2LL * cin, s));
}
