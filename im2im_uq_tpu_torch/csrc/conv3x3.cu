// K3 and K4: the 3x3 same-padding convolution + bias, and its fused form
// with a BatchNorm+ReLU prologue and a per-channel stats epilogue; NCHW,
// float32, for sm_90a.
//
// Replaces the TPU kernels im2im_uq_tpu/ops/pallas_conv.py
//   K3 `conv3x3_pallas_raw` (`_conv_kernel_db`): y = conv3x3(x) + bias;
//   K4 `_conv3x3_fused_raw` (`_conv_kernel_fused`):
//      y = conv3x3(relu(x * scale + shift)) + bias, the prologue optional
//      and applied inside the image only (the zero frame stays zero when
//      shift > 0, pallas_conv.py:157-161), and, optionally, per-(image,
//      channel) sums of the stored y and y^2: stats (B, 2, Cout).
// One kernel template serves both; K3 is its instance with neither the
// prologue nor the stats.
//
// What bounds it: operations. A conv does 2 * B*H*W * Cin*Cout*9 FLOPs on
// B*H*W*(Cin + Cout) floats, hundreds of FLOPs per byte at the UNet's
// widths, and f32 runs on the CUDA cores (67 TFLOP/s on an H100 SXM), not
// on the tensor cores. Design (conv3x3_tile.cuh): implicit GEMM on register
// tiles of 8 channels x 8 rows per thread, the halo and the weights staged
// in shared memory, 9 FFMA per loaded input value and 64 per loaded weight
// vector. The TPU kernel's gates (Cin % 128, the row tile, W padded to 8)
// and the XLA fallback beside it are gone: every shape runs, Cin = 1
// included. Tensor cores (wgmma on TF32 or bf16) and TMA double buffering
// are later work.
//
// The stats are taken per block over its 8 x 32 pixels (a warp butterfly
// per channel), written as partials, and summed over the blocks of each
// image in a second fixed-order pass: no float atomics.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

template <bool kPrologue, bool kStats>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ weight,
                       const float* __restrict__ bias, const float* __restrict__ scale,
                       const float* __restrict__ shift, float* __restrict__ y,
                       float* __restrict__ part, int cin, int cout, int h, int w, int ntw) {
  __shared__ Smem sm;
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kCoTile;
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
  accumulate<kPrologue, false>(x + b * cin * plane, weight, scale, shift, cin, cout, h, w, y0,
                               x0, co0, sm, acc);

  const int xx = x0 + lane;
  const int ntiles = gridDim.x;
#pragma unroll
  for (int j = 0; j < kCoPerWarp; ++j) {
    const int co = co0 + warp * kCoPerWarp + j;  // the same in the whole warp
    if (co >= cout) break;
    const float bv = bias != nullptr ? bias[co] : 0.0f;
    float* out = y + (static_cast<int64_t>(b) * cout + co) * plane;
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
      const int yy = y0 + r;
      if (yy < h && xx < w) {
        const float v = __fadd_rn(acc[j][r], bv);
        out[static_cast<int64_t>(yy) * w + xx] = v;
        if (kStats) {  // over the stored values, as the TPU kernel
          s += v;
          q = fmaf(v, v, q);
        }
      }
    }
    if (kStats) {
      s = warp_sum(s);
      q = warp_sum(q);
      if (lane == 0) {
        float* p = part + (static_cast<int64_t>(b) * ntiles + tile) * 2 * cout + co;
        p[0] = s;
        p[cout] = q;
      }
    }
  }
}

template <bool kPrologue, bool kStats>
cudaError_t launch(const float* x, const float* weight, const float* bias, const float* scale,
                   const float* shift, float* y, float* part, int b, int cin, int cout, int h,
                   int w, cudaStream_t stream) {
  const int ntw = tiles_w(w);
  const dim3 grid(static_cast<unsigned>(ntw * tiles_h(h)),
                  static_cast<unsigned>((cout + kCoTile - 1) / kCoTile),
                  static_cast<unsigned>(b));
  conv3x3_fwd_kernel<kPrologue, kStats><<<grid, kThreads, 0, stream>>>(
      x, weight, bias, scale, shift, y, part, cin, cout, h, w, ntw);
  return cudaGetLastError();
}

bool bad_shape(int b, int cin, int cout, int h, int w) {
  return b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || b > 65535;
}

}  // namespace

// Floats of scratch that im2im_conv3x3_fused needs for its stats partials.
extern "C" long long im2im_conv3x3_scratch(int b, int cout, int h, int w) {
  return static_cast<long long>(b) * tiles_w(w) * tiles_h(h) * 2 * cout;
}

// K3 and K4. x (b, cin, h, w), weight (cout, cin, 3, 3), bias (cout) or
// null, y (b, cout, h, w); float32, contiguous. scale, shift (cin) feed
// the prologue, read when prologue != 0; with with_stats != 0, part
// (im2im_conv3x3_scratch floats) and stats (b, 2, cout) are written:
// stats[i][0] = sum of y[i], stats[i][1] = sum of y[i]^2 per channel. K3 is
// the call with neither. Returns a cudaError_t value.
extern "C" int im2im_conv3x3_fused(const void* x, const void* weight, const void* bias,
                                   const void* scale, const void* shift, void* y, void* part,
                                   void* stats, int b, int cin, int cout, int h, int w,
                                   int prologue, int with_stats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(b, cin, cout, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(weight);
  const auto* bf = static_cast<const float*>(bias);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* yf = static_cast<float*>(y);
  auto* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prologue && with_stats)
    err = launch<true, true>(xf, wf, bf, sc, sh, yf, pf, b, cin, cout, h, w, s);
  else if (prologue)
    err = launch<true, false>(xf, wf, bf, sc, sh, yf, pf, b, cin, cout, h, w, s);
  else if (with_stats)
    err = launch<false, true>(xf, wf, bf, sc, sh, yf, pf, b, cin, cout, h, w, s);
  else
    err = launch<false, false>(xf, wf, bf, sc, sh, yf, pf, b, cin, cout, h, w, s);
  if (err != cudaSuccess || !with_stats) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_rows(pf, static_cast<float*>(stats), b,
                                             static_cast<int64_t>(tiles_w(w)) * tiles_h(h),
                                             2LL * cout, s));
}
