// K3 and K4: the 3x3 same-padding convolution + bias, and its fused form
// with a BatchNorm+ReLU prologue and a per-channel stats epilogue; NCHW,
// float32 and bfloat16, for sm_90a.
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
// What bounds it: the bound counts one multiply-add per (pixel, channel
// pair), the Winograd limit, at 165 TFLOP/s, the float32-accurate rate of
// 3xTF32 on the tensor cores, against the bytes of x read and y written
// once. At batch 32, 320x320 the 320x320 and 160x160 levels are bound by
// bytes, the 40x40 and 20x20 levels by operations.
//
// Design: the implicit GEMM of conv3x3_tc.cuh on the tensor cores (wgmma,
// A from registers) in 3xTF32, float32-accurate: M = the pixels of a box of
// one image, N = 32 output channels a block, K = 9 taps x Cin in chunks of
// 8 input channels, the weights unflipped, one contiguous run of 72 floats
// per output channel and chunk. The box is chosen per shape to pad the
// least (none at 320, 160 and 80; 10.7% at 40, 21.9% at 20, where the 8 x 32
// tile of the FFMA kernel before this one padded 37.5% and 47.9%). The
// prologue is applied in shared memory, by the thread that copied each in-image
// element, after its cp.async lands. The epilogue adds the bias (rounded to
// nearest), stores y and takes the stats over the stored values: a fixed
// butterfly over the lanes, the warps in order into per-block partials,
// summed per image over the boxes by conv3x3::reduce_rows in a fixed
// order: no float atomics, the same bits on every run.
//
// The stem (Cin = 1, K = 9) has its own kernel: a thread per pixel of the
// same boxes, its 9 taps in registers, FFMA over the output channels (the
// weights read as warp-wide broadcasts), the stats per channel by a warp
// butterfly and the warps in order. Its bound is the bytes of y. The GEMM
// runs Cin = 1 as well (its chunks are zero past the channels), but pads K
// = 9 to 72 and was slower there on an H100: at (32, 1, 320, 320, 64), 0.99
// ms against the stem's 0.69 with the stats, 0.87 against 0.39 without
// (scripts/compare_conv_builds.py --gemm-stem).
//
// bfloat16 (x, weight, bias and y bf16; scale, shift and stats f32): the
// stem (Cin = 1) runs bf16 through its FFMA kernel here (a product of two
// bf16 values is exact in float32; TMA cannot take its 2-byte pixels); every
// other bf16 K3/K4 runs on wgmma fed by TMA over an NHWC copy of x
// (conv3x3_bf16.cu, im2im_conv3x3_wgmma), which this entry point refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "conv3x3_tc.cuh"

namespace {

using namespace conv3x3;

// K3/K4 in float32 on the GEMM (the prologue in the GEMM).
template <bool kPrologue, bool kStats>
__global__ void __launch_bounds__(kThreads, 2)
    conv3x3_fwd_kernel(Grid g, const float* __restrict__ x, const float* __restrict__ weight,
                       const float* __restrict__ bias, const float* __restrict__ scale,
                       const float* __restrict__ shift, float* __restrict__ y,
                       float* __restrict__ part, int cin) {
  extern __shared__ __align__(16) float smem[];
  const Place at = place(g);
  float acc[kMt][kNt][4];
  gemm<false, kPrologue>(geo(g, at, x, weight, scale, shift, cin), smem, acc);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cout = g.nc, h = g.h, w = g.w, tw = g.box.tw;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int npx = g.box.th * tw;
  float bv[kNt][2], s[kNt][2], q[kNt][2];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = at.n0 + 8 * j + 2 * tig + e;
      bv[j][e] = bias != nullptr && c < cout ? to_f32(bias[c]) : 0.0f;
      s[j][e] = q[j][e] = 0.0f;
    }
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = pixel(warp, i, gid, u);
      const int yy = at.y0 + p / tw, xx = at.x0 + p % tw;
      if (p >= npx || yy >= h || xx >= w) continue;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = at.n0 + 8 * j + 2 * tig + e;
          if (c >= cout) continue;
          const float v = store(y + (static_cast<int64_t>(at.b) * cout + c) * hw + yy * w + xx,
                                __fadd_rn(acc[i][j][2 * u + e], bv[j][e]));
          if (kStats) {  // over the stored values, as the TPU kernel
            s[j][e] += v;
            q[j][e] = fmaf(v, v, q[j][e]);
          }
        }
    }
  if (!kStats) return;

  // the block's sums per channel: lanes of one tig in a fixed butterfly,
  // then the M warps in order
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s[j][e] += __shfl_xor_sync(0xffffffffu, s[j][e], m);
        q[j][e] += __shfl_xor_sync(0xffffffffu, q[j][e], m);
      }
  __syncthreads();  // every warp is done with the stages
  float* red = smem;  // [warp][c_l][2]
  if (gid == 0) {
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c_l = 8 * j + 2 * tig + e;
        red[(warp * kBn + c_l) * 2] = s[j][e];
        red[(warp * kBn + c_l) * 2 + 1] = q[j][e];
      }
  }
  __syncthreads();
  if (tid < kBn && at.n0 + tid < cout) {
    float s_sum = 0.0f, q_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < kWarps; ++m) {
      s_sum += red[(m * kBn + tid) * 2];
      q_sum += red[(m * kBn + tid) * 2 + 1];
    }
    float* p = part + (static_cast<int64_t>(at.b) * (gridDim.x / g.ntn) + at.box) * 2 * cout + at.n0 + tid;
    p[0] = s_sum;
    p[cout] = q_sum;
  }
}

// The stem, Cin = 1: a thread per pixel of the box, all output channels. In
// bf16 the prologue's activation is rounded to bf16 before the products.
template <typename T, bool kPrologue, bool kStats>
__global__ void __launch_bounds__(kThreads)
    conv3x3_fwd_stem_kernel(const T* __restrict__ x, const T* __restrict__ weight,
                            const T* __restrict__ bias, const float* __restrict__ scale,
                            const float* __restrict__ shift, T* __restrict__ y,
                            float* __restrict__ part, int cout, int h, int w, int th, int tw) {
  __shared__ float red[kWarps][32][2];
  const int b = blockIdx.y, box = blockIdx.x;
  const int nbx = (w + tw - 1) / tw;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int yy = (box / nbx) * th + tid / tw, xx = (box % nbx) * tw + tid % tw;
  const bool in = tid < th * tw && yy < h && xx < w;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const T* xb = x + static_cast<int64_t>(b) * hw;
  const float sc = kPrologue ? scale[0] : 0.0f, sh = kPrologue ? shift[0] : 0.0f;
  float a[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int ty = yy + t / 3 - 1, tx = xx + t % 3 - 1;
    const bool ok = in && ty >= 0 && ty < h && tx >= 0 && tx < w;
    const float v = ok ? to_f32(xb[ty * w + tx]) : 0.0f;
    a[t] = kPrologue && ok ? round_as<T>(affine_relu(v, sc, sh)) : v;
  }
  T* out = y + static_cast<int64_t>(b) * cout * hw + yy * w + xx;
  for (int c0 = 0; c0 < cout; c0 += 32) {
    const int nc = cout - c0 < 32 ? cout - c0 : 32;
    for (int c_l = 0; c_l < nc; ++c_l) {
      const int c = c0 + c_l;
      const T* wc = weight + c * 9;  // the same address in the whole block
      float acc = __fmul_rn(to_f32(wc[0]), a[0]);
#pragma unroll
      for (int t = 1; t < 9; ++t) acc = fmaf(to_f32(wc[t]), a[t], acc);
      float v = __fadd_rn(acc, bias != nullptr ? to_f32(bias[c]) : 0.0f);
      if (in) v = store(out + c * hw, v);
      if (kStats) {
        float sv = in ? v : 0.0f, qv = sv * sv;
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          sv += __shfl_xor_sync(0xffffffffu, sv, m);
          qv += __shfl_xor_sync(0xffffffffu, qv, m);
        }
        if (lane == 0) {
          red[warp][c_l][0] = sv;
          red[warp][c_l][1] = qv;
        }
      }
    }
    if (kStats) {
      __syncthreads();
      if (tid < nc) {
        float s_sum = 0.0f, q_sum = 0.0f;
#pragma unroll
        for (int m = 0; m < kWarps; ++m) {
          s_sum += red[m][tid][0];
          q_sum += red[m][tid][1];
        }
        float* p = part + (static_cast<int64_t>(b) * gridDim.x + box) * 2 * cout + c0 + tid;
        p[0] = s_sum;
        p[cout] = q_sum;
      }
      __syncthreads();
    }
  }
}

template <typename T, bool kPrologue, bool kStats>
cudaError_t launch(const Grid& g, int b, int cin, const T* x, const T* weight, const T* bias,
                   const float* scale, const float* shift, T* y, float* part, cudaStream_t s) {
  if (cin == 1) {
    if (b > 65535) return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(g.boxes), static_cast<unsigned>(b));
    conv3x3_fwd_stem_kernel<T, kPrologue, kStats><<<grid, kThreads, 0, s>>>(
        x, weight, bias, scale, shift, y, part, g.nc, g.h, g.w, g.box.th, g.box.tw);
    return cudaGetLastError();
  }
  if constexpr (std::is_same_v<T, float>)
    return launch_grid(conv3x3_fwd_kernel<kPrologue, kStats>, g, b, s, x, weight, bias, scale,
                       shift, y, part, cin);
  else
    return cudaErrorInvalidValue;  // bf16 beyond the stem: im2im_conv3x3_wgmma
}

template <typename T>
cudaError_t launch_all(const Grid& g, int b, int cin, const void* x, const void* weight,
                       const void* bias, const float* sc, const float* sh, void* y, float* pf,
                       int prologue, int with_stats, cudaStream_t s) {
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(weight);
  const auto* bt = static_cast<const T*>(bias);
  auto* yt = static_cast<T*>(y);
  if (prologue && with_stats)
    return launch<T, true, true>(g, b, cin, xt, wt, bt, sc, sh, yt, pf, s);
  if (prologue) return launch<T, true, false>(g, b, cin, xt, wt, bt, sc, sh, yt, pf, s);
  if (with_stats) return launch<T, false, true>(g, b, cin, xt, wt, bt, sc, sh, yt, pf, s);
  return launch<T, false, false>(g, b, cin, xt, wt, bt, sc, sh, yt, pf, s);
}

}  // namespace

// Floats of scratch that im2im_conv3x3_fused needs for its stats partials.
extern "C" long long im2im_conv3x3_scratch(int b, int cout, int h, int w) {
  return static_cast<long long>(b) * make_grid(h, w, cout).boxes * 2 * cout;
}

// K3 and K4. x (b, cin, h, w), weight (cout, cin, 3, 3), bias (cout) or
// null, y (b, cout, h, w): dtype 0 float32, 1 bfloat16 (cin = 1 only, the
// stem), contiguous; scale, shift (cin) float32 feed the prologue, read
// when prologue != 0; with with_stats != 0, part (im2im_conv3x3_scratch
// floats) and stats (b, 2, cout) float32 are written: stats[i][0] = sum of
// y[i], stats[i][1] = sum of y[i]^2 per channel, over the stored values. K3
// is the call with neither. Returns a cudaError_t value.
extern "C" int im2im_conv3x3_fused(const void* x, const void* weight, const void* bias,
                                   const void* scale, const void* shift, void* y, void* part,
                                   void* stats, int b, int cin, int cout, int h,
                                   int w, int prologue, int with_stats, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = make_grid(h, w, cout);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_all<float>(g, b, cin, x, weight, bias, sc, sh, y, pf, prologue, with_stats, s);
  else
    err = launch_all<__nv_bfloat16>(g, b, cin, x, weight, bias, sc, sh, y, pf, prologue,
                                    with_stats, s);
  if (err != cudaSuccess || !with_stats) return static_cast<int>(err);
  return static_cast<int>(
      launch_reduce_rows(pf, static_cast<float*>(stats), b, g.boxes, 2LL * cout, s));
}
