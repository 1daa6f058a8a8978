// K5: the weight and bias gradients of K4, NCHW, float32, for sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_conv_bwd.py
// `wgrad3x3_pallas_raw` (`_wgrad_kernel`).
//
// What it computes, for the input x (B, Cin, H, W) and the cotangent g
// (B, Cout, H, W) of a 3x3 same-padding conv:
//   a      = relu(x * scale + shift) inside the image with the prologue, x
//            without it, and 0 outside the image;
//   dW[co, c, dh, dw] = sum over b, y, x of g[b, co, y, x]
//                       * a[b, c, y + dh - 1, x + dw - 1],
//   db[co] = sum over b, y, x of g[b, co, y, x],
// dW in nn.Conv2d's (Cout, Cin, 3, 3) layout.
//
// What bounds it: operations: a GEMM of M = Cout, N = Cin * 9 and a
// reduction depth K = B*H*W (3.3 M at batch 32, 320x320) on the CUDA cores.
// Design: K is split across blocks by runs of image rows (a slice), enough
// slices that about 8 blocks per SM are in flight; each block owns a tile
// of 64 output channels x 32 input channels x 9 taps and walks its slice
// one row of 32 columns at a time, staging the row's cotangent (32, 64) and
// the three input rows it touches (32 channels x 3 x 34, with the prologue
// applied to the elements inside the image) in shared memory. Lane l of
// warp k owns input channel l and output channels 8k..8k+7: 72 f32
// accumulators, a sliding 3x3 window of the input in registers (3 new
// values per column), the cotangent as two broadcast 16-byte loads. The
// slices write partial dW and db, and a second pass sums them over the
// slices in a fixed order: no float atomics. The TPU kernel's column
// chunking and its gates (128-aligned channels, the row tile, f32 C <= 256)
// were Mosaic limits and are gone: every shape runs.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoT = 64;        // output channels per block, 8 per warp
constexpr int kCiT = 32;        // input channels per block, one per lane
constexpr int kCols = 32;       // columns per staged row
constexpr int kAsRow = kCols + 2;
constexpr int kAsPlane = 3 * kAsRow + 1;  // odd: lanes hit distinct banks
constexpr int kGsStride = kCoT + 4;       // 16-byte rows
constexpr int64_t kTargetBlocks = 8 * 132;

struct __align__(16) WgradSmem {
  float gs[kCols * kGsStride];  // [col][co]
  float as[kCiT * kAsPlane];    // [ci][dh][col]
};

int64_t ci_tiles(int cin) { return (cin + kCiT - 1) / kCiT; }
int64_t co_tiles(int cout) { return (cout + kCoT - 1) / kCoT; }

// rows of (image, y) per slice: enough slices for kTargetBlocks blocks
int64_t rows_per_slice(int b, int cin, int cout, int h) {
  const int64_t rows = static_cast<int64_t>(b) * h;
  const int64_t tiles = ci_tiles(cin) * co_tiles(cout);
  int64_t want = (kTargetBlocks + tiles - 1) / tiles;
  if (want > rows) want = rows;
  return (rows + want - 1) / want;
}

int64_t num_slices(int b, int cin, int cout, int h) {
  const int64_t rps = rows_per_slice(b, cin, cout, h);
  return (static_cast<int64_t>(b) * h + rps - 1) / rps;
}

// no minimum of resident blocks: under the 128-register cap that two blocks
// per SM would need, the 72 + 8 accumulators and the 3x3 window spill
template <bool kPrologue>
__global__ void __launch_bounds__(kThreads)
    wgrad3x3_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    float* __restrict__ part_w, float* __restrict__ part_b, int b_total,
                    int cin, int cout, int h, int w, int64_t rps, int nci) {
  __shared__ WgradSmem sm;
  const int64_t slice = blockIdx.x;
  const int ci_tile = blockIdx.y % nci;
  const int co0 = (blockIdx.y / nci) * kCoT;
  const int ci0 = ci_tile * kCiT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t rows = static_cast<int64_t>(b_total) * h;
  const int64_t row_end = (slice + 1) * rps < rows ? (slice + 1) * rps : rows;

  float acc[8][9];
  float dbacc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dbacc[j] = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[j][t] = 0.0f;
  }

  for (int64_t row = slice * rps; row < row_end; ++row) {
    const int b = static_cast<int>(row / h);
    const int yy = static_cast<int>(row % h);
    const float* xb = x + static_cast<int64_t>(b) * cin * plane;
    const float* gb = g + static_cast<int64_t>(b) * cout * plane;
    for (int x0 = 0; x0 < w; x0 += kCols) {
      __syncthreads();  // the previous row's tiles are consumed
      for (int e = tid; e < kCiT * 3 * kAsRow; e += kThreads) {
        const int ci = ci0 + e / (3 * kAsRow);
        const int rem = e % (3 * kAsRow);
        const int gy = yy - 1 + rem / kAsRow;
        const int gx = x0 - 1 + rem % kAsRow;
        float v = 0.0f;
        if (ci < cin && gy >= 0 && gy < h && gx >= 0 && gx < w) {
          v = xb[ci * plane + static_cast<int64_t>(gy) * w + gx];
          if (kPrologue) v = conv3x3::affine_relu(v, scale[ci], shift[ci]);
        }
        sm.as[(e / (3 * kAsRow)) * kAsPlane + rem] = v;
      }
      for (int e = tid; e < kCoT * kCols; e += kThreads) {
        const int co = co0 + e / kCols;
        const int xx = x0 + e % kCols;
        sm.gs[(e % kCols) * kGsStride + e / kCols] =
            co < cout && xx < w ? gb[co * plane + static_cast<int64_t>(yy) * w + xx] : 0.0f;
      }
      __syncthreads();
      const float* ap = sm.as + lane * kAsPlane;
      float a[3][3];
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
        a[dh][0] = ap[dh * kAsRow];
        a[dh][1] = ap[dh * kAsRow + 1];
      }
#pragma unroll 4
      for (int c = 0; c < kCols; ++c) {
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) a[dh][2] = ap[dh * kAsRow + c + 2];
        const float* gp = sm.gs + c * kGsStride + warp * 8;
        const float4 ga = *reinterpret_cast<const float4*>(gp);
        const float4 gc = *reinterpret_cast<const float4*>(gp + 4);
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gc.x, gc.y, gc.z, gc.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int dw = 0; dw < 3; ++dw)
              acc[j][dh * 3 + dw] = fmaf(gv[j], a[dh][dw], acc[j][dh * 3 + dw]);
          if (ci_tile == 0) dbacc[j] += gv[j];  // the same branch in the whole block
        }
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          a[dh][0] = a[dh][1];
          a[dh][1] = a[dh][2];
        }
      }
    }
  }

  const int ci = ci0 + lane;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + warp * 8 + j;
    if (co >= cout) break;
    if (ci < cin) {
      float* p = part_w + ((slice * cout + co) * cin + ci) * 9;
#pragma unroll
      for (int t = 0; t < 9; ++t) p[t] = acc[j][t];
    }
    if (ci_tile == 0 && lane == 0) part_b[slice * cout + co] = dbacc[j];
  }
}

}  // namespace

// Floats of scratch that im2im_wgrad3x3 needs for its split-K partials.
extern "C" long long im2im_wgrad3x3_scratch(int b, int cin, int cout, int h, int w) {
  (void)w;
  return num_slices(b, cin, cout, h) * (static_cast<long long>(cout) * cin * 9 + cout);
}

// K5. x (b, cin, h, w) the forward's raw input, g (b, cout, h, w), scale,
// shift (cin) read when prologue != 0, scratch (im2im_wgrad3x3_scratch
// floats), dw (cout, cin, 3, 3), db (cout); float32, contiguous. Returns a
// cudaError_t value.
extern "C" int im2im_wgrad3x3(const void* x, const void* g, const void* scale,
                              const void* shift, void* scratch, void* dw, void* db, int b,
                              int cin, int cout, int h, int w, int prologue, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rps = rows_per_slice(b, cin, cout, h);
  const int64_t slices = num_slices(b, cin, cout, h);
  const int nci = static_cast<int>(ci_tiles(cin));
  const int64_t tiles = nci * co_tiles(cout);
  if (slices > 0x7fffffff || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto* part_w = static_cast<float*>(scratch);
  auto* part_b = part_w + slices * cout * cin * 9;
  const dim3 grid(static_cast<unsigned>(slices), static_cast<unsigned>(tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(g);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  if (prologue)
    wgrad3x3_kernel<true><<<grid, kThreads, 0, s>>>(xf, gf, sc, sh, part_w, part_b, b, cin, cout,
                                                    h, w, rps, nci);
  else
    wgrad3x3_kernel<false><<<grid, kThreads, 0, s>>>(xf, gf, sc, sh, part_w, part_b, b, cin,
                                                     cout, h, w, rps, nci);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = conv3x3::launch_reduce_rows(part_w, static_cast<float*>(dw), 1, slices,
                                    static_cast<int64_t>(cout) * cin * 9, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      conv3x3::launch_reduce_rows(part_b, static_cast<float*>(db), 1, slices, cout, s));
}
