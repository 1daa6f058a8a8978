// K6: the input gradient of K4, NCHW, float32, for sm_90a (its bfloat16
// instance is conv3x3_bf16.cu's), for the shapes off the plan of
// dgrad3x3_tma.cu (ops/conv_bwd.dgrad_f32_plan: Cin not a multiple of 64,
// W not of 4, unaligned tensors), which runs the rest; also callable on any
// float32 shape for comparisons (conv_bwd.dgrad3x3_cp_async).
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
// What bounds it: the bound counts one multiply-add per (pixel, channel
// pair), the Winograd limit, at 165 TFLOP/s, the float32-accurate rate of
// 3xTF32 on the tensor cores, against the bytes of g and x read and dx
// written once. At batch 32, 320x320 the 40x40 and 20x20 levels are bound
// by operations, the larger ones by bytes.
//
// Design: the implicit GEMM of conv3x3_tc.cuh on the tensor cores (wgmma,
// A from registers) in 3xTF32, float32-accurate, which K3/K4 share: M =
// the pixels of a box of one image, N = 32 input channels a block, K = 9
// taps x Cout in chunks of 8 output channels, with A[p, (co, t)] = g[co] at
// pixel p shifted by tap t and B[(co, t), c] = W[co, c, 8 - t]: the weight
// is read flipped and transposed by index arithmetic while it is split,
// one contiguous run of 288 floats per output channel and chunk. Many
// pixels and few channels per block: every block stages the weights of its
// channels for every chunk, so a block of 256 pixels moves half the weight
// bytes per product of one of 128 (blocks of 128 x 64 and 128 x 128 were
// slower on the card). The box is chosen per shape to pad the least (320,
// 160, 80: none; 40: 10.7%; 20: 21.9%).
// The epilogue: the mask, the scale and the per-block (sum dam * x, sum
// dam) partials (a fixed butterfly over the lanes, then the M warps in
// order), summed over the blocks by conv3x3::reduce_rows in a fixed order:
// no float atomics, the same bits on every run.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tc.cuh"

namespace {

using namespace conv3x3;

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 2)
    dgrad3x3_tc_kernel(Grid g, const float* __restrict__ gy, const float* __restrict__ weight,
                       const float* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ shift, float* __restrict__ dx,
                       float* __restrict__ part, int cout) {
  extern __shared__ __align__(16) float smem[];
  const Place at = place(g);
  float acc[kMt][kNt][4];
  gemm<true, false>(geo(g, at, gy, weight, nullptr, nullptr, cout), smem, acc);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cin = g.nc, h = g.h, w = g.w, tw = g.box.tw;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int npx = g.box.th * tw;

  float s0[kNt][2], s1[kNt][2];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) s0[j][e] = s1[j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = pixel(warp, i, gid, u);
      const int y = at.y0 + p / tw, xx = at.x0 + p % tw;
      if (p >= npx || y >= h || xx >= w) continue;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = at.n0 + 8 * j + 2 * tig + e;
          if (c >= cin) continue;
          const int64_t idx = (static_cast<int64_t>(at.b) * cin + c) * hw + y * w + xx;
          const float v = acc[i][j][2 * u + e];
          if (!kPrologue) {
            store(dx + idx, v);
            continue;
          }
          const float sc = scale[c];
          const float xv = to_f32(x[idx]);
          const float dam = __fadd_rn(__fmul_rn(xv, sc), shift[c]) > 0.0f ? v : 0.0f;
          store(dx + idx, __fmul_rn(dam, sc));
          s0[j][e] = fmaf(dam, xv, s0[j][e]);
          s1[j][e] += dam;
        }
    }
  if (!kPrologue) return;

  // the block's sums per channel: lanes of one tig in a fixed butterfly,
  // then the M warps in order
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s0[j][e] += __shfl_xor_sync(0xffffffffu, s0[j][e], m);
        s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], m);
      }
  __syncthreads();  // every warp is done with the stages
  float* red = smem;  // [warp][c_l][2]
  if (gid == 0) {
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c_l = 8 * j + 2 * tig + e;
        red[(warp * kBn + c_l) * 2] = s0[j][e];
        red[(warp * kBn + c_l) * 2 + 1] = s1[j][e];
      }
  }
  __syncthreads();
  if (tid < kBn && at.n0 + tid < cin) {
    float s_sum = 0.0f, q_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < kWarps; ++m) {
      s_sum += red[(m * kBn + tid) * 2];
      q_sum += red[(m * kBn + tid) * 2 + 1];
    }
    float* p = part + (static_cast<int64_t>(at.b) * (gridDim.x / g.ntn) + at.box) * 2 * cin + at.n0 + tid;
    p[0] = s_sum;
    p[cin] = q_sum;
  }
}

template <bool kPrologue>
cudaError_t launch(const Grid& gr, int b, int cout, const float* g, const float* weight,
                   const float* x, const float* sc, const float* sh, float* dx, float* pf,
                   cudaStream_t s) {
  return launch_grid(dgrad3x3_tc_kernel<kPrologue>, gr, b, s, g, weight, x, sc, sh, dx, pf, cout);
}

}  // namespace

// Floats of scratch that im2im_dgrad3x3 needs for its reduction partials.
extern "C" long long im2im_dgrad3x3_scratch(int b, int cin, int h, int w) {
  return static_cast<long long>(b) * make_grid(h, w, cin).boxes * 2 * cin;
}

// K6. g (b, cout, h, w), weight (cout, cin, 3, 3) the forward kernel, x
// (b, cin, h, w) the forward's raw input, dx (b, cin, h, w): float32,
// contiguous. With prologue != 0: scale, shift (cin) float32, part
// (im2im_dgrad3x3_scratch floats) and red (2, cin) float32 are used and red
// is written. Returns a cudaError_t value.
extern "C" int im2im_dgrad3x3(const void* g, const void* weight, const void* x,
                              const void* scale, const void* shift, void* dx, void* part,
                              void* red, int b, int cin, int cout, int h, int w, int prologue,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid gr = make_grid(h, w, cin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* wf = static_cast<const float*>(weight);
  const auto* xf = static_cast<const float*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* dxf = static_cast<float*>(dx);
  auto* pf = static_cast<float*>(part);
  err = prologue ? launch<true>(gr, b, cout, gf, wf, xf, sc, sh, dxf, pf, s)
                 : launch<false>(gr, b, cout, gf, wf, xf, sc, sh, dxf, pf, s);
  if (err != cudaSuccess || !prologue) return static_cast<int>(err);
  return static_cast<int>(launch_reduce_rows(pf, static_cast<float*>(red), 1,
                                             static_cast<int64_t>(b) * gr.boxes, 2LL * cin, s));
}
