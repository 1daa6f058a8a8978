// K3-K6 in bfloat16 on Hopper's wgmma fed by TMA, for sm_90a: the forward
// conv (K3, K4) over an NHWC copy of its input, and its backward (K5, K6)
// over one cotangent that both read.
//
// Replaces, in bf16, the TPU kernels im2im_uq_tpu/ops/pallas_conv.py
// `conv3x3_pallas_raw` (K3) and `_conv3x3_fused_raw` (K4),
// im2im_uq_tpu/ops/pallas_conv_bwd.py `wgrad3x3_pallas_raw` (K5) and
// `dgrad3x3_pallas_raw` (K6), and the padded cotangent that the JAX package
// materializes once for K5 and K6 (im2im_uq_tpu/ops/pallas_conv.py:371-376,
// 424-427).
//
// What it computes, for the fused conv y = conv3x3(relu(x * scale + shift))
// + b (prologue on) or conv3x3(x) + b with x (B, Cin, H, W) and its
// cotangent gy (B, Cout, H, W), NCHW bf16:
//   the activation pass: a[b, y, x, c] = bf16(relu(f32(x) * scale +
//                          shift)) (x itself without the prologue), NHWC,
//                          channels padded to a multiple of 8 with 0 (the
//                          operand of K3/K4 and of K5);
//   K3/K4:               y[p, co] = bf16(sum over (t, c) of a[p + s_t, c] *
//                          W[co, c, t] + b[co]), the sum in f32 and rounded
//                          once (the TPU kernel's f32 accumulator), and with
//                          the stats the per-(image, channel) sums of f32(y)
//                          and f32(y)^2 over the stored values;
//   the cotangent pass:  g[b, y, x, co] = bf16(f32(gy) + gs[b, co]
//                          + 2 f32(y) gq[b, co]) with the stats' cotangent
//                          (gs, gq) = gst[b], else gy; written once, NHWC,
//                          padded as the activation;
//   K5:                  dW[co, c, t] = sum over pixels p of g[p, co] *
//                          a[p + s_t, c] (0 outside the image) and db[co] =
//                          sum of f32(g[p, co]), f32;
//   K6:                  da[p, c] = sum over (t, co) of g[p - s_t, co] *
//                          W[co, c, t]; with the prologue the mask
//                          f32(x) * scale + shift > 0 (the product and the
//                          sum each rounded, no FMA contraction), dam = da
//                          masked, dx = bf16(dam * scale) NCHW, and the
//                          reductions (sum dam * x, sum dam) per channel;
//                          without it dx = bf16(da).
// Every product is an exact bf16 x bf16 product summed in f32.
//
// What bounds it: one multiply-add per (pixel, channel pair) at the bf16
// tensor-core rate (989 TFLOP/s) against x and g read once and dx written
// once (K3/K4: x read and y written once); at batch 32, 320x320 the 20x20
// and 40x40 levels are bound by operations, the larger ones by bytes.
//
// Design. With channels innermost a tap shift moves an operand by whole
// pixels of 16-byte groups of 8 channels, so every operand tile is a
// canonical wgmma layout without swizzle and lands by TMA: a box of 8
// channels x columns x rows of one image per group of 8 channels (the
// coordinates outside the image read as 0, which is the conv's zero
// frame). Both GEMMs run M over pixels of a tile flattened with its halo:
// an output tile of TH rows x TW columns sits in a haloed box of (TH + 2)
// rows x HC = TW + 2 columns, output pixel (r, c) at box position (r + 1)
// HC + c + 1, and tap (dh, dw) reads position (r + dh) HC + c + dw: the
// same run of positions shifted by dh HC + dw, so one descriptor per tap
// and m64 instance covers pixels across rows. The frame columns inside that
// run are computed and dropped.
// - K6 is the forward conv of g with the flipped, transposed kernel: M =
//   tile pixels (m64 instances of flattened positions), N = Cin in slices
//   of kBn = 64 or 128, K = 9 taps x Cout in chunks of 16 channels. The
//   weights of a slice are packed once per call (pack_weights_k6) into
//   wgmma's K-major B layout chunk by chunk and streamed through the ring
//   beside the g boxes, one bulk copy per chunk: the deep levels' weights
//   (9 x 512 x 128 x 2 bytes a slice) do not fit a block. One producer
//   warp keeps `stages` chunks in flight (full / empty mbarriers); two
//   consumer warpgroups each hold kMi m64 instances. Persistent blocks walk
//   the tiles of one slice; the epilogue of a tile (mask, dx, the
//   reductions) runs while the next tile's chunks land. Where W is a
//   multiple of 8, the producer also brings the tile's x into shared memory
//   by TMA while its products run, and dx leaves from there by one TMA
//   store: lane by lane, each load of x waited behind the previous store of
//   dx, and the epilogue took most of the time at 320x320. The reductions are
//   summed per block in a fixed order (lanes by a butterfly, then each
//   warp's running sum in shared memory, then the warps in order) and over
//   the blocks by conv3x3::reduce_rows: the same bits on every run.
// - K3/K4 are the same kernel body (k6::run) with the forward's epilogue,
//   under a kernel name of their own (conv3x3_fwd_wgmma_kernel): A = the
//   activation pass's NHWC copy of x (the prologue applied and rounded to
//   bf16 there, as the TPU kernel feeds its products), N = Cout in slices
//   of 64 or 128, K = 9 taps x Cin in chunks of 16, the weights packed
//   unflipped by the same pack_weights_k6. The epilogue adds the bias in
//   f32, rounds once to bf16 and stores y (by one TMA store from shared
//   memory where W % 8 == 0, else lane by lane); with the stats each tile's
//   sums of y and y^2 over the stored values run the same fixed order
//   (lanes by a butterfly, warps in order in shared memory, two buffers so
//   that one barrier a tile suffices) into a row per tile, summed per image
//   by conv3x3::reduce_rows. The bf16 K3/K4 before this one packed x into
//   NCHW words of channel pairs and ran N = 32 tiles with A from registers:
//   2.3-2.5x cuDNN's time at 40x40 and 20x20 (PERF.md). The stem (Cin = 1)
//   keeps its FFMA kernel (conv3x3.cu).
// - K5: M = 64 output channels, N = 64 input channels, K = the pixels of a
//   tile, with the 9 taps as 9 products of the same A. Each operand lands
//   as one TMA box of 64 channels, a 128-byte row a pixel (g: the tile's
//   TH x TW pixels; the activation: its (TH + 2) x HC haloed box), in the
//   128-byte swizzle; A (g, [pixel][co]) and B ([position][c]) are both
//   MN-major, read through swizzled descriptors with both transpose
//   immediates. A tap's B starts at any row of the box: the swizzle's
//   phase is the rows' own address bits (base offset 0, checked on the
//   card; the other reading is off by order 1). Each of three consumer
//   warpgroups owns one tap row dh (taps 3 dh .. 3 dh + 2). The tile's
//   pixels run in k-steps of 16 over a box of TH x TW (TW a multiple of 8;
//   columns past the image are 0 in g, so they add nothing); a k-step's
//   second 8 pixels may start the next row, and the B descriptor's stride
//   between its two groups of 8 rows then takes the frame's 2 columns. The
//   products accumulate in the tensor core across a block's tiles, at most
//   K5_DEPTH k-steps (ops/conv_bwd.py), which bounds the accumulator's
//   truncating adds (a fresh partial per tile, added in f32, needs twice
//   the registers, and N = 32 was slower on the card). db rides along: the
//   first tap row's warpgroup of the first N tile sums g's box, 16 bytes a
//   load, while the tile's products run. Split K: slices of tiles, their
//   partials summed by conv3x3::reduce_rows in a fixed order.
// - The stem (Cin = 1: a pixel of x is 2 bytes, under TMA's 16) runs
//   wgrad_stem_kernel, FFMA over the NHWC g: a lane per pixel and 8 output
//   channels, the 9 taps of x against one 16-byte load of g.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tc.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace tmak;

// ---------------------------------------------------------------------------
// The NHWC passes: NCHW bf16 in, NHWC bf16 out, channels padded to cp.

constexpr int kPx = 64;  // pixels a block
constexpr int kCc = 32;  // channels a round

enum Mode { kActivation = 0, kCotangent = 1 };

// One block: 64 pixels of one image, all channels in rounds of 32: reads
// coalesced along the pixels, a transpose in shared memory, 16-byte writes
// along the channels. kCotangent: g_tot with gst, gy as it is without.
// kActivation: relu(x * scale + shift) rounded to bf16 where scale is
// given, x where not.
template <int kMode>
__global__ void __launch_bounds__(256)
    nhwc_kernel(const __nv_bfloat16* __restrict__ in, const __nv_bfloat16* __restrict__ y,
                const float* __restrict__ gst, const float* __restrict__ scale,
                const float* __restrict__ shift, __nv_bfloat16* __restrict__ out, int c, int cp,
                int64_t hw) {
  __shared__ __align__(16) __nv_bfloat16 tile[kPx][kCc + 8];
  const int b = blockIdx.y;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPx;
  const int tid = threadIdx.x;
  const int pl = tid & (kPx - 1), cq = tid >> 6;  // the thread's pixel; channels cq + 4 k
  const int64_t p = p0 + pl;
  const bool pin = p < hw;
  for (int c0 = 0; c0 < cp; c0 += kCc) {
#pragma unroll
    for (int k = 0; k < kCc / 4; ++k) {
      const int cl = cq + 4 * k, ch = c0 + cl;
      float v = 0.0f;
      if (pin && ch < c) {
        const int64_t idx = (static_cast<int64_t>(b) * c + ch) * hw + p;
        v = __bfloat162float(in[idx]);
        if (kMode == kActivation) {
          if (scale != nullptr) v = conv3x3::affine_relu(v, scale[ch], shift[ch]);
        } else if (gst != nullptr) {
          // (f32(gy) + gs) + (2 f32(y)) gq, each operation rounded, as the
          // plain expression (2 y is exact)
          const float gs = gst[(2 * static_cast<int64_t>(b)) * c + ch];
          const float gq = gst[(2 * static_cast<int64_t>(b) + 1) * c + ch];
          v = __fadd_rn(__fadd_rn(v, gs), __fmul_rn(2.0f * __bfloat162float(y[idx]), gq));
        }
      }
      tile[pl][cl] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    const int pw = tid >> 2, v8 = 8 * (tid & 3);
    if (p0 + pw < hw && c0 + v8 < cp)
      *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * hw + p0 + pw) * cp + c0 + v8)) =
          *reinterpret_cast<const uint4*>(&tile[pw][v8]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The implicit GEMM over flattened haloed tiles, fed by TMA: K6, and K3/K4.

namespace k6 {

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kPiece = 32768;  // bytes per bulk copy of weights
constexpr int kKc = 16;        // K channels a chunk (two groups: one k16 step)

// Whose epilogue a block runs: K6's (mask, dx, the reductions) or the
// forward conv's (bias, y, the stats).
enum Kind { kDgrad = 0, kForward = 1 };

struct Geo {
  const __nv_bfloat16* x;     // K6: the forward's raw input (b, nc, h, w), for the mask
  const __nv_bfloat16* bias;  // the forward: (nc), or null
  const float* scale;         // K6 with the prologue: (nc)
  const float* shift;
  __nv_bfloat16* out;  // (b, nc, h, w): K6's dx, the forward's y
  float* part;         // K6: [block row][2][nc], the reductions; the forward: [tile][2][nc], the stats
  int b, h, w, nc, kp;  // nc: N channels (K6: Cin, the forward: Cout); kp: the NHWC operand's, padded to 8
  int th, tw, hc;       // output tile; haloed columns, tw + 2
  int stages, nch, ntn;   // ring stages, chunks, N slices
  int tiles_y, tiles_x, tiles;
  int plane, abytes, wbytes, sbytes;  // bytes: a group's box, the chunk's A, its weights, a stage
  int xs_bytes;  // the out tile of the TMA epilogue (0: the epilogue stores itself)
};

// wpack[slice][chunk][tap][n group][k half][8 n][8 k] = B[(k, tap), n] with k
// = chunk * 16 + 8 k half + k8 and n = slice * bn + 8 n group + n8, 0 past
// kdim and ndim: with flip, W[k][n][8 - tap] of a (K, N, 3, 3) weight (K6:
// the forward's weight, K = Cout, N = Cin, transposed and flipped); without,
// W[n][k][tap] of an (N, K, 3, 3) weight (the forward conv's, unflipped).
__global__ void pack_weights_k6(const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
                                int kdim, int ndim, int bn, int nch, int flip, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int64_t e = i;
    const int k8 = static_cast<int>(e % 8);
    e /= 8;
    const int n8 = static_cast<int>(e % 8);
    e /= 8;
    const int kh = static_cast<int>(e % 2);
    e /= 2;
    const int ng = static_cast<int>(e % (bn / 8));
    e /= bn / 8;
    const int tap = static_cast<int>(e % 9);
    e /= 9;
    const int ch = static_cast<int>(e % nch);
    const int ns = static_cast<int>(e / nch);
    const int k = ch * kKc + kh * 8 + k8, n = ns * bn + ng * 8 + n8;
    out[i] = k < kdim && n < ndim
                 ? w[flip ? (static_cast<int64_t>(k) * ndim + n) * 9 + 8 - tap
                          : (static_cast<int64_t>(n) * kdim + k) * 9 + tap]
                 : __float2bfloat16_rn(0.0f);
  }
}

// A block's work, for the kernels below. kPrologue: K6's prologue (the mask,
// the scale and the reductions); kStats: the forward's stats. kTma: the
// output tile leaves shared memory by one TMA store (K6 with the prologue
// first loads its x there by TMA, [n][r][c] of the tile, while the tile's
// products run); else each lane stores its outputs (and K6 loads x) itself.
// amap: the A operand (K6: the cotangent, the forward: x), NHWC; xmap: K6's
// x; omap: the output.
template <int kKind, int kBn, bool kPrologue, bool kStats, bool kTma>
__device__ __forceinline__ void run(const CUtensorMap& amap, const CUtensorMap& xmap,
                                    const CUtensorMap& omap, const __nv_bfloat16* __restrict__ wpack,
                                    const Geo& g) {
  static_assert(!kPrologue || kKind == kDgrad, "only K6 has the prologue");
  static_assert(!kStats || kKind == kForward, "only the forward has the stats");
  constexpr int kMi = kBn <= 64 ? 4 : 2;  // m64 instances a consumer warpgroup
  constexpr int kRed = 4 * kConsumers * kBn * 2;  // floats of one [warp][kBn][2] of sums
  extern __shared__ __align__(1024) unsigned char smem[];
  auto* xs = reinterpret_cast<__nv_bfloat16*>(smem + g.stages * g.sbytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.stages * g.sbytes + g.xs_bytes);
  uint64_t* empty = full + g.stages;
  uint64_t* xfull = empty + g.stages;  // x of the tile has landed in xs
  uint64_t* xempty = xfull + 1;        // the tile's dx has left xs
  // K6: each warp's running sums; the forward: one tile's sums, two buffers
  float* red = reinterpret_cast<float*>(xempty + 1);
  const int ns = blockIdx.x % g.ntn;
  const int first = blockIdx.x / g.ntn, step = gridDim.x / g.ntn;
  // the warp index broadcast from lane 0, so that ptxas sees the role
  // branch below as warp-uniform (else it serializes the consumers' wgmma)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int per_img = g.tiles_y * g.tiles_x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);  // lane 0 of each consumer warp
    }
    mbar_init(xfull, 1);
    mbar_init(xempty, 1);  // the consumer thread that stores dx
    fence_barrier_init();
  }
  __syncthreads();  // the only block-wide barrier: the producer warp leaves below

  if (warp == 4 * kConsumers) {
    if (lane != 0) return;
    const int box = (g.th + 2) * g.hc * 16;
    const int x_after = (g.stages < g.nch ? g.stages : g.nch) - 1;
    int q = 0, i = 0;
    for (int t = first; t < g.tiles; t += step, ++i) {
      const int b = t / per_img, r = t - b * per_img;
      const int y0 = (r / g.tiles_x) * g.th, x0 = (r % g.tiles_x) * g.tw;
      for (int c = 0; c < g.nch; ++c, ++q) {
        const int s = q % g.stages, use = q / g.stages;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        unsigned char* st = smem + s * g.sbytes;
        mbar_expect_tx(full + s, 2 * box + g.wbytes);
        for (int gi = 0; gi < 2; ++gi)
          tma_load_4d(st + gi * g.plane, &amap, (2 * c + gi) * 8, x0 - 1, y0 - 1, b, full + s);
        const unsigned char* src = reinterpret_cast<const unsigned char*>(wpack) +
                                   (static_cast<int64_t>(ns) * g.nch + c) * g.wbytes;
        for (int off = 0; off < g.wbytes; off += kPiece)
          bulk_load(st + g.abytes + off, src + off,
                    g.wbytes - off < kPiece ? g.wbytes - off : kPiece, full + s);
        // the tile's x once its first chunks are on their way and the last
        // tile's dx has left xs
        if (kTma && kPrologue && c == x_after) {
          if (i > 0) mbar_wait(xempty, (i - 1) & 1);
          mbar_expect_tx(xfull, g.th * g.tw * kBn * 2);
          tma_load_4d(xs, &xmap, x0, y0, ns * kBn, b, xfull);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int tid = threadIdx.x;
  if (kPrologue && gid == 0) {  // this lane's running sums, zeroed by itself
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(warp * kBn + 8 * j + 2 * tig + (e >> 1)) * 2 + (e & 1)] = 0.0f;
  }
  float acc[kMi][kBn / 2];
  int q = 0, i = 0;
  for (int t = first; t < g.tiles; t += step, ++i) {
    for (int c = 0; c < g.nch; ++c, ++q) {
      const int s = q % g.stages;
      mbar_wait(full + s, (q / g.stages) & 1);
      const unsigned char* a = smem + s * g.sbytes;
      const unsigned char* wc = a + g.abytes;
      tc::wgmma_fence();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int shift = (tap / 3) * g.hc + tap % 3;
        const uint64_t db = tc::wgmma_desc(wc + tap * (kBn / 8) * 256, 128, 256);
        const int scale = (c | tap) != 0;  // the tile's first product overwrites
#pragma unroll
        for (int mi = 0; mi < kMi; ++mi) {
          const int m0 = (wg * kMi + mi) * 64;
          const uint64_t da = tc::wgmma_desc(a + (m0 + shift) * 16, g.plane, 128);
          tc::WgmmaBf16<kBn>::run(acc[mi], da, db, scale);
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // the previous chunk's products are done: free its stage
      mbar_arrive_if(empty + (q + g.stages - 1) % g.stages, c > 0 && lane == 0);
    }
    tc::wgmma_wait<0>();
    mbar_arrive_if(empty + (q - 1) % g.stages, lane == 0);

    // the epilogue: each of the lane's rows is a flattened box position
    const int b = t / per_img, r = t - b * per_img;
    const int y0 = (r / g.tiles_x) * g.th, x0 = (r % g.tiles_x) * g.tw;
    const int64_t hw = static_cast<int64_t>(g.h) * g.w;
    // the row's pixel: its offset in xs (kTma) or in an NCHW plane, or -1
    // off the tile or the image
    int at[kMi][2];
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int pos = (wg * kMi + mi) * 64 + 16 * wq + gid + 8 * hf + g.hc + 1;
        const int rr = pos / g.hc - 1, cc = pos % g.hc - 1;
        const int yy = y0 + rr, xx = x0 + cc;
        const bool in = cc >= 0 && cc < g.tw && rr < g.th && yy < g.h && xx < g.w;
        at[mi][hf] = in ? (kTma ? rr * g.tw + cc : yy * g.w + xx) : -1;
      }
    if (kTma) {
      consumers_sync(128 * kConsumers);  // the last tile's output has left xs
      if (kPrologue) mbar_wait(xfull, i & 1);
    }
    float* rt = red + (i & 1) * kRed;  // the forward's sums of this tile
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j) {
      // the output planes of the column pair (-1 past the channels)
      int64_t planes[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = ns * kBn + 8 * j + 2 * tig + e;
        planes[e] = n >= g.nc ? -1
                    : kTma    ? static_cast<int64_t>(8 * j + 2 * tig + e) * g.th * g.tw
                              : (static_cast<int64_t>(b) * g.nc + n) * hw;
      }
      float s0[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f};
      if constexpr (kKind == kDgrad) {
        // x of the column pair's rows, all loaded before the first store of
        // dx (which the compiler would otherwise order them after)
        float xv[2][kMi][2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int64_t idx = planes[e] + at[mi][hf];
              xv[e][mi][hf] = kPrologue && planes[e] >= 0 && at[mi][hf] >= 0
                                  ? __bfloat162float(kTma ? xs[idx] : g.x[idx])
                                  : 0.0f;
            }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (planes[e] < 0) continue;
          const int n = ns * kBn + 8 * j + 2 * tig + e;
          const float sc = kPrologue ? g.scale[n] : 0.0f, sh = kPrologue ? g.shift[n] : 0.0f;
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              if (at[mi][hf] < 0) continue;
              const int64_t idx = planes[e] + at[mi][hf];
              __nv_bfloat16* out = kTma ? xs + idx : g.out + idx;
              const float v = acc[mi][4 * j + 2 * hf + e];
              if (!kPrologue) {
                *out = __float2bfloat16_rn(v);
                continue;
              }
              const float x = xv[e][mi][hf];
              const float dam = __fadd_rn(__fmul_rn(x, sc), sh) > 0.0f ? v : 0.0f;
              *out = __float2bfloat16_rn(__fmul_rn(dam, sc));
              s0[e] = fmaf(dam, x, s0[e]);
              s1[e] += dam;
            }
        }
      } else {
        // y = the f32 sum plus the bias, rounded once; the stats over the
        // stored values, as the TPU kernel's
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (planes[e] < 0) continue;
          const int n = ns * kBn + 8 * j + 2 * tig + e;
          const float bv = g.bias != nullptr ? __bfloat162float(g.bias[n]) : 0.0f;
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              if (at[mi][hf] < 0) continue;
              const __nv_bfloat16 y = __float2bfloat16_rn(__fadd_rn(acc[mi][4 * j + 2 * hf + e], bv));
              (kTma ? xs : g.out)[planes[e] + at[mi][hf]] = y;
              const float v = __bfloat162float(y);
              s0[e] += v;
              s1[e] = fmaf(v, v, s1[e]);
            }
        }
      }
      if (kPrologue || kStats) {  // the column pair's sums: the lanes by a butterfly
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int m = 4; m < 32; m <<= 1) {
            s0[e] += __shfl_xor_sync(0xffffffffu, s0[e], m);
            s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], m);
          }
        if (gid == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = (warp * kBn + 8 * j + 2 * tig + e) * 2;
            if (kPrologue) {  // K6: the warp's running sums
              red[o] += s0[e];
              red[o + 1] += s1[e];
            } else {
              rt[o] = s0[e];
              rt[o + 1] = s1[e];
            }
          }
        }
      }
    }
    if (kTma) {  // the output out of xs by one thread, which then frees xs
      tc::fence_proxy_async();
      consumers_sync(128 * kConsumers);
      if (tid == 0) {
        tma_store_4d(&omap, xs, x0, y0, ns * kBn, b);
        bulk_store_commit_and_wait_read();
        if (kPrologue) mbar_arrive_if(xempty, true);
      }
    } else if (kStats) {
      consumers_sync(128 * kConsumers);
    }
    if (kStats) {  // the tile's stats: the warps in order (rt is not written
                   // again before every consumer has passed the next tile's barrier)
      const int n = ns * kBn + tid;
      if (tid < kBn && n < g.nc) {
        float s_sum = 0.0f, q_sum = 0.0f;
#pragma unroll
        for (int m = 0; m < 4 * kConsumers; ++m) {
          s_sum += rt[(m * kBn + tid) * 2];
          q_sum += rt[(m * kBn + tid) * 2 + 1];
        }
        g.part[(2 * static_cast<int64_t>(t)) * g.nc + n] = s_sum;
        g.part[(2 * static_cast<int64_t>(t) + 1) * g.nc + n] = q_sum;
      }
    }
  }
  if (kTma && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (!kPrologue) return;
  consumers_sync(128 * kConsumers);
  const int n = ns * kBn + tid;
  if (tid < kBn && n < g.nc) {
    float s_sum = 0.0f, q_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < 4 * kConsumers; ++m) {
      s_sum += red[(m * kBn + tid) * 2];
      q_sum += red[(m * kBn + tid) * 2 + 1];
    }
    g.part[(2 * static_cast<int64_t>(first)) * g.nc + n] = s_sum;
    g.part[(2 * static_cast<int64_t>(first) + 1) * g.nc + n] = q_sum;
  }
}

// K6: the forward conv of the cotangent with the flipped, transposed kernel.
template <int kBn, bool kPrologue, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    dgrad_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap dxmap, const __nv_bfloat16* __restrict__ wpack,
                 const __grid_constant__ Geo g) {
  run<kDgrad, kBn, kPrologue, false, kTma>(gmap, xmap, dxmap, wpack, g);
}

// K3 and K4: the forward conv of x (the prologue already applied by the NHWC
// pass) with the kernel as it is, a name of its own in the profiler.
template <int kBn, bool kStats, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap ymap,
                             const __nv_bfloat16* __restrict__ wpack,
                             const __grid_constant__ Geo g) {
  run<kForward, kBn, false, kStats, kTma>(xmap, ymap, ymap, wpack, g);
}

// Dynamic shared memory of a launch: the ring, the TMA epilogue's tile, the
// barriers, and `reds` [warp][bn][2] buffers of sums.
inline int smem_bytes(const Geo& g, int bn, int reds) {
  return g.stages * g.sbytes + g.xs_bytes + (2 * g.stages + 2) * 8 +
         reds * 4 * kConsumers * bn * 2 * 4;
}

// The geometry of a launch over images b x h x w: N = nc channels in
// slices of bn, K = the kp channels (a multiple of 8) of the NHWC operand in
// chunks of kKc, output tiles of th x tw, the TMA epilogue where W and TW
// are multiples of 8. False where the shape is out of range.
inline bool make_geo(Geo& g, int b, int h, int w, int nc, int kp, int bn, int th, int tw,
                     int stages, int blocks) {
  if (b <= 0 || nc <= 0 || kp <= 0 || kp % 8 != 0 || h <= 0 || w <= 0 ||
      (bn != 64 && bn != 128) || th < 1 || tw < 1 || th + 2 > 256 || tw + 2 > 256 ||
      stages < 2 || blocks <= 0)
    return false;
  g.b = b;
  g.h = h;
  g.w = w;
  g.nc = nc;
  g.kp = kp;
  g.th = th;
  g.tw = tw;
  g.hc = tw + 2;
  g.stages = stages;
  g.nch = (kp + kKc - 1) / kKc;
  g.ntn = (nc + bn - 1) / bn;
  if (blocks % g.ntn != 0) return false;
  g.tiles_y = (h + th - 1) / th;
  g.tiles_x = (w + tw - 1) / tw;
  const int64_t tiles = static_cast<int64_t>(b) * g.tiles_y * g.tiles_x;
  if (tiles > 0x7fffffff) return false;
  g.tiles = static_cast<int>(tiles);
  // a group's box, and the rows past it that the last m64 instance's taps
  // read (dropped positions), 128-byte aligned
  const int mt = 64 * (bn <= 64 ? 4 : 2) * kConsumers;  // the tile's M rows
  int positions = (th + 2) * g.hc;
  if (mt + 2 * g.hc + 2 > positions) positions = mt + 2 * g.hc + 2;
  g.plane = (positions * 16 + 127) / 128 * 128;
  g.abytes = 2 * g.plane;
  g.wbytes = 9 * kKc * bn * 2;
  g.sbytes = (g.abytes + g.wbytes + 127) / 128 * 128;
  // the TMA epilogue where the image's rows and the tile's are whole
  // 16-byte runs
  g.xs_bytes = w % 8 == 0 && tw % 8 == 0 ? (th * tw * bn * 2 + 127) / 128 * 128 : 0;
  return true;
}

// Pack a weight into wpack (pack_weights_k6) for g's slices and chunks.
inline cudaError_t pack_weights(const void* weight, void* wpack, int kdim, int ndim, int bn,
                                const Geo& g, bool flip, cudaStream_t s) {
  const int64_t total = static_cast<int64_t>(g.ntn) * g.nch * 9 * kKc * bn;
  pack_weights_k6<<<conv3x3::grid_stride_blocks(total), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(weight), static_cast<__nv_bfloat16*>(wpack), kdim, ndim,
      bn, g.nch, flip ? 1 : 0, total);
  return cudaGetLastError();
}

template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, int bytes, int blocks, cudaStream_t s,
                          const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(args...);
  return cudaGetLastError();
}

template <int kBn>
cudaError_t launch_dgrad(const CUtensorMap& gmap, const CUtensorMap& xmap, const CUtensorMap& dxmap,
                         const __nv_bfloat16* wpack, const Geo& g, int blocks, bool prologue,
                         cudaStream_t s) {
  const int bytes = smem_bytes(g, kBn, 1);
  const bool tma = g.xs_bytes > 0;
  auto kernel = prologue ? (tma ? dgrad_kernel<kBn, true, true> : dgrad_kernel<kBn, true, false>)
                         : (tma ? dgrad_kernel<kBn, false, true> : dgrad_kernel<kBn, false, false>);
  return launch_kernel(kernel, bytes, blocks, s, gmap, xmap, dxmap, wpack, g);
}

template <int kBn>
cudaError_t launch_fwd(const CUtensorMap& xmap, const CUtensorMap& ymap,
                       const __nv_bfloat16* wpack, const Geo& g, int blocks, bool stats,
                       cudaStream_t s) {
  const int bytes = smem_bytes(g, kBn, 2);
  const bool tma = g.xs_bytes > 0;
  auto kernel = stats ? (tma ? conv3x3_fwd_wgmma_kernel<kBn, true, true>
                             : conv3x3_fwd_wgmma_kernel<kBn, true, false>)
                      : (tma ? conv3x3_fwd_wgmma_kernel<kBn, false, true>
                             : conv3x3_fwd_wgmma_kernel<kBn, false, false>);
  return launch_kernel(kernel, bytes, blocks, s, xmap, ymap, wpack, g);
}

}  // namespace k6

// ---------------------------------------------------------------------------
// K5.

namespace k5 {

constexpr int kConsumers = 3;  // one per tap row dh
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kCo = 64;  // output channels a block (M)
constexpr int kCi = 64;  // input channels a block (N)

struct Geo {
  float* part;    // [slice][co][c][tap]
  float* part_b;  // [slice][warp of the db warpgroup][co]
  int cin, cout, h, w;
  int th, tw, hc;  // tile (tw a multiple of 8, th * tw of 16); haloed columns
  int stages, tiles_y, tiles_x, tiles, per_slice, nco, nci;
  int gbytes, abytes, sbytes;  // bytes: g's box, the activation's box, a stage
};

// Descriptor of an MN-major tile with the 128-byte swizzle at p (a row of
// 64 elements, K rows 128 bytes apart, as a swizzled TMA box lands them):
// sbo bytes between groups of 8 K rows. The swizzle's phase is the rows'
// own address bits 7-9, so p may start at any row (a base offset of 0;
// the other reading, the offset from p's bits, is off by order 1 on the
// card).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, int sbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__global__ void __launch_bounds__(kThreads, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap amap,
                 Geo g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.stages * g.sbytes);
  uint64_t* empty = full + g.stages;
  const int cit = blockIdx.x % g.nci, cot = (blockIdx.x / g.nci) % g.nco;
  const int slice = blockIdx.x / (g.nci * g.nco);
  const int t0 = slice * g.per_slice;
  const int t1 = t0 + g.per_slice < g.tiles ? t0 + g.per_slice : g.tiles;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  const int per_img = g.tiles_y * g.tiles_x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    if (lane != 0) return;
    const int bytes = (g.th * g.tw + (g.th + 2) * g.hc) * 128;
    for (int t = t0, i = 0; t < t1; ++t, ++i) {
      const int s = i % g.stages, use = i / g.stages;
      if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
      const int b = t / per_img, r = t - b * per_img;
      const int y0 = (r / g.tiles_x) * g.th, x0 = (r % g.tiles_x) * g.tw;
      unsigned char* st = smem + s * g.sbytes;
      mbar_expect_tx(full + s, bytes);
      tma_load_4d(st, &gmap, cot * kCo, x0, y0, b, full + s);
      tma_load_4d(st + g.gbytes, &amap, cit * kCi, x0 - 1, y0 - 1, b, full + s);
    }
    return;
  }

  const int dh = warp >> 2, wq = warp & 3;  // the warpgroup's tap row; the warp's 16 channels
  const int gid = lane >> 2, tig = lane & 3;
  const int steps = g.th * g.tw / 16;
  // db: warpgroup 0 of the first N tile sums g's box while the tile's
  // products run, thread (lane, cg) the 8 channels of 16-byte chunk cg at
  // the pixels pl, pl + 16, ... in order, pl = its index / 8
  const bool with_db = dh == 0 && cit == 0;
  const int cg = threadIdx.x & 7, pl = (threadIdx.x >> 3) & 15;
  float gsum[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) gsum[e] = 0.0f;
  float acc[3][kCi / 2];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int r = 0; r < kCi / 2; ++r) acc[d][r] = 0.0f;

  for (int t = t0, i = 0; t < t1; ++t, ++i) {
    const int s = i % g.stages;
    mbar_wait(full + s, (i / g.stages) & 1);
    const unsigned char* gs = smem + s * g.sbytes;
    const unsigned char* as = gs + g.gbytes;
    tc::wgmma_fence();
    int r0 = 0, c0 = 0;  // the k-step's first pixel in the tile
    for (int k = 0; k < steps; ++k) {
      // A: pixels 16 k .. 16 k + 15 of g's box, two groups of 8 rows; B:
      // the tap's positions of those pixels, the second 8 starting the
      // next row where c0 + 8 reaches TW
      const uint64_t da = desc_sw128(gs + k * 2048, 1024);
      const int r1 = c0 + 8 < g.tw ? r0 : r0 + 1, c1 = c0 + 8 < g.tw ? c0 + 8 : c0 + 8 - g.tw;
      const int pos0 = (r0 + dh) * g.hc + c0, pos1 = (r1 + dh) * g.hc + c1;
#pragma unroll
      for (int dw = 0; dw < 3; ++dw)
        tc::wgmma_m64n64k16_ss_tt(acc[dw], da,
                                  desc_sw128(as + (pos0 + dw) * 128, (pos1 - pos0) * 128));
      c0 += 16;
      while (c0 >= g.tw) {
        c0 -= g.tw;
        ++r0;
      }
    }
    tc::wgmma_commit();
    if (with_db) {
      for (int p = pl; p < g.th * g.tw; p += 16) {  // row p: 128 bytes, chunks swizzled by p % 8
        const uint4 v = *reinterpret_cast<const uint4*>(gs + p * 128 + ((cg ^ (p & 7)) << 4));
        const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gsum[2 * e] += __low2float(pr[e]);
          gsum[2 * e + 1] += __high2float(pr[e]);
        }
      }
    }
    tc::wgmma_wait<1>();  // the last tile's products are done: free its stage
    mbar_arrive_if(empty + (i + g.stages - 1) % g.stages, i > 0 && lane == 0);
  }
  tc::wgmma_wait<0>();
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int r = 0; r < kCi / 2; ++r) tc::keep(acc[d][r]);

  if (with_db) {  // db's partials: the lanes of a chunk by a butterfly, a row per warp
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gsum[e] += __shfl_xor_sync(0xffffffffu, gsum[e], 8);
      gsum[e] += __shfl_xor_sync(0xffffffffu, gsum[e], 16);
    }
    if (lane < 8) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int co = cot * kCo + 8 * cg + e;
        if (co < g.cout)
          g.part_b[(4 * static_cast<int64_t>(slice) + wq) * g.cout + co] = gsum[e];
      }
    }
  }
  // part[slice][co][c][tap]; the accumulator layout: rows (co) 16 wq + gid
  // (+ 8), columns (c) 8 j + 2 tig + e at [4 j + 2 hf + e]
#pragma unroll
  for (int dw = 0; dw < 3; ++dw)
#pragma unroll
    for (int j = 0; j < kCi / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = cot * kCo + 16 * wq + gid + 8 * hf;
          const int c = cit * kCi + 8 * j + 2 * tig + e;
          if (co < g.cout && c < g.cin)
            g.part[((static_cast<int64_t>(slice) * g.cout + co) * g.cin + c) * 9 + 3 * dh + dw] =
                acc[dw][4 * j + 2 * hf + e];
        }
}

// The stem (Cin = 1). Warp w of a block owns output channels blockIdx.y *
// 64 + 8 w .. + 7, lane l the pixels l, l + 32, ... of the block's run:
// per pixel the 9 taps of x (the prologue applied, rounded to bf16, 0
// outside the image) against one 16-byte load of g, 72 FMAs into the
// lane's sums; then the lanes by a fixed butterfly into part[slice][co]
// [tap], and db's sums of g into part_b[slice][co].
template <bool kPrologue>
__global__ void __launch_bounds__(256)
    wgrad_stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gp,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      float* __restrict__ part, float* __restrict__ part_b, int cout, int cp,
                      int h, int w, int64_t npx, int64_t per_slice) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co0 = blockIdx.y * 64 + 8 * warp;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t p_begin = static_cast<int64_t>(blockIdx.x) * per_slice;
  const int64_t p_end = p_begin + per_slice < npx ? p_begin + per_slice : npx;
  const float sc = kPrologue ? scale[0] : 0.0f, sh = kPrologue ? shift[0] : 0.0f;
  float acc[8][9], gsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    gsum[j] = 0.0f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[j][t] = 0.0f;
  }
  if (co0 < cp) {
    for (int64_t p = p_begin + lane; p < p_end; p += 32) {
      const int64_t bi = p / hw;
      const int rem = static_cast<int>(p - bi * hw);
      const int yy = rem / w, xx = rem - yy * w;
      const __nv_bfloat16* xb = x + bi * hw;
      float a[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int ys = yy + t / 3 - 1, xs = xx + t % 3 - 1;
        a[t] = 0.0f;
        if (ys >= 0 && ys < h && xs >= 0 && xs < w) {
          a[t] = __bfloat162float(xb[ys * w + xs]);
          if (kPrologue)
            a[t] = __bfloat162float(__float2bfloat16_rn(conv3x3::affine_relu(a[t], sc, sh)));
        }
      }
      const uint4 gv = *reinterpret_cast<const uint4*>(gp + p * cp + co0);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float gj = j & 1 ? __high2float(g2[j >> 1]) : __low2float(g2[j >> 1]);
        gsum[j] += gj;
#pragma unroll
        for (int t = 0; t < 9; ++t) acc[j][t] = fmaf(gj, a[t], acc[j][t]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) {
      gsum[j] += __shfl_xor_sync(0xffffffffu, gsum[j], m);
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[j][t] += __shfl_xor_sync(0xffffffffu, acc[j][t], m);
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + j;
    if (co >= cout) continue;
    part_b[static_cast<int64_t>(blockIdx.x) * cout + co] = gsum[j];
#pragma unroll
    for (int t = 0; t < 9; ++t)
      part[(static_cast<int64_t>(blockIdx.x) * cout + co) * 9 + t] = acc[j][t];
  }
}

}  // namespace k5

}  // namespace

// The NHWC pass. mode 0 (the activation): in = x (b, c, h, w), out = a (b,
// h, w, cp), the prologue applied where scale is not null. mode 1 (the
// cotangent): in = gy, with gst (b, 2, c) f32 and y (b, c, h, w) the
// stats' terms are added (gst null: gy as it is). bf16 tensors, cp a
// multiple of 8 >= c, out 16-byte aligned. Returns a cudaError_t value.
extern "C" int im2im_nhwc_pass(const void* in, const void* y, const void* gst, const void* scale,
                               const void* shift, void* out, int b, int c, int cp, int h, int w,
                               int mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || c <= 0 || h <= 0 || w <= 0 || cp < c || cp % 8 != 0 || b > 65535 ||
      (mode != kActivation && mode != kCotangent) || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t blocks = (hw + kPx - 1) / kPx;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  const auto* ib = static_cast<const __nv_bfloat16*>(in);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const auto* gf = static_cast<const float*>(gst);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  if (mode == kActivation)
    nhwc_kernel<kActivation><<<grid, 256, 0, s>>>(ib, yb, gf, sc, sh, ob, c, cp, hw);
  else
    nhwc_kernel<kCotangent><<<grid, 256, 0, s>>>(ib, yb, gf, sc, sh, ob, c, cp, hw);
  return static_cast<int>(cudaGetLastError());
}

// K3 and K4 in bf16 on wgmma: xp (b, h, w, cp) the NHWC operand (x, or the
// prologue's activation: im2im_nhwc_pass mode 0), weight (cout, cin, 3, 3),
// bias (cout) or null, y (b, cout, h, w), all bf16. The plan
// (ops/conv_bwd.conv_plan): bn (64 or 128), tile th x tw, stages, blocks (a
// multiple of the ceil(cout / bn) slices). wpack: the packed weights,
// ceil(cout / bn) * ceil(cp / 16) * 9 * 16 * bn bf16. With stats not null,
// part (b * ceil(h / th) * ceil(w / tw) rows of 2 cout floats) and stats
// (b, 2, cout) f32 receive the per-(image, channel) sums of y and y^2 over
// the stored values. Returns a cudaError_t value.
extern "C" int im2im_conv3x3_wgmma(const void* xp, const void* weight, const void* bias, void* y,
                                   void* wpack, void* part, void* stats, int b, int cin, int cp,
                                   int cout, int h, int w, int bn, int th, int tw, int stages,
                                   int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  k6::Geo g{};
  if (cin <= 0 || cp < cin || !k6::make_geo(g, b, h, w, cout, cp, bn, th, tw, stages, blocks) ||
      (reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(wpack)) % 16 != 0 ||
      (g.xs_bytes > 0 && reinterpret_cast<uintptr_t>(y) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  g.bias = static_cast<const __nv_bfloat16*>(bias);
  g.out = static_cast<__nv_bfloat16*>(y);
  g.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  CUtensorMap xmap, ymap;
  err = tmak::nhwc_map(&xmap, xp, b, h, w, cp, g.hc, th + 2);
  if (err == cudaSuccess && g.xs_bytes > 0)
    err = tmak::nchw_map(&ymap, y, b, cout, h, w, tw, th, bn);
  else
    ymap = xmap;  // not read
  if (err == cudaSuccess) err = k6::pack_weights(weight, wpack, cin, cout, bn, g, false, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* wp = static_cast<const __nv_bfloat16*>(wpack);
  const bool with_stats = stats != nullptr;
  err = bn == 64 ? k6::launch_fwd<64>(xmap, ymap, wp, g, blocks, with_stats, s)
                 : k6::launch_fwd<128>(xmap, ymap, wp, g, blocks, with_stats, s);
  if (err != cudaSuccess || !with_stats) return static_cast<int>(err);
  return static_cast<int>(conv3x3::launch_reduce_rows(g.part, static_cast<float*>(stats), b,
                                                      g.tiles_y * g.tiles_x, 2LL * cout, s));
}

// K6 in bf16 on wgmma: gp the NHWC cotangent (b, h, w, cp), weight (cout,
// cin, 3, 3), x (b, cin, h, w) the forward's raw input, dx (b, cin, h, w),
// all bf16; scale, shift (cin) f32 read with prologue != 0. The plan
// (ops/conv_bwd.dgrad_plan): bn (64 or 128), tile th x tw, stages, blocks
// (a multiple of the ceil(cin / bn) slices). wpack: the packed weights,
// ceil(cin / bn) * ceil(cp / 16) * 9 * 16 * bn bf16; part: blocks / slices
// rows of 2 cin floats, and red (2, cin) f32 receives the reductions with
// the prologue. Returns a cudaError_t value.
extern "C" int im2im_dgrad3x3_wgmma(const void* gp, const void* weight, const void* x,
                                    const void* scale, const void* shift, void* dx, void* wpack,
                                    void* part, void* red, int b, int cin, int cout, int cp, int h,
                                    int w, int prologue, int bn, int th, int tw, int stages,
                                    int blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  k6::Geo g{};
  if (cout <= 0 || cp < cout || !k6::make_geo(g, b, h, w, cin, cp, bn, th, tw, stages, blocks) ||
      (reinterpret_cast<uintptr_t>(gp) | reinterpret_cast<uintptr_t>(wpack)) % 16 != 0 ||
      (g.xs_bytes > 0 &&
       (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dx)) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  g.x = static_cast<const __nv_bfloat16*>(x);
  g.scale = static_cast<const float*>(scale);
  g.shift = static_cast<const float*>(shift);
  g.out = static_cast<__nv_bfloat16*>(dx);
  g.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  CUtensorMap gmap, xmap, dxmap;
  err = tmak::nhwc_map(&gmap, gp, b, h, w, cp, g.hc, th + 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g.xs_bytes > 0) {
    err = tmak::nchw_map(&xmap, x, b, cin, h, w, tw, th, bn);
    if (err == cudaSuccess) err = tmak::nchw_map(&dxmap, dx, b, cin, h, w, tw, th, bn);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    xmap = gmap;  // not read
    dxmap = gmap;
  }
  err = k6::pack_weights(weight, wpack, cout, cin, bn, g, true, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* wp = static_cast<const __nv_bfloat16*>(wpack);
  err = bn == 64 ? k6::launch_dgrad<64>(gmap, xmap, dxmap, wp, g, blocks, prologue != 0, s)
                 : k6::launch_dgrad<128>(gmap, xmap, dxmap, wp, g, blocks, prologue != 0, s);
  if (err != cudaSuccess || !prologue) return static_cast<int>(err);
  return static_cast<int>(conv3x3::launch_reduce_rows(g.part, static_cast<float*>(red), 1,
                                                      blocks / g.ntn, 2LL * cin, s));
}

// K5 in bf16 on wgmma: act (b, h, w, cpi) the NHWC activation and gp (b,
// h, w, cpo) the NHWC cotangent, bf16, 16-byte aligned, cpi and cpo
// multiples of 8; part: slices * (cout * cin * 9 + 4 * cout) floats; dw (cout,
// cin, 3, 3) and db (cout) f32. The plan (ops/conv_bwd.wgrad_plan): tile th x tw (tw a multiple
// of 8, th * tw of 16, at most 256), stages, slices of per_slice tiles.
// Returns a cudaError_t value.
extern "C" int im2im_wgrad3x3_wgmma(const void* act, const void* gp, void* part, void* dw,
                                    void* db, int b,
                                    int cin, int cpi, int cout, int cpo, int h, int w, int th,
                                    int tw, int stages, int per_slice, int slices, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || cpi < cin || cpo < cout ||
      cpi % 8 != 0 || cpo % 8 != 0 || th < 1 || tw < 8 || tw % 8 != 0 || (th * tw) % 16 != 0 ||
      th * tw > 256 || tw + 2 > 256 || stages < 2 || per_slice <= 0 || slices <= 0 ||
      (reinterpret_cast<uintptr_t>(act) | reinterpret_cast<uintptr_t>(gp)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  k5::Geo g{};
  g.part = static_cast<float*>(part);
  g.part_b = g.part + static_cast<int64_t>(slices) * cout * cin * 9;
  g.cin = cin;
  g.cout = cout;
  g.h = h;
  g.w = w;
  g.th = th;
  g.tw = tw;
  g.hc = tw + 2;
  g.stages = stages;
  g.tiles_y = (h + th - 1) / th;
  g.tiles_x = (w + tw - 1) / tw;
  const int64_t tiles = static_cast<int64_t>(b) * g.tiles_y * g.tiles_x;
  g.nco = (cout + k5::kCo - 1) / k5::kCo;
  g.nci = (cpi + k5::kCi - 1) / k5::kCi;
  const int64_t blocks = static_cast<int64_t>(slices) * g.nco * g.nci;
  if (tiles > 0x7fffffff || blocks > 0x7fffffff ||
      static_cast<int64_t>(per_slice) * (slices - 1) >= tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  g.per_slice = per_slice;
  // 64 channels a box row of 128 bytes; the 128-byte swizzle repeats
  // every 1024 bytes, where each box starts
  g.gbytes = (th * tw * 128 + 1023) / 1024 * 1024;
  g.abytes = ((th + 2) * g.hc * 128 + 1023) / 1024 * 1024;
  g.sbytes = g.gbytes + g.abytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  CUtensorMap gmap, amap;
  err = tmak::nhwc_map(&gmap, gp, b, h, w, cpo, tw, th, k5::kCo);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = tmak::nhwc_map(&amap, act, b, h, w, cpi, g.hc, th + 2, k5::kCi);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = stages * g.sbytes + 2 * stages * 8;
  err = cudaFuncSetAttribute(k5::wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k5::wgrad_kernel<<<static_cast<unsigned>(blocks), k5::kThreads, bytes, s>>>(gmap, amap, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = conv3x3::launch_reduce_rows(g.part, static_cast<float*>(dw), 1, slices,
                                    static_cast<int64_t>(cout) * cin * 9, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      conv3x3::launch_reduce_rows(g.part_b, static_cast<float*>(db), 1, 4LL * slices, cout, s));
}

// K5's stem (Cin = 1) in bf16: x (b, 1, h, w) bf16, gp (b, h, w, cpo) the
// NHWC cotangent (16-byte aligned); scale, shift (1) f32 read with
// prologue != 0; part: slices * (cout * 9 + cout) floats; dw (cout, 1, 3,
// 3) and db (cout) f32. The pixels split into `slices` runs of per_slice.
// Returns a cudaError_t value.
extern "C" int im2im_wgrad3x3_stem(const void* x, const void* gp, const void* scale,
                                   const void* shift, void* part, void* dw, void* db, int b,
                                   int cout, int cpo, int h, int w, int prologue,
                                   long long per_slice, int slices, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t npx = static_cast<int64_t>(b) * h * w;
  if (b <= 0 || cout <= 0 || h <= 0 || w <= 0 || cpo < cout || cpo % 8 != 0 || per_slice <= 0 ||
      slices <= 0 || per_slice * (slices - 1) >= npx || (cout + 63) / 64 > 65535 ||
      reinterpret_cast<uintptr_t>(gp) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(slices), static_cast<unsigned>((cout + 63) / 64));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(gp);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* pf = static_cast<float*>(part);
  auto* pb = pf + static_cast<int64_t>(slices) * cout * 9;
  if (prologue)
    k5::wgrad_stem_kernel<true><<<grid, 256, 0, s>>>(xb, gb, sc, sh, pf, pb, cout, cpo, h, w, npx,
                                                     per_slice);
  else
    k5::wgrad_stem_kernel<false><<<grid, 256, 0, s>>>(xb, gb, sc, sh, pf, pb, cout, cpo, h, w,
                                                      npx, per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = conv3x3::launch_reduce_rows(pf, static_cast<float*>(dw), 1, slices,
                                    static_cast<int64_t>(cout) * 9, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      conv3x3::launch_reduce_rows(pb, static_cast<float*>(db), 1, slices, cout, s));
}
