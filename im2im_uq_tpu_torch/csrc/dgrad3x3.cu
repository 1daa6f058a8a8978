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
// What bounds it: the bound counts one multiply-add per (pixel, channel
// pair), the Winograd limit, at 165 TFLOP/s, the float32-accurate rate of
// 3xTF32 on the tensor cores, against the bytes of g and x read and dx
// written once. At batch 32, 320x320 the 40x40 and 20x20 levels are bound
// by operations, the larger ones by bytes.
//
// Design: an implicit GEMM on the tensor cores in 3xTF32 (mma_tf32.cuh),
// float32-accurate: M = the pixels of a box of one image, N = Cin, K =
// 9 * Cout, with A[p, (co, t)] = g[co] at pixel p shifted by tap t and
// B[(co, t), c] = W[co, c, 8 - t]. mma.sync, not wgmma: the tap shifts move
// A by one pixel at a time, off the 16-byte canonical layouts that wgmma
// reads, while mma.sync fragments are loaded lane by lane at any offset.
// - Tile. A block owns 256 pixels x 32 input channels; its 8 warps are
//   stacked along M, a warp 32 pixels x 32 channels, 2 x 4 fragments of
//   16 x 8, within the 128 registers that let two blocks share an SM.
//   Many pixels and few channels: every block stages the weights of its
//   channels for every chunk, so a block of 256 pixels moves half the
//   weight bytes per product of one of 128 (blocks of 128 x 64 and
//   128 x 128 were slower on the card).
// - Boxes. The 256 pixels are a box of TH rows x TW columns of one image,
//   flattened, so a fragment's 16 rows may cross a row of the box; each
//   lane keeps the shared-memory offsets of its 4 pixel rows. The box is
//   chosen per shape to pad the least (TW = W where W <= 256, or 32, 16,
//   64, 8, 128, 256; TH = 256 / TW): padded work at 320: 0 (8 x 32), 160: 0
//   (8 x 32), 80: 0 (16 x 16), 40: 10.7% (6 x 40), 20: 21.9% (12 x 20),
//   where the 8 x 32 tile of the FFMA kernel before this one padded 40 by
//   37.5% and 20 by 47.9%.
// - Depth. K runs over chunks of 8 output channels x 9 taps. Each stage
//   holds the chunk's g box with its 1-pixel frame (zero outside the
//   image; the frame flattened over the lanes) and its weights, copied with
//   cp.async: three stages, so the copies of the next two chunks run under
//   the current chunk's mma. The weight is read flipped and transposed by
//   index arithmetic while it is copied. Operands are split into hi and lo
//   as their fragments are loaded; a chunk's products accumulate in the
//   tensor core, 27 mma deep, and are then added to the block's sums in
//   float32 (the tensor core's accumulation drops low bits: run over all
//   of K, its error grew with K's depth, past the 3e-5 bar at Cout = 512).
// - The epilogue: the mask, the scale and the per-block (sum dam * x, sum
//   dam) partials (a fixed butterfly over the lanes, then the M warps in
//   order), summed over the blocks by conv3x3::reduce_rows in a fixed
//   order: no float atomics, the same bits on every run.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tile.cuh"
#include "mma_tf32.cuh"

namespace {

using tc::Split;

constexpr int kStages = 3;
constexpr int kWarps = 8;    // along M
constexpr int kThreads = 32 * kWarps;
constexpr int kMt = 2;       // 16-pixel fragments per warp
constexpr int kNt = 4;       // 8-channel fragments per warp
constexpr int kBoxPx = 16 * kMt * kWarps;  // pixels per block
constexpr int kBn = 8 * kNt;               // input channels per block
constexpr int kWs = kBn + 8;  // = 8 mod 32: B fragment loads hit 32 banks
constexpr int kCoCh = 8;     // output channels per stage: 9 k-steps of 8

struct Box {
  int th, tw;
};

inline int64_t box_count(Box bx, int h, int w) {
  return static_cast<int64_t>((h + bx.th - 1) / bx.th) * ((w + bx.tw - 1) / bx.tw);
}

// The box of at most kBoxPx pixels that pads the image least; the first of
// the list on a tie.
Box dgrad_box(int h, int w) {
  const int widths[] = {w <= kBoxPx ? w : 32, 32, 16, 64, 8, 128, 256};
  Box best{kBoxPx / widths[0], widths[0]};
  for (int tw : widths) {
    const Box bx{kBoxPx / tw, tw};
    if (bx.th > 0 && box_count(bx, h, w) < box_count(best, h, w)) best = bx;
  }
  return best;
}

// floats per channel of a staged g box with its frame; = 8 mod 32, so that
// the 4 channels of an A fragment fall 8 banks apart
int halo_plane(Box bx) {
  const int p = (bx.th + 2) * (bx.tw + 2);
  return p + (40 - p % 32) % 32;
}

// A stage: the g box [co][row][col], then the weights [tap * 8 + co][c]; a
// multiple of 4 floats.
__host__ __device__ __forceinline__ int stage_floats(int plane) {
  return (kCoCh * plane + 9 * kCoCh * kWs + 3) & ~3;
}

int smem_bytes(int plane) {
  return kStages * stage_floats(plane) * static_cast<int>(sizeof(float));
}

struct Geo {
  const float* g;
  const float* weight;
  int cin, cout, h, w, th, tw, plane, c0, b, y0, x0;
};

// Start the copies of chunk `chunk` (output channels 8 chunk .. 8 chunk + 7)
// into one stage, 0 outside the image. The weight is stored flipped and
// transposed: W[co][c][tap] at [(8 - tap) * 8 + co][c].
__device__ __forceinline__ void stage_chunk(int chunk, const Geo& ge, float* st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t hw = static_cast<int64_t>(ge.h) * ge.w;
  const int co0 = chunk * kCoCh;
  // a channel per warp, its (TH + 2) x (TW + 2) frame flattened over the
  // lanes; the row is e / rs in float, exact for frames this small
  const int rs = ge.tw + 2;
  const int hp = (ge.th + 2) * rs;
  const float inv_rs = 1.0f / rs;
  for (int co_l = warp; co_l < kCoCh; co_l += kWarps) {
    const int co = co0 + co_l;
    const float* gc = ge.g + (static_cast<int64_t>(ge.b) * ge.cout + co) * hw;
    for (int e = lane; e < hp; e += 32) {
      const int rr = __float2int_rz((e + 0.5f) * inv_rs);
      const int y = ge.y0 - 1 + rr, xx = ge.x0 - 1 + e - rr * rs;
      const bool ok = co < ge.cout && y >= 0 && y < ge.h && xx >= 0 && xx < ge.w;
      tc::cp_async4(st + co_l * ge.plane + e, ok ? gc + y * ge.w + xx : ge.g, ok);
    }
  }
  float* ws = st + kCoCh * ge.plane;
  // lanes on consecutive channels c, so that the stores hit 32 banks; the
  // loads gather with a stride of 9 floats, in cache lines that the other
  // taps' passes read again
  for (int e = threadIdx.x; e < kCoCh * 9 * kBn; e += kThreads) {
    const int c_l = e % kBn;
    const int row = e / kBn;  // co_l * 9 + tap
    const int co_l = row / 9;
    const int tap = row - co_l * 9;
    const int co = co0 + co_l;
    const bool ok = co < ge.cout && ge.c0 + c_l < ge.cin;
    tc::cp_async4(ws + ((8 - tap) * kCoCh + co_l) * kWs + c_l,
                  ok ? ge.weight + (static_cast<int64_t>(co) * ge.cin + ge.c0 + c_l) * 9 + tap
                     : ge.weight,
                  ok);
  }
}

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 2)
    dgrad3x3_tc_kernel(const float* __restrict__ g, const float* __restrict__ weight,
                       const float* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ shift, float* __restrict__ dx,
                       float* __restrict__ part, int cin, int cout, int h, int w, int th,
                       int tw, int plane) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kBn;
  const int tile = blockIdx.x;
  const int nbx = (w + tw - 1) / tw;
  const int y0 = (tile / nbx) * th, x0 = (tile % nbx) * tw;
  const Geo ge{g, weight, cin, cout, h, w, th, tw, plane, c0, b, y0, x0};
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int rs = tw + 2;
  const int npx = th * tw;
  const int sf = stage_floats(plane);

  // the lane's pixel rows: offsets in the staged box (0 past the box)
  int pix[kMt][2];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = warp * 16 * kMt + i * 16 + gid + 8 * u;
      pix[i][u] = p < npx ? (p / tw) * rs + p % tw + tig * plane : tig * plane;
    }

  float acc[kMt][kNt][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const int nch = (cout + kCoCh - 1) / kCoCh;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) stage_chunk(s, ge, smem + s * sf);
    tc::cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk it is staged; the buffer of chunk it - 1 is free
    const int nxt = it + kStages - 1;
    if (nxt < nch) stage_chunk(nxt, ge, smem + (nxt % kStages) * sf);
    tc::cp_async_commit();
    const float* gs = smem + (it % kStages) * sf;
    const float* ws = gs + kCoCh * plane;
    float pt[kMt][kNt][4];
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) pt[i][j][r] = 0.0f;
#pragma unroll 3
    for (int t = 0; t < 9; ++t) {  // the k-step of tap t
      const float* ap = gs + (t / 3) * rs + t % 3;
      Split a[kMt][4];
#pragma unroll
      for (int i = 0; i < kMt; ++i) {
        a[i][0] = tc::split(ap[pix[i][0]]);
        a[i][1] = tc::split(ap[pix[i][1]]);
        a[i][2] = tc::split(ap[4 * plane + pix[i][0]]);
        a[i][3] = tc::split(ap[4 * plane + pix[i][1]]);
      }
      const float* bp = ws + (t * kCoCh + tig) * kWs + gid;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const Split bf[2] = {tc::split(bp[8 * j]), tc::split(bp[4 * kWs + 8 * j])};
#pragma unroll
        for (int i = 0; i < kMt; ++i) tc::mma3(pt[i][j], a[i], bf);
      }
    }
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += pt[i][j][r];
  }
  tc::cp_async_wait<0>();

  float s0[kNt][2], s1[kNt][2];
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) s0[j][e] = s1[j][e] = 0.0f;
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = warp * 16 * kMt + i * 16 + gid + 8 * u;
      const int y = y0 + p / tw, xx = x0 + p % tw;
      if (p >= npx || y >= h || xx >= w) continue;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * tig + e;
          if (c >= cin) continue;
          const int64_t idx = (static_cast<int64_t>(b) * cin + c) * hw + y * w + xx;
          const float v = acc[i][j][2 * u + e];
          if (!kPrologue) {
            dx[idx] = v;
            continue;
          }
          const float sc = scale[c];
          const float xv = x[idx];
          const float dam = __fadd_rn(__fmul_rn(xv, sc), shift[c]) > 0.0f ? v : 0.0f;
          dx[idx] = __fmul_rn(dam, sc);
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
  if (tid < kBn && c0 + tid < cin) {
    float s0_sum = 0.0f, s1_sum = 0.0f;
#pragma unroll
    for (int m = 0; m < kWarps; ++m) {
      s0_sum += red[(m * kBn + tid) * 2];
      s1_sum += red[(m * kBn + tid) * 2 + 1];
    }
    float* p = part + (static_cast<int64_t>(b) * gridDim.x + tile) * 2 * cin + c0 + tid;
    p[0] = s0_sum;
    p[cin] = s1_sum;
  }
}

template <bool kPrologue>
cudaError_t launch(Box bx, int plane, const float* g, const float* wt, const float* x,
                   const float* sc, const float* sh, float* dx, float* part, int b, int cin,
                   int cout, int h, int w, cudaStream_t s) {
  const int bytes = smem_bytes(plane);
  cudaError_t err = cudaFuncSetAttribute(dgrad3x3_tc_kernel<kPrologue>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(box_count(bx, h, w)),
                  static_cast<unsigned>((cin + kBn - 1) / kBn), static_cast<unsigned>(b));
  dgrad3x3_tc_kernel<kPrologue><<<grid, kThreads, bytes, s>>>(
      g, wt, x, sc, sh, dx, part, cin, cout, h, w, bx.th, bx.tw, plane);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that im2im_dgrad3x3 needs for its reduction partials.
extern "C" long long im2im_dgrad3x3_scratch(int b, int cin, int h, int w) {
  return static_cast<long long>(b) * box_count(dgrad_box(h, w), h, w) * 2 * cin;
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
  const Box bx = dgrad_box(h, w);
  const int64_t boxes = box_count(bx, h, w);
  if (boxes > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int plane = halo_plane(bx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* wf = static_cast<const float*>(weight);
  const auto* xf = static_cast<const float*>(x);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* pf = static_cast<float*>(part);
  auto* df = static_cast<float*>(dx);
  if (!prologue)
    return static_cast<int>(
        launch<false>(bx, plane, gf, wf, xf, sc, sh, df, pf, b, cin, cout, h, w, s));
  err = launch<true>(bx, plane, gf, wf, xf, sc, sh, df, pf, b, cin, cout, h, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(conv3x3::launch_reduce_rows(
      pf, static_cast<float*>(red), 1, static_cast<int64_t>(b) * boxes, 2LL * cin, s));
}
