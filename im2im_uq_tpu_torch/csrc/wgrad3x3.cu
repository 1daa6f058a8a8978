// K5: the weight and bias gradients of K4, NCHW, float32, for sm_90a (its
// bfloat16 instance is conv3x3_bf16.cu's): the stem (Cin = 1) and every
// shape that ops/conv_bwd.wgrad_f32_plan does not take (Cin off the
// multiples of 16, W off the multiples of 4, unaligned tensors). The rest
// runs wgrad3x3_tma.cu's kernel on Hopper's wgmma fed by TMA (2.4x faster
// over the batch-32 320x320 step on an H100, PERF.md); this one stays
// callable on any shape for comparisons (conv_bwd.wgrad3x3_mma_sync).
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
// What bounds it: a GEMM of M = Cout, N = 9 * Cin and depth K = B*H*W
// (3.3 M at batch 32, 320x320). The bound counts one multiply-add per
// (pixel, channel pair), the Winograd limit, at 165 TFLOP/s, the
// float32-accurate rate of 3xTF32 on the tensor cores, against the bytes
// of x and g read once. At batch 32, 320x320 the levels of 256 channels
// and more are bound by operations, the shallower ones and the stem by
// bytes.
//
// Design: an implicit GEMM on the tensor cores in 3xTF32 (mma_tf32.cuh),
// float32-accurate. mma.sync, not wgmma: the B operand is the input shifted
// by each of the 9 taps, one pixel at a time, which breaks the 16-byte
// canonical layouts that wgmma reads from shared memory, while mma.sync
// fragments are loaded lane by lane at any offset.
// - Tile. A block owns 64 output channels x 32 input channels x 9 taps
//   (N = 288). Its 8 warps are 2 (M) x 4 (N): a warp holds 32 x 72 of dW,
//   2 x 9 fragments of 16 x 8, 72 float32 accumulators a lane, within the
//   128 registers that let two blocks share an SM (one block alone left
//   the tensor cores much slower). Within a warp's N the fragment index
//   is the tap and the column the channel, so a B fragment is the staged
//   input at one shared-memory offset per tap: one staged box of input
//   rows with its frame serves all 9 taps.
// - Depth. K runs over boxes of 64 pixels (TH rows x TW columns, TW a
//   power of 2 >= 8, so that one k-step of 8 pixels lies in one row and
//   the index arithmetic is shifts), the box chosen per shape to pad the
//   least (320, 160, 80: 2 x 32, no padding; 40: 8 x 8, none; 20: 8 x 8,
//   44%). Each stage holds g (64 channels x the box; 16-byte copies where
//   W % 4 == 0) and the input box with its 1-pixel frame (32 channels, the
//   frame flattened over the lanes), copied with cp.async, zero outside the
//   image; the prologue is applied in place, to the in-image elements only,
//   by the thread that copied them, so the zero frame stays 0 when
//   shift > 0. Three stages: the copies of the next two boxes run under
//   the current box's mma. Operands are split into hi and lo as their
//   fragments are loaded, and each product goes through a fresh
//   accumulator (tc::mma3_fresh).
// - Split K. The boxes are split into slices, enough that about 8 blocks
//   per SM are launched; each slice writes its partial dW and db, and
//   conv3x3::reduce_rows sums the partials over the slices in a fixed
//   order: no float atomics, the same bits on every run.
// - db rides along: the blocks of the first input-channel tile sum the
//   staged g, each thread a fixed quarter of the pixels of one channel.
// - The stem (Cin = 1, N = 9) has its own tile: 64 x 16 (the 9 taps of its
//   one channel padded to two fragments), the 8 warps splitting the k-steps
//   of each box among them and summing their fragments in shared memory in
//   a fixed order at the end. It streams g once.

#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tc.cuh"
#include "mma_tf32.cuh"

namespace {

using tc::Split;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kCoT = 64;               // output channels per block
constexpr int kBoxPx = 64;             // pixels per box
constexpr int kGsStride = kBoxPx + 4;  // = 4 mod 32: A fragment loads hit 32 banks
constexpr int64_t kTargetBlocks = 8 * 132;

struct Box {
  int th, tw, log2_tw;
};

// The box of 64 pixels (TW = 2^log2_tw >= 8 columns, TH = 64 / TW rows) that
// pads the image least; the first of the list on a tie.
Box wgrad_box(int h, int w) {
  static const Box kBoxes[] = {{2, 32, 5}, {1, 64, 6}, {4, 16, 4}, {8, 8, 3}};
  Box best = kBoxes[0];
  int64_t best_boxes = -1;
  for (const Box& bx : kBoxes) {
    const int64_t n = static_cast<int64_t>((h + bx.th - 1) / bx.th) * ((w + bx.tw - 1) / bx.tw);
    if (best_boxes < 0 || n < best_boxes) {
      best = bx;
      best_boxes = n;
    }
  }
  return best;
}

// floats per input channel of a staged box with its frame; = 4 mod 8, so
// that the 8 channels of a B fragment fall in distinct banks
int halo_plane(Box bx) {
  const int p = (bx.th + 2) * (bx.tw + 2);
  return p + (12 - p % 8) % 8;
}

template <bool kStem>
struct Cfg {
  static constexpr int kCiT = kStem ? 2 : 32;     // input channels staged per block
  static constexpr int kMt = kStem ? 4 : 2;       // 16-row fragments per warp
  static constexpr int kNt = kStem ? 2 : 9;       // 8-column fragments per warp
  static constexpr int kWarpsN = kStem ? 1 : 4;   // warps along N (general: 2 x 4)
  static constexpr int kWarpsK = kStem ? 8 : 1;   // warps along K (stem: 8)
};

struct Plan {
  Box box;
  int plane;
  bool stem;
  int nci, nco;
  int64_t boxes, per_slice, slices;
};

Plan plan(int b, int cin, int cout, int h, int w) {
  Plan p;
  p.box = wgrad_box(h, w);
  p.plane = halo_plane(p.box);
  p.stem = cin == 1;
  p.nci = p.stem ? 1 : (cin + Cfg<false>::kCiT - 1) / Cfg<false>::kCiT;
  p.nco = (cout + kCoT - 1) / kCoT;
  p.boxes = static_cast<int64_t>(b) * ((h + p.box.th - 1) / p.box.th) *
            ((w + p.box.tw - 1) / p.box.tw);
  const int64_t tiles = static_cast<int64_t>(p.nci) * p.nco;
  int64_t want = (kTargetBlocks + tiles - 1) / tiles;
  if (want > p.boxes) want = p.boxes;
  p.per_slice = (p.boxes + want - 1) / want;
  p.slices = (p.boxes + p.per_slice - 1) / p.per_slice;
  return p;
}

// A stage: g [co][pixel], then the input box [ci][row][col]; a multiple of
// 4 floats, so that every stage is 16-byte aligned.
template <bool kStem>
struct Stage {
  static constexpr int kX = kCoT * kGsStride;
  __host__ __device__ static int floats(int plane) {
    return (kX + Cfg<kStem>::kCiT * plane + 3) & ~3;
  }
};

template <bool kStem>
int smem_bytes(int plane) {
  int floats = kStages * Stage<kStem>::floats(plane) + 2 * Cfg<kStem>::kCiT;
  if (kStem && floats < kWarps * 32 * 32) floats = kWarps * 32 * 32;  // the warps' sums
  return floats * static_cast<int>(sizeof(float));
}

struct Geo {
  const float* x;
  const float* g;
  int cin, cout, h, w, th, tw, log2_tw, plane, co0, ci0;
  bool vec;  // g's rows are 16-byte aligned: 16-byte copies
};

// The box q of the slice: its image and top-left pixel.
template <typename G>
__device__ __forceinline__ void box_origin(int64_t q, const G& ge, int& b, int& y0, int& x0) {
  const int nbx = (ge.w + ge.tw - 1) >> ge.log2_tw;
  const int nby = (ge.h + ge.th - 1) / ge.th;
  b = static_cast<int>(q / (static_cast<int64_t>(nbx) * nby));
  const int r = static_cast<int>(q % (static_cast<int64_t>(nbx) * nby));
  y0 = (r / nbx) * ge.th;
  x0 = (r % nbx) * ge.tw;
}

// The elements of box q that this thread stages, in one fixed order, for
// two passes over one stage: kCopy starts their copies (cp.async, 0 outside
// the image); !kCopy, after this thread's copies have landed, applies the
// prologue to its in-image input elements in place.
template <bool kStem, bool kCopy>
__device__ __forceinline__ void visit_box(int64_t q, const Geo& ge, float* st, const float* ss) {
  constexpr int kCiT = Cfg<kStem>::kCiT;
  int b, y0, x0;
  box_origin(q, ge, b, y0, x0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t hw = static_cast<int64_t>(ge.h) * ge.w;
  if (kCopy) {
    const float* gb = ge.g + static_cast<int64_t>(b) * ge.cout * hw;
    if (ge.vec) {
      // 64 channels x 16 runs of 4 pixels: a warp takes 2 channels a pass
      const int k = 4 * (lane & 15);
      const int y = y0 + (k >> ge.log2_tw), xx = x0 + (k & (ge.tw - 1));
      const bool in = y < ge.h && xx < ge.w;
      for (int co_l = 2 * warp + (lane >> 4); co_l < kCoT; co_l += 2 * kWarps) {
        const bool ok = in && ge.co0 + co_l < ge.cout;
        tc::cp_async16(st + co_l * kGsStride + k,
                       ok ? gb + (ge.co0 + co_l) * hw + y * ge.w + xx : ge.g, ok);
      }
    } else {
      for (int k = lane; k < kBoxPx; k += 32) {
        const int y = y0 + (k >> ge.log2_tw), xx = x0 + (k & (ge.tw - 1));
        const bool in = y < ge.h && xx < ge.w;
        for (int co_l = warp; co_l < kCoT; co_l += kWarps) {
          const bool ok = in && ge.co0 + co_l < ge.cout;
          tc::cp_async4(st + co_l * kGsStride + k,
                        ok ? gb + (ge.co0 + co_l) * hw + y * ge.w + xx : ge.g, ok);
        }
      }
    }
  }
  float* xs = st + Stage<kStem>::kX;
  const float* xb = ge.x + static_cast<int64_t>(b) * ge.cin * hw;
  // the lanes walk each channel's (TH + 2) x (TW + 2) frame flattened; the
  // row is e / rs in float, exact for frames this small
  const int rs = ge.tw + 2;
  const int hp = (ge.th + 2) * rs;
  const float inv_rs = 1.0f / rs;
  for (int ci_l = warp; ci_l < kCiT; ci_l += kWarps) {
    const bool c_ok = ge.ci0 + ci_l < ge.cin;
    const float* xc = xb + (ge.ci0 + ci_l) * hw;
    const float sc = kCopy ? 0.0f : ss[ci_l], sh = kCopy ? 0.0f : ss[kCiT + ci_l];
    for (int e = lane; e < hp; e += 32) {
      const int rr = __float2int_rz((e + 0.5f) * inv_rs);
      const int y = y0 - 1 + rr, xx = x0 - 1 + e - rr * rs;
      const bool ok = c_ok && y >= 0 && y < ge.h && xx >= 0 && xx < ge.w;
      float* p = xs + ci_l * ge.plane + e;
      if (kCopy)
        tc::cp_async4(p, ok ? xc + y * ge.w + xx : ge.x, ok);
      else if (ok)
        *p = conv3x3::affine_relu(*p, sc, sh);
    }
  }
}

// The (input channel, tap) of column j of the warp's N fragment t.
template <bool kStem>
__device__ __forceinline__ void column(int wn, int t, int j, int& ci_l, int& tap) {
  if (kStem) {
    const int n = 8 * t + j;
    ci_l = n / 9;
    tap = n % 9;
  } else {
    ci_l = 8 * wn + j;
    tap = t;
  }
}

template <bool kStem, bool kPrologue>
__global__ void __launch_bounds__(kThreads, 2)
    wgrad3x3_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ scale, const float* __restrict__ shift,
                       float* __restrict__ part_w, float* __restrict__ part_b, int cin,
                       int cout, int h, int w, int th, int log2_tw, int plane, int vec,
                       int64_t per_slice, int64_t boxes, int nci) {
  using C = Cfg<kStem>;
  using St = Stage<kStem>;
  extern __shared__ __align__(16) float smem[];
  const int64_t slice = blockIdx.x;
  const int ci_tile = blockIdx.y % nci;
  const Geo ge{x, g, cin, cout, h, w, th, 1 << log2_tw, log2_tw, plane,
               static_cast<int>(blockIdx.y / nci) * kCoT, ci_tile * C::kCiT, vec != 0};
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = kStem ? 0 : warp / C::kWarpsN;
  const int wn = kStem ? 0 : warp % C::kWarpsN;
  const int wk = kStem ? warp : 0;
  const int sf = St::floats(plane);
  float* ss = smem + kStages * sf;  // scale, shift of the block's channels
  if (kPrologue) {
    for (int i = tid; i < C::kCiT; i += kThreads) {
      const int ci = ge.ci0 + i;
      ss[i] = ci < cin ? scale[ci] : 0.0f;
      ss[C::kCiT + i] = ci < cin ? shift[ci] : 0.0f;
    }
    __syncthreads();
  }

  const int rs = (1 << log2_tw) + 2;
  int off[C::kNt];  // the B fragment's offset in the input box, per tap fragment
#pragma unroll
  for (int t = 0; t < C::kNt; ++t) {
    int ci_l, tap;
    column<kStem>(wn, t, gid, ci_l, tap);
    off[t] = ci_l * plane + (tap / 3) * rs + tap % 3 + tig;
  }
  float acc[C::kMt][C::kNt][4];
#pragma unroll
  for (int i = 0; i < C::kMt; ++i)
#pragma unroll
    for (int t = 0; t < C::kNt; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][t][r] = 0.0f;
  const bool with_db = ci_tile == 0;  // the same in the whole block
  float dbacc = 0.0f;

  const int64_t q0 = slice * per_slice;
  const int n = static_cast<int>((q0 + per_slice < boxes ? q0 + per_slice : boxes) - q0);
  const int lsr = log2_tw - 3;  // log2 of the k-steps of 8 pixels per box row
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) visit_box<kStem, true>(q0 + s, ge, smem + s * sf, ss);
    tc::cp_async_commit();
  }
  for (int it = 0; it < n; ++it) {
    float* st = smem + (it % kStages) * sf;
    tc::cp_async_wait<kStages - 2>();
    if (kPrologue) visit_box<kStem, false>(q0 + it, ge, st, ss);
    __syncthreads();  // box it is staged; the buffer of box it - 1 is free
    const int nxt = it + kStages - 1;
    if (nxt < n) visit_box<kStem, true>(q0 + nxt, ge, smem + (nxt % kStages) * sf, ss);
    tc::cp_async_commit();
    const float* xs = st + St::kX;
    for (int s = wk; s < kBoxPx / 8; s += C::kWarpsK) {
      Split a[C::kMt][4];
#pragma unroll
      for (int i = 0; i < C::kMt; ++i) {
        const float* ap = st + ((kStem ? 0 : wm * 32) + i * 16 + gid) * kGsStride + 8 * s + tig;
        a[i][0] = tc::split(ap[0]);
        a[i][1] = tc::split(ap[8 * kGsStride]);
        a[i][2] = tc::split(ap[4]);
        a[i][3] = tc::split(ap[8 * kGsStride + 4]);
      }
      const int r = s >> lsr;
      const float* bp = xs + r * rs + (s - (r << lsr)) * 8;
#pragma unroll
      for (int t = 0; t < C::kNt; ++t) {
        const Split bf[2] = {tc::split(bp[off[t]]), tc::split(bp[off[t] + 4])};
#pragma unroll
        for (int i = 0; i < C::kMt; ++i) tc::mma3_fresh(acc[i][t], a[i], bf);
      }
    }
    if (with_db) {
      // thread tid: channel tid / 4, pixels = tid (mod 4), in order
      const float* gp = st + (tid >> 2) * kGsStride;
      for (int k = tid & 3; k < kBoxPx; k += 4) dbacc += gp[k];
    }
  }
  tc::cp_async_wait<0>();

  if (with_db) {
    dbacc += __shfl_xor_sync(0xffffffffu, dbacc, 1);
    dbacc += __shfl_xor_sync(0xffffffffu, dbacc, 2);
    const int co = ge.co0 + (tid >> 2);
    if ((tid & 3) == 0 && co < cout) part_b[slice * cout + co] = dbacc;
  }
  if (kStem) {
    // the warps' sums, added in warp order by warp 0
    __syncthreads();  // every warp is done with the stages
    float* red = smem;
#pragma unroll
    for (int i = 0; i < C::kMt; ++i)
#pragma unroll
      for (int t = 0; t < C::kNt; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[(warp * 32 + (i * C::kNt + t) * 4 + r) * 32 + lane] = acc[i][t][r];
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int i = 0; i < C::kMt; ++i)
#pragma unroll
      for (int t = 0; t < C::kNt; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = 0.0f;
          for (int k = 0; k < kWarps; ++k) v += red[(k * 32 + (i * C::kNt + t) * 4 + r) * 32 + lane];
          acc[i][t][r] = v;
        }
  }
#pragma unroll
  for (int i = 0; i < C::kMt; ++i)
#pragma unroll
    for (int t = 0; t < C::kNt; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int co = ge.co0 + (kStem ? 0 : wm * 32) + i * 16 + gid + (r >= 2 ? 8 : 0);
        int ci_l, tap;
        column<kStem>(wn, t, 2 * tig + (r & 1), ci_l, tap);
        const int ci = ge.ci0 + ci_l;
        if (co < cout && ci < cin)
          part_w[((slice * cout + co) * cin + ci) * 9 + tap] = acc[i][t][r];
      }
}

template <bool kStem, bool kPrologue>
cudaError_t launch(const Plan& p, const float* x, const float* g, const float* sc,
                   const float* sh, float* part_w, float* part_b, int cin, int cout, int h,
                   int w, cudaStream_t s) {
  const int bytes = smem_bytes<kStem>(p.plane);
  cudaError_t err = cudaFuncSetAttribute(wgrad3x3_tc_kernel<kStem, kPrologue>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.slices), static_cast<unsigned>(p.nci * p.nco));
  wgrad3x3_tc_kernel<kStem, kPrologue><<<grid, kThreads, bytes, s>>>(
      x, g, sc, sh, part_w, part_b, cin, cout, h, w, p.box.th, p.box.log2_tw, p.plane,
      w % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0, p.per_slice, p.boxes, p.nci);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that im2im_wgrad3x3 needs for its split-K partials.
extern "C" long long im2im_wgrad3x3_scratch(int b, int cin, int cout, int h, int w) {
  return plan(b, cin, cout, h, w).slices * (static_cast<long long>(cout) * cin * 9 + cout);
}

// K5. x (b, cin, h, w) the forward's raw input and g (b, cout, h, w),
// float32; scale, shift (cin) float32 read when prologue != 0, scratch
// (im2im_wgrad3x3_scratch floats), dw (cout, cin, 3, 3) and db (cout)
// float32; contiguous. Returns a cudaError_t value.
extern "C" int im2im_wgrad3x3(const void* x, const void* g, const void* scale,
                              const void* shift, void* scratch, void* dw, void* db, int b,
                              int cin, int cout, int h, int w, int prologue, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan(b, cin, cout, h, w);
  if (p.slices > 0x7fffffff || static_cast<int64_t>(p.nci) * p.nco > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* part_w = static_cast<float*>(scratch);
  auto* part_b = part_w + p.slices * cout * cin * 9;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(g);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  if (p.stem)
    err = prologue ? launch<true, true>(p, xf, gf, sc, sh, part_w, part_b, cin, cout, h, w, s)
                   : launch<true, false>(p, xf, gf, sc, sh, part_w, part_b, cin, cout, h, w, s);
  else
    err = prologue ? launch<false, true>(p, xf, gf, sc, sh, part_w, part_b, cin, cout, h, w, s)
                   : launch<false, false>(p, xf, gf, sc, sh, part_w, part_b, cin, cout, h, w, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = conv3x3::launch_reduce_rows(part_w, static_cast<float*>(dw), 1, p.slices,
                                    static_cast<int64_t>(cout) * cin * 9, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      conv3x3::launch_reduce_rows(part_b, static_cast<float*>(db), 1, p.slices, cout, s));
}
