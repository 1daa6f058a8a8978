// The shared core of the 3x3 same-padding convolution kernels, NCHW,
// float32, for sm_90a: the implicit GEMM on the tensor cores that K3/K4
// (conv3x3.cu) and K6 (dgrad3x3.cu) instantiate in float32, and the
// prologue, the dtype helpers and the fixed-order cross-block sums that
// K3-K6 share in both dtypes (K5, wgrad3x3.cu, and the bf16 kernels,
// conv3x3_bf16.cu, take affine_relu, round_as and reduce_rows).
//
// The GEMM. A block owns M = the pixels of a box of one image (at most 256,
// flattened) x N = 32 channels, and walks K = 9 taps x the K channels in
// chunks of 8 channels x 9 taps:
//   A[p, (k, t)] = in[k] at pixel p shifted by tap t (0 outside the image),
//   B[(k, t), n] = W[n][k][t] (the forward conv: K = Cin, N = Cout) or
//                  W[k][n][8 - t] (kFlip, K6's transposed, flipped kernel:
//                  K = Cout, N = Cin), by index arithmetic while staging.
// wgmma (m64n32k8, TF32), A from registers, B from shared memory: the tap
// shifts move A by one pixel at a time, off the 16-byte canonical layouts
// that wgmma reads from shared memory, so each lane loads its A fragment
// at the tap's offsets, as for mma.sync; B, the chunk's weights, is a plain
// (K x N) tile per tap. The 8 warps are two warpgroups of 128 pixels, each
// two m64 instances, within the 128 registers that let two blocks share an
// SM. Each stage holds the chunk's box of `in` with its 1-pixel frame (the
// frame flattened over the lanes, one channel per warp) and the chunk's
// weights in copy order (one contiguous run of the weight tensor per n in
// the forward, per k under kFlip), copied with cp.async: three stages, so
// the copies of the next two chunks run under the current chunk's
// products. Once its copies have landed, each thread applies the prologue
// (kPrologue: relu(v * scale[k] + shift[k]), to in-image elements only, so
// the zero frame stays 0 when shift > 0) and splits its weights into the hi
// and lo tiles that wgmma reads, in its canonical K-major layout.
//
// 3xTF32 (mma_tf32.cuh): A is split into hi and lo as its fragments are
// loaded, B once per block and chunk; each k-step issues its lo*hi
// products, then its hi*lo, then its hi*hi, over both m64 instances; the A
// registers of k-steps t and t + 1 are double-buffered, so that k-step t's
// loads run under k-step t - 1's products. A chunk's products accumulate in
// the tensor core, 27 k-steps of 8 deep, into a partial zeroed per chunk,
// which is then added to the block's sums in float32 (the tensor core's
// accumulation drops low bits: run over all of K, its error grew with K's
// depth). It runs K3, K4 and K6 faster on the card than the same tiles on
// mma.sync.m16n8k8 did (PERF.md).
//
// The grid (launch_grid, place): a block per (box, tile of 32 channels,
// image), the channel tile the fastest index, so that the blocks that
// stage one box of `in` run together and find it in L2.
//
// The box is chosen per shape to pad the least (TW = W where W <= 256, or
// 32, 16, 64, 8, 128, 256; TH = 256 / TW): padded work at 320: 0 (8 x 32),
// 160: 0 (8 x 32), 80: 0 (16 x 16), 40: 10.7% (6 x 40), 20: 21.9% (12 x 20).
//
// Cross-block sums (K4's stats, K6's reductions, K5's split-K) are written
// as per-block partials and summed by reduce_rows in a fixed order: no
// float atomics, so two runs give the same bits. K4 and K6 each keep their
// own copy of the per-block sums: as one shared function they ran slower
// on the card (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_tf32.cuh"

namespace conv3x3 {

__device__ __forceinline__ float affine_relu(float v, float scale, float shift) {
  // rounded as the plain version's x * scale + shift (no FMA contraction)
  return fmaxf(__fadd_rn(__fmul_rn(v, scale), shift), 0.0f);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// v rounded to T, as a float
template <typename T>
__device__ __forceinline__ float round_as(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}

// v rounded to T and stored; returns the stored value as a float
__device__ __forceinline__ float store(float* p, float v) {
  *p = v;
  return v;
}
__device__ __forceinline__ float store(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 r = __float2bfloat16_rn(v);
  *p = r;
  return __bfloat162float(r);
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

constexpr int kStages = 3;
constexpr int kWarps = 8;  // two warpgroups along M
constexpr int kThreads = 32 * kWarps;
constexpr int kMt = 2;                     // m64 instances per warpgroup
constexpr int kNt = 4;                     // 8-channel column groups of the n32 tile
constexpr int kBoxPx = 64 * kMt * kWarps / 4;  // pixels per block
constexpr int kBn = 8 * kNt;               // N channels per block
constexpr int kKc = 8;                     // K channels per chunk: 9 k-steps of 8
constexpr int kWChunk = kBn * 9 * kKc;     // weights of a chunk
// split weights: per tap a (32 n x 8 k) tile in wgmma's K-major layout
// without swizzle, core matrices of 8 n x 4 k (16 bytes a row): k groups
// kLbo bytes apart, n groups kSbo bytes apart; taps 260 floats apart, so
// that the 9 taps of one (n, k) fall in distinct banks when stored
constexpr int kLbo = 128, kSbo = 256;
constexpr int kTapStride = 260;
constexpr int kSplit = 9 * kTapStride;  // floats of one part, hi or lo, of a chunk

struct Box {
  int th, tw;
};

inline int64_t box_count(Box bx, int h, int w) {
  return static_cast<int64_t>((h + bx.th - 1) / bx.th) * ((w + bx.tw - 1) / bx.tw);
}

// The box of at most kBoxPx pixels that pads the image least; the first of
// the list on a tie.
inline Box choose_box(int h, int w) {
  const int widths[] = {w <= kBoxPx ? w : 32, 32, 16, 64, 8, 128, 256};
  Box best{kBoxPx / widths[0], widths[0]};
  for (int tw : widths) {
    const Box bx{kBoxPx / tw, tw};
    if (bx.th > 0 && box_count(bx, h, w) < box_count(best, h, w)) best = bx;
  }
  return best;
}

// floats per channel of a staged box with its frame; = 8 mod 32, so that
// the 4 channels of an A fragment fall 8 banks apart
inline int halo_plane(Box bx) {
  const int p = (bx.th + 2) * (bx.tw + 2);
  return p + (40 - p % 32) % 32;
}

// A stage: the box [k][row][col], then the chunk's weights in copy order; a
// multiple of 4 floats.
__host__ __device__ __forceinline__ int stage_floats(int plane) {
  return (kKc * plane + kWChunk + 3) & ~3;
}

// The stages, then two buffers of split weights (hi, then lo), chunk it in
// buffer it % 2.
inline int smem_bytes(int plane) {
  return (kStages * stage_floats(plane) + 2 * 2 * kSplit) * static_cast<int>(sizeof(float));
}

// The blocks of one GEMM over images of h x w pixels and nc N channels: a
// block per (box, tile of kBn channels, image), the channel tile the
// fastest grid index, so that the blocks that stage one box of `in` run
// together and find it in L2.
struct Grid {
  int h, w, nc;
  Box box;
  int plane, ntn;
  int64_t boxes;
};

inline Grid make_grid(int h, int w, int nc) {
  const Box bx = choose_box(h, w);
  return {h, w, nc, bx, halo_plane(bx), (nc + kBn - 1) / kBn, box_count(bx, h, w)};
}

// Launch kernel(g, args...) over g's blocks for b images, with `bytes` of
// dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_grid_bytes(Kernel kernel, const Grid& g, int b, cudaStream_t s, int bytes,
                              Args... args) {
  if (b > 65535 || g.boxes * g.ntn > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(g.boxes * g.ntn), static_cast<unsigned>(b));
  kernel<<<grid, kThreads, bytes, s>>>(g, args...);
  return cudaGetLastError();
}

// launch_grid_bytes with the float32 GEMM's shared memory
template <typename Kernel, typename... Args>
cudaError_t launch_grid(Kernel kernel, const Grid& g, int b, cudaStream_t s, Args... args) {
  return launch_grid_bytes(kernel, g, b, s, smem_bytes(g.plane), args...);
}

// This block's image b, box, first channel n0 and the box's first pixel.
struct Place {
  int b, box, n0, y0, x0;
};

__device__ __forceinline__ Place place(const Grid& g) {
  const int box = blockIdx.x / g.ntn;
  const int nbx = (g.w + g.box.tw - 1) / g.box.tw;
  return {static_cast<int>(blockIdx.y), box, (static_cast<int>(blockIdx.x) - box * g.ntn) * kBn,
          (box / nbx) * g.box.th, (box % nbx) * g.box.tw};
}

struct Geo {
  const float* in;      // (B, kc, h, w)
  const float* weight;  // (nc, kc, 3, 3), or (kc, nc, 3, 3) under kFlip
  const float* scale;   // (kc), read with kPrologue
  const float* shift;
  int kc, nc, h, w, th, tw, plane, n0, b, y0, x0;
};

__device__ __forceinline__ Geo geo(const Grid& g, const Place& at, const float* in,
                                   const float* weight, const float* scale, const float* shift,
                                   int kc) {
  return {in,  weight,   scale, shift,    kc,   g.nc, g.h, g.w, g.box.th,
          g.box.tw, g.plane, at.n0, at.b, at.y0, at.x0};
}

// The pixel of the box in row gid + 8 u of fragment i of warp `warp`: two
// warpgroups of 128 pixels, each two m64 instances of 4 warps x 16 rows.
__device__ __forceinline__ int pixel(int warp, int i, int gid, int u) {
  return (warp >> 2) * (64 * kMt) + i * 64 + (warp & 3) * 16 + gid + 8 * u;
}

// The elements of the chunk's box that this thread copies, in one fixed
// order, for two passes over one stage: kCopy starts their copies
// (cp.async, 0 outside the image); !kCopy, after this thread's copies have
// landed, applies the prologue to its in-image elements in place.
template <bool kCopy>
__device__ __forceinline__ void visit_box(int chunk, const Geo& ge, float* st) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t hw = static_cast<int64_t>(ge.h) * ge.w;
  // a channel per warp, its (TH + 2) x (TW + 2) frame flattened over the
  // lanes; the row is e / rs in float, exact for frames this small
  const int rs = ge.tw + 2;
  const int hp = (ge.th + 2) * rs;
  const float inv_rs = 1.0f / rs;
  for (int k_l = warp; k_l < kKc; k_l += kWarps) {
    const int k = chunk * kKc + k_l;
    if (!kCopy && k >= ge.kc) continue;
    const float* src = ge.in + (static_cast<int64_t>(ge.b) * ge.kc + k) * hw;
    const float sc = kCopy ? 0.0f : ge.scale[k], sh = kCopy ? 0.0f : ge.shift[k];
    for (int e = lane; e < hp; e += 32) {
      const int rr = __float2int_rz((e + 0.5f) * inv_rs);
      const int y = ge.y0 - 1 + rr, xx = ge.x0 - 1 + e - rr * rs;
      const bool ok = k < ge.kc && y >= 0 && y < ge.h && xx >= 0 && xx < ge.w;
      float* p = st + k_l * ge.plane + e;
      if (kCopy)
        tc::cp_async4(p, ok ? src + y * ge.w + xx : ge.in, ok);
      else if (ok)
        *p = affine_relu(*p, sc, sh);
    }
  }
}

// The weights of chunk `chunk` that this thread stages, element e of the
// chunk's contiguous runs (per n in the forward, W[n][k][t], 72 floats; per
// k under kFlip, W[k][n][t], 288 floats), for two passes: kCopy starts
// their copies to raw[e] (cp.async, 0 past the channels); !kCopy, after
// they have landed, splits each into hi and lo at its place in the tiles of
// B[(k, t), n] = W[n][k][t] (forward) or W[k][n][8 - t] (kFlip).
template <bool kFlip, bool kCopy>
__device__ __forceinline__ void visit_weights(int chunk, const Geo& ge, float* raw, float* split) {
  const int k0 = chunk * kKc;
  for (int e = threadIdx.x; e < kWChunk; e += kThreads) {
    int n_l, k_l, t;
    int64_t src;
    if (!kFlip) {
      n_l = e / (9 * kKc);
      const int r = e - n_l * (9 * kKc);
      k_l = r / 9;
      t = r - k_l * 9;
      src = (static_cast<int64_t>(ge.n0 + n_l) * ge.kc + k0) * 9 + r;
    } else {
      k_l = e / (9 * kBn);
      const int r = e - k_l * (9 * kBn);
      n_l = r / 9;
      t = 8 - (r - n_l * 9);
      src = (static_cast<int64_t>(k0 + k_l) * ge.nc + ge.n0) * 9 + r;
    }
    if (kCopy) {
      const bool ok = ge.n0 + n_l < ge.nc && k0 + k_l < ge.kc;
      tc::cp_async4(raw + e, ok ? ge.weight + src : ge.weight, ok);
    } else {
      const tc::Split sp = tc::split(raw[e]);
      const int o = t * kTapStride + (n_l >> 3) * (kSbo / 4) + (k_l >> 2) * (kLbo / 4) +
                    (n_l & 7) * 4 + (k_l & 3);
      split[o] = __uint_as_float(sp.hi);
      split[kSplit + o] = __uint_as_float(sp.lo);
    }
  }
}

// Start the copies of chunk `chunk` (K channels 8 chunk .. 8 chunk + 7) into
// one stage, 0 past the channels.
template <bool kFlip>
__device__ __forceinline__ void stage_chunk(int chunk, const Geo& ge, float* st) {
  visit_box<true>(chunk, ge, st);
  visit_weights<kFlip, true>(chunk, ge, st + kKc * ge.plane, nullptr);
}

// acc[i][j][r] = the block's GEMM for the warp's fragment (i, j), element r:
// pixel pixel(warp, i, gid, r / 2) of the box, channel n0 + 8 j + 2 tig +
// r % 2. smem: smem_bytes(plane).
template <bool kFlip, bool kPrologue>
__device__ __forceinline__ void gemm(const Geo& ge, float* smem, float (&acc)[kMt][kNt][4]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rs = ge.tw + 2;
  const int npx = ge.th * ge.tw;
  const int plane = ge.plane;
  const int sf = stage_floats(plane);
  float* split = smem + kStages * sf;

  // the lane's pixel rows: offsets in the staged box (0 past the box)
  int pix[kMt][2];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = pixel(warp, i, gid, u);
      pix[i][u] = p < npx ? (p / ge.tw) * rs + p % ge.tw + tig * plane : tig * plane;
    }

#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  const int nch = (ge.kc + kKc - 1) / kKc;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch) stage_chunk<kFlip>(s, ge, smem + s * sf);
    tc::cp_async_commit();
  }
  for (int it = 0; it < nch; ++it) {
    float* st = smem + (it % kStages) * sf;
    tc::cp_async_wait<kStages - 2>();
    if (kPrologue) visit_box<false>(it, ge, st);
    float* sb = split + (it & 1) * 2 * kSplit;
    visit_weights<kFlip, false>(it, ge, st + kKc * plane, sb);
    tc::fence_proxy_async();  // the split weights, for wgmma's reads
    __syncthreads();  // chunk it is staged; the buffers of chunk it - 1 are free
    const int nxt = it + kStages - 1;
    if (nxt < nch) stage_chunk<kFlip>(nxt, ge, smem + (nxt % kStages) * sf);
    tc::cp_async_commit();
    float pt[kMt][4 * kNt];
#pragma unroll
    for (int i = 0; i < kMt; ++i)
#pragma unroll
      for (int r = 0; r < 4 * kNt; ++r) pt[i][r] = 0.0f;
    // A of k-steps t and t + 1 in two register buffers: k-step t overwrites
    // buffer t % 2 once the wgmma of k-step t - 2 that read it are done
    uint32_t ah[2][kMt][4], al[2][kMt][4];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int buf = t & 1;
      if (t >= 2) {
        tc::wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < kMt; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            tc::keep(ah[buf][i][q]);
            tc::keep(al[buf][i][q]);
          }
      }
      const float* ap = st + (t / 3) * rs + t % 3;
#pragma unroll
      for (int i = 0; i < kMt; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const tc::Split sp = tc::split(ap[(q >> 1) * 4 * plane + pix[i][q & 1]]);
          ah[buf][i][q] = sp.hi;
          al[buf][i][q] = sp.lo;
        }
      tc::wgmma_fence();
      const uint64_t dh = tc::wgmma_desc(sb + t * kTapStride, kLbo, kSbo);
      const uint64_t dl = tc::wgmma_desc(sb + kSplit + t * kTapStride, kLbo, kSbo);
      // 3xTF32, the small terms first, each pass over both instances
#pragma unroll
      for (int i = 0; i < kMt; ++i) tc::wgmma_m64n32k8(pt[i], al[buf][i], dh);
#pragma unroll
      for (int i = 0; i < kMt; ++i) tc::wgmma_m64n32k8(pt[i], ah[buf][i], dl);
#pragma unroll
      for (int i = 0; i < kMt; ++i) tc::wgmma_m64n32k8(pt[i], ah[buf][i], dh);
      tc::wgmma_commit();
    }
    tc::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kMt; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        tc::keep(ah[0][i][q]);
        tc::keep(al[0][i][q]);
        tc::keep(ah[1][i][q]);
        tc::keep(al[1][i][q]);
      }
#pragma unroll
      for (int r = 0; r < 4 * kNt; ++r) {
        tc::keep(pt[i][r]);
        acc[i][r >> 2][r & 3] += pt[i][r];
      }
    }
  }
  tc::cp_async_wait<0>();
}

// Blocks of 256 threads for a grid-stride loop over n elements.
inline unsigned grid_stride_blocks(int64_t n) {
  const int64_t blocks = (n + 255) / 256;
  return static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
}

}  // namespace conv3x3
