// K6 in float32 on Hopper: the input gradient of the fused 3x3 conv (K4),
// NCHW, on wgmma in 3xTF32 fed by TMA, for sm_90a. It runs every float32
// shape that ops/conv_bwd.dgrad_f32_plan takes (Cin a multiple of 64, W of
// 4, 16-byte aligned tensors); the shapes off the plan keep dgrad3x3.cu's
// kernel on conv3x3_tc.cuh, which stays callable for comparisons
// (conv_bwd.dgrad3x3_cp_async).
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_conv_bwd.py
// `dgrad3x3_pallas_raw` (`_dgrad_kernel`), as dgrad3x3.cu does.
//
// What it computes, for the cotangent g (B, Cout, H, W) of a 3x3
// same-padding conv with weight W (Cout, Cin, 3, 3) over the input x:
//   da[b, c, y, x] = sum over co, dh, dw of g[b, co, y + 1 - dh, x + 1 - dw]
//                    * W[co, c, dh, dw]  (0 outside the image);
// with the prologue (the forward applied relu(x * scale + shift)) the mask
// is recomputed from the raw x, strictly x * scale + shift > 0, and
//   dam = da * mask,  dx = dam * scale,  red = (sum dam * x, sum dam) per c;
// without it dx = da and red is not written.
//
// What bounds it: a GEMM of M = B H W pixels, N = Cin and K = 9 Cout (tap,
// output channel), run in 3xTF32 on the tensor cores: 165 TFLOP/s of
// float32-accurate products on an H100 SXM. A direct conv's 9 multiply-adds
// per (pixel, channel pair) at that rate are this design's floor, the same
// as K5's: 1.464 ms for each level of the batch-32 320x320 UNet but the
// 20x20 one. The kernel it replaces (conv3x3_tc.cuh) ran a quarter of that
// rate: m64n32 products fed by cp.async from every thread, the weights
// split again by every block for every chunk.
//
// Design. A persistent block per SM owns one slice of 64 input channels
// (blockIdx.x % ntn) and walks output tiles of TH x TW pixels (at most 256,
// flattened; the plan picks the tile that pads the image least), each in
// chunks of 8 output channels x 9 taps.
// - The roles. Warpgroup 0 is the producer (setmaxnreg 40): one thread
//   keeps TMA loads in flight through a ring of stages (full / empty
//   mbarriers); warps 1-3 leave. Warpgroups 1-2 are the consumers
//   (setmaxnreg 232), 128 of the tile's pixels each as two m64 x n64
//   instances.
// - B = the flipped, transposed weights, B[(co, t), c] = W[co, c, 8 - t]:
//   tf32 wgmma reads B K-major only, so pack_weights_kernel writes each
//   tap's hi and lo (tc::split) once a call in wgmma's K-major no-swizzle
//   layout (core matrices of 8 c x 4 co, 16 bytes a row: LBO = 128 bytes
//   between K-adjacent, SBO = 256 between N-adjacent ones), and each
//   chunk's 18 tiles (36,864 bytes) land in its stage by bulk copies on
//   the stage's mbarrier. No block splits weights.
// - A = g shifted by the tap: a chunk's 8 channels of g land by TMA as one
//   NCHW box [8][ROWS][HC] from (x0 - 4, y0 - 1): a box must start on 16
//   bytes in its inner dimension (from x0 - 1 a TMA load faulted with an
//   illegal instruction on the card, PERF.md), HC = TW + 8 or TW + 12
//   columns, ROWS >= TH + 2, and TMA's zero fill outside the tensor is the
//   image's padding. A tap moves A by single pixels, off wgmma's
//   shared-memory layouts, so each lane loads its fragment of
//   mma.m16n8k8's A layout (pixels gid, gid + 8; channels tig, tig + 4) at
//   the tap's offset and splits it in registers. The plan makes a channel's
//   plane ROWS x HC an odd multiple of 8 floats and keeps the 8 pixels of
//   a load 8 apart in the banks (HC = TW + 8 where a load crosses a tile
//   row), so the 4 channels x 8 pixels of a load hit 32 banks.
// - The products: per tap a consumer issues lo*hi, then hi*lo, then hi*hi
//   over both of its instances into a partial. The taps run on across
//   chunks (the A registers of taps t and t + 1 double-buffered), and a
//   chunk's stage is released once the next chunk's second tap has waited
//   for its products. Every kDrain = 2 chunks, and at a tile's end, the
//   partial is added to the tile's sums in float32 (the tensor core's own
//   accumulation drops low bits: K3's finding), the two warpgroups a chunk
//   apart, so that one keeps the tensor cores busy while the other waits
//   and drains. (A drain every chunk, both warpgroups at once, was 2-7%
//   slower on the card; see PERF.md.)
// - The epilogue, while the producer already loads the next tile: per
//   pixel in the image the mask from the raw x (__fadd_rn(__fmul_rn(x, sc),
//   sh) > 0, as dgrad3x3.cu), dx = dam * scale stored as 32-byte runs of 8
//   pixels, and the tile's (sum dam * x, sum dam) of each channel summed
//   over a warp's lanes by a fixed butterfly and added to the warp's slot
//   in shared memory; at the end the warps' slots in order give the
//   block's partial, and conv3x3::reduce_rows sums the blocks' partials in
//   a fixed order: no float atomics, the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tc.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"
#include "wgmma_tf32.cuh"

namespace {

namespace k6f {

using namespace tmak;

constexpr int kThreads = 384;     // the producer warpgroup, then two consumer warpgroups
constexpr int kBn = 64;           // input channels a block (N)
constexpr int kKc = 8;            // output channels a chunk (K: 8 x 9 taps)
constexpr int kMi = 2;            // m64 instances a consumer warpgroup
constexpr int kTilePx = 64 * kMi * 2;          // pixels a tile at most
constexpr int kWtile = kBn * kKc * 4;          // bytes of one tap's hi (or lo): 2 KB
constexpr int kWchunk = 18 * kWtile;           // a chunk's 9 taps, hi and lo
constexpr int kPiece = 32768;                  // bytes per bulk copy of weights
constexpr int kConsumerWarps = 8;
constexpr int kRedFloats = kConsumerWarps * kBn * 2;  // [warp][channel][2]
constexpr int kDrain = 2;         // chunks between a consumer's drains of its partial

struct Geo {
  float* dx;
  const float* x;
  const float* scale;   // (cin), read with the prologue
  const float* shift;
  float* part;          // [per_slice][2][cin], written with the prologue
  int cin, h, w;
  int th, tw, hc, cs;   // the tile; the box's columns and floats a channel
  int nch, ntn, stages, stage_bytes, box_bytes, woff;
  int tiles_y, tiles_x, tiles;
};

// wpack[slice][chunk][tap][hi, lo][c group][co half][8 c][4 co] =
// split(W[co, c, 8 - tap]) with co = 8 chunk + 4 half + k, c = 64 slice +
// 8 group + n, 0 past Cout; split as tc::split does.
__global__ void pack_weights_kernel(const float* __restrict__ w, float* __restrict__ out,
                                    int cin, int cout, int nch, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int64_t e = i;
    const int k4 = static_cast<int>(e % 4);
    e /= 4;
    const int n8 = static_cast<int>(e % 8);
    e /= 8;
    const int kh = static_cast<int>(e % 2);
    e /= 2;
    const int ng = static_cast<int>(e % (kBn / 8));
    e /= kBn / 8;
    const int part = static_cast<int>(e % 2);
    e /= 2;
    const int tap = static_cast<int>(e % 9);
    e /= 9;
    const int c = static_cast<int>(e % nch);
    const int ns = static_cast<int>(e / nch);
    const int co = c * kKc + 4 * kh + k4, n = ns * kBn + 8 * ng + n8;
    const float v =
        co < cout ? w[(static_cast<int64_t>(co) * cin + n) * 9 + 8 - tap] : 0.0f;
    const tc::Split sp = tc::split(v);
    out[i] = __uint_as_float(part == 0 ? sp.hi : sp.lo);
  }
}

// *p = v in shared memory where `on`, predicated as tmak::store_if
__device__ __forceinline__ void sts_if(float* p, float v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.shared.f32 [%0], %1;\n}\n" ::"r"(
          smem_addr(p)),
      "f"(v), "r"(static_cast<int>(on))
      : "memory");
}

// The tile t's image and first row and column.
struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int t) {
  const int per_img = g.tiles_y * g.tiles_x;
  const int b = t / per_img, r = t - b * per_img;
  const int ty = r / g.tiles_x;
  return {b, ty * g.th, (r - ty * g.tiles_x) * g.tw};
}

// The tile's epilogue for one consumer thread: acc[i][4 j + 2 u + e] is
// pixel 128 wg + 64 i + 16 wq + gid + 8 u of the tile, channel
// 64 ns + 8 j + 2 tig + e. Zeroes acc. With the prologue an instance's 32
// values of x are loaded before any of its stores, so that their latencies
// overlap.
template <bool kPrologue>
__device__ __forceinline__ void epilogue(const Geo& g, const Tile& at, int ns, int wg, int wq,
                                         int gid, int tig, int cw, float* red,
                                         float (&acc)[kMi][kBn / 2]) {
  const int64_t hw = static_cast<int64_t>(g.h) * g.w;
  const int npx = g.th * g.tw;
  const int c0 = ns * kBn + 2 * tig;
  float sc[kBn / 8][2], sh[kBn / 8][2], s0[kBn / 8][2], s1[kBn / 8][2];
  if constexpr (kPrologue) {
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = g.scale[c0 + 8 * j + e];
        sh[j][e] = g.shift[c0 + 8 * j + e];
        s0[j][e] = s1[j][e] = 0.0f;
      }
  }
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
    int64_t base[2];
    bool in[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = 128 * wg + 64 * i + 16 * wq + gid + 8 * u;
      const int py = p / g.tw;
      const int yy = at.y0 + py, xx = at.x0 + p - py * g.tw;
      in[u] = p < npx && yy < g.h && xx < g.w;
      base[u] = (static_cast<int64_t>(at.b) * g.cin + c0) * hw +
                static_cast<int64_t>(yy) * g.w + xx;
    }
    float xv[2][kBn / 8][2];
    if constexpr (kPrologue) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            xv[u][j][e] = g.x[in[u] ? base[u] + (8 * j + e) * hw : 0];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* out = g.dx + base[u] + (8 * j + e) * hw;
          const float v = acc[i][4 * j + 2 * u + e];
          acc[i][4 * j + 2 * u + e] = 0.0f;
          if constexpr (!kPrologue) {
            store_if(out, v, in[u]);
          } else {
            const float x = xv[u][j][e];
            const float dam =
                in[u] && __fadd_rn(__fmul_rn(x, sc[j][e]), sh[j][e]) > 0.0f ? v : 0.0f;
            store_if(out, __fmul_rn(dam, sc[j][e]), in[u]);
            s0[j][e] = fmaf(dam, x, s0[j][e]);
            s1[j][e] += dam;
          }
        }
  }
  if constexpr (kPrologue) {
    // the warp's sums per channel: the lanes of one tig in a fixed
    // butterfly, then added to the warp's slot (one owner a slot)
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s0[j][e] += __shfl_xor_sync(0xffffffffu, s0[j][e], m);
          s1[j][e] += __shfl_xor_sync(0xffffffffu, s1[j][e], m);
        }
        float* r = red + (cw * kBn + 8 * j + 2 * tig + e) * 2;
        const float n0 = r[0] + s0[j][e], n1 = r[1] + s1[j][e];
        sts_if(r, n0, gid == 0);
        sts_if(r + 1, n1, gid == 0);
      }
  }
}

// A consumer lane's A in a box: the offsets of its pixels at tap (0, 0) and
// channel tig, the step to channel tig + 4, and the box's row.
struct Lane {
  int poff[kMi][2];
  int c4, hc;
};

// The 9 taps of one chunk for a consumer warpgroup: A of tap t loaded at
// the tap's offset into register buffer (t + kPar) % 2 (9 taps a chunk, so
// the buffers alternate across chunks too) and split, then the three TF32
// products of each instance into its partial, tap 0's first overwriting it
// where add == 0. Each tap first waits for the products of the tap two
// before it (which read its buffer); at tap 1 those are the last of the
// chunk before, whose stage is then released where `release` is set.
template <int kPar>
__device__ __forceinline__ void chunk_products(const float* box, const unsigned char* wc,
                                               const Lane& ln, int add, uint64_t* held,
                                               bool release, uint32_t (&ah)[2][kMi][4],
                                               uint32_t (&al)[2][kMi][4],
                                               float (&pt)[kMi][kBn / 2]) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int buf = (tap + kPar) & 1;
    tc::wgmma_wait<1>();
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tc::keep(ah[buf][i][r]);
        tc::keep(al[buf][i][r]);
      }
    if (tap == 1) mbar_arrive_if(held, release);
    // the flipped tap (dh', dw') = (tap / 3, tap % 3) reads g at row
    // y + dh' - 1 and column x + dw' - 1
    const float* ap = box + (tap / 3) * ln.hc + tap % 3;
#pragma unroll
    for (int i = 0; i < kMi; ++i) {
      // (pixel gid, co tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4)
      const float v[4] = {ap[ln.poff[i][0]], ap[ln.poff[i][1]], ap[ln.poff[i][0] + ln.c4],
                          ap[ln.poff[i][1] + ln.c4]};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const tc::Split sp = tc::split(v[r]);
        ah[buf][i][r] = sp.hi;
        al[buf][i][r] = sp.lo;
      }
    }
    tc::wgmma_fence();
    const uint64_t dh = tc::wgmma_desc(wc + 2 * tap * kWtile, 128, 256);
    const uint64_t dl = tc::wgmma_desc(wc + (2 * tap + 1) * kWtile, 128, 256);
    // 3xTF32, the small terms first
#pragma unroll
    for (int i = 0; i < kMi; ++i)
      tc::WgmmaTf32<kBn>::run(pt[i], al[buf][i], dh, tap == 0 ? add : 1);
#pragma unroll
    for (int i = 0; i < kMi; ++i) tc::WgmmaTf32<kBn>::run(pt[i], ah[buf][i], dl, 1);
#pragma unroll
    for (int i = 0; i < kMi; ++i) tc::WgmmaTf32<kBn>::run(pt[i], ah[buf][i], dh, 1);
    tc::wgmma_commit();
  }
}

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 1)
    dgrad3x3_tma_kernel(const __grid_constant__ CUtensorMap gmap,
                        const float* __restrict__ wpack, Geo g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + g.stages * g.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + kRedFloats);
  uint64_t* empty = full + g.stages;
  const int ns = blockIdx.x % g.ntn;
  const int first = blockIdx.x / g.ntn, step = gridDim.x / g.ntn;
  // the warp index broadcast from lane 0, so that ptxas sees the role
  // branches as warp-uniform
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  for (int i = threadIdx.x; i < kRedFloats; i += kThreads) red[i] = 0.0f;
  __syncthreads();  // the only block-wide barrier

  if (warp < 4) {
    setmaxnreg_producer();
    if (warp != 0 || lane != 0) return;
    const unsigned char* wslice = reinterpret_cast<const unsigned char*>(wpack) +
                                  static_cast<int64_t>(ns) * g.nch * kWchunk;
    int s = 0, ph = 0, q = 0;
    for (int t = first; t < g.tiles; t += step) {
      const Tile at = tile_of(g, t);
      for (int c = 0; c < g.nch; ++c, ++q) {
        if (q >= g.stages) mbar_wait(empty + s, ph ^ 1);
        unsigned char* st = smem + s * g.stage_bytes;
        mbar_expect_tx(full + s, g.box_bytes + kWchunk);
        tma_load_4d(st, &gmap, at.x0 - 4, at.y0 - 1, c * kKc, at.b, full + s);
        const unsigned char* wc = wslice + static_cast<int64_t>(c) * kWchunk;
        for (int off = 0; off < kWchunk; off += kPiece)
          bulk_load(st + g.woff + off, wc + off, kWchunk - off < kPiece ? kWchunk - off : kPiece,
                    full + s);
        if (++s == g.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  setmaxnreg_consumer();

  const int cw = warp - 4, wg = cw >> 2, wq = cw & 3;
  const int gid = lane >> 2, tig = lane & 3;
  // the lane's A in a box: pixel p of the tile at tap (0, 0) (column x - x0
  // + 3: the box starts at x0 - 4 and the tap reads x - 1), channel tig;
  // pixels past the tile read column 0 and are never stored
  const int npx = g.th * g.tw;
  Lane ln;
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int p = 128 * wg + 64 * i + 16 * wq + gid + 8 * u;
      const int py = p / g.tw;
      ln.poff[i][u] = (p < npx ? py * g.hc + (p - py * g.tw) + 3 : 0) + tig * g.cs;
    }
  ln.c4 = 4 * g.cs;
  ln.hc = g.hc;

  float acc[kMi][kBn / 2], pt[kMi][kBn / 2];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int r = 0; r < kBn / 2; ++r) acc[i][r] = pt[i][r] = 0.0f;
  uint32_t ah[2][kMi][4] = {}, al[2][kMi][4] = {};
  // The partial is drained into the sums every kDrain chunks, the two
  // warpgroups a chunk apart (one keeps the tensor cores busy while the
  // other waits for its products and drains), and at a tile's end; a
  // stage is released once its products are done: at the drain, or at the
  // next chunk's tap 1.
  const int left0 = kDrain - wg;  // chunks to a warpgroup's first drain in a tile
  int left = left0;
  int s = 0, ph = 0, q = 0;  // the chunk's stage, its parity, chunks so far
  int hs = 0;                // the stage held unreleased, where `held`
  bool held = false, pending = false;
  for (int t = first; t < g.tiles; t += step) {
#pragma unroll 1
    for (int c = 0; c < g.nch; ++c, ++q) {
      mbar_wait(full + s, ph);
      const unsigned char* st = smem + s * g.stage_bytes;
      const float* box = reinterpret_cast<const float*>(st);
      const bool rel = held && lane == 0;
      if (q & 1)
        chunk_products<1>(box, st + g.woff, ln, pending, empty + hs, rel, ah, al, pt);
      else
        chunk_products<0>(box, st + g.woff, ln, pending, empty + hs, rel, ah, al, pt);
      held = false;
      const bool last = c + 1 == g.nch;
      if (--left == 0 || last) {
        tc::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < kMi; ++i) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            tc::keep(ah[0][i][r]);
            tc::keep(al[0][i][r]);
            tc::keep(ah[1][i][r]);
            tc::keep(al[1][i][r]);
          }
#pragma unroll
          for (int r = 0; r < kBn / 2; ++r) {
            tc::keep(pt[i][r]);
            acc[i][r] += pt[i][r];
          }
        }
        mbar_arrive_if(empty + s, lane == 0);  // the stage's box and weights are read
        pending = false;
        left = last ? left0 : kDrain;
      } else {
        pending = held = true;
        hs = s;
      }
      if (++s == g.stages) {
        s = 0;
        ph ^= 1;
      }
    }
    // The A registers and the partial hold nothing the next tile reads: as
    // constants they need no registers through the epilogue.
#pragma unroll
    for (int i = 0; i < kMi; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) ah[0][i][r] = al[0][i][r] = ah[1][i][r] = al[1][i][r] = 0u;
#pragma unroll
      for (int r = 0; r < kBn / 2; ++r) pt[i][r] = 0.0f;
    }
    epilogue<kPrologue>(g, tile_of(g, t), ns, wg, wq, gid, tig, cw, red, acc);
  }
  if (!kPrologue) return;
  consumers_sync(kConsumerWarps * 32);  // every warp's slots are final
  const int tid = threadIdx.x - 128;
  if (tid < kBn) {
    float sx = 0.0f, sd = 0.0f;
#pragma unroll
    for (int m = 0; m < kConsumerWarps; ++m) {
      sx += red[(m * kBn + tid) * 2];
      sd += red[(m * kBn + tid) * 2 + 1];
    }
    float* p = g.part + static_cast<int64_t>(first) * 2 * g.cin + ns * kBn + tid;
    p[0] = sx;
    p[g.cin] = sd;
  }
}

}  // namespace k6f

}  // namespace

// Floats of the packed weights that im2im_dgrad3x3_tma needs as scratch:
// every 64-channel slice's chunks of 8 output channels, tf32 hi and lo.
extern "C" long long im2im_dgrad3x3_tma_scratch(int cin, int cout) {
  return static_cast<long long>(cin / k6f::kBn) * ((cout + k6f::kKc - 1) / k6f::kKc) *
         (k6f::kWchunk / 4);
}

// K6 in float32 on wgmma with TMA: g (b, cout, h, w), weight (cout, cin,
// 3, 3) the forward kernel, x (b, cin, h, w) the forward's raw input, dx
// (b, cin, h, w), float32, contiguous, g 16-byte aligned; wpack: the
// scratch above. With prologue != 0: scale, shift (cin), part (per_slice *
// 2 * cin floats) and red (2, cin) are used and red is written. The plan
// (ops/conv_bwd.dgrad_f32_plan): cin a multiple of 64, w of 4; tiles of th
// x tw pixels (at most 256), boxes of hc columns (hc >= tw + 5, a multiple
// of 4) x rows (>= th + 2), a ring of `stages`, per_slice persistent
// blocks a 64-channel slice. Returns a cudaError_t value.
extern "C" int im2im_dgrad3x3_tma(const void* g, const void* weight, const void* x,
                                  const void* scale, const void* shift, void* dx, void* wpack,
                                  void* part, void* red, int b, int cin, int cout, int h, int w,
                                  int prologue, int th, int tw, int hc, int rows, int stages,
                                  int per_slice, int device, void* stream) {
  using namespace k6f;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cin % kBn != 0 || cout <= 0 || h <= 0 || w <= 0 || w % 4 != 0 ||
      th <= 0 || tw <= 0 || th * tw > kTilePx || hc % 4 != 0 || hc < tw + 5 || hc > 256 ||
      rows < th + 2 || rows > 256 || stages < 2 || per_slice <= 0 ||
      (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(wpack)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo ge{};
  ge.cin = cin;
  ge.h = h;
  ge.w = w;
  ge.th = th;
  ge.tw = tw;
  ge.hc = hc;
  ge.cs = rows * hc;
  ge.nch = (cout + kKc - 1) / kKc;
  ge.ntn = cin / kBn;
  ge.stages = stages;
  ge.box_bytes = kKc * rows * hc * 4;
  ge.woff = (ge.box_bytes + 127) / 128 * 128;
  ge.stage_bytes = ge.woff + kWchunk;
  ge.tiles_y = (h + th - 1) / th;
  ge.tiles_x = (w + tw - 1) / tw;
  const int64_t tiles = static_cast<int64_t>(b) * ge.tiles_y * ge.tiles_x;
  const int64_t blocks = static_cast<int64_t>(per_slice) * ge.ntn;
  const int64_t bytes =
      static_cast<int64_t>(stages) * ge.stage_bytes + kRedFloats * 4 + 2LL * stages * 8;
  if (tiles > 0x7fffffff || per_slice > tiles || blocks > 0x7fffffff || bytes > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  ge.tiles = static_cast<int>(tiles);
  ge.dx = static_cast<float*>(dx);
  ge.x = static_cast<const float*>(x);
  ge.scale = static_cast<const float*>(scale);
  ge.shift = static_cast<const float*>(shift);
  ge.part = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  CUtensorMap gmap;
  err = tmak::nchw_map(&gmap, g, b, cout, h, w, hc, rows, kKc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t total = static_cast<int64_t>(ge.ntn) * ge.nch * (kWchunk / 4);
  const int64_t pblocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
  pack_weights_kernel<<<static_cast<unsigned>(pblocks), 256, 0, s>>>(
      static_cast<const float*>(weight), static_cast<float*>(wpack), cin, cout, ge.nch, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kernel = prologue ? dgrad3x3_tma_kernel<true> : dgrad3x3_tma_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<int>(bytes), s>>>(
      gmap, static_cast<const float*>(wpack), ge);
  err = cudaGetLastError();
  if (err != cudaSuccess || !prologue) return static_cast<int>(err);
  return static_cast<int>(conv3x3::launch_reduce_rows(ge.part, static_cast<float*>(red), 1,
                                                      per_slice, 2LL * cin, s));
}
