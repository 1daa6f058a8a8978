// K5 in float32 on Hopper: the weight and bias gradients of the fused 3x3
// conv (K4), NCHW, on wgmma in 3xTF32 fed by TMA, for sm_90a. It runs
// every float32 shape that ops/conv_bwd.wgrad_f32_plan takes (Cin a
// multiple of 16, W of 4, 16-byte aligned tensors); the stem (Cin = 1) and
// the shapes off the plan keep wgrad3x3.cu's mma.sync kernel, which stays
// callable for comparisons (conv_bwd.wgrad3x3_mma_sync).
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_conv_bwd.py
// `wgrad3x3_pallas_raw` (`_wgrad_kernel`), as wgrad3x3.cu does.
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
// What bounds it: a GEMM of M = 9 Cin (tap, input channel), N = Cout and
// depth K = B H W pixels (3.3 M at batch 32, 320x320), run in 3xTF32 on the
// tensor cores: 165 TFLOP/s of float32-accurate products on an H100 SXM.
// A direct conv's 9 multiply-adds per (pixel, channel pair) at that rate
// are this design's floor: 1.464 ms for each level of the batch-32 320x320
// UNet but the 20x20 one (0.366). The mma.sync kernel it replaces ran at a
// quarter of that rate on Ampere's instructions; a wgmma at full rate reads
// B from shared memory at 64 bytes a cycle, half the SM's bandwidth, so
// the design keeps every other shared-memory stream small.
//
// Design. A block owns M = 256 rows of (tap, input channel) x N = 64
// output channels and a slice of K (split K).
// - The roles. Warpgroup 0 is the producer (setmaxnreg 40): one thread of
//   warp 0 keeps TMA loads in flight through a ring of stages (full /
//   ready / empty mbarriers), warps 1-2 split g into its tf32 hi and lo
//   halves and sum db, warp 3 idles (setmaxnreg takes whole warpgroups).
//   Warpgroups 1-2 are the consumers (setmaxnreg 232), two m64 x n64
//   instances each.
// - K runs over chunks: one image row of a strip of TW columns (TW a
//   multiple of 8), walked down the strip, so that a chunk brings one new
//   row of the activation and reuses the two above it. A stage holds the
//   chunk's g and the activation row below it; a chunk's products read the
//   activation rows of the two stages before its own. A strip's first
//   chunk in the slice is preceded by two warm-ups that bring the rows
//   y - 1 and y alone. A consumer releases a stage once the products that
//   read it are done: after each drain of its partial (below), every event
//   up to e - 2. Drains come every stages - 4 chunks, so at a wait every
//   event up to e - stages + 2 is released and the producer runs two
//   events ahead.
// - B = g (K x N), K-major, as tf32 needs: one TMA box of 4 pixels x 64
//   output channels ([co][4], 1 KB) per 4 columns of the row lands as a
//   column of core matrices of wgmma's K-major no-swizzle layout (SBO =
//   128 bytes between 8-channel groups, LBO = 1 KB between 4-pixel
//   boxes). 3xTF32 needs B's hi and lo in shared memory: the split warps
//   round hi in place (tc::split, as cvt.rna.tf32.f32 rounds) and write lo
//   beside it, then fence.proxy.async before the consumers' wgmma read them.
// - A = the shifted activation (M x K): an m64 instance's warp owns 16 rows,
//   one tap of 16 channels; the rows of a block are (16-channel group,
//   tap) pairs in that order, so that a block reads at most 3 groups (48
//   channels) of the activation. The activation lands by TMA as rows of
//   16 channels x HC = TW + 12 columns from x0 - 4 (a box must start on 16
//   bytes in its inner dimension: from x0 - 1 the launch faulted with an
//   illegal instruction on the card; 0 outside the image); a
//   tap shifts A by single pixels, off wgmma's shared-memory layouts, so
//   each lane loads its fragment of mma.m16n8k8's A layout at the tap's
//   offset (HC = 4 mod 8: the 8 channels x 4 pixels of a load hit 32
//   banks), applies the prologue to the in-image elements, splits it in
//   registers (tc::split) and feeds wgmma.m64n64k8 with A from registers,
//   as K3's float32 core does. (The prologue applied in place in shared
//   memory by the producer's warps made them the bottleneck on the card.)
// - The products: per k-step of 8 pixels a consumer issues lo*hi, then
//   hi*lo, then hi*hi over both of its instances into a partial; every
//   stages - 4 chunks (and before a strip's warm-ups) the partial is added
//   to the sums in float32 once its products are done (the tensor core's
//   own accumulation drops low bits: K3's finding), the two warpgroups half
//   a period apart, so that one keeps the tensor cores busy while the other
//   drains. A registers of k-steps t and t + 1 are double-buffered.
// - Split K: each slice of chunks writes its partial dW (and, in the
//   blocks of the first M tile, db) and conv3x3::reduce_rows sums them
//   over the slices in a fixed order: no float atomics, the same bits on
//   every run.
// - Why the stem and odd shapes keep wgrad3x3.cu: at Cin = 1 a block's 256
//   rows would hold 9 useful ones; a W that is not a multiple of 4 breaks
//   TMA's 16-byte row strides, and a Cin off the 16-channel groups the
//   row layout.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "conv3x3_tc.cuh"
#include "mma_tf32.cuh"
#include "tma.cuh"
#include "wgmma_tf32.cuh"

namespace {

namespace k5f {

using namespace tmak;

constexpr int kThreads = 384;     // the producer warpgroup, then two consumer warpgroups
constexpr int kBn = 64;           // output channels a block (N)
constexpr int kRowGroups = 16;    // (tap, 16 channels) row groups a block (M = 256)
constexpr int kSlots = 3;         // 16-channel groups of the activation a block may read
constexpr int kBoxBytes = kBn * 16;  // one TMA box of g: [co][4 pixels] float32
constexpr int kSplitThreads = kBn;   // warps 1-2, thread t: output channel t
constexpr int kConsumerWarps = 8;

struct Geo {
  float* part;          // [slice][co][c][tap]
  float* part_b;        // [slice][co]
  const float* scale;   // (cin), read with the prologue
  const float* shift;
  int cin, cout, h, w;
  int tw, hc, stages, gbytes, stage_bytes;  // gbytes: g's hi (or lo) of a chunk
  int nxs, ncg, mtiles, ntiles;
  int period;  // chunks between a consumer's drains: stages - 4
  int64_t chunks, per_slice;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int g_bytes(int tw) { return tw / 4 * kBoxBytes; }
// bytes of one 16-channel row of the activation
__host__ __device__ constexpr int row_bytes(int hc) { return 16 * hc * 4; }
__host__ __device__ constexpr int stage_bytes(int tw) {
  return round_up(2 * g_bytes(tw) + kSlots * row_bytes(tw + 12), 1024);
}

// The events of a slice of chunks [k0, k1), in order, as every role walks
// them: chunk k is image b, the strip of columns x0 .. x0 + tw - 1, row y
// (strips walked row by row); its events are v = 0 and 1, the warm-ups
// that bring the activation rows y - 1 and y where the chunk starts a run
// (the slice's first chunk, or row 0), and v = 2, the chunk (g's row y and
// the activation row y + 1). Event e is in stage s (s1, s2: the stages of
// e - 1 and e - 2) at use parity ph. Counters, not divisions: the roles'
// scalar work per event held the consumers back on the card.
struct Walk {
  int64_t k, k1;
  int e, b, xs, x0, y, v, s, s1, s2, ph;
  __device__ __forceinline__ Walk(const Geo& g, int64_t k0, int64_t k_end)
      : k(k0), k1(k_end), e(0), v(0), s(0), s1(0), s2(0), ph(0) {
    const int64_t per_img = static_cast<int64_t>(g.nxs) * g.h;
    b = static_cast<int>(k0 / per_img);
    const int r = static_cast<int>(k0 - b * per_img);
    xs = r / g.h;
    y = r - xs * g.h;
    x0 = xs * g.tw;
  }
  __device__ __forceinline__ bool live() const { return k < k1; }
  // the chunk after this one starts a run (or there is none)
  __device__ __forceinline__ bool run_ends(const Geo& g) const {
    return k + 1 == k1 || y + 1 == g.h;
  }
  __device__ __forceinline__ void next(const Geo& g) {
    ++e;
    s2 = s1;
    s1 = s;
    if (++s == g.stages) {
      s = 0;
      ph ^= 1;
    }
    if (v < 2) {
      ++v;
      return;
    }
    ++k;
    if (++y == g.h) {
      y = 0;
      if (++xs == g.nxs) {
        xs = 0;
        ++b;
      }
      x0 = xs * g.tw;
    }
    v = y == 0 ? 0 : 2;
  }
};

// Warp 0, one thread: the TMA loads of every event into the ring.
__device__ __forceinline__ void produce(const CUtensorMap* xmap, const CUtensorMap* gmap,
                                       const Geo& g, unsigned char* smem, uint64_t* full,
                                       uint64_t* empty, int64_t k0, int64_t k1, int co0, int cg0,
                                       int nslots) {
  const int rb = row_bytes(g.hc);
  for (Walk w(g, k0, k1); w.live(); w.next(g)) {
    if (w.e >= g.stages) mbar_wait(empty + w.s, w.ph ^ 1);
    unsigned char* st = smem + w.s * g.stage_bytes;
    mbar_expect_tx(full + w.s, (w.v == 2 ? g.gbytes : 0) + nslots * rb);
    if (w.v == 2)
      for (int j = 0; j < g.tw / 4; ++j)
        tma_load_4d(st + j * kBoxBytes, gmap, w.x0 + 4 * j, w.y, co0, w.b, full + w.s);
    for (int j = 0; j < nslots; ++j)
      tma_load_4d(st + 2 * g.gbytes + j * rb, xmap, w.x0 - 4, w.y - 1 + w.v, (cg0 + j) * 16,
                  w.b, full + w.s);
  }
}

// Warps 1-2 (t = 0 .. 63): per chunk, split its g into hi (in place) and
// lo, thread t the output channel co0 + t, and sum db in a fixed order
// (four running sums, one per pixel of a box, added in order at the end).
__device__ __forceinline__ void split_g(const Geo& g, unsigned char* smem, uint64_t* full,
                                       uint64_t* ready, int64_t k0, int64_t k1, int64_t slice,
                                       int co0, bool with_db, int t) {
  float4 db = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (Walk w(g, k0, k1); w.live(); w.next(g)) {
    mbar_wait(full + w.s, w.ph);
    unsigned char* st = smem + w.s * g.stage_bytes;
    if (w.v == 2) {
#pragma unroll 2
      for (int j = 0; j < g.tw / 4; ++j) {
        float4* p = reinterpret_cast<float4*>(st + j * kBoxBytes + 16 * t);
        const float4 u = *p;
        if (with_db) {
          db.x += u.x;
          db.y += u.y;
          db.z += u.z;
          db.w += u.w;
        }
        const tc::Split a = tc::split(u.x), b = tc::split(u.y), cc = tc::split(u.z),
                        d = tc::split(u.w);
        *p = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi), __uint_as_float(cc.hi),
                         __uint_as_float(d.hi));
        *reinterpret_cast<float4*>(st + g.gbytes + j * kBoxBytes + 16 * t) =
            make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo), __uint_as_float(cc.lo),
                        __uint_as_float(d.lo));
      }
      tc::fence_proxy_async();  // hi and lo, for the consumers' wgmma
    }
    mbar_arrive_if(ready + w.s, true);
  }
  if (with_db && co0 + t < g.cout)
    g.part_b[slice * g.cout + co0 + t] = ((db.x + db.y) + db.z) + db.w;
}

// A consumer's prologue: per instance, the scale and shift of its two
// channels, whether the chunk's activation row is in the image, and the
// image column of its first pixel at k-step 0 less the strip's x0.
struct Prologue {
  float sc[2][2], sh[2][2];
  bool row_in[2];
  int xoff[2];
  int x0, w;
};

// One k-step of 8 pixels of a consumer: A of both instances loaded at the
// k-step's pixels into buffer kBuf (with the prologue applied to the
// in-image elements) and split, then the three TF32 products of each into
// its partial (the first overwrites it where add == 0).
template <int kBuf, bool kPrologue>
__device__ __forceinline__ void k_step(int ks, int add, const unsigned char* const* arow, int rs,
                                       const unsigned char* gh, const unsigned char* gl,
                                       const Prologue& pr, uint32_t (&ah)[2][2][4],
                                       uint32_t (&al)[2][2][4], float (&pt)[2][kBn / 2]) {
  tc::wgmma_wait<1>();  // the products of the k-step before last, which read buffer kBuf
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      tc::keep(ah[kBuf][i][r]);
      tc::keep(al[kBuf][i][r]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // (channel gid, pixel tig), (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4)
    const float* ap = reinterpret_cast<const float*>(arow[i] + 32 * ks);
    float v[4] = {ap[0], ap[rs], ap[4], ap[rs + 4]};
    if (kPrologue) {
      // pixels tig and tig + 4 of the k-step; outside the image the frame stays 0
      const int x = pr.x0 + 8 * ks + pr.xoff[i];
      const bool in0 = pr.row_in[i] && static_cast<unsigned>(x) < static_cast<unsigned>(pr.w);
      const bool in1 = pr.row_in[i] && static_cast<unsigned>(x + 4) < static_cast<unsigned>(pr.w);
      v[0] = in0 ? conv3x3::affine_relu(v[0], pr.sc[i][0], pr.sh[i][0]) : v[0];
      v[1] = in0 ? conv3x3::affine_relu(v[1], pr.sc[i][1], pr.sh[i][1]) : v[1];
      v[2] = in1 ? conv3x3::affine_relu(v[2], pr.sc[i][0], pr.sh[i][0]) : v[2];
      v[3] = in1 ? conv3x3::affine_relu(v[3], pr.sc[i][1], pr.sh[i][1]) : v[3];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const tc::Split sp = tc::split(v[r]);
      ah[kBuf][i][r] = sp.hi;
      al[kBuf][i][r] = sp.lo;
    }
  }
  tc::wgmma_fence();
  const uint64_t dh = tc::wgmma_desc(gh + 2 * kBoxBytes * ks, kBoxBytes, 128);
  const uint64_t dl = tc::wgmma_desc(gl + 2 * kBoxBytes * ks, kBoxBytes, 128);
  // 3xTF32, the small terms first; the chunk's first product overwrites
#pragma unroll
  for (int i = 0; i < 2; ++i) tc::WgmmaTf32<kBn>::run(pt[i], al[kBuf][i], dh, add);
#pragma unroll
  for (int i = 0; i < 2; ++i) tc::WgmmaTf32<kBn>::run(pt[i], ah[kBuf][i], dl, 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) tc::WgmmaTf32<kBn>::run(pt[i], ah[kBuf][i], dh, 1);
  tc::wgmma_commit();
}

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad3x3_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap gmap, Geo g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.stages * g.stage_bytes);
  uint64_t* ready = full + g.stages;
  uint64_t* empty = ready + g.stages;
  const int nt = blockIdx.x % g.ntiles;
  const int mt = (blockIdx.x / g.ntiles) % g.mtiles;
  const int64_t slice = blockIdx.x / (g.ntiles * g.mtiles);
  const int64_t k0 = slice * g.per_slice;
  const int64_t k1 = k0 + g.per_slice < g.chunks ? k0 + g.per_slice : g.chunks;
  const int co0 = nt * kBn;
  // the 16-channel groups of this M tile's row groups 16 mt .. 16 mt + 15
  const int cg0 = kRowGroups * mt / 9;
  const int cg_end = (kRowGroups * mt + kRowGroups - 1) / 9;
  const int nslots = (cg_end < g.ncg - 1 ? cg_end : g.ncg - 1) - cg0 + 1;
  // the warp index broadcast from lane 0, so that ptxas sees the role
  // branches as warp-uniform
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, kSplitThreads);
      mbar_init(empty + s, kConsumerWarps);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();  // the only block-wide barrier

  if (warp < 4) {
    setmaxnreg_producer();
    if (warp == 0) {
      if (lane == 0) produce(&xmap, &gmap, g, smem, full, empty, k0, k1, co0, cg0, nslots);
      return;
    }
    if (warp < 3)
      split_g(g, smem, full, ready, k0, k1, slice, co0, mt == 0, static_cast<int>(threadIdx.x) - 32);
    return;
  }
  setmaxnreg_consumer();

  const int cw = warp - 4, wg = cw >> 2, wq = cw & 3;
  const int gid = lane >> 2, tig = lane & 3;
  const int rs = 8 * g.hc;  // floats from channel gid to gid + 8
  // the lane's two instances: row group q = (16-channel group, tap)
  int off[2], dh[2], cbase[2], tap[2];
  bool ok[2];
  Prologue pr;
  pr.w = g.w;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = kRowGroups * mt + (2 * wg + i) * 4 + wq;
    ok[i] = q < 9 * g.ncg;
    const int cg = ok[i] ? q / 9 : cg0;
    tap[i] = ok[i] ? q % 9 : 0;
    dh[i] = tap[i] / 3;
    cbase[i] = cg * 16 + gid;
    off[i] = 2 * g.gbytes + (cg - cg0) * row_bytes(g.hc) + gid * 4 * g.hc +
             (tap[i] % 3 + 3 + tig) * 4;
    pr.xoff[i] = tig + tap[i] % 3 - 1;
    if (kPrologue)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        pr.sc[i][u] = g.scale[cbase[i] + 8 * u];
        pr.sh[i][u] = g.shift[cbase[i] + 8 * u];
      }
  }
  float acc[2][kBn / 2], pt[2][kBn / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < kBn / 2; ++r) acc[i][r] = pt[i][r] = 0.0f;
  uint32_t ah[2][2][4] = {}, al[2][2][4] = {};
  const int nks = g.tw / 8;
  // The partial is drained into the sums every second chunk, the two
  // warpgroups a chunk apart (one keeps the tensor cores busy while the
  // other drains), and before warm-ups and at the end; a stage is
  // released once its last reader's products are done: after a drain,
  // every event up to e - 2 (a chunk reads the activation rows of the two
  // events before it).
  // chunks until the next drain (the second warpgroup's first run is half
  // a period shorter, so that the two drain apart), k-steps
  const int left0 = g.period - wg * (g.period / 2);
  int left = left0, kk = 0;
  int rel = 0, rel_s = 0;   // the next event to release, its stage
  bool pending = false;     // products not yet drained
  for (Walk w(g, k0, k1); w.live(); w.next(g)) {
    mbar_wait(ready + w.s, w.ph);
    if (w.v == 2) {
      const unsigned char* gh = smem + w.s * g.stage_bytes;
      // the activation row y - 1 + dh: in the stage of event e - 2 + dh
      const unsigned char* arow[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        arow[i] = smem + (dh[i] == 0 ? w.s2 : dh[i] == 1 ? w.s1 : w.s) * g.stage_bytes + off[i];
        pr.row_in[i] = static_cast<unsigned>(w.y - 1 + dh[i]) < static_cast<unsigned>(g.h);
      }
      pr.x0 = w.x0;
      // buffers alternate over the k-steps of every chunk
      int ks = 0;
      if (kk & 1) {
        k_step<1, kPrologue>(0, pending, arow, rs, gh, gh + g.gbytes, pr, ah, al, pt);
        ks = 1;
      }
#pragma unroll 1
      for (; ks < nks; ks += 2) {
        k_step<0, kPrologue>(ks, ks > 0 || pending, arow, rs, gh, gh + g.gbytes, pr, ah, al, pt);
        if (ks + 1 < nks)
          k_step<1, kPrologue>(ks + 1, 1, arow, rs, gh, gh + g.gbytes, pr, ah, al, pt);
      }
      kk += nks;
      pending = true;
      const bool run_ends = w.run_ends(g);
      if (--left == 0 || run_ends) {
        tc::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
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
        pending = false;
        left = run_ends ? left0 : g.period;
      }
    }
    if (!pending)
      for (; rel <= w.e - 2; ++rel) {
        mbar_arrive_if(empty + rel_s, lane == 0);
        rel_s = rel_s + 1 == g.stages ? 0 : rel_s + 1;
      }
  }

  // part[slice][co][c][tap]; the accumulator layout: rows (c) gid (+ 8),
  // columns (co) 8 j + 2 tig + (r & 1) at [4 j + r]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!ok[i]) continue;
#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int co = co0 + 8 * j + 2 * tig + (r & 1);
        const int ch = cbase[i] + 8 * (r >> 1);
        if (co < g.cout)
          g.part[((slice * g.cout + co) * g.cin + ch) * 9 + tap[i]] = acc[i][4 * j + r];
      }
  }
}

}  // namespace k5f

}  // namespace

// K5 in float32 on wgmma with TMA: x (b, cin, h, w) the forward's raw input
// and g (b, cout, h, w), float32, contiguous, 16-byte aligned; scale, shift
// (cin) read when prologue != 0; part: slices * (cout * cin * 9 + cout)
// floats; dw (cout, cin, 3, 3) and db (cout) float32. The plan
// (ops/conv_bwd.wgrad_f32_plan): cin a multiple of 16, w of 4; chunks of
// tw columns (a multiple of 8, at most 244), a ring of `stages` (at least 5), slices of
// per_slice chunks. Returns a cudaError_t value.
extern "C" int im2im_wgrad3x3_tma(const void* x, const void* g, const void* scale,
                                  const void* shift, void* part, void* dw, void* db, int b,
                                  int cin, int cout, int h, int w, int prologue, int tw,
                                  int stages, long long per_slice, int slices, int device,
                                  void* stream) {
  using namespace k5f;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || cin <= 0 || cin % 16 != 0 || cout <= 0 || h <= 0 || w <= 0 || w % 4 != 0 ||
      tw < 8 || tw % 8 != 0 || tw + 12 > 256 || stages < 5 || per_slice <= 0 || slices <= 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo ge{};
  ge.cin = cin;
  ge.cout = cout;
  ge.h = h;
  ge.w = w;
  ge.tw = tw;
  ge.hc = tw + 12;
  ge.stages = stages;
  ge.gbytes = g_bytes(tw);
  ge.stage_bytes = stage_bytes(tw);
  ge.nxs = (w + tw - 1) / tw;
  ge.ncg = cin / 16;
  ge.mtiles = (9 * ge.ncg + kRowGroups - 1) / kRowGroups;
  ge.ntiles = (cout + kBn - 1) / kBn;
  ge.period = stages - 4;
  ge.chunks = static_cast<int64_t>(b) * ge.nxs * h;
  ge.per_slice = per_slice;
  ge.scale = static_cast<const float*>(scale);
  ge.shift = static_cast<const float*>(shift);
  ge.part = static_cast<float*>(part);
  ge.part_b = ge.part + static_cast<int64_t>(slices) * cout * cin * 9;
  const int64_t blocks = static_cast<int64_t>(slices) * ge.mtiles * ge.ntiles;
  const int64_t bytes = static_cast<int64_t>(stages) * ge.stage_bytes + 3LL * stages * 8;
  if (per_slice * (slices - 1) >= ge.chunks || blocks > 0x7fffffff || bytes > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  CUtensorMap xmap, gmap;
  err = tmak::nchw_map(&xmap, x, b, cin, h, w, ge.hc, 1, 16, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == cudaSuccess)
    err = tmak::nchw_map(&gmap, g, b, cout, h, w, 4, 1, kBn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = prologue ? wgrad3x3_tma_kernel<true> : wgrad3x3_tma_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<int>(bytes), s>>>(xmap, gmap, ge);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = conv3x3::launch_reduce_rows(ge.part, static_cast<float*>(dw), 1, slices,
                                    static_cast<int64_t>(cout) * cin * 9, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      conv3x3::launch_reduce_rows(ge.part_b, static_cast<float*>(db), 1, slices, cout, s));
}
