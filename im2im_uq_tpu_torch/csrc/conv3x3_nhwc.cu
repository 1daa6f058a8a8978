// P2-P5: the 3x3 same-padding convolution without bias, NHWC input, HWIO
// kernel, float32 or bfloat16, for sm_90a, on the tensor cores, by three
// kernels (ops/conv_probe.uses_tma and tma_plan choose, before the launch):
//   the TMA path in bfloat16 (namespace tma, below): Cin and Cout
//     multiples of 8 (TMA's 16-byte strides) where the weights of one slice
//     of output channels fit a block: one persistent wgmma kernel that all
//     four wrappers share;
//   the TMA path in float32 (namespace tma, below): Cin and Cout multiples
//     of 4, one persistent wgmma kernel in 3xTF32 that all four share, its
//     weights streamed through the ring chunk by chunk;
//   the cp.async path: every other shape (Cin or Cout off those multiples,
//     bfloat16 weights too large for a block, unaligned tensors), one
//     implicit GEMM on mma.sync with four launch configurations.
//
// Replaces the TPU kernels of benchmarks/bench_pallas_conv.py (the probes of
// a hand-written conv against XLA's):
//   P2 `conv3x3_pallas` (single-buffered row tiles)   -> kSingle
//   P3 `conv3x3_pallas_db` (double-buffered)          -> kDouble
//   P4 `conv3x3_pallas_l1` (Cin not a multiple of 128) -> kTail
//   P5 `conv3x3_pallas_c64` (Cin = 64)                -> kC64
//
// What it computes: y[b, i, j, n] = sum over (dh, dw, k) of
//   x[b, i + dh - 1, j + dw - 1, k] * w[dh, dw, k, n]   (0 outside the image)
// with float32 accumulation, y in x's dtype (bfloat16 rounded once, to
// nearest even, as the probes' `.astype` does). The GEMM: M = output
// pixels, N = Cout, K = 9 Cin.
//
// What bounds it, at the probes' default (32, 320, 320, 64 -> 64): bytes.
// x, y and w each moved once take 0.25 ms in bfloat16 and 0.50 ms in
// float32 at 3.35 TB/s; the 13.4 GMAC of one multiply-add per output and
// channel pair (the Winograd count) take 0.027 ms at 989 TFLOP/s dense
// bfloat16 and 0.163 ms at 165 TFLOP/s of 3xTF32 (TF32's 495 over its
// three passes). A direct conv does nine times that, 120.8 GMAC: 0.245 ms
// in bfloat16, as long as the bytes, and 1.464 ms in 3xTF32, the floor of
// any direct float32 design on the tensor cores.
//
// The cp.async path. A block owns a tile of 8 x 16 output pixels (one m16
// fragment per tile row) x 64 output channels and walks K in chunks of kKc channels
// (64 bytes of a pixel: 32 bfloat16 or 16 float32; 128 bytes in kC64) x 9
// taps. In NHWC a tap moves an operand by whole pixels, that is by Cin
// contiguous channels, so every tap's A rows stay 16-byte aligned (K3's
// NCHW taps move by one element): the chunk's haloed tile, 10 x 18 pixels
// of kKc channels, is copied once with cp.async (the frame outside the
// image zero-filled through the source-size-0 form) and each tap reads its
// A fragments from it with ldmatrix at the tap's pixel offset. Each staged
// pixel is padded by 16 bytes and each weight row by 8 elements, so the 8
// rows of an ldmatrix fall in 8 distinct 16-byte bank groups. The weights
// of a chunk sit in shared memory as [tap][k][n] (HWIO's own order, so the
// copies are contiguous runs of Cout).
//   bfloat16: mma.sync.m16n8k16, bf16 x bf16 -> f32; B through
//     ldmatrix.trans. The products are exact in float32.
//   float32: mma.sync.m16n8k8 in 3xTF32 (mma_tf32.cuh's split; lo*hi, hi*lo,
//     hi*hi) into a fresh partial per chunk that is then added in float32,
//     as K3 does: float32-accurate.
// 8 warps: 4 along M (two tile rows each) x 2 along N (32 channels each).
// A block takes a contiguous run of tiles of one 64-channel slice of N and
// walks (tile, chunk) pairs in order; the instances differ in how:
//   kSingle (P2): one stage: copy, wait, compute, pair after pair;
//   kDouble (P3): a two-stage cp.async ring: the next pair (next chunk, or
//     the next tile's first chunk) is in flight while this one computes;
//   kTail (P4): kDouble, plus a channel tail: any Cin, the chunk's channels
//     past Cin zero-filled in both operands, k-steps wholly past it skipped;
//   kC64 (P5): Cin = 64; a chunk is 128 bytes a pixel (the whole Cin in
//     bfloat16, half of it in float32); the block's 9 x 64 x 64 weights stay
//     resident in shared memory (81 KB in bfloat16 with the padding) and only
//     the activations pass through the two-stage ring.
// Rows and columns of a tile past the image are predicated (read as the
// zero frame, never stored): any H, W >= 1. A Cin or Cout whose pixel or
// weight row is not a whole number of 16-byte vectors is copied element by
// element (plain loads and stores) instead of by cp.async.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"
#include "tma.cuh"
#include "wgmma_bf16.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kTh = 8, kTw = 16;                 // output tile
constexpr int kHr = kTh + 2, kHc = kTw + 2;      // haloed tile
constexpr int kHalo = kHr * kHc;                 // 180 pixels
constexpr int kBn = 64;                          // output channels a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWaves = 2;                        // blocks per resident slot

enum Variant { kSingle = 0, kDouble = 1, kTail = 2, kC64 = 3 };

// Shapes of one instance for element type T.
template <typename T, int kVariant>
struct Cfg {
  static constexpr int kSz = static_cast<int>(sizeof(T));
  static constexpr int kChunkBytes = kVariant == kC64 ? 128 : 64;
  static constexpr int kKc = kChunkBytes / kSz;           // channels a chunk
  static constexpr int kStepCh = 32 / kSz;                // channels a k-step
  static constexpr int kSteps = kKc / kStepCh;
  static constexpr int kStages = kVariant == kSingle ? 1 : 2;
  static constexpr bool kResident = kVariant == kC64;
  static constexpr bool kHasTail = kVariant == kTail;
  static constexpr int kXs = kChunkBytes + 16;            // bytes a staged pixel
  static constexpr int kWrow = kBn + 8;                   // elements a weight row
  static constexpr int kXBytes = kHalo * kXs;
  static constexpr int kWBytes = 9 * kKc * kWrow * kSz;   // one chunk's weights
  static constexpr int kStageBytes = kXBytes + (kResident ? 0 : kWBytes);
  static int smem_bytes(int nch) {
    return kStages * kStageBytes + (kResident ? nch * kWBytes : 0);
  }
};

struct Geo {
  const char* x;  // (b, h, w, cin)
  const char* w;  // (3, 3, cin, cout)
  char* y;        // (b, h, w, cout)
  int b, h, w_, cin, cout;
  int tiles_y, tiles_x, tiles, per, nch;
  int vec_x, vec_w;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b, m16n8k16, bfloat16 operands, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// This block's tile t: image, first output row and column.
struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int t) {
  const int per_img = g.tiles_y * g.tiles_x;
  const int b = t / per_img, r = t - b * per_img;
  return {b, (r / g.tiles_x) * kTh, (r % g.tiles_x) * kTw};
}

// Start the copies of chunk `chunk` of tile `tl` into the stage at `xs`: the
// haloed pixels' kKc channels, 0 outside the image and past Cin.
template <typename T, int kVariant>
__device__ __forceinline__ void stage_x(const Geo& g, const Tile& tl, int chunk, char* xs) {
  using C = Cfg<T, kVariant>;
  const int k0 = chunk * C::kKc;
  if (g.vec_x) {
    constexpr int kG = C::kChunkBytes / 16;  // 16-byte groups a pixel
    constexpr int kPer = 16 / C::kSz;
    for (int e = threadIdx.x; e < kHalo * kG; e += kThreads) {
      const int hp = e / kG, q = e - hp * kG;
      const int yy = tl.y0 - 1 + hp / kHc, xx = tl.x0 - 1 + hp % kHc;
      const int k = k0 + q * kPer;
      const bool ok = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w_ && k < g.cin;
      const int64_t off =
          ok ? ((static_cast<int64_t>(tl.b) * g.h + yy) * g.w_ + xx) * g.cin + k : 0;
      cp_async16(xs + hp * C::kXs + q * 16, g.x + off * C::kSz, ok);
    }
  } else {
    const T* x = reinterpret_cast<const T*>(g.x);
    for (int e = threadIdx.x; e < kHalo * C::kKc; e += kThreads) {
      const int hp = e / C::kKc, kl = e - hp * C::kKc;
      const int yy = tl.y0 - 1 + hp / kHc, xx = tl.x0 - 1 + hp % kHc;
      const int k = k0 + kl;
      const bool ok = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w_ && k < g.cin;
      T v = zero_of<T>();
      if (ok) v = x[((static_cast<int64_t>(tl.b) * g.h + yy) * g.w_ + xx) * g.cin + k];
      reinterpret_cast<T*>(xs + hp * C::kXs)[kl] = v;
    }
  }
}

// Start the copies of chunk `chunk`'s weights for output channels n0 ..
// n0 + 63 into `ws` as [tap][k][n], 0 past Cin and Cout.
template <typename T, int kVariant>
__device__ __forceinline__ void stage_w(const Geo& g, int n0, int chunk, char* ws) {
  using C = Cfg<T, kVariant>;
  const int k0 = chunk * C::kKc;
  if (g.vec_w) {
    constexpr int kPer = 16 / C::kSz;
    constexpr int kG = kBn / kPer;  // 16-byte groups a row
    for (int e = threadIdx.x; e < 9 * C::kKc * kG; e += kThreads) {
      const int row = e / kG, q = e - row * kG;
      const int t = row / C::kKc, kl = row - t * C::kKc;
      const int k = k0 + kl, n = n0 + q * kPer;
      const bool ok = k < g.cin && n < g.cout;
      const int64_t off = ok ? (static_cast<int64_t>(t) * g.cin + k) * g.cout + n : 0;
      cp_async16(ws + (row * C::kWrow + q * kPer) * C::kSz, g.w + off * C::kSz, ok);
    }
  } else {
    const T* w = reinterpret_cast<const T*>(g.w);
    for (int e = threadIdx.x; e < 9 * C::kKc * kBn; e += kThreads) {
      const int row = e / kBn, nl = e - row * kBn;
      const int t = row / C::kKc, kl = row - t * C::kKc;
      const int k = k0 + kl, n = n0 + nl;
      T v = zero_of<T>();
      if (k < g.cin && n < g.cout) v = w[(static_cast<int64_t>(t) * g.cin + k) * g.cout + n];
      reinterpret_cast<T*>(ws)[row * C::kWrow + nl] = v;
    }
  }
}

// acc += this warp's share of chunk `chunk`: A from the staged tile `xs`,
// B from the weights `ws` ([tap][k][n]).
template <typename T, int kVariant>
__device__ __forceinline__ void compute(const Geo& g, int chunk, const char* xs, const char* ws,
                                        float (&acc)[2][4][4]) {
  using C = Cfg<T, kVariant>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  // ldmatrix rows: matrix lane / 8 = (pixels 0-7 | 8-15) x (bytes 0-15 | 16-31)
  const int mrow = (lane & 7) + 8 * ((lane >> 3) & 1), mcol = 16 * (lane >> 4);
  constexpr bool kBf16 = sizeof(T) == 2;
  float pt[2][4][4];  // float32: the chunk's fresh partial
  if constexpr (!kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) pt[i][j][r] = 0.0f;
  }
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {
    const int dh = t / 3, dw = t - 3 * (t / 3);
#pragma unroll
    for (int s = 0; s < C::kSteps; ++s) {
      if (C::kHasTail && chunk * C::kKc + s * C::kStepCh >= g.cin) break;
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 2 * wm + i + dh;  // halo row of this tile row and tap
        ldmatrix_x4(a[i], xs + (row * kHc + mrow + dw) * C::kXs + s * 32 + mcol);
      }
      if constexpr (kBf16) {
        // B (k16 x n8) fragments of the warp's four n8 tiles, two per ldmatrix
        uint32_t b[4][2];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t r[4];
          const int k = t * C::kKc + s * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
          const int n = 32 * wn + 16 * jp + 8 * (lane >> 4);
          ldmatrix_x4_trans(r, ws + (k * C::kWrow + n) * C::kSz);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      } else {
        tc::Split sa[2][4], sb[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) sa[i][q] = tc::split(__uint_as_float(a[i][q]));
        const float* wf = reinterpret_cast<const float*>(ws);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = t * C::kKc + s * 8 + tig + 4 * u;
            sb[j][u] = tc::split(wf[k * C::kWrow + 32 * wn + 8 * j + gid]);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tc::mma(pt[i][j], sa[i][0].lo, sa[i][1].lo, sa[i][2].lo, sa[i][3].lo, sb[j][0].hi,
                    sb[j][1].hi);
            tc::mma(pt[i][j], sa[i][0].hi, sa[i][1].hi, sa[i][2].hi, sa[i][3].hi, sb[j][0].lo,
                    sb[j][1].lo);
            tc::mma(pt[i][j], sa[i][0].hi, sa[i][1].hi, sa[i][2].hi, sa[i][3].hi, sb[j][0].hi,
                    sb[j][1].hi);
          }
      }
    }
  }
  if constexpr (!kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += pt[i][j][r];
  }
}

// Store the warp's fragments of tile `tl` (rows and columns past the image,
// channels past Cout dropped) and zero them.
template <typename T>
__device__ __forceinline__ void epilogue(const Geo& g, const Tile& tl, int n0,
                                         float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  T* y = reinterpret_cast<T*>(g.y);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int yy = tl.y0 + 2 * wm + i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int xx = tl.x0 + gid + 8 * (r >> 1);
        const int n = n0 + 32 * wn + 8 * j + 2 * tig + (r & 1);
        if (yy < g.h && xx < g.w_ && n < g.cout)
          store(y + ((static_cast<int64_t>(tl.b) * g.h + yy) * g.w_ + xx) * g.cout + n,
                acc[i][j][r]);
        acc[i][j][r] = 0.0f;
      }
  }
}

template <typename T, int kVariant>
__global__ void __launch_bounds__(kThreads) conv3x3_nhwc_kernel(Geo g) {
  using C = Cfg<T, kVariant>;
  extern __shared__ __align__(128) char smem[];
  const int n0 = blockIdx.y * kBn;
  const int first = blockIdx.x * g.per;
  const int last = first + g.per < g.tiles ? first + g.per : g.tiles;
  const int total = (last - first) * g.nch;  // (tile, chunk) pairs
  char* wres = smem + C::kStages * C::kStageBytes;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // pair q into stage `slot`
  auto stage = [&](int q, int slot) {
    char* st = smem + slot * C::kStageBytes;
    const int chunk = q % g.nch;
    stage_x<T, kVariant>(g, tile_at(g, first + q / g.nch), chunk, st);
    if (!C::kResident) stage_w<T, kVariant>(g, n0, chunk, st + C::kXBytes);
  };

  if (C::kResident)
    for (int c = 0; c < g.nch; ++c) stage_w<T, kVariant>(g, n0, c, wres + c * C::kWBytes);
  if (C::kStages == 2) {
    if (total > 0) stage(0, 0);
    tc::cp_async_commit();
  }
  for (int q = 0; q < total; ++q) {
    const int slot = C::kStages == 2 ? (q & 1) : 0;
    if (C::kStages == 1) {
      stage(q, 0);
      tc::cp_async_commit();
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // pair q staged; under kDouble, pair q - 1's stage is free
    if (C::kStages == 2 && q + 1 < total) {
      stage(q + 1, slot ^ 1);
      tc::cp_async_commit();
    }
    const int chunk = q % g.nch;
    const char* st = smem + slot * C::kStageBytes;
    const char* ws = C::kResident ? wres + chunk * C::kWBytes : st + C::kXBytes;
    compute<T, kVariant>(g, chunk, st, ws, acc);
    if (chunk == g.nch - 1) epilogue<T>(g, tile_at(g, first + q / g.nch), n0, acc);
    if (C::kStages == 1) __syncthreads();  // the one stage is free again
  }
  tc::cp_async_wait<0>();
}

template <typename T, int kVariant>
cudaError_t launch(Geo g, int device, cudaStream_t s) {
  using C = Cfg<T, kVariant>;
  g.nch = (g.cin + C::kKc - 1) / C::kKc;
  if (!C::kHasTail && g.cin % C::kKc != 0) return cudaErrorInvalidValue;
  if (kVariant == kC64 && g.cin != 64) return cudaErrorInvalidValue;
  const int bytes = C::smem_bytes(g.nch);
  auto kernel = conv3x3_nhwc_kernel<T, kVariant>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int sms = 0, resident = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  g.tiles_y = (g.h + kTh - 1) / kTh;
  g.tiles_x = (g.w_ + kTw - 1) / kTw;
  const int64_t tiles = static_cast<int64_t>(g.b) * g.tiles_y * g.tiles_x;
  const int ntn = (g.cout + kBn - 1) / kBn;
  if (tiles > 0x7fffffff || ntn > 65535) return cudaErrorInvalidValue;
  g.tiles = static_cast<int>(tiles);
  // tiles a block: the card's resident blocks kWaves times over
  const int64_t slots = static_cast<int64_t>(sms) * resident * kWaves;
  g.per = static_cast<int>((tiles * ntn + slots - 1) / slots);
  const int64_t bx = (tiles + g.per - 1) / g.per;
  kernel<<<dim3(static_cast<unsigned>(bx), ntn), kThreads, bytes, s>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Geo& g, int variant, int device, cudaStream_t s) {
  switch (variant) {
    case kSingle: return launch<T, kSingle>(g, device, s);
    case kDouble: return launch<T, kDouble>(g, device, s);
    case kTail: return launch<T, kTail>(g, device, s);
    case kC64: return launch<T, kC64>(g, device, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 path on wgmma with TMA (Cin % 8 == 0, Cout % 8 == 0, and the
// plan's weights fit a block's shared memory; ops/conv_probe.tma_plan picks
// it and its sizes). P2-P5 share it: on Hopper their distinct staging
// schemes buy nothing over one ring fed by TMA.
//
// A block owns one slice of kBn output channels (blockIdx.x % ntn) and
// keeps all of that slice's weights resident in shared memory, packed by
// pack_weights_kernel into wgmma's K-major no-swizzle layout (core matrices
// of 8 n x 8 k, 16 bytes a row: LBO = 128 bytes between K-adjacent, SBO =
// 256 between N-adjacent ones) and copied once by a bulk copy. It walks
// output tiles of kTh rows x 64 pixels (persistent: tiles first, first +
// step, ...), and for each tile the K chunks of `groups` x 8 channels.
// A chunk's haloed activations, (kTh + 2) rows x 66 pixels, land by TMA
// as one box per group of 8 channels, [group][row][col][8 bf16]: a tensor
// map over x as (Cin, W, H, B) with the box (8, 66, kTh + 2, 1), whose
// coordinates -1 and past the edge (and channels past Cin) are zero-filled.
// In that layout every tap's A for one output row of 64 pixels is the same
// buffer offset by (dh * 66 + dw) * 16 bytes: a K-major no-swizzle A with
// SBO = 128 (8 pixels of 16 bytes) and LBO = the group's plane.
// Warps 0-7 are two consumer warpgroups, each kTh / 2 output rows of m64 x
// kBn (wgmma.m64nNk16, bf16 x bf16 -> f32); warp 8 is the producer, one
// thread that keeps a ring of `stages` chunks in flight (full / empty
// mbarriers). A consumer releases a stage once the products that read it
// are done (wgmma.wait_group 1 after the next chunk's are issued). The
// epilogue rounds each float32 sum once to bfloat16 (nearest even), turns
// each quad's pairs of channels into 8 channels a lane by shuffles, and
// stores them 16 bytes a lane from the registers (bn = 16: pairs, 4 bytes);
// the next tile's copies are already in flight.
namespace tma {

using namespace tmak;

constexpr int kTw = 64;                          // output pixels of a tile row
constexpr int kHc = kTw + 2;                     // haloed columns
constexpr int kConsumers = 2;                    // warpgroups
constexpr int kThreads = 128 * kConsumers + 32;  // and the producer warp
constexpr int kPiece = 32768;                    // bytes per bulk copy of weights

__host__ __device__ constexpr int rows_for(int bn) { return bn <= 64 ? 8 : 4; }
// bytes of one group's box, and its stride in a stage (128-byte aligned)
__host__ __device__ constexpr int box_bytes(int th) { return (th + 2) * kHc * 16; }
__host__ __device__ constexpr int plane_bytes(int th) { return (box_bytes(th) + 127) / 128 * 128; }

template <typename T>
struct Geo {
  T* y;
  int b, h, w, cin, cout;
  int groups, stages, nch, ntn;  // 8-channel groups a chunk, ring stages, chunks, N slices
  int tiles_y, tiles_x, tiles;
  int plane, abytes, wchunk, wbytes;  // bytes: a group, a stage, a weight chunk, a slice
};

// *p = v where `on`, predicated inside the instruction
__device__ __forceinline__ void store_if(void* p, uint32_t v, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.b32 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"(static_cast<int>(on))
      : "memory");
}

// 16 bytes at p (16-byte aligned) where `on`
__device__ __forceinline__ void store16_if(void* p, const uint32_t (&v)[4], bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p st.global.v4.b32 [%0], {%1, %2, %3, %4};\n}\n" ::"l"(p),
      "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]), "r"(static_cast<int>(on))
      : "memory");
}

// The 4 x 4 transpose of 32-bit words across the 4 lanes of a quad (lane
// bits 0-1 = q): on entry lane q holds v[i] = word (i, q), on exit word
// (q, i). Two butterfly stages of 2 x 2 blocks, by shuffles and selects.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool odd = q & 1, high = q & 2;
  uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  v[0] = odd ? x0 : v[0];
  v[1] = odd ? v[1] : x0;
  v[2] = odd ? x1 : v[2];
  v[3] = odd ? v[3] : x1;
  x0 = __shfl_xor_sync(0xffffffffu, high ? v[0] : v[2], 2);
  x1 = __shfl_xor_sync(0xffffffffu, high ? v[1] : v[3], 2);
  v[0] = high ? x0 : v[0];
  v[1] = high ? x1 : v[1];
  v[2] = high ? v[2] : x0;
  v[3] = high ? v[3] : x1;
}

// wpack[slice][chunk][tap][k16 step][n group][k half][8 n][8 k] from HWIO
// w (3, 3, cin, cout), 0 past Cin and Cout: each chunk the shared-memory
// image that the consumers' B descriptors read.
__global__ void pack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                    __nv_bfloat16* __restrict__ out, int cin, int cout, int bn,
                                    int kc, int nch, int64_t total) {
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
    const int ks = static_cast<int>(e % (kc / 16));
    e /= kc / 16;
    const int tap = static_cast<int>(e % 9);
    e /= 9;
    const int c = static_cast<int>(e % nch);
    const int ns = static_cast<int>(e / nch);
    const int k = c * kc + ks * 16 + kh * 8 + k8, n = ns * bn + ng * 8 + n8;
    out[i] = k < cin && n < cout ? w[(static_cast<int64_t>(tap) * cin + k) * cout + n]
                                 : __float2bfloat16_rn(0.0f);
  }
}

template <int kBn>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_tma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __nv_bfloat16* __restrict__ wpack, Geo<__nv_bfloat16> g) {
  constexpr int kTh = rows_for(kBn);
  constexpr int kMi = kTh / kConsumers;  // output rows (m64 instances) a consumer
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* wres = smem;                  // the slice's weights, chunk c at c * wchunk
  unsigned char* astage = smem + g.wbytes;     // the ring: stage s at s * abytes
  uint64_t* full = reinterpret_cast<uint64_t*>(astage + g.stages * g.abytes);
  uint64_t* empty = full + g.stages;
  uint64_t* wfull = empty + g.stages;
  const int ns = blockIdx.x % g.ntn;
  const int first = blockIdx.x / g.ntn, step = gridDim.x / g.ntn;
  // the warp index broadcast from lane 0, so that ptxas sees the role branch
  // below as warp-uniform (else it serializes the consumers' wgmma)
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);  // lane 0 of each consumer warp
    }
    mbar_init(wfull, 1);
    fence_barrier_init();
  }
  __syncthreads();  // the only block-wide barrier: the producer warp leaves below

  if (warp == 4 * kConsumers) {
    if (lane != 0) return;
    mbar_expect_tx(wfull, g.wbytes);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(wpack) + static_cast<int64_t>(ns) * g.wbytes;
    for (int off = 0; off < g.wbytes; off += kPiece)
      bulk_load(wres + off, src + off, g.wbytes - off < kPiece ? g.wbytes - off : kPiece, wfull);
    const int per_img = g.tiles_y * g.tiles_x;
    int q = 0;
    for (int t = first; t < g.tiles; t += step) {
      const int b = t / per_img, r = t - b * per_img;
      const int y0 = (r / g.tiles_x) * kTh, x0 = (r % g.tiles_x) * kTw;
      for (int c = 0; c < g.nch; ++c, ++q) {
        const int s = q % g.stages, use = q / g.stages;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        unsigned char* a = astage + s * g.abytes;
        mbar_expect_tx(full + s, g.groups * box_bytes(kTh));
        for (int gi = 0; gi < g.groups; ++gi)
          tma_load_4d(a + gi * g.plane, &xmap, (c * g.groups + gi) * 8, x0 - 1, y0 - 1, b,
                      full + s);
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  float acc[kMi][kBn / 2];
  mbar_wait(wfull, 0);
  const int steps = g.groups / 2;  // k16 steps a chunk
  const int per_img = g.tiles_y * g.tiles_x;
  int q = 0;
  for (int t = first; t < g.tiles; t += step) {
    for (int c = 0; c < g.nch; ++c, ++q) {
      const int s = q % g.stages;
      mbar_wait(full + s, (q / g.stages) & 1);
      const unsigned char* a = astage + s * g.abytes;
      const unsigned char* wc = wres + c * g.wchunk;
      tc::wgmma_fence();
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3, dw = tap - 3 * (tap / 3);
#pragma unroll 1
        for (int ks = 0; ks < steps; ++ks) {
          const uint64_t db = tc::wgmma_desc(wc + (tap * steps + ks) * (kBn / 8) * 256, 128, 256);
          const int scale = (c | tap | ks) != 0;  // the tile's first product overwrites
#pragma unroll
          for (int mi = 0; mi < kMi; ++mi) {
            const int row = wg * kMi + mi;
            const uint64_t da = tc::wgmma_desc(
                a + ks * 2 * g.plane + ((row + dh) * kHc + dw) * 16, g.plane, 128);
            tc::WgmmaBf16<kBn>::run(acc[mi], da, db, scale);
          }
        }
      }
      tc::wgmma_commit();
      tc::wgmma_wait<1>();  // the previous chunk's products are done: free its stage
      mbar_arrive_if(empty + (q + g.stages - 1) % g.stages, c > 0 && lane == 0);
    }
    tc::wgmma_wait<0>();
    mbar_arrive_if(empty + (q - 1) % g.stages, lane == 0);

    const int b = t / per_img, r = t - b * per_img;
    const int y0 = (r / g.tiles_x) * kTh, x0 = (r % g.tiles_x) * kTw;
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
      const int yy = y0 + wg * kMi + mi;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int xx = x0 + 16 * wq + (lane >> 2) + 8 * hf;
        const bool in = yy < g.h && xx < g.w;
        __nv_bfloat16* yp =
            g.y + ((static_cast<int64_t>(b) * g.h + yy) * g.w + xx) * g.cout + ns * kBn;
        if constexpr (kBn % 32 == 0) {
          // each quad's 4 lanes hold 2 channels of each 8-channel group j; a
          // transpose over 4 groups gives each lane 8 channels: 16 bytes
#pragma unroll
          for (int jb = 0; jb < kBn / 32; ++jb) {
            uint32_t v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 4 * jb + i;
              const __nv_bfloat162 pr =
                  __floats2bfloat162_rn(acc[mi][4 * j + 2 * hf], acc[mi][4 * j + 2 * hf + 1]);
              v[i] = *reinterpret_cast<const uint32_t*>(&pr);
            }
            quad_transpose(v, lane & 3);
            const int n = 8 * (4 * jb + (lane & 3));
            store16_if(yp + n, v, in && ns * kBn + n < g.cout);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kBn / 8; ++j) {
            const int n = 8 * j + 2 * (lane & 3);
            const __nv_bfloat162 pr =
                __floats2bfloat162_rn(acc[mi][4 * j + 2 * hf], acc[mi][4 * j + 2 * hf + 1]);
            store_if(yp + n, *reinterpret_cast<const uint32_t*>(&pr), in && ns * kBn + n < g.cout);
          }
        }
      }
    }
  }
}

template <int kBn>
cudaError_t launch(const void* x, const void* w, void* y, void* wpack, Geo<__nv_bfloat16> g,
                   int device, cudaStream_t s) {
  constexpr int kTh = rows_for(kBn);
  const int kc = 8 * g.groups;
  g.nch = (g.cin + kc - 1) / kc;
  g.ntn = (g.cout + kBn - 1) / kBn;
  g.tiles_y = (g.h + kTh - 1) / kTh;
  g.tiles_x = (g.w + kTw - 1) / kTw;
  const int64_t tiles = static_cast<int64_t>(g.b) * g.tiles_y * g.tiles_x;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  g.tiles = static_cast<int>(tiles);
  g.plane = plane_bytes(kTh);
  g.abytes = g.groups * g.plane;
  g.wchunk = 9 * kc * kBn * 2;
  g.wbytes = g.nch * g.wchunk;
  const int bytes = g.wbytes + g.stages * g.abytes + (2 * g.stages + 1) * 8;

  CUtensorMap xmap;
  cudaError_t err = nhwc_map(&xmap, x, g.b, g.h, g.w, g.cin, kHc, kTh + 2);
  if (err != cudaSuccess) return err;

  const int64_t total = static_cast<int64_t>(g.ntn) * g.wbytes / 2;
  const int64_t pblocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
  pack_weights_kernel<<<static_cast<unsigned>(pblocks), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wpack), g.cin, g.cout,
      kBn, kc, g.nch, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kernel = conv3x3_tma_kernel<kBn>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one block per SM, the slices of a tile side by side (blockIdx % ntn)
  int64_t per_slice = sms / g.ntn;
  if (per_slice < 1) per_slice = 1;
  if (per_slice > g.tiles) per_slice = g.tiles;
  const int64_t blocks = per_slice * g.ntn;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  g.y = static_cast<__nv_bfloat16*>(y);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      xmap, static_cast<const __nv_bfloat16*>(wpack), g);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The float32 path on wgmma with TMA, in 3xTF32 (Cin % 4 == 0, Cout % 4 ==
// 0; ops/conv_probe.tma_plan picks it and bn): the bfloat16 kernel's
// producer warp, ring and persistent tiles, with A from registers and the
// weights streamed. P2-P5 share it.
//
// A block owns one slice of kBn output channels (blockIdx.x % ntn) and
// walks output tiles of kTh32 = 4 rows x 64 pixels, each in chunks of 8
// input channels x 9 taps. A, the activations: a chunk's haloed tile, 6
// rows x 66 pixels x 8 channels, lands by TMA as one box [row][col][8 f32]
// (a tensor map over x as (Cin, W, H, B), the frame and the channels past
// Cin zero-filled). A tap moves A by whole 32-byte pixels, off the layouts
// wgmma reads from shared memory, and 3xTF32 needs A's hi and lo besides:
// each lane loads its fragment of mma.m16n8k8's A layout at the tap's
// offset, splits it in registers (mma_tf32.cuh's split) and feeds
// wgmma.m64nNk8 with A from registers, as K3's float32 core does
// (conv3x3_tc.cuh). The k-step's channels are permuted so that one 8-byte
// load gives a lane both of its columns: A's column j < 4 (a0, a1) is
// channel 2 j, column j + 4 (a2, a3) channel 2 j + 1, and the weights' row
// kh * 4 + k4 is channel 2 k4 + kh; a warp's load is 8 pixels x 32 bytes,
// one contiguous 256-byte run, free of bank conflicts. The A registers of
// taps t and t + 1 are double-buffered: tap t overwrites buffer t % 2 once
// the products of tap t - 2 are done (wgmma.wait_group 1).
// B, the weights: tf32 B must be K-major and HWIO is N-major, so
// pack_weights_f32_kernel writes each tap's hi and lo tiles once per call
// in wgmma's K-major no-swizzle layout (core matrices of 8 n x 4 k, 16
// bytes a row: LBO = 128 bytes between K-adjacent, SBO = 256 between
// N-adjacent ones), and each chunk's tiles (576 kBn bytes) land in its
// stage beside its box, by bulk copies on the same mbarrier. A slice's hi
// and lo (9 x Cin x kBn x 8 bytes: 294,912 at Cin 64, bn 64) outgrow a
// block; where a slice of 32 fits, keeping it resident was no faster on an
// H100 than streaming it (PERF.md), so every shape streams.
// The products: per tap a consumer issues lo*hi, then hi*lo, then hi*hi,
// each over both of its rows, into a partial that the chunk's first
// product overwrites (27 products of depth 8, K3's chunk); once the chunk's
// products are done the partial is added to the tile's sums in float32:
// the tensor core's own accumulation drops low bits (K3's finding). Warps
// 0-7 are two consumer warpgroups, 2 output rows (m64 x kBn each) apiece,
// at most 128 sums and partials a thread (the 168 registers a thread of a
// block of three warpgroups); warp 8 is the producer, one thread that keeps
// a ring of stages in flight (full / empty mbarriers). The epilogue stores
// each lane's channel pairs, 8 bytes each (4 lanes: one 32-byte sector a
// row), predicated past the image and Cout; the next tile's copies are
// already in flight. A fixed tile order and no atomics: the same bits every
// run.

constexpr int kTh32 = 4;                          // output rows of a float32 tile
constexpr int kMi32 = kTh32 / kConsumers;         // rows (m64 instances) a consumer
constexpr int kBox32 = (kTh32 + 2) * kHc * 8 * 4;  // bytes of a chunk's box: 12,672
static_assert(kBox32 % 128 == 0, "a stage's weights follow its box 128-byte aligned");

// bytes of one tap's hi (or lo) tile, and of a chunk's 9 x 2 of them
__host__ __device__ constexpr int wtile32_bytes(int bn) { return bn * 8 * 4; }
__host__ __device__ constexpr int wchunk32_bytes(int bn) { return 18 * wtile32_bytes(bn); }

// wpack[slice][chunk][tap][hi, lo][n group][k half][8 n][4 k] from HWIO w
// (3, 3, cin, cout): row (kh, k4) of a chunk's tile is its channel 2 k4 +
// kh, 0 past Cin and Cout, split as tc::split does.
__global__ void pack_weights_f32_kernel(const float* __restrict__ w, float* __restrict__ out,
                                        int cin, int cout, int bn, int nch, int64_t total) {
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
    const int ng = static_cast<int>(e % (bn / 8));
    e /= bn / 8;
    const int part = static_cast<int>(e % 2);
    e /= 2;
    const int tap = static_cast<int>(e % 9);
    e /= 9;
    const int c = static_cast<int>(e % nch);
    const int ns = static_cast<int>(e / nch);
    const int k = c * 8 + 2 * k4 + kh, n = ns * bn + ng * 8 + n8;
    const float v =
        k < cin && n < cout ? w[(static_cast<int64_t>(tap) * cin + k) * cout + n] : 0.0f;
    const tc::Split sp = tc::split(v);
    out[i] = __uint_as_float(part == 0 ? sp.hi : sp.lo);
  }
}

// *p = (v0, v1) where `on` (p 8-byte aligned)
__device__ __forceinline__ void store2_if(float* p, float v0, float v1, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n@p st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(p),
      "f"(v0), "f"(v1), "r"(static_cast<int>(on))
      : "memory");
}

template <int kBn>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_tma_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                           const float* __restrict__ wpack, Geo<float> g) {
  constexpr int kWtile = wtile32_bytes(kBn), kWchunk = wchunk32_bytes(kBn);
  constexpr int kStage = kBox32 + kWchunk;
  // stage s at s * kStage: the chunk's box, then its weights
  extern __shared__ __align__(1024) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + g.stages * kStage);
  uint64_t* empty = full + g.stages;
  const int ns = blockIdx.x % g.ntn;
  const int first = blockIdx.x / g.ntn, step = gridDim.x / g.ntn;
  // warp-uniform, as in the bfloat16 kernel
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 5), 0);
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();  // the only block-wide barrier: the producer warp leaves below

  const unsigned char* wslice =
      reinterpret_cast<const unsigned char*>(wpack) + static_cast<int64_t>(ns) * g.nch * kWchunk;
  const int per_img = g.tiles_y * g.tiles_x;
  if (warp == 4 * kConsumers) {
    if (lane != 0) return;
    int q = 0;
    for (int t = first; t < g.tiles; t += step) {
      const int b = t / per_img, r = t - b * per_img;
      const int y0 = (r / g.tiles_x) * kTh32, x0 = (r % g.tiles_x) * kTw;
      for (int c = 0; c < g.nch; ++c, ++q) {
        const int s = q % g.stages, use = q / g.stages;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        unsigned char* st = ring + s * kStage;
        mbar_expect_tx(full + s, kStage);
        tma_load_4d(st, &xmap, c * 8, x0 - 1, y0 - 1, b, full + s);
        for (int off = 0; off < kWchunk; off += kPiece)
          bulk_load(st + kBox32 + off, wslice + static_cast<int64_t>(c) * kWchunk + off,
                    kWchunk - off < kPiece ? kWchunk - off : kPiece, full + s);
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  const int gid = lane >> 2, tig = lane & 3;
  // the lane's A in a box at tap (0, 0): pixel 16 wq + gid of the
  // consumer's first row, channels 2 tig and 2 tig + 1
  const int aoff = ((wg * kMi32) * kHc + 16 * wq + gid) * 32 + 8 * tig;
  float acc[kMi32][kBn / 2], pt[kMi32][kBn / 2];
  uint32_t ah[2][kMi32][4], al[2][kMi32][4];
#pragma unroll
  for (int mi = 0; mi < kMi32; ++mi)
#pragma unroll
    for (int r = 0; r < kBn / 2; ++r) acc[mi][r] = pt[mi][r] = 0.0f;
  int q = 0;
  for (int t = first; t < g.tiles; t += step) {
    for (int c = 0; c < g.nch; ++c, ++q) {
      const int s = q % g.stages;
      mbar_wait(full + s, (q / g.stages) & 1);
      const unsigned char* st = ring + s * kStage;
      const unsigned char* wc = st + kBox32;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int buf = tap & 1;
        if (tap >= 2) {
          tc::wgmma_wait<1>();  // the products of tap - 2, which read buffer buf
#pragma unroll
          for (int mi = 0; mi < kMi32; ++mi)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              tc::keep(ah[buf][mi][v]);
              tc::keep(al[buf][mi][v]);
            }
        }
        const unsigned char* ap = st + aoff + ((tap / 3) * kHc + tap % 3) * 32;
#pragma unroll
        for (int mi = 0; mi < kMi32; ++mi) {
          // pixels gid and gid + 8 of the consumer's row mi: (a0, a2), (a1, a3)
          const float2 u0 = *reinterpret_cast<const float2*>(ap + mi * kHc * 32);
          const float2 u1 = *reinterpret_cast<const float2*>(ap + (mi * kHc + 8) * 32);
          const float v[4] = {u0.x, u1.x, u0.y, u1.y};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const tc::Split sp = tc::split(v[r]);
            ah[buf][mi][r] = sp.hi;
            al[buf][mi][r] = sp.lo;
          }
        }
        tc::wgmma_fence();
        const uint64_t dh = tc::wgmma_desc(wc + 2 * tap * kWtile, 128, 256);
        const uint64_t dl = tc::wgmma_desc(wc + (2 * tap + 1) * kWtile, 128, 256);
        // 3xTF32, the small terms first; the chunk's first product overwrites
#pragma unroll
        for (int mi = 0; mi < kMi32; ++mi) tc::WgmmaTf32<kBn>::run(pt[mi], al[buf][mi], dh, tap);
#pragma unroll
        for (int mi = 0; mi < kMi32; ++mi) tc::WgmmaTf32<kBn>::run(pt[mi], ah[buf][mi], dl, 1);
#pragma unroll
        for (int mi = 0; mi < kMi32; ++mi) tc::WgmmaTf32<kBn>::run(pt[mi], ah[buf][mi], dh, 1);
        tc::wgmma_commit();
      }
      tc::wgmma_wait<0>();
      mbar_arrive_if(empty + s, lane == 0);  // the stage's box and weights are read
#pragma unroll
      for (int mi = 0; mi < kMi32; ++mi) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          tc::keep(ah[0][mi][v]);
          tc::keep(al[0][mi][v]);
          tc::keep(ah[1][mi][v]);
          tc::keep(al[1][mi][v]);
        }
#pragma unroll
        for (int r = 0; r < kBn / 2; ++r) {
          tc::keep(pt[mi][r]);
          acc[mi][r] += pt[mi][r];
        }
      }
    }

    const int b = t / per_img, r = t - b * per_img;
    const int y0 = (r / g.tiles_x) * kTh32, x0 = (r % g.tiles_x) * kTw;
#pragma unroll
    for (int mi = 0; mi < kMi32; ++mi) {
      const int yy = y0 + wg * kMi32 + mi;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int xx = x0 + 16 * wq + gid + 8 * hf;
        const bool in = yy < g.h && xx < g.w;
        float* yp = g.y + ((static_cast<int64_t>(b) * g.h + yy) * g.w + xx) * g.cout + ns * kBn;
#pragma unroll
        for (int j = 0; j < kBn / 8; ++j) {
          const int n = 8 * j + 2 * tig;
          store2_if(yp + n, acc[mi][4 * j + 2 * hf], acc[mi][4 * j + 2 * hf + 1],
                    in && ns * kBn + n < g.cout);
          acc[mi][4 * j + 2 * hf] = acc[mi][4 * j + 2 * hf + 1] = 0.0f;
        }
      }
    }
  }
}

template <int kBn>
cudaError_t launch_f32(const void* x, const void* w, void* y, void* wpack, Geo<float> g,
                       int device, cudaStream_t s) {
  constexpr int kWchunk = wchunk32_bytes(kBn);
  g.nch = (g.cin + 7) / 8;
  g.ntn = (g.cout + kBn - 1) / kBn;
  g.tiles_y = (g.h + kTh32 - 1) / kTh32;
  g.tiles_x = (g.w + kTw - 1) / kTw;
  const int64_t tiles = static_cast<int64_t>(g.b) * g.tiles_y * g.tiles_x;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  g.tiles = static_cast<int>(tiles);
  const int64_t bytes = static_cast<int64_t>(g.stages) * (kBox32 + kWchunk) + 2 * g.stages * 8;
  if (bytes > 232448) return cudaErrorInvalidValue;

  CUtensorMap xmap;
  cudaError_t err = nhwc_map(&xmap, x, g.b, g.h, g.w, g.cin, kHc, kTh32 + 2, 8,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;

  const int64_t total = static_cast<int64_t>(g.ntn) * g.nch * kWchunk / 4;
  const int64_t pblocks = (total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096;
  pack_weights_f32_kernel<<<static_cast<unsigned>(pblocks), 256, 0, s>>>(
      static_cast<const float*>(w), static_cast<float*>(wpack), g.cin, g.cout, kBn, g.nch,
      total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kernel = conv3x3_tma_f32_kernel<kBn>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // one block per SM, the slices of a tile side by side (blockIdx % ntn)
  int64_t per_slice = sms / g.ntn;
  if (per_slice < 1) per_slice = 1;
  if (per_slice > g.tiles) per_slice = g.tiles;
  const int64_t blocks = per_slice * g.ntn;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  g.y = static_cast<float*>(y);
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<int>(bytes), s>>>(
      xmap, static_cast<const float*>(wpack), g);
  return cudaGetLastError();
}

}  // namespace tma

}  // namespace

// x: (b, h, w, cin), kernel: (3, 3, cin, cout), y: (b, h, w, cout), all
// contiguous in one dtype (0 = float32, 1 = bfloat16). variant: 0 = P2
// single-buffered, 1 = P3 double-buffered, 2 = P4 any Cin, 3 = P5 Cin = 64;
// P2, P3 take Cin a multiple of 32 (bfloat16) or 16 (float32). vec_x,
// vec_w: x's pixels and the kernel's rows are whole 16-byte vectors and the
// pointers 16-byte aligned. Returns a cudaError_t value.
extern "C" int im2im_conv3x3_nhwc(const void* x, const void* kernel, void* y, int b, int h,
                                  int w, int cin, int cout, int variant, int dtype, int vec_x,
                                  int vec_w, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geo g{};
  g.x = static_cast<const char*>(x);
  g.w = static_cast<const char*>(kernel);
  g.y = static_cast<char*>(y);
  g.b = b;
  g.h = h;
  g.w_ = w;
  g.cin = cin;
  g.cout = cout;
  g.vec_x = vec_x;
  g.vec_w = vec_w;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(g, variant, device, s));
  if (dtype == 1) return static_cast<int>(dispatch<__nv_bfloat16>(g, variant, device, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of the packed weights that im2im_conv3x3_nhwc_tma needs as scratch
// for the plan (bn, groups) in dtype (0 = float32, 1 = bfloat16): every N
// slice's chunks of groups x 8 channels, in bfloat16 or as float32's tf32
// hi and lo. Minus a cudaError_t value for a dtype it does not know.
extern "C" long long im2im_conv3x3_nhwc_tma_scratch(int cin, int cout, int bn, int groups,
                                                    int dtype) {
  if (dtype != 0 && dtype != 1) return -static_cast<long long>(cudaErrorInvalidValue);
  const long long kc = 8LL * groups;
  return ((cout + bn - 1) / bn) * ((cin + kc - 1) / kc) * 9 * kc * bn * (dtype == 0 ? 8 : 2);
}

// The path on wgmma with TMA: x (b, h, w, cin), kernel (3, 3, cin, cout), y
// (b, h, w, cout), all of dtype (0 = float32, 1 = bfloat16), contiguous, x
// and wpack 16-byte aligned; wpack: the scratch above. The plan (bn, chunks
// of groups x 8 channels, ring stages) comes from ops/conv_probe.tma_plan:
// bfloat16 takes Cin % 8 == 0 and Cout % 8 == 0, bn in 16, 32, 64, 96,
// 128 and an even groups; float32 takes Cin % 4 == 0 and Cout % 4 == 0, bn
// in 32, 64 and groups 1. Returns a cudaError_t value.
extern "C" int im2im_conv3x3_nhwc_tma(const void* x, const void* kernel, void* y, void* wpack,
                                      int b, int h, int w, int cin, int cout, int bn,
                                      int groups, int stages, int dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int align = dtype == 0 ? 4 : 8;  // channels of 16 bytes
  if ((dtype != 0 && dtype != 1) || b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 ||
      cin % align != 0 || cout % align != 0 || stages < 1 ||
      (dtype == 0 ? groups != 1 : groups < 2 || groups % 2 != 0) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wpack)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    tma::Geo<float> g{};
    g.b = b;
    g.h = h;
    g.w = w;
    g.cin = cin;
    g.cout = cout;
    g.groups = groups;
    g.stages = stages;
    switch (bn) {
      case 32: return static_cast<int>(tma::launch_f32<32>(x, kernel, y, wpack, g, device, s));
      case 64: return static_cast<int>(tma::launch_f32<64>(x, kernel, y, wpack, g, device, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  tma::Geo<__nv_bfloat16> g{};
  g.b = b;
  g.h = h;
  g.w = w;
  g.cin = cin;
  g.cout = cout;
  g.groups = groups;
  g.stages = stages;
  switch (bn) {
    case 16: return static_cast<int>(tma::launch<16>(x, kernel, y, wpack, g, device, s));
    case 32: return static_cast<int>(tma::launch<32>(x, kernel, y, wpack, g, device, s));
    case 64: return static_cast<int>(tma::launch<64>(x, kernel, y, wpack, g, device, s));
    case 96: return static_cast<int>(tma::launch<96>(x, kernel, y, wpack, g, device, s));
    case 128: return static_cast<int>(tma::launch<128>(x, kernel, y, wpack, g, device, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
