// K1b: backward of the 2x bilinear upsample with align_corners=True, NCHW,
// for sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_resize.py
// `_upsample2x_bwd_raw` / `_bwd_kernel` (the custom VJP of the fused decoder
// upsample).
//
// What it computes: the transpose of K1 (csrc/upsample2x.cu). Along one axis
// of n inputs and 2n outputs,
//   dx[m] = a1[m]*g[2m] + a3[m]*g[2m+2] + a2[m]*g[2m+1] + a0[m]*g[2m-1]
// with a0[m] = fo[m-1], a1[m] = fe[m], a2[m] = 1 - fo[m], a3[m] = 1 - fe[m+1]
// (pallas_resize.py:281-287), from the forward's phase weights fe/fo. The
// wrapper passes the four tables per axis as one small f32 array
// [a0 | a1 | a2 | a3]. a0[0] = 0 and a3[n-1] = 0, so the taps at 2m-1 < 0
// and 2m+2 > 2n-1 are clamped onto real elements with a weight of exactly 0
// (the same elements as the plain version's, so even a zero's sign agrees).
// The W axis is reduced first (one partial sum per cotangent row), then the
// H axis, each as the same four-term sum in the same order as the plain
// version `upsample2x_bwd_plain`.
//
// What bounds it: bytes, once nothing else does. It reads the cotangent
// once (4|dx| elements) and writes dx once; 16 multiply-adds per output are
// far below the card's compute rate. A design that spends a few hundred
// instructions an element is bound by issue instead: the bf16 kernel
// before this one gave a thread one dx element in a grid-stride loop over
// a 64-bit index (four 64-bit divisions and remainders an element, each a
// long software routine) and 16 scalar 2-byte loads, and took 3.8x its
// byte bound on an H100.
//
// Design, float32 (upsample2x_bwd_kernel): the gather form, with no
// atomics. One thread per dx element reads its 4x4 window of the cotangent
// (rows 2i-1..2i+2, columns 2j-1..2j+2, clamped), accumulates in f32 and
// stores once. Neighbouring threads own neighbouring columns, so each row's
// loads are coalesced and the overlap between windows is served by L1.
//
// Design, bfloat16 (upsample2x_bwd_tile_kernel, upsample2x_tile.cuh): the
// TPU kernel's row tiles, with Hopper's loads. A thread owns 8 dx columns
// (one 16-byte vector) of one plane and walks down a tile of 4 dx rows: it
// finds its place once, with one 32-bit division, and then steps a row
// pointer. For each cotangent row it loads the 16 columns it reads as two
// 16-byte vectors and the two halo columns as 2-byte loads (L1 hits: a
// neighbour's vectors), and reduces the W axis into 8 partials. A
// cotangent row feeds two dx rows, so its partials stay in registers for
// the next row, and each cotangent row is read once a tile (two more at
// the tile's top, from L2); the next two rows are loaded a step ahead. dx
// goes out as one 16-byte store. Where W % 8 != 0 or a pointer is not
// 16-byte aligned, the same body runs one column a thread (V = 1).
//
// Both keep the plain version's order: the W axis first (one partial sum
// per cotangent row), then the H axis, every multiply and add rounded (no
// contraction), one rounding to the tensor's dtype at the end. So both are
// bit-identical to upsample2x_bwd_plain. The TPU kernel's W%8 gate,
// 128-lane channel pad and banded (2W, W) matmul were Mosaic workarounds
// and are gone: every shape runs, including H or W = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "upsample2x_tile.cuh"

namespace {

// ((a1*v1 + a3*v3) + a2*v2) + a0*v0, rounded after every operation.
__device__ __forceinline__ float taps(float a0, float a1, float a2, float a3, float v0,
                                      float v1, float v2, float v3) {
  float s = __fadd_rn(__fmul_rn(a1, v1), __fmul_rn(a3, v3));
  s = __fadd_rn(s, __fmul_rn(a2, v2));
  return __fadd_rn(s, __fmul_rn(a0, v0));
}

// float32 K1b: one thread per dx element reads its 4x4 window of the
// cotangent.
__global__ void upsample2x_bwd_kernel(const float* __restrict__ g, float* __restrict__ dx,
                                      const float* __restrict__ ah,  // [a0|a1|a2|a3] over h
                                      const float* __restrict__ aw,  // [a0|a1|a2|a3] over w
                                      int64_t planes, int h, int w) {
  const int64_t total = planes * h * w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int h2 = 2 * h, w2 = 2 * w;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int j = static_cast<int>(idx % w);
    const int64_t t = idx / w;
    const int i = static_cast<int>(t % h);
    const int64_t plane = t / h;
    const float* gp = g + plane * h2 * w2;

    // clamped taps, as the plain version clamps them: 2m-1 -> 1 at m = 0
    // (the first odd output), 2m+2 -> 2m at m = n-1 (the last even output)
    const int c0 = j > 0 ? 2 * j - 1 : 1;
    const int c3 = j < w - 1 ? 2 * j + 2 : 2 * j;
    const float aw0 = aw[j], aw1 = aw[w + j], aw2 = aw[2 * w + j], aw3 = aw[3 * w + j];
    const int rows[4] = {i > 0 ? 2 * i - 1 : 1, 2 * i, 2 * i + 1, i < h - 1 ? 2 * i + 2 : 2 * i};
    float part[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* row = gp + static_cast<int64_t>(rows[k]) * w2;
      part[k] = taps(aw0, aw1, aw2, aw3, __ldg(row + c0), __ldg(row + 2 * j),
                     __ldg(row + 2 * j + 1), __ldg(row + c3));
    }
    const float d = taps(ah[i], ah[h + i], ah[2 * h + i], ah[3 * h + i], part[0], part[1],
                         part[2], part[3]);
    dx[idx] = d;
  }
}

// A cotangent row at a thread's dx columns j0 .. j0 + V - 1, as bf16 words:
// mid holds cotangent columns 2 j0 .. 2 j0 + 2V - 1 (mid[k]: 2 j0 + 2k in
// the low half, 2 j0 + 2k + 1 in the high), halo column 2 j0 - 1 (low) and
// 2 j0 + 2V (high), clamped as the plain version clamps them (1 at j0 = 0,
// 2 j0 + 2V - 2 at the last column).
template <int V>
struct GRow {
  uint32_t mid[V];
  uint32_t halo;
};

template <int V>
__device__ __forceinline__ GRow<V> load_grow(const __nv_bfloat16* row, int j0, int w) {
  GRow<V> r;
  const auto* bits = reinterpret_cast<const uint16_t*>(row);
  if constexpr (V == 8) {
    const auto* v = reinterpret_cast<const uint4*>(row + 2 * j0);
    const uint4 a = __ldg(v), b = __ldg(v + 1);
    r.mid[0] = a.x, r.mid[1] = a.y, r.mid[2] = a.z, r.mid[3] = a.w;
    r.mid[4] = b.x, r.mid[5] = b.y, r.mid[6] = b.z, r.mid[7] = b.w;
  } else {  // any alignment: two 2-byte loads
    r.mid[0] = __ldg(bits + 2 * j0) | static_cast<uint32_t>(__ldg(bits + 2 * j0 + 1)) << 16;
  }
  const uint32_t left = __ldg(bits + (j0 > 0 ? 2 * j0 - 1 : 1));
  const uint32_t right = __ldg(bits + (j0 + V < w ? 2 * (j0 + V) : 2 * (j0 + V) - 2));
  r.halo = left | right << 16;
  return r;
}

// The W partials of one cotangent row at the V dx columns:
// part[u] = taps(a0, a1, a2, a3 of column j, g[2j-1], g[2j], g[2j+1], g[2j+2])
template <int V>
__device__ __forceinline__ void w_partials(const GRow<V>& r, const float (&aw)[4][V],
                                           float (&part)[V]) {
  float v[2 * V + 2];
  v[0] = k1::lo_f32(r.halo);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    v[2 * k + 1] = k1::lo_f32(r.mid[k]);
    v[2 * k + 2] = k1::hi_f32(r.mid[k]);
  }
  v[2 * V + 1] = k1::hi_f32(r.halo);
#pragma unroll
  for (int u = 0; u < V; ++u)
    part[u] = taps(aw[0][u], aw[1][u], aw[2][u], aw[3][u], v[2 * u], v[2 * u + 1],
                   v[2 * u + 2], v[2 * u + 3]);
}

// bf16 K1b: a thread walks down its tile of dx rows at its V columns. Each
// cotangent row's W partials are computed once and kept for the two dx
// rows that read them (row 2i + 1 and 2i + 2 feed dx rows i and i + 1);
// the next two cotangent rows are loaded a step ahead. Same operations, in
// the same order, as upsample2x_bwd_kernel and the plain version.
template <int V>
__global__ void __launch_bounds__(k1::kMaxThreads)
    upsample2x_bwd_tile_kernel(const __nv_bfloat16* __restrict__ g,
                               __nv_bfloat16* __restrict__ dx,
                               const float* __restrict__ ah,  // [a0|a1|a2|a3] over h
                               const float* __restrict__ aw,  // [a0|a1|a2|a3] over w
                               long long planes, int h, int w, int rows, int tiles) {
  long long plane;
  int j0, i0, i1;
  if (!k1::place(planes, h, w, rows, tiles, V, &plane, &j0, &i0, &i1)) return;
  const int w2 = 2 * w;
  const __nv_bfloat16* gp = g + plane * 4 * h * w;
  __nv_bfloat16* dxp = dx + plane * h * w + j0;
  float a[4][V];
#pragma unroll
  for (int t = 0; t < 4; ++t) k1::load_f32s<V>(aw + t * w + j0, a[t]);
  auto grow = [&](int q) { return load_grow<V>(gp + static_cast<size_t>(q) * w2, j0, w); };

  // partials of rows 2i - 1 (1 at i = 0) and 2i; raw rows 2i + 1 and 2i + 2
  float r0[V], r1[V], r2[V], r3[V];
  w_partials<V>(grow(i0 > 0 ? 2 * i0 - 1 : 1), a, r0);
  w_partials<V>(grow(2 * i0), a, r1);
  GRow<V> c = grow(2 * i0 + 1), d = i0 < h - 1 ? grow(2 * i0 + 2) : c;
  for (int i = i0; i < i1; ++i) {
    GRow<V> c_next = c, d_next = d;
    if (i + 1 < i1) {
      c_next = grow(2 * i + 3);
      if (i + 1 < h - 1) d_next = grow(2 * i + 4);
    }
    w_partials<V>(c, a, r2);
    if (i < h - 1) {
      w_partials<V>(d, a, r3);
    } else {  // row 2i + 2 is clamped onto 2i (weight 0)
#pragma unroll
      for (int u = 0; u < V; ++u) r3[u] = r1[u];
    }
    const float b0 = __ldg(ah + i), b1 = __ldg(ah + h + i), b2 = __ldg(ah + 2 * h + i),
                b3 = __ldg(ah + 3 * h + i);
    __nv_bfloat16* out = dxp + static_cast<size_t>(i) * w;
    if constexpr (V == 8) {
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = k1::pack_bf16x2(taps(b0, b1, b2, b3, r0[2 * k], r1[2 * k], r2[2 * k], r3[2 * k]),
                               taps(b0, b1, b2, b3, r0[2 * k + 1], r1[2 * k + 1], r2[2 * k + 1],
                                    r3[2 * k + 1]));
      *reinterpret_cast<uint4*>(out) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      *out = __float2bfloat16_rn(taps(b0, b1, b2, b3, r0[0], r1[0], r2[0], r3[0]));
    }
#pragma unroll
    for (int u = 0; u < V; ++u) r0[u] = r2[u], r1[u] = r3[u];
    c = c_next;
    d = d_next;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loop covers the rest

int launch_f32(const void* g, void* dx, const void* ah, const void* aw, int64_t planes, int h,
               int w, cudaStream_t stream) {
  const int64_t total = planes * h * w;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  upsample2x_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<float*>(dx), static_cast<const float*>(ah),
      static_cast<const float*>(aw), planes, h, w);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* g, void* dx, const void* ah, const void* aw, long long planes,
                int h, int w, int kind, cudaStream_t stream) {
  k1::Plan p;
  dim3 grid, block;
  const cudaError_t err =
      k1::launch_shape(planes, h, w, kind, k1::kBwdVector, g, dx, &p, &grid, &block);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  auto* dxb = static_cast<__nv_bfloat16*>(dx);
  const auto* ahf = static_cast<const float*>(ah);
  const auto* awf = static_cast<const float*>(aw);
  if (kind == 1)
    upsample2x_bwd_tile_kernel<k1::kBwdVector><<<grid, block, 0, stream>>>(
        gb, dxb, ahf, awf, planes, h, w, p.rows, p.tiles);
  else
    upsample2x_bwd_tile_kernel<1><<<grid, block, 0, stream>>>(gb, dxb, ahf, awf, planes, h, w,
                                                              p.rows, p.tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g: (planes, 2h, 2w) contiguous; dx: (planes, h, w) contiguous, same dtype.
// ah: (4h,) f32 device table [a0 | a1 | a2 | a3] over h; aw: (4w,) over w.
// kind: 0 = float32; bfloat16 1 8 columns a thread (W % 8 == 0, g and dx
// 16-byte aligned), 2 one column a thread. Returns a cudaError_t value (0 =
// ok).
extern "C" int im2im_upsample2x_bwd(const void* g, void* dx, const void* ah, const void* aw,
                                    long long planes, int h, int w, int kind, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch_f32(g, dx, ah, aw, planes, h, w, s);
  if (kind == 1 || kind == 2) return launch_bf16(g, dx, ah, aw, planes, h, w, kind, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
