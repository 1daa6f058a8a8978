// K1: 2x bilinear upsample with align_corners=True, NCHW, for sm_90a.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_resize.py
// `_upsample2x_fwd_raw` / `_fwd_kernel` (the fused decoder upsample).
//
// What it computes: for an input plane of n rows, output row 2m is
// x[m-1] + (x[m] - x[m-1]) * fe[m] and output row 2m+1 is
// x[m] + (x[m+1] - x[m]) * fo[m], with the phase weights fe/fo of
// `_phase_weights` (pallas_resize.py:59-73) passed in as small f32 tables.
// The taps at m-1 < 0 and m+1 > n-1 are clamped; their weight is exactly 0
// there (fe[0] = 1, fo[n-1] = 0), so clamping changes nothing. The lerp runs
// along H first and then along W, like resize_bilinear_align_corners.
//
// What bounds it: bytes, once nothing else does. Each output element costs
// a few flops, and the call reads the input once and writes four times as
// much. A design that spends a few hundred instructions an element is
// bound by issue instead: the bf16 kernel before this one gave a thread one
// input element in a grid-stride loop over a 64-bit index (four 64-bit
// divisions and remainders an element, each a long software routine), 9
// scalar 2-byte loads, 4-byte stores and some 20 f32-bf16 round trips, and
// took 3.7x its byte bound on an H100, more than the f32 kernel at twice
// the bytes.
//
// Design, float32 (upsample2x_kernel): one thread per 2x2 output quad. A
// thread reads its 3x3 input neighbourhood (the neighbours' reads hit
// L1/L2), does both lerps in f32, and writes two 2-element vectors, one per
// output row; neighbouring threads own neighbouring quads along W, so the
// stores are coalesced.
//
// Design, bfloat16 (upsample2x_tile_kernel, upsample2x_tile.cuh): the TPU
// kernel's row tiles (a grid over image and row tile, whole rows at a
// time), with Hopper's loads and stores. A thread owns 4 input columns of
// one plane and walks down a tile of 4 input rows: it finds its place once,
// with one 32-bit division, and then steps a row pointer. Rows i - 1, i and
// i + 1 sit in a register window, one 8-byte load and two 2-byte halo loads
// a row (the halo columns j0 - 1 and j0 + 4 are a neighbour's, L1 hits),
// the next row loaded a step ahead. The H lerps run on bf16 pairs (sub,
// mul, add .rn.bf16x2: 3 instructions for 2 elements), the halo columns as
// one more pair; the W taps in f32. Each output row leaves as one 16-byte
// store a thread, so a warp's stores are contiguous, marked evict-first
// (the kernel never reads its output; faster than write-back stores on an
// H100). Short tiles give many threads
// (memory-level parallelism at the small decoder levels) and cost two halo
// rows a tile, read from L2. Where W % 4 != 0 or a pointer is not 16-byte
// aligned, the same body runs one column a thread (V = 1). The TPU
// kernel's shape gates (W%8, C>=32) and its banded W-axis matmul were
// Mosaic workarounds and are gone: every shape runs.
//
// Numerics, float32: f32 arithmetic with one rounding at the store. The
// lerps use explicitly rounded intrinsics, so no multiply-add is contracted
// and the result is bit-identical to the plain PyTorch version (which runs
// the same subtract, multiply and add as separate f32 operations).
//
// Numerics, bfloat16: the TPU kernel's function (pallas_resize.py:158-181).
// The H-axis lerps run in bf16, each subtract, multiply and add rounded
// once to bf16 (the plain version does each in f32 and rounds: f32's 24
// bits are more than twice bf16's 8 plus 2, so that double rounding gives
// the same bits), with the phase weights rounded to bf16 and zero rows
// beyond the edges. The W axis is the TPU kernel's matmul against the bf16
// entries of `_col_transpose_matrix(W)`: each output column has two taps,
// whose products of two bf16 values are exact in f32, added once in f32 and
// rounded once to bf16 (fma(p, a, q*b) with q*b exact), so the order of the
// taps cannot change the bits. For bf16 the W table holds those four tap
// weights per input column (already rounded to bf16) instead of fe/fo.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "upsample2x_tile.cuh"

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// a + (b - a) * f, rounded after every operation (no FMA contraction).
__device__ __forceinline__ float lerp(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));
}

__global__ void upsample2x_kernel(const float* __restrict__ x, float* __restrict__ y,
                                  const float* __restrict__ wh,  // fe_h[h], fo_h[h]
                                  const float* __restrict__ ww,  // fe_w[w], fo_w[w]
                                  int64_t planes, int h, int w) {
  const int64_t total = planes * h * w;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int j = static_cast<int>(idx % w);
    const int64_t t = idx / w;
    const int i = static_cast<int>(t % h);
    const int64_t plane = t / h;

    const float* xp = x + plane * h * w;
    const float* row_m = xp + static_cast<int64_t>(i > 0 ? i - 1 : 0) * w;
    const float* row_c = xp + static_cast<int64_t>(i) * w;
    const float* row_p = xp + static_cast<int64_t>(i < h - 1 ? i + 1 : h - 1) * w;
    const int jm = j > 0 ? j - 1 : 0;
    const int jp = j < w - 1 ? j + 1 : w - 1;

    const float feh = wh[i], foh = wh[h + i];
    const float few = ww[j], fow = ww[w + j];

    // H pass at the three input columns jm, j, jp.
    float even[3], odd[3];
    const int cols[3] = {jm, j, jp};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float m = load_f32(row_m + cols[k]);
      const float c = load_f32(row_c + cols[k]);
      const float p = load_f32(row_p + cols[k]);
      even[k] = lerp(m, c, feh);
      odd[k] = lerp(c, p, foh);
    }

    // W pass: output columns 2j (phase even) and 2j+1 (phase odd).
    float* out = y + plane * 4 * h * w + static_cast<int64_t>(2 * i) * (2 * w) + 2 * j;
    store_pair(out, lerp(even[0], even[1], few), lerp(even[1], even[2], fow));
    store_pair(out + 2 * w, lerp(odd[0], odd[1], few), lerp(odd[1], odd[2], fow));
  }
}

// one bf16x2 operation, rounded once to bf16 (to nearest even); the .rn
// keeps ptxas from contracting a multiply and an add into one fma
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// a + (b - a) * f on two bf16 lanes, every operation rounded to bf16
__device__ __forceinline__ uint32_t lerp_bf16x2(uint32_t a, uint32_t b, uint32_t f) {
  return add_bf16x2(a, mul_bf16x2(sub_bf16x2(b, a), f));
}

// f (a bf16 value held as a float) in both halves of a word
__device__ __forceinline__ uint32_t splat_bf16(float f) { return k1::pack_bf16x2(f, f); }

// One input row at a thread's V columns j0 .. j0 + V - 1 (V = 4 or 1), as
// bf16 words: mid[k] holds columns j0 + 2k and j0 + 2k + 1 (for V = 1 the
// high half is 0), halo holds column j0 - 1 (low) and j0 + V (high), each
// clamped onto the row's edge, as the W taps past the edge (weight 0) read
// it.
template <int V>
struct Row {
  static constexpr int kWords = (V + 1) / 2;
  uint32_t mid[kWords];
  uint32_t halo;
};

template <int V>
__device__ __forceinline__ Row<V> load_row(const __nv_bfloat16* row, int j0, int w) {
  Row<V> r;
  const auto* bits = reinterpret_cast<const uint16_t*>(row);
  if constexpr (V == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + j0));
    r.mid[0] = v.x, r.mid[1] = v.y;
  } else {
    r.mid[0] = __ldg(bits + j0);
  }
  const uint32_t left = __ldg(bits + (j0 > 0 ? j0 - 1 : 0));
  const uint32_t right = __ldg(bits + (j0 + V < w ? j0 + V : w - 1));
  r.halo = left | right << 16;
  return r;
}

template <int V>
__device__ __forceinline__ Row<V> zero_row() {
  Row<V> r;
#pragma unroll
  for (int k = 0; k < Row<V>::kWords; ++k) r.mid[k] = 0;
  r.halo = 0;
  return r;
}

// The W taps of one lerped row (Row layout), written as the 2V output
// columns 2 j0 .. 2 j0 + 2V - 1: column 2j is ep·e[j-1] + ec·e[j], column
// 2j+1 is oc·e[j] + on·e[j+1]; both products of bf16 values are exact in
// f32, so fma(p, a, q·b) is their sum rounded once, as the plain version's
// f32 product is. The store is evict-first (st.global.cs): the output is
// four times the input and is read by the next kernel, not this one.
template <int V>
__device__ __forceinline__ void store_taps(__nv_bfloat16* out, const Row<V>& e,
                                           const float (&tap)[4][V]) {
  float f[V + 2];
  f[0] = k1::lo_f32(e.halo);
#pragma unroll
  for (int u = 0; u < V; ++u)
    f[u + 1] = u % 2 ? k1::hi_f32(e.mid[u / 2]) : k1::lo_f32(e.mid[u / 2]);
  f[V + 1] = k1::hi_f32(e.halo);
  uint32_t o[V];
#pragma unroll
  for (int u = 0; u < V; ++u)
    o[u] = k1::pack_bf16x2(__fmaf_rn(tap[0][u], f[u], __fmul_rn(tap[1][u], f[u + 1])),
                           __fmaf_rn(tap[2][u], f[u + 1], __fmul_rn(tap[3][u], f[u + 2])));
  if constexpr (V == 4)
    __stcs(reinterpret_cast<uint4*>(out), make_uint4(o[0], o[1], o[2], o[3]));
  else
    __stcs(reinterpret_cast<unsigned*>(out), o[0]);
}

// bf16 K1f: a thread lerps its V columns of each input row of its tile
// along H (rows i - 1, i, i + 1 in a register window that walks down the
// tile, the next row loaded a step ahead; zero rows past the edges) and
// writes output rows 2i and 2i + 1.
template <int V>
__global__ void __launch_bounds__(k1::kMaxThreads)
    upsample2x_tile_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                           const float* __restrict__ wh,  // fe_h[h], fo_h[h], bf16
                           const float* __restrict__ ww,  // 4 taps x w, bf16
                           long long planes, int h, int w, int rows, int tiles) {
  long long plane;
  int j0, i0, i1;
  if (!k1::place(planes, h, w, rows, tiles, V, &plane, &j0, &i0, &i1)) return;
  const __nv_bfloat16* xp = x + plane * h * w;
  __nv_bfloat16* yp = y + plane * 4 * h * w + 2 * j0;
  float tap[4][V];
#pragma unroll
  for (int t = 0; t < 4; ++t) k1::load_f32s<V>(ww + t * w + j0, tap[t]);

  Row<V> m = i0 > 0 ? load_row<V>(xp + static_cast<size_t>(i0 - 1) * w, j0, w) : zero_row<V>();
  Row<V> c = load_row<V>(xp + static_cast<size_t>(i0) * w, j0, w);
  Row<V> p = i0 + 1 < h ? load_row<V>(xp + static_cast<size_t>(i0 + 1) * w, j0, w)
                        : zero_row<V>();
  for (int i = i0; i < i1; ++i) {
    const Row<V> next = i + 2 < h && i + 1 < i1
                            ? load_row<V>(xp + static_cast<size_t>(i + 2) * w, j0, w)
                            : zero_row<V>();
    const uint32_t fe = splat_bf16(__ldg(wh + i)), fo = splat_bf16(__ldg(wh + h + i));
    Row<V> even, odd;
#pragma unroll
    for (int k = 0; k < Row<V>::kWords; ++k) {
      even.mid[k] = lerp_bf16x2(m.mid[k], c.mid[k], fe);
      odd.mid[k] = lerp_bf16x2(c.mid[k], p.mid[k], fo);
    }
    even.halo = lerp_bf16x2(m.halo, c.halo, fe);
    odd.halo = lerp_bf16x2(c.halo, p.halo, fo);
    __nv_bfloat16* out = yp + static_cast<size_t>(2 * i) * (2 * w);
    store_taps<V>(out, even, tap);
    store_taps<V>(out + 2 * w, odd, tap);
    m = c;
    c = p;
    p = next;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loop covers the rest

inline unsigned blocks_for(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// x: (planes, h, w) contiguous; y: (planes, 2h, 2w) contiguous, same dtype.
// kind 0 = float32: wh (2h,) f32 device table [fe_h | fo_h], ww (2w,)
// [fe_w | fo_w]. kind 1 = bfloat16, 4 columns a thread (W % 4 == 0, x and y
// 16-byte aligned), kind 2 = bfloat16 one column a thread: wh (2h,) the same
// weights rounded to bf16, ww (4w,) the W taps per input column j, rounded
// to bf16: [weight of j - 1 in column 2j | of j in 2j | of j in 2j + 1 | of
// j + 1 in 2j + 1]. Returns a cudaError_t value (0 = ok).
extern "C" int im2im_upsample2x(const void* x, void* y, const void* wh, const void* ww,
                                long long planes, int h, int w, int kind, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (planes <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* whf = static_cast<const float*>(wh);
  const auto* wwf = static_cast<const float*>(ww);
  if (kind == 0) {
    upsample2x_kernel<<<blocks_for(planes * h * w), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), whf, wwf, planes, h, w);
    return static_cast<int>(cudaGetLastError());
  }
  if (kind != 1 && kind != 2) return static_cast<int>(cudaErrorInvalidValue);
  k1::Plan p;
  dim3 grid, block;
  err = k1::launch_shape(planes, h, w, kind, k1::kFwdVector, x, y, &p, &grid, &block);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (kind == 1)
    upsample2x_tile_kernel<k1::kFwdVector><<<grid, block, 0, s>>>(xb, yb, whf, wwf, planes, h, w,
                                                                  p.rows, p.tiles);
  else
    upsample2x_tile_kernel<1><<<grid, block, 0, s>>>(xb, yb, whf, wwf, planes, h, w, p.rows,
                                                     p.tiles);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernels' plan at a plane of (h, w) elements and `vec` columns a
// thread (1, 4 or 8), as ops/upsample.upsample_plan gives it: out[6] = {vec,
// units, col_tiles, rows, tiles, groups}. Returns a cudaError_t value.
extern "C" int im2im_upsample2x_plan(int h, int w, int vec, int* out) {
  if (h <= 0 || w <= 0 || (vec != 1 && vec != k1::kFwdVector && vec != k1::kBwdVector) ||
      w % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const k1::Plan p = k1::plan(h, w, vec);
  const int fields[6] = {p.vec, p.units, p.col_tiles, p.rows, p.tiles, p.groups};
  for (int k = 0; k < 6; ++k) out[k] = fields[k];
  return 0;
}
