// The row-tiled layout of the bf16 K1f and K1b kernels (upsample2x.cu,
// upsample2x_bwd.cu), for sm_90a.
//
// A thread owns `vec` adjacent columns of one plane (its kernel's vector
// width: K1f 4, K1b 8; 1 for the shapes the vector does not fit) and walks
// down a tile of `rows` rows of them, so that it finds its plane, tile and
// columns once, from blockIdx and threadIdx, and then only steps a row
// pointer. A block is `units` threads across the columns by `groups`
// planes, all at one tile: blockIdx.x = plane group * tiles + tile (one
// 32-bit division a thread), blockIdx.y = the column tile. plan() is
// ops/upsample.upsample_plan, line for line; im2im_upsample2x_plan returns
// it so that the two can be held to each other on the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace k1 {

constexpr int kFwdVector = 4, kBwdVector = 8;  // upsample.FWD_VECTOR, BWD_VECTOR
constexpr int kBlockThreads = 128;             // upsample.BLOCK_THREADS
constexpr int kMaxThreads = 512;               // upsample.MAX_THREADS, the launch bound
constexpr int kTileRows = 4, kUnitsMax = 256;  // upsample.TILE_ROWS, UNITS_MAX

struct Plan {
  int vec, units, col_tiles, rows, tiles, groups;
};

inline int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

inline Plan plan(int h, int w, int vec) {
  Plan p;
  p.vec = vec;
  const int units_total = w / vec;
  p.units = units_total < kUnitsMax ? units_total : kUnitsMax;
  p.groups = (kBlockThreads + p.units - 1) / p.units;
  const int step = 32 / gcd(p.units, 32);
  const int aligned = (p.groups + step - 1) / step * step;
  if (p.units * aligned <= kMaxThreads) p.groups = aligned;
  p.col_tiles = (units_total + p.units - 1) / p.units;
  p.rows = h < kTileRows ? h : kTileRows;
  p.tiles = (h + p.rows - 1) / p.rows;
  return p;
}

// kind 1, the kernel's vector instance (`vector` columns a thread), needs
// W % vector == 0 and 16-byte aligned pointers; kind 2 is one column a
// thread. The grid, or an error: too many blocks for blockIdx.x, a plane of
// 2^31 elements or more, or a vector kind the shape or the pointers do not
// fit.
inline cudaError_t launch_shape(long long planes, int h, int w, int kind, int vector,
                                const void* a, const void* b, Plan* p, dim3* grid, dim3* block) {
  const int vec = kind == 1 ? vector : 1;
  if (kind == 1 && (w % vector || reinterpret_cast<uintptr_t>(a) % 16 ||
                    reinterpret_cast<uintptr_t>(b) % 16))
    return cudaErrorInvalidValue;
  if (4LL * h * w >= (1LL << 31)) return cudaErrorInvalidValue;
  *p = plan(h, w, vec);
  const long long groups = (planes + p->groups - 1) / p->groups;
  if (groups * p->tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  *grid = dim3(static_cast<unsigned>(groups * p->tiles), static_cast<unsigned>(p->col_tiles));
  *block = dim3(p->units, p->groups);
  return cudaSuccess;
}

// The thread's place: plane, first column, and its tile's rows [i0, i1).
// False for a thread past the planes or the columns.
__device__ __forceinline__ bool place(long long planes, int h, int w, int rows, int tiles,
                                      int vec, long long* plane, int* j0, int* i0, int* i1) {
  const int group = blockIdx.x / tiles;
  const int tile = blockIdx.x - group * tiles;
  *plane = static_cast<long long>(group) * blockDim.y + threadIdx.y;
  *j0 = (blockIdx.y * blockDim.x + threadIdx.x) * vec;
  *i0 = tile * rows;
  *i1 = min(*i0 + rows, h);
  return *plane < planes && *j0 < w;
}

// the float of the bf16 in the low or the high half of a 32-bit word
__device__ __forceinline__ float lo_f32(uint32_t word) { return __uint_as_float(word << 16); }
__device__ __forceinline__ float hi_f32(uint32_t word) {
  return __uint_as_float(word & 0xffff0000u);
}

// a and b rounded to bf16 (to nearest even) in one word, a in the low half
// (the lower address)
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// V consecutive floats of a weight table (V = 8: 32-byte aligned)
template <int V>
__device__ __forceinline__ void load_f32s(const float* p, float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
      out[4 * k] = v.x, out[4 * k + 1] = v.y, out[4 * k + 2] = v.z, out[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = __ldg(p + k);
  }
}

}  // namespace k1
