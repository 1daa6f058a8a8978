// K2: the RCPS fraction-missed loss table, for sm_90a, as a per-pixel
// threshold search.
//
// Replaces the TPU kernel im2im_uq_tpu/ops/pallas_kernels.py
// `_loss_table_padded` / `_loss_table_kernel`.
//
// What it computes: for each example n and each lambda l,
//   table[n, l] = #{pixels: (a > 1e-6 & lam*dl < a) | (b > 1e-6 & lam*du < b)} / P
// with a = pred - label and b = -a, the strict comparisons and the two
// COLLAPSE_EPS guards of the TPU kernel (pallas_kernels.py:62-73).
//
// Why a search gives the same table. At most one guard passes (a > 1e-6
// and -a > 1e-6 exclude each other), so a pixel has at most one slope s
// (dl or du) and one residual r > 1e-6. Round-to-nearest multiplication is
// monotone, so over the grid sorted ascending fl(lam*s) is non-decreasing
// (s > 0), non-increasing (s < 0) or +-0 for every finite lam (s = +-0),
// and `lam*s < r` holds on a prefix (s > 0), a suffix (s < 0), or exactly
// the finite values (s = +-0: inf*0 is NaN). A NaN lam or a NaN s makes the
// compare false: NaN values are ranked last and covered by no interval, a
// NaN slope covers nothing. A binary search that evaluates the very same
// f32 product and strict compare (`__fmul_rn(lam, s) < r`, never a
// reciprocal or r / s) finds the interval in ceil(log2(L + 1)) steps.
// table[n, l] is the number of intervals that cover l's rank, from a
// difference array over L + 1 integer bins and a prefix sum: integer counts,
// so the table is bit-identical to the plain version and to itself from
// run to run, whatever order the atomics take.
//
// What bounds it: bytes. The four (N, P) maps are read once and the table
// written once: 4 (4 N P + L + N L) bytes, 52.6 MB at (32, 102400),
// L = 1000: 0.0157 ms at 3.35 TB/s. The brute force that the first design
// ran (two multiplies and two compares per (pixel, lambda)) would take
// 0.196 ms at the 67 TFLOP/s f32 peak.
//
// Design, two launches:
//   rank_kernel    ranks the L values by counting (NaN last, ties by index,
//                  one 64-bit integer compare a pair): sorted[rank[l]] =
//                  lam[l]. O(L^2) compares, 32 lambdas a block, each counted
//                  by 8 thread slices: 32 blocks at L = 1000. It also zeroes
//                  the per-example counts and pads the sorted grid with NaN.
//   search_kernel  a block per (example, pixel chunk): four blocks per SM,
//                  one wave where N allows. Each thread reads 4 pixels of
//                  each map with one 16-byte load (when P % 4 == 0),
//                  searches the sorted grid in shared memory for the 4 at
//                  once (the grid padded with NaN to a power of two above L,
//                  so that every search takes the same fixed number of
//                  halvings) and adds +-1 to the example's bins with
//                  shared-memory integer atomics; the bins every pixel of a
//                  kind shares (bin 0 and bin Lv of prefixes and suffixes,
//                  the finite range of zero slopes) are counted in registers
//                  and added once per warp. The block then writes its L + 1
//                  bins to its own row of the (N, chunks, L + 1) int32
//                  scratch, with plain stores: no atomics between blocks.
//                  Where the grid and the bins do not fit kMaxSharedBytes,
//                  the search reads the sorted grid from global memory and
//                  adds to the block's row there. The last block of an
//                  example to finish (a count of finished blocks per
//                  example) sums the example's rows, takes the prefix sum
//                  and writes its row of the table, out[n, l] =
//                  float(cover[rank[l]]) / float(P), the same f32 division
//                  as the JAX package's counts / P.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxSharedBytes = 64 * 1024;  // the sorted grid and the bins
constexpr float kCollapseEps = 1e-6f;

// The rank order as one 64-bit key: the value's bits made order-preserving
// as an unsigned integer (-0 as +0, every NaN above +inf), then the index
// for ties.
__device__ __forceinline__ uint64_t rank_key(float v, int i) {
  uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = v != v ? 0xFFFFFFFFu : (u & 0x80000000u ? ~u : u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(i);
}

// A block ranks kRankLams lambdas: rank[i] = #{j: key(j) < key(i)}, each of
// kRankSplit thread slices counting over every kRankSplit-th key of a tile,
// the slices' counts then added in shared memory. It also zeroes
// (grid-stride) the per-example counts of finished search blocks and pads
// the sorted grid with NaN.
constexpr int kRankLams = 32, kRankSplit = kThreads / kRankLams, kRankTile = 2048;

__global__ void __launch_bounds__(kThreads) rank_kernel(const float* __restrict__ lam,
                                                        float* __restrict__ sorted,
                                                        int* __restrict__ rank, int num_lam,
                                                        int p2, int* __restrict__ done,
                                                        int n) {
  __shared__ uint64_t keys[kRankTile];
  __shared__ int counts[kRankSplit][kRankLams];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < n;
       e += stride)
    done[e] = 0;
  for (int64_t e = num_lam + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < p2;
       e += stride)
    sorted[e] = __int_as_float(0x7fffffff);  // NaN: past every value, covered by nothing
  const int il = threadIdx.x % kRankLams, js = threadIdx.x / kRankLams;
  const int i = blockIdx.x * kRankLams + il;
  const float vi = i < num_lam ? lam[i] : 0.0f;
  const uint64_t ki = rank_key(vi, i);
  int r = 0;
  for (int start = 0; start < num_lam; start += kRankTile) {
    const int m = num_lam - start < kRankTile ? num_lam - start : kRankTile;
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kThreads) keys[j] = rank_key(lam[start + j], start + j);
    __syncthreads();
    for (int j = js; j < m; j += kRankSplit) r += keys[j] < ki;
  }
  counts[js][il] = r;
  __syncthreads();
  if (js == 0 && i < num_lam) {
    for (int t = 1; t < kRankSplit; ++t) r += counts[t][il];
    sorted[r] = vi;
    rank[i] = r;
  }
}

// first index in [0, len) of v (ascending, NaN last) for which pred fails
template <typename Pred>
__device__ __forceinline__ int first_false(const float* v, int len, Pred pred) {
  int base = 0;
  while (len > 0) {
    const int half = len >> 1;
    if (pred(v[base + half])) {
      base += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return base;
}

// Where the grid's finite values sit in sorted order: [f0, f1), and the
// number of non-NaN values, lv.
struct Ranges {
  int f0, f1, lv;
};

__device__ __forceinline__ Ranges ranges(const float* v, int num_lam) {
  const float inf = __int_as_float(0x7f800000);
  Ranges rg;
  rg.lv = first_false(v, num_lam, [](float x) { return x == x; });
  rg.f0 = first_false(v, rg.lv, [inf](float x) { return x == -inf; });
  rg.f1 = first_false(v, rg.lv, [inf](float x) { return x < inf; });
  return rg;
}

// One example's row of the table from its search blocks' partial bins
// (`chunks` rows of num_lam + 1): their sum, into the first row; its prefix
// sum in place (integers, so any order gives the same counts); then out[l]
// = float(cover[rank[l]]) / float(P), in column order. Run by a whole block.
__device__ void finish_example(int* row, int chunks, const int* __restrict__ rank,
                               float* __restrict__ out, int64_t num_px, int num_lam) {
  __shared__ int warp_sums[kThreads / 32];
  for (int i = threadIdx.x; i < num_lam; i += kThreads) {
    int sum = 0;
#pragma unroll 8
    for (int c = 0; c < chunks; ++c)
      sum += __ldcg(row + static_cast<int64_t>(c) * (num_lam + 1) + i);
    row[i] = sum;
  }
  __syncthreads();
  const int per = (num_lam + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < num_lam ? lo + per : num_lam;
  int total = 0;
  for (int i = lo; i < hi; ++i) total += row[i];
  // inclusive scan of the threads' totals: within each warp, then across
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = total;
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int prior = 0;
  for (int w = 0; w < warp; ++w) prior += warp_sums[w];
  int run = prior + incl - total;  // the exclusive prefix of this thread's bins
  for (int i = lo; i < hi; ++i) {
    run += row[i];
    row[i] = run;
  }
  __syncthreads();  // the block's global writes are visible to the block
  const float p = static_cast<float>(num_px);
  for (int l = threadIdx.x; l < num_lam; l += kThreads)
    out[l] = __fdiv_rn(static_cast<float>(row[rank[l]]), p);
}

// A pixel's side: kNone (no guard passes, or a NaN slope: never missed),
// kPrefix (s > 0: missed on [0, k)), kSuffix (s < 0: on [k, lv)), kZero
// (s = +-0: at every finite lambda).
enum Kind { kNone = 0, kPrefix = 1, kSuffix = 2, kZero = 3 };

struct Side {
  float s, r;
  int kind;
};

__device__ __forceinline__ Side side_of(float pred, float label, float dl, float du) {
  const float a = __fsub_rn(pred, label), b = -a;
  Side sd{0.0f, 0.0f, kNone};
  if (a > kCollapseEps) {
    sd.s = dl;
    sd.r = a;
  } else if (b > kCollapseEps) {
    sd.s = du;
    sd.r = b;
  } else {
    return sd;
  }
  sd.kind = sd.s > 0.0f ? kPrefix : sd.s < 0.0f ? kSuffix : sd.s == 0.0f ? kZero : kNone;
  return sd;
}

// k for kM pixels at once (independent chains, so their shared-memory
// loads overlap): the length of the prefix of v (ascending, NaN padded to
// p2 = a power of two above L) on which `lam * s < r` holds (kPrefix), or
// on which it fails at a number (kSuffix), by a fixed number of halvings.
template <int kM>
__device__ __forceinline__ void search(const float* v, int p2, const Side (&sd)[kM],
                                       int (&k)[kM]) {
#pragma unroll
  for (int i = 0; i < kM; ++i) k[i] = 0;
  for (int half = p2 >> 1; half > 0; half >>= 1) {
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      const float x = v[k[i] + half - 1];
      const bool hit = __fmul_rn(x, sd[i].s) < sd[i].r;
      k[i] += (sd[i].kind == kSuffix ? !hit && x == x : hit) ? half : 0;
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) search_kernel(
    const float* __restrict__ pred, const float* __restrict__ label,
    const float* __restrict__ dl, const float* __restrict__ du,
    const float* __restrict__ sorted_g, int* __restrict__ part,
    const int* __restrict__ rank, int* __restrict__ done, float* __restrict__ out,
    int64_t num_px, int num_lam, int p2, int chunks, int vec) {
  extern __shared__ __align__(16) int smem[];
  const int n = blockIdx.x / chunks, c = blockIdx.x - n * chunks;
  int* row = part + static_cast<int64_t>(blockIdx.x) * (num_lam + 1);  // this block's bins
  __shared__ Ranges block_rg;
  const float* v = sorted_g;
  int* bins = row;
  Ranges rg;
  if (kShared) {
    float* vs = reinterpret_cast<float*>(smem);
    bins = smem + p2;
    for (int i = threadIdx.x; i < p2; i += kThreads) vs[i] = sorted_g[i];
    for (int i = threadIdx.x; i <= num_lam; i += kThreads) bins[i] = 0;
    __syncthreads();
    if (threadIdx.x == 0) block_rg = ranges(vs, num_lam);
    __syncthreads();
    v = vs;
    rg = block_rg;
  } else {
    for (int i = threadIdx.x; i <= num_lam; i += kThreads) row[i] = 0;
    __syncthreads();
    rg = ranges(v, num_lam);
  }

  int c0 = 0, cv = 0, cz = 0;  // at bin 0, at bin lv, zero slopes (f0 +1, f1 -1)
  auto add = [&](int k, int d) {
    if (k == 0)
      c0 += d;
    else if (k == rg.lv)
      cv += d;
    else
      atomicAdd(bins + k, d);
  };
  auto record = [&](const Side& sd, int k) {
    if (sd.kind == kPrefix) {
      c0 += 1;
      add(k, -1);
    } else if (sd.kind == kSuffix) {
      add(k, 1);
      cv -= 1;
    } else if (sd.kind == kZero) {
      cz += 1;
    }
  };

  const int64_t base = static_cast<int64_t>(n) * num_px;
  if (vec) {
    const int64_t quads = num_px >> 2;
    const int64_t per = (quads + chunks - 1) / chunks;
    const int64_t end = (c + 1) * per < quads ? (c + 1) * per : quads;
    const float4* p4 = reinterpret_cast<const float4*>(pred + base);
    const float4* l4 = reinterpret_cast<const float4*>(label + base);
    const float4* d4 = reinterpret_cast<const float4*>(dl + base);
    const float4* u4 = reinterpret_cast<const float4*>(du + base);
    // each pass loads the next pass's 4 pixels before it searches its own
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int64_t q = c * per + threadIdx.x;
    float4 p = zero, l = zero, sl = zero, su = zero;
    if (q < end) p = __ldg(p4 + q), l = __ldg(l4 + q), sl = __ldg(d4 + q), su = __ldg(u4 + q);
    for (; q < end; q += kThreads) {
      const int64_t qn = q + kThreads;
      float4 pn = zero, ln = zero, sln = zero, sun = zero;
      if (qn < end)
        pn = __ldg(p4 + qn), ln = __ldg(l4 + qn), sln = __ldg(d4 + qn), sun = __ldg(u4 + qn);
      const Side sd[4] = {side_of(p.x, l.x, sl.x, su.x), side_of(p.y, l.y, sl.y, su.y),
                          side_of(p.z, l.z, sl.z, su.z), side_of(p.w, l.w, sl.w, su.w)};
      int k[4];
      search<4>(v, p2, sd, k);
#pragma unroll
      for (int i = 0; i < 4; ++i) record(sd[i], k[i]);
      p = pn, l = ln, sl = sln, su = sun;
    }
  } else {
    const int64_t per = (num_px + chunks - 1) / chunks;
    const int64_t end = (c + 1) * per < num_px ? (c + 1) * per : num_px;
    for (int64_t q = c * per + threadIdx.x; q < end; q += kThreads) {
      const Side sd[1] = {side_of(__ldg(pred + base + q), __ldg(label + base + q),
                                  __ldg(dl + base + q), __ldg(du + base + q))};
      int k[1];
      search<1>(v, p2, sd, k);
      record(sd[0], k[0]);
    }
  }

  // the register counts, once per warp
  c0 = __reduce_add_sync(0xffffffffu, c0);
  cv = __reduce_add_sync(0xffffffffu, cv);
  cz = __reduce_add_sync(0xffffffffu, cz);
  if ((threadIdx.x & 31) == 0) {
    if (c0) atomicAdd(bins, c0);
    if (cv) atomicAdd(bins + rg.lv, cv);
    if (cz) {
      atomicAdd(bins + rg.f0, cz);
      atomicAdd(bins + rg.f1, -cz);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i <= num_lam; i += kThreads) row[i] = bins[i];
  }

  // The example's last block to finish writes its row of the table.
  __shared__ int last;
  __threadfence();  // this thread's bins, before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + n, 1) == chunks - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    finish_example(part + static_cast<int64_t>(n) * chunks * (num_lam + 1), chunks, rank,
                   out + static_cast<int64_t>(n) * num_lam, num_px, num_lam);
  }
}

}  // namespace

// The power of two above num_lam: the sorted grid's length, NaN padded.
static int padded(int num_lam) {
  int p2 = 1;
  while (p2 <= num_lam) p2 <<= 1;
  return p2;
}

// Search blocks per example: kBlocksPerSm per SM in all (one wave where n
// allows), each with at least a pass of its threads over pixels; 0 with
// *err set on a failure. Once per device it also reads the SM count and
// sets the search's shared-memory limit.
static int64_t chunks_of(int n, long long num_px, int vec, int device, cudaError_t* err) {
  static int sms_of[64];
  *err = cudaSuccess;
  if (device < 0 || device >= 64 || n <= 0 || num_px <= 0) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  if (sms_of[device] == 0) {
    int sms = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (*err == cudaSuccess)
      *err = cudaFuncSetAttribute(search_kernel<true>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (*err != cudaSuccess) return 0;
    sms_of[device] = sms;
  }
  const int64_t units = vec ? num_px / 4 : num_px;
  const int64_t most = (units + kThreads - 1) / kThreads;
  int64_t chunks = static_cast<int64_t>(kBlocksPerSm) * sms_of[device] / n;
  if (chunks > most) chunks = most;
  return chunks < 1 ? 1 : chunks;
}

// The int32 scratch of a call, in elements (negative: minus a cudaError_t
// value): the (n) counts of finished search blocks, the sorted grid
// (padded(num_lam) floats' bits), the ranks (num_lam), and the search
// blocks' bins, (n, chunks, num_lam + 1).
extern "C" long long im2im_loss_table_scratch(int n, long long num_px, int num_lam, int vec,
                                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const int64_t chunks = chunks_of(n, num_px, vec, device, &err);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return n + padded(num_lam) + static_cast<long long>(num_lam) +
         n * chunks * (num_lam + 1LL);
}

// pred, label, dl, du: (n, num_px) f32 contiguous; lam: (num_lam,) f32;
// out: (n, num_lam) f32; scratch: im2im_loss_table_scratch(n, num_px,
// num_lam, vec, device) int32; vec: num_px % 4 == 0 and the maps 16-byte
// aligned. Returns a cudaError_t value (0 = ok).
extern "C" int im2im_loss_table(const void* pred, const void* label, const void* dl,
                                const void* du, const void* lam, void* out, void* scratch,
                                int n, long long num_px, int num_lam, int vec, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a bin counts at most num_px pixels in an int
  if (n <= 0 || num_px <= 0 || num_px > 0x7fffffff || num_lam <= 0 || num_lam > (1 << 29))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = chunks_of(n, num_px, vec, device, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunks * n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int p2 = padded(num_lam);
  int* done = static_cast<int*>(scratch);
  float* sorted = reinterpret_cast<float*>(done + n);
  int* rank = reinterpret_cast<int*>(sorted + p2);
  int* part = rank + num_lam;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  rank_kernel<<<(num_lam + kRankLams - 1) / kRankLams, kThreads, 0, s>>>(
      static_cast<const float*>(lam), sorted, rank, num_lam, p2, done, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const unsigned blocks = static_cast<unsigned>(chunks * n);
  const int64_t shared = static_cast<int64_t>(sizeof(int)) * (p2 + num_lam + 1);
  const float* args_p = static_cast<const float*>(pred);
  const float* args_l = static_cast<const float*>(label);
  const float* args_d = static_cast<const float*>(dl);
  const float* args_u = static_cast<const float*>(du);
  if (shared <= kMaxSharedBytes) {
    search_kernel<true><<<blocks, kThreads, static_cast<int>(shared), s>>>(
        args_p, args_l, args_d, args_u, sorted, part, rank, done, static_cast<float*>(out),
        num_px, num_lam, p2, static_cast<int>(chunks), vec);
  } else {
    search_kernel<false><<<blocks, kThreads, 0, s>>>(
        args_p, args_l, args_d, args_u, sorted, part, rank, done, static_cast<float*>(out),
        num_px, num_lam, p2, static_cast<int>(chunks), vec);
  }
  return static_cast<int>(cudaGetLastError());
}
