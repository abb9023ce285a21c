// Per-row symmetric quantize -> dequantize of the cut-layer wire, for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernels of src/repro/kernels/quant_exchange.py:
//   quant_dequant       (_quant_kernel)       -> qdq_rows_kernel (rows up to
//                                                8,192 wide), qdq_wide_kernel
//                                                (wider: one cooperative launch)
//   quant_dequant_stats (_quant_stats_kernel) -> qdq_stats_kernel (up to
//                                                8,192 columns and 8,192 rows),
//                                                the wide path (wider, or more
//                                                rows)
//
// What bounds them on this card: bytes, and at the CNN's messages launches.
// A cut-layer message on the main path is (B, d_c) = (64, 256) f32 (the
// batched round's (320, 256)).  qdq reads 4*N*D bytes and writes 4*N*D +
// 4*N: 131,328 B, 0.04 us at 3.35 TB/s, far below the few microseconds a
// launch costs.  qdq_rows_kernel reads x once: rows up to 256 wide at one
// column a lane over 1 to 8 warps (each value is an IEEE division: the
// fewer a lane holds, the shorter its chain), wider ones over the block's 8
// warps at up to 32 values a lane (16-byte loads where D % 4 == 0), the
// row's values in registers from its |x| max (warp shuffles, and shared
// memory across a row's warps) to its quantize.  The LM round's
// (4, 2,097,152) (33.5 MB, 20 us of bytes) runs qdq_wide_kernel, one
// cooperative launch with one grid barrier between the partial maxima and
// the quantize, most of x kept in shared memory between the two passes
// (below).
//
// qdq_stats runs each message in ONE launch with no cross-launch state: a
// message on the path is one batch (N = 64 rows), so the batch mean needs
// neither a second launch nor a global reduction.  One launch takes M
// messages (the batched round sends R clusters' messages at once), one
// thread-block cluster of up to 8 blocks of 16 warps each.  The cluster cuts
// the message into col_blocks chunks of `segs` (1, 2 or 4) segments of 256
// columns and row_blocks chunks of about 8 rows (quantizing is the work: an
// IEEE division a value, so (64, 256) spreads over 8 SMs, one row a warp;
// 8,192 columns are 8 column chunks of 1,024).
//   * a warp owns rows warp, warp + 16, ... of its block's chunk: a lane
//     holds 8 of a segment's columns (two float4 loads where D % 4 == 0),
//     the row's |x| max is a shuffle butterfly (no block barrier per row),
//     and the first 32 / (8 * segs) of its rows stay in registers for pass
//     2 (every row at (64, 256); rows past that are read back from deq,
//     which the same lane wrote);
//   * with several column chunks the rows' partial maxima cross the cluster
//     through distributed shared memory (a max is exact in any order, so
//     the scales and deq are the reference's bits);
//   * each warp keeps its column sums in registers, in its rows' order; a
//     barrier, then the block's column sums in warp order; the means are the
//     row chunks' sums in rank order (a cluster barrier between), over N;
//   * after a barrier, each row's sum (v - mu)^2 over the block's columns
//     goes to shared memory by shuffles, and the block's sums of mu^2 (row
//     chunk 0 only), min(v, 0)^2 and v^2 by shuffles and warp order;
//   * column chunk 0 of each row chunk sums its rows' partials in chunk
//     order, takes the square roots and sums them in row order; rank 0 sums
//     the blocks' parts in rank order and finishes [dispersion,
//     support_residual].
// With one block that is three barriers (~256 in the one-block-a-message
// kernel this replaced); a cluster adds three cluster barriers.  No float
// atomics, so the bits repeat from run to run.
//
// A cluster holds at most 8 x 1,024 columns, and a block's shared memory
// two floats a row, so it takes messages up to 8,192 wide and 8,192 rows.  A
// wider message (an LM's cut activations: S * d_model = 512 * 4,096 =
// 2,097,152 columns at B = 4), or a taller one, takes
// the wide path, three launches behind one C call over a grid of
// (message, 2,048-column chunk):
//   1. wide_rowmax_kernel: one partial |x| max per (row, chunk);
//   2. wide_qdq_kernel: a block owns one chunk of one message and walks its
//      rows in order: the row's scale from its partial maxima (a max, exact
//      in any order, so the scales and deq are qdq_rows_kernel's bits),
//      deq, the column sums in row order (8 columns a thread, in
//      registers), their mean, then per-(row, chunk) partials of
//      sum (v - mu)^2 and per-chunk partials of sum mu^2, sum min(v, 0)^2
//      and sum v^2;
//   3. wide_finish_kernel: one block per message sums each row's partials in
//      a fixed order, takes the square roots, sums them over the rows in
//      order and finishes [dispersion, support_residual] as qdq_stats_kernel
//      does.
// No float atomics, so reruns are bit-identical; the caller allocates the
// partials' scratch.
//
// Bits.  deq and scales must equal the reference's bit for bit, so:
//   * scale = max(amax, 1e-12) * f32(1/qmax): under jit XLA rewrites the
//     reference's division by qmax into this multiply;
//   * a / scale is an IEEE division (__fdiv_rn; the file is built without
//     --use_fast_math);
//   * int8 rounds half to even (rintf) and clips to +-127; fp8 clips to
//     +-448 and converts with __nv_cvt_float_to_fp8(.., __NV_SATFINITE,
//     __NV_E4M3), which rounds to nearest even;
//   * the products are __fmul_rn, so nvcc cannot contract them into FMAs.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-12f;
constexpr int kFmtInt8 = 0;
constexpr int kFmtFp8E4M3 = 1;

// Butterfly reductions: every lane ends with the same bits, since IEEE
// addition and max are commutative.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max (of non-negative values) or sum in a fixed order; every
// thread gets the result.  blockDim.x is a multiple of 32; `red` holds 32
// floats and is free again when this returns.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? red[lane] : 0.f;
  r = kMax ? warp_max(r) : warp_sum(r);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float row_scale(float amax, float qinv) {
  return __fmul_rn(fmaxf(amax, kEps), qinv);
}

template <int kFmt>
__device__ __forceinline__ float qdq(float a, float scale) {
  float v = __fdiv_rn(a, scale);
  if (kFmt == kFmtInt8) {
    v = fminf(fmaxf(rintf(v), -127.f), 127.f);
  } else {
    v = fminf(fmaxf(v, -448.f), 448.f);
    const __nv_fp8_storage_t q = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
    v = __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E4M3)));
  }
  return __fmul_rn(v, scale);
}

// ---------------------------------------------------------------------------
// B2 up to 8,192 columns: a warp or a few warps a row, the row in registers
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;                 // 8 warps a block
constexpr int kRowVals = 32;                     // values a lane at most

// Lane `lane` of the row's warp `wr` (of `warps`) holds value i (< kVals) of
// the row at this column: with `vec` (D % 4 == 0, rows 16-byte aligned)
// values 4c .. 4c + 3 are one float4, the row's 4-column chunk (c * warps +
// wr) * 32 + lane; without, the lanes stride by one column.
__device__ __forceinline__ int row_col(int i, int wr, int warps, int lane, bool vec) {
  return vec ? (((i >> 2) * warps + wr) * 32 + lane) * 4 + (i & 3)
             : (i * warps + wr) * 32 + lane;
}

// A lane's kVals values of a row (0 past D), 16-byte loads with `vec` (kVals
// >= 4); and their quantized values written back the same way.
template <int kVals>
__device__ __forceinline__ void load_row(const float* row, int d, int wr, int warps, int lane,
                                         bool vec, float (&v)[kVals]) {
  if constexpr (kVals >= 4) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < kVals; i += 4) {
        const int c = row_col(i, wr, warps, lane, true);
        const float4 f = c < d ? *reinterpret_cast<const float4*>(row + c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[i] = f.x;
        v[i + 1] = f.y;
        v[i + 2] = f.z;
        v[i + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    const int c = row_col(i, wr, warps, lane, false);
    v[i] = c < d ? row[c] : 0.f;
  }
}

template <int kFmt, int kVals>
__device__ __forceinline__ void store_row(float* row, int d, int wr, int warps, int lane,
                                          bool vec, const float (&v)[kVals], float scale) {
  if constexpr (kVals >= 4) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < kVals; i += 4) {
        const int c = row_col(i, wr, warps, lane, true);
        if (c < d) {
          *reinterpret_cast<float4*>(row + c) =
              make_float4(qdq<kFmt>(v[i], scale), qdq<kFmt>(v[i + 1], scale),
                          qdq<kFmt>(v[i + 2], scale), qdq<kFmt>(v[i + 3], scale));
        }
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    const int c = row_col(i, wr, warps, lane, false);
    if (c < d) row[c] = qdq<kFmt>(v[i], scale);
  }
}

// Grid: ceil(N / (8 / warps)) blocks; warp w takes row blockIdx.x * (8 /
// warps) + w / warps with its `warps` - 1 neighbours.  x is read once: the
// row's values stay in registers between its max and its quantize.  kVals
// values a lane: 1 for rows up to 256 wide (the CNN's messages, which
// spread over 1 to 8 warps), else 32 over 8 warps (up to 8,192 columns),
// the values past D masked (no division issued for them).  Two counts, not
// one: the masked values' loads and maxima would lengthen every lane of the
// CNN's rows, and a count between would only shorten untimed widths.
template <int kFmt, int kVals>
__global__ void __launch_bounds__(kRowThreads)
qdq_rows_kernel(const float* __restrict__ x, float* __restrict__ deq,
                float* __restrict__ scales, int n, int d, float qinv, int warps,
                int vec_rows) {
  __shared__ float wmax[kRowThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int shift = __ffs(warps) - 1;            // warps is a power of two
  const int wr = warp & (warps - 1);
  const int64_t row = (static_cast<int64_t>(blockIdx.x) << (3 - shift)) + (warp >> shift);
  const bool live = row < n;
  float v[kVals];
  if (live) {
    load_row(x + row * d, d, wr, warps, lane, vec_rows != 0, v);
  } else {
#pragma unroll
    for (int i = 0; i < kVals; ++i) v[i] = 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kVals; ++i) amax = fmaxf(amax, fabsf(v[i]));
  amax = warp_max(amax);
  if (warps > 1) {                               // the same for the whole block
    if (lane == 0) wmax[warp] = amax;
    __syncthreads();
    amax = warp_max(lane < warps ? wmax[warp - wr + lane] : 0.f);
  }
  if (!live) return;
  const float scale = row_scale(amax, qinv);
  if (wr == 0 && lane == 0) scales[row] = scale;
  store_row<kFmt>(deq + row * d, d, wr, warps, lane, vec_rows != 0, v, scale);
}

template <int kFmt>
int launch_rows(const float* x, float* deq, float* scales, int n, int d, float qinv, int warps,
                int vals, int vec, cudaStream_t s) {
  const int rows = kRowThreads / 32 / warps;
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(n) + rows - 1) / rows);
  if (vals == 1) {
    qdq_rows_kernel<kFmt, 1><<<blocks, kRowThreads, 0, s>>>(x, deq, scales, n, d, qinv, warps,
                                                            vec);
  } else {
    qdq_rows_kernel<kFmt, kRowVals><<<blocks, kRowThreads, 0, s>>>(x, deq, scales, n, d, qinv,
                                                                   warps, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B3 up to 8,192 columns and rows: one cluster a message
// ---------------------------------------------------------------------------

constexpr int kStatsWarps = 16;
constexpr int kStatsThreads = kStatsWarps * 32;
constexpr int kSegCols = 256;                 // a warp-row segment: 8 columns a lane
constexpr int kSlots = kSegCols / 32;
constexpr int kMaxStatsBlocks = 8;            // blocks a cluster (the portable maximum)
constexpr int kMaxStatsRows = 8192;           // rows a block's shared arrays hold
constexpr int kCachedFloats = 32;             // registers a lane keeps of its rows

template <int kSegs> struct StatsCfg {
  static constexpr int kCols = kSegs * kSegCols;          // a block's columns
  static constexpr int kVals = kSegs * kSlots;            // a lane's values of a row
  static constexpr int kCache = kCachedFloats / kVals;    // rows a warp keeps in registers
  static constexpr int kSmem = (2 * kMaxStatsRows + (kStatsWarps + 1) * kCols) * 4;
};

// The column of a lane's value i (segment i / 8, slot i % 8) from the
// block's first column: with `vec`, slots 0-3 and 4-7 are two float4s 128
// columns apart; without, the lanes stride by one column.
__device__ __forceinline__ int stats_col(int i, int lane, bool vec) {
  const int seg = i / kSlots;
  const int k = i % kSlots;
  return seg * kSegCols + (vec ? (k >> 2) * 128 + lane * 4 + (k & 3) : k * 32 + lane);
}

// A lane's values of one row (0 past D).  With `vec`, D % 4 == 0 and the
// row is 16-byte aligned, so a float4 lies wholly inside or outside it.
template <int kVals>
__device__ __forceinline__ void load_vals(const float* row, int c0, int d, int lane, bool vec,
                                          float (&v)[kVals]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kVals; i += 4) {
      const int c = c0 + stats_col(i, lane, true);
      const float4 f = c < d ? *reinterpret_cast<const float4*>(row + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i] = f.x;
      v[i + 1] = f.y;
      v[i + 2] = f.z;
      v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int c = c0 + stats_col(i, lane, false);
      v[i] = c < d ? row[c] : 0.f;
    }
  }
}

template <int kVals>
__device__ __forceinline__ void store_vals(float* row, int c0, int d, int lane, bool vec,
                                           const float (&v)[kVals]) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < kVals; i += 4) {
      const int c = c0 + stats_col(i, lane, true);
      if (c < d) {
        *reinterpret_cast<float4*>(row + c) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      const int c = c0 + stats_col(i, lane, false);
      if (c < d) row[c] = v[i];
    }
  }
}

// stats = [dispersion, support_residual] of the dequantized message, as
// core.split.message_stats defines them.  Grid: M clusters of row_blocks x
// col_blocks blocks; block rank = row chunk * col_blocks + column chunk owns
// rows [row chunk * rows, + rows) and kCols columns from column chunk * kCols.
template <int kFmt, int kSegs>
__global__ void __launch_bounds__(kStatsThreads)
qdq_stats_kernel(const float* __restrict__ x, float* __restrict__ deq,
                 float* __restrict__ scales, float* __restrict__ stats, int n, int d,
                 float qinv, int col_blocks, int rows, int vec_rows) {
  using C = StatsCfg<kSegs>;
  extern __shared__ float sm[];
  float* pmax = sm;                  // rows: |x| maxima over this block's columns
  float* pdev = pmax + rows;         // rows: sum (v - mu)^2 over them; then distances
  float* colp = pdev + rows;         // 16 x kCols: each warp's column sums; row 0 the means
  float* bsum = colp + kStatsWarps * C::kCols;   // kCols: the block's column sums
  __shared__ float red[3][kStatsWarps];   // each warp's sums of mu^2, min(v, 0)^2, v^2
  __shared__ __align__(16) float part[4]; // the block's: those three, its rows' distances

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int row_blocks = blocks / col_blocks;
  const int crank = rank % col_blocks;
  const int rrank = rank / col_blocks;
  const int64_t msg = blockIdx.x / blocks;
  x += msg * n * d;
  deq += msg * n * d;
  scales += msg * n;
  stats += msg * 2;
  const int r0 = rrank * rows;                       // this block's first row
  const int nr = min(n - r0, rows);                  // and its number of rows
  const int c0 = crank * C::kCols;
  const bool vec = vec_rows != 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int uncached = warp + C::kCache * kStatsWarps;   // this warp's first row read back

  float cache[C::kCache][C::kVals];
  float colsum[C::kVals];
#pragma unroll
  for (int i = 0; i < C::kVals; ++i) colsum[i] = 0.f;

  // pass 1a: local rows warp, warp + 16, ...: their |x| maxima over this
  // block's columns
  auto row_max = [&](int i, float (&v)[C::kVals]) {
    load_vals(x + static_cast<int64_t>(r0 + i) * d, c0, d, lane, vec, v);
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < C::kVals; ++j) a = fmaxf(a, fabsf(v[j]));
    a = warp_max(a);
    if (lane == 0) pmax[i] = a;
  };
#pragma unroll
  for (int i = 0; i < C::kCache; ++i) {
    if (warp + i * kStatsWarps < nr) row_max(warp + i * kStatsWarps, cache[i]);
  }
  for (int i = uncached; i < nr; i += kStatsWarps) {
    float v[C::kVals];
    row_max(i, v);
  }
  if (col_blocks > 1) {
    cluster.sync();            // the row chunk's partial maxima are visible
  } else {
    __syncwarp();              // a warp reads back only its own rows' maxima
  }

  // pass 1b: scale, quantize -> dequantize, deq out, column sums in row order
  auto row_qdq = [&](int i, float (&v)[C::kVals], bool cached) {
    float a;
    if (col_blocks > 1) {
      a = warp_max(lane < col_blocks ? cluster.map_shared_rank(pmax, rrank * col_blocks + lane)[i]
                                     : 0.f);
    } else {
      a = pmax[i];
    }
    const float scale = row_scale(a, qinv);
    if (crank == 0 && lane == 0) scales[r0 + i] = scale;
    if (!cached) load_vals(x + static_cast<int64_t>(r0 + i) * d, c0, d, lane, vec, v);
#pragma unroll
    for (int j = 0; j < C::kVals; ++j) {
      v[j] = qdq<kFmt>(v[j], scale);
      colsum[j] += v[j];
    }
    store_vals(deq + static_cast<int64_t>(r0 + i) * d, c0, d, lane, vec, v);
  };
#pragma unroll
  for (int i = 0; i < C::kCache; ++i) {
    if (warp + i * kStatsWarps < nr) row_qdq(warp + i * kStatsWarps, cache[i], true);
  }
  for (int i = uncached; i < nr; i += kStatsWarps) {
    float v[C::kVals];
    row_qdq(i, v, false);
  }
#pragma unroll
  for (int j = 0; j < C::kVals; ++j) colp[warp * C::kCols + stats_col(j, lane, vec)] = colsum[j];
  __syncthreads();

  // the block's column sums in warp order; the means from the row chunks'
  // sums in rank order (a thread reads back only its own columns' sums
  // when the block is the column chunk's only one)
  for (int c = tid; c < C::kCols; c += kStatsThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kStatsWarps; ++w) sum += colp[w * C::kCols + c];
    bsum[c] = sum;
  }
  if (row_blocks > 1) cluster.sync();  // every block's column sums are visible
  const float nt = static_cast<float>(n);
  float mu_sq = 0.f;                   // each column counted by row chunk 0 only
  for (int c = tid; c < C::kCols; c += kStatsThreads) {
    float peer[kMaxStatsBlocks];
#pragma unroll
    for (int q = 0; q < kMaxStatsBlocks; ++q) {
      peer[q] = q >= row_blocks ? 0.f
                : q == rrank    ? bsum[c]
                                : cluster.map_shared_rank(bsum, q * col_blocks + crank)[c];
    }
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxStatsBlocks; ++q) {
      if (q < row_blocks) sum += peer[q];
    }
    const float mu = __fdiv_rn(sum, nt);   // 0 past D
    colp[c] = mu;
    if (rrank == 0) mu_sq += mu * mu;
  }
  __syncthreads();

  // pass 2: each row's sum (v - mu)^2 over this block's columns; the norms
  float neg_sq = 0.f;
  float tot_sq = 0.f;
  auto row_dev = [&](int i, const float (&v)[C::kVals]) {
    float dev_sq = 0.f;
#pragma unroll
    for (int j = 0; j < C::kVals; ++j) {
      const float dev = v[j] - colp[stats_col(j, lane, vec)];
      const float neg = fminf(v[j], 0.f);
      dev_sq += dev * dev;
      neg_sq += neg * neg;
      tot_sq += v[j] * v[j];
    }
    dev_sq = warp_sum(dev_sq);
    if (lane == 0) pdev[i] = dev_sq;
  };
#pragma unroll
  for (int i = 0; i < C::kCache; ++i) {
    if (warp + i * kStatsWarps < nr) row_dev(warp + i * kStatsWarps, cache[i]);
  }
  for (int i = uncached; i < nr; i += kStatsWarps) {
    float v[C::kVals];
    load_vals(deq + static_cast<int64_t>(r0 + i) * d, c0, d, lane, vec, v);   // own writes
    row_dev(i, v);
  }
  mu_sq = warp_sum(mu_sq);
  neg_sq = warp_sum(neg_sq);
  tot_sq = warp_sum(tot_sq);
  if (lane == 0) {
    red[0][warp] = mu_sq;
    red[1][warp] = neg_sq;
    red[2][warp] = tot_sq;
  }
  if (col_blocks > 1) {
    cluster.sync();            // the row chunk's distance partials are visible
  } else {
    __syncthreads();
  }

  // the block's part: its warps' sums in warp order; column chunk 0 also
  // its rows' distances (partials in column-chunk order), summed in row order
  if (warp == 0) {
    if (crank == 0) {
      for (int i = lane; i < nr; i += 32) {
        float dev_sq = 0.f;
        for (int c = 0; c < col_blocks; ++c) {
          dev_sq += c == 0 ? pdev[i] : cluster.map_shared_rank(pdev, rrank * col_blocks + c)[i];
        }
        pdev[i] = sqrtf(dev_sq);
      }
    }
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kStatsWarps; ++w) sum += red[k][w];
        part[k] = sum;
      }
      float dist = 0.f;
      if (crank == 0) {
        for (int i = 0; i < nr; ++i) dist += pdev[i];
      }
      part[3] = dist;
    }
  }
  if (blocks > 1) cluster.sync();    // every block's part is visible

  // rank 0 finishes: the parts in rank order
  if (rank == 0 && tid == 0) {
    float peer[kMaxStatsBlocks][4];    // every load issued before the sums
#pragma unroll
    for (int p = 0; p < kMaxStatsBlocks; ++p) {
      if (p < blocks) {
        const float4 pp = *reinterpret_cast<const float4*>(
            p == 0 ? part : cluster.map_shared_rank(part, p));
        peer[p][0] = pp.x;
        peer[p][1] = pp.y;
        peer[p][2] = pp.z;
        peer[p][3] = pp.w;
      }
    }
    float sums[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < kMaxStatsBlocks; ++p) {
      if (p < blocks) {
#pragma unroll
        for (int k = 0; k < 4; ++k) sums[k] += peer[p][k];
      }
    }
    const float mu_norm = fmaxf(sqrtf(sums[0]), kEps);
    const float total = fmaxf(sqrtf(sums[2]), kEps);
    stats[0] = __fdiv_rn(__fdiv_rn(sums[3], nt), mu_norm);
    stats[1] = __fdiv_rn(sqrtf(sums[1]), total);
  }
  if (blocks > 1) cluster.sync();    // no block leaves while a peer reads its shared memory
}

template <int kFmt, int kSegs>
int launch_stats(const float* x, float* deq, float* scales, float* stats, int m, int n, int d,
                 float qinv, int row_blocks, int col_blocks, int rows, int vec,
                 cudaStream_t s) {
  auto kernel = qdq_stats_kernel<kFmt, kSegs>;
  // raise the shared-memory cap once, on the first call (before any
  // CUDA-graph capture of the launch), to what the largest message takes
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, StatsCfg<kSegs>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int blocks = row_blocks * col_blocks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m) * blocks, 1, 1);
  cfg.blockDim = dim3(kStatsThreads, 1, 1);
  cfg.dynamicSmemBytes =
      (2 * rows + (kStatsWarps + 1) * StatsCfg<kSegs>::kCols) * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, deq, scales, stats, n, d, qinv,
                                             col_blocks, rows, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int kFmt>
int dispatch_stats(const float* x, float* deq, float* scales, float* stats, int m, int n,
                   int d, float qinv, int row_blocks, int col_blocks, int segs, int rows,
                   int vec, cudaStream_t s) {
  switch (segs) {
    case 1: return launch_stats<kFmt, 1>(x, deq, scales, stats, m, n, d, qinv, row_blocks,
                                         col_blocks, rows, vec, s);
    case 2: return launch_stats<kFmt, 2>(x, deq, scales, stats, m, n, d, qinv, row_blocks,
                                         col_blocks, rows, vec, s);
    case 4: return launch_stats<kFmt, 4>(x, deq, scales, stats, m, n, d, qinv, row_blocks,
                                         col_blocks, rows, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// the wide paths (D > the one-block kernels' 8,192 columns)
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;
constexpr int kWideCols = 2048;                      // columns a chunk
constexpr int kWidePer = kWideCols / kWideThreads;   // columns a thread

// pmax[row, chunk] = max |x[row, chunk's columns]| over all M * N rows.
__global__ void wide_rowmax_kernel(const float* __restrict__ x, float* __restrict__ pmax,
                                   int rows, int d, int nchunks) {
  __shared__ float red[32];
  const int chunk = blockIdx.x;
  const int c0 = chunk * kWideCols;
  const int c1 = min(d, c0 + kWideCols);
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* xr = x + row * d;
    float amax = 0.f;
    for (int j = c0 + threadIdx.x; j < c1; j += blockDim.x) amax = fmaxf(amax, fabsf(xr[j]));
    amax = block_reduce<true>(amax, red);
    if (threadIdx.x == 0) pmax[row * nchunks + chunk] = amax;
  }
}

// B2 on wide rows: ONE cooperative launch.  The message is cut into tiles
// of kTileCols columns of one row (tile j = row j / tpr, columns from (j %
// tpr) * kTileCols), and block b walks tiles [b * per, + per).  Pass 1
// copies the block's first kKeptTiles tiles into shared memory with
// cp.async, all issued at once (224 KB in flight an SM: the copy runs at the
// memory's rate), reads any further tile into registers meanwhile, and
// writes each tile's warps' |x| maxima to `pmax` (a thread reads back only
// what it copied: no block barrier); one grid barrier; pass 2 takes each
// row's max from its tiles' partial maxima (a max, exact in any order:
// qdq_rows_kernel's bits), quantizes the kept tiles from shared memory and
// the rest read again from x, and writes deq.  At (4, 2,097,152): 1,024
// tiles over 128 blocks, 7 of a block's 8 kept (29 MB of the 33.5 MB).
constexpr int kTileWarps = 32;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kTileVals = 8;                             // values a thread of a tile
constexpr int kTileCols = 8192;
static_assert(kTileCols == kTileThreads * kTileVals, "a tile is one value set of the block");
constexpr int kKeptTiles = 7;                            // 224 KB of shared memory

// A tile is a row segment that the block's 32 warps hold as qdq_rows_kernel
// holds a row (row_col with 32 warps: value i of thread tid at column i *
// 1,024 + tid, or element i % 4 of float4 (i / 4) * 1,024 + tid with
// `vec`).  Shared memory keeps it at float (k * 8 + i) * 1,024 + tid of
// kept tile k without `vec`, with `vec` at float ((k * 2 + i / 4) * 1,024 +
// tid) * 4 + i % 4 (a thread's float4s whole).
__device__ __forceinline__ int kept_at(int k, int i, int tid, bool vec) {
  return vec ? ((k * 2 + i / 4) * kTileThreads + tid) * 4 + i % 4
             : (k * kTileVals + i) * kTileThreads + tid;
}

// cp.async of `bytes` (4 or 16) from src, zeros past the row (src_bytes 0)
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool in, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 4 : 0) : "memory");
  }
}

template <int kFmt>
__global__ void __launch_bounds__(kTileThreads, 1)
qdq_wide_kernel(const float* __restrict__ x, float* __restrict__ deq,
                float* __restrict__ scales, float* __restrict__ pmax,
                unsigned int* __restrict__ arrived, int d, int tpr, int tiles, int per,
                float qinv, int vec_rows) {
  extern __shared__ float4 kept4[];                // kKeptTiles tiles, laid out by kept_at
  float* kept = reinterpret_cast<float*>(kept4);
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool vec = vec_rows != 0;
  const int j0 = blockIdx.x * per;
  const int j1 = min(tiles, j0 + per);
  const int n_kept = min(j1 - j0, kKeptTiles);
  auto tile_max = [&](int j, const float (&v)[kTileVals]) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < kTileVals; ++i) a = fmaxf(a, fabsf(v[i]));
    a = warp_max(a);
    if (lane == 0) pmax[static_cast<int64_t>(j) * kTileWarps + warp] = a;
  };

  // pass 1: the kept tiles' copies all in flight, the rest read meanwhile
  for (int k = 0; k < n_kept; ++k) {
    const int64_t row = (j0 + k) / tpr;
    const int c0 = static_cast<int>(j0 + k - row * tpr) * kTileCols;
    const float* xr = x + row * d;
    if (vec) {
#pragma unroll
      for (int i = 0; i < kTileVals; i += 4) {
        const int c = c0 + row_col(i, warp, kTileWarps, lane, true);
        cp_async(kept + kept_at(k, i, tid, true), xr + (c < d ? c : 0), c < d, 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTileVals; ++i) {
        const int c = c0 + row_col(i, warp, kTileWarps, lane, false);
        cp_async(kept + kept_at(k, i, tid, false), xr + (c < d ? c : 0), c < d, 4);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = j0 + n_kept; j < j1; ++j) {
    const int64_t row = j / tpr;
    const int c0 = static_cast<int>(j - row * tpr) * kTileCols;
    float v[kTileVals];
    load_row(x + row * d + c0, d - c0, warp, kTileWarps, lane, vec, v);
    tile_max(j, v);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  for (int k = 0; k < n_kept; ++k) {
    float v[kTileVals];
#pragma unroll
    for (int i = 0; i < kTileVals; ++i) v[i] = kept[kept_at(k, i, tid, vec)];
    tile_max(j0 + k, v);
  }
  grid_sync::barrier(arrived, gridDim.x);

  int64_t cached = -1;
  float scale = 0.f;
  for (int j = j0; j < j1; ++j) {
    const int64_t row = j / tpr;
    if (row != cached) {                           // the same for the whole block
      const float* pr = pmax + row * tpr * kTileWarps;
      float a = 0.f;
      for (int c = tid; c < tpr * kTileWarps; c += kTileThreads) a = fmaxf(a, __ldcg(pr + c));
      scale = row_scale(block_reduce<true>(a, red), qinv);
      cached = row;
    }
    const int c0 = static_cast<int>(j - row * tpr) * kTileCols;
    if (c0 == 0 && tid == 0) scales[row] = scale;
    float v[kTileVals];
    if (j - j0 < kKeptTiles) {
#pragma unroll
      for (int i = 0; i < kTileVals; ++i) v[i] = kept[kept_at(j - j0, i, tid, vec)];
    } else {
      load_row(x + row * d + c0, d - c0, warp, kTileWarps, lane, vec, v);
    }
    store_row<kFmt>(deq + row * d + c0, d - c0, warp, kTileWarps, lane, vec, v, scale);
  }
}

// One block per (chunk, message): deq and scales of the chunk's columns,
// pdev[msg, row, chunk] = sum (v - mu)^2, pchunk[msg, chunk] = (sum mu^2,
// sum min(v, 0)^2, sum v^2).
template <int kFmt>
__global__ void wide_qdq_kernel(const float* __restrict__ x, float* __restrict__ deq,
                                float* __restrict__ scales, const float* __restrict__ pmax,
                                float* __restrict__ pdev, float* __restrict__ pchunk, int n,
                                int d, int nchunks, float qinv) {
  __shared__ float red[32];
  const int chunk = blockIdx.x;
  const int64_t msg = blockIdx.y;
  x += msg * n * d;
  deq += msg * n * d;
  scales += msg * n;
  pmax += msg * n * nchunks;
  pdev += msg * n * nchunks;
  pchunk += (msg * nchunks + chunk) * 3;
  const int c0 = chunk * kWideCols + threadIdx.x;

  float col[kWidePer];
#pragma unroll
  for (int k = 0; k < kWidePer; ++k) col[k] = 0.f;
  for (int r = 0; r < n; ++r) {
    const float* pr = pmax + static_cast<int64_t>(r) * nchunks;
    float amax = 0.f;
    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) amax = fmaxf(amax, pr[c]);
    const float scale = row_scale(block_reduce<true>(amax, red), qinv);
    if (chunk == 0 && threadIdx.x == 0) scales[r] = scale;
    const float* xr = x + static_cast<int64_t>(r) * d;
    float* dr = deq + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int k = 0; k < kWidePer; ++k) {
      const int j = c0 + k * kWideThreads;
      if (j < d) {
        const float v = qdq<kFmt>(xr[j], scale);
        dr[j] = v;
        col[k] += v;
      }
    }
  }

  // the column means; then the rows read back (a thread reads only the
  // columns it wrote, so no barrier)
  const float nt = static_cast<float>(n);
  float mu_sq = 0.f;
#pragma unroll
  for (int k = 0; k < kWidePer; ++k) {
    if (c0 + k * kWideThreads < d) {
      col[k] = __fdiv_rn(col[k], nt);
      mu_sq += col[k] * col[k];
    }
  }
  float neg_sq = 0.f;
  float tot_sq = 0.f;
  for (int r = 0; r < n; ++r) {
    const float* dr = deq + static_cast<int64_t>(r) * d;
    float dev_sq = 0.f;
#pragma unroll
    for (int k = 0; k < kWidePer; ++k) {
      const int j = c0 + k * kWideThreads;
      if (j < d) {
        const float v = dr[j];
        const float dev = v - col[k];
        const float neg = fminf(v, 0.f);
        dev_sq += dev * dev;
        neg_sq += neg * neg;
        tot_sq += v * v;
      }
    }
    dev_sq = block_reduce<false>(dev_sq, red);
    if (threadIdx.x == 0) pdev[static_cast<int64_t>(r) * nchunks + chunk] = dev_sq;
  }
  mu_sq = block_reduce<false>(mu_sq, red);
  neg_sq = block_reduce<false>(neg_sq, red);
  tot_sq = block_reduce<false>(tot_sq, red);
  if (threadIdx.x == 0) {
    pchunk[0] = mu_sq;
    pchunk[1] = neg_sq;
    pchunk[2] = tot_sq;
  }
}

// One block per message: each row's partials summed in a fixed order (a
// thread takes chunks tid, tid + 256, ..., then the block's fixed tree),
// the square roots summed over the rows in order, and the finish.
__global__ void wide_finish_kernel(const float* __restrict__ pdev,
                                   const float* __restrict__ pchunk, float* __restrict__ stats,
                                   int n, int nchunks) {
  __shared__ float red[32];
  const int64_t msg = blockIdx.x;
  pdev += msg * n * nchunks;
  pchunk += msg * nchunks * 3;
  float dist_sum = 0.f;  // meaningful in thread 0
  for (int r = 0; r < n; ++r) {
    const float* pr = pdev + static_cast<int64_t>(r) * nchunks;
    float dev_sq = 0.f;
    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) dev_sq += pr[c];
    dist_sum += sqrtf(block_reduce<false>(dev_sq, red));
  }
  float mu_sq = 0.f, neg_sq = 0.f, tot_sq = 0.f;
  for (int c = threadIdx.x; c < nchunks; c += blockDim.x) {
    mu_sq += pchunk[3 * c];
    neg_sq += pchunk[3 * c + 1];
    tot_sq += pchunk[3 * c + 2];
  }
  mu_sq = block_reduce<false>(mu_sq, red);
  neg_sq = block_reduce<false>(neg_sq, red);
  tot_sq = block_reduce<false>(tot_sq, red);
  if (threadIdx.x == 0) {
    const float nt = static_cast<float>(n);
    const float mu_norm = fmaxf(sqrtf(mu_sq), kEps);
    const float total = fmaxf(sqrtf(tot_sq), kEps);
    stats[msg * 2] = __fdiv_rn(__fdiv_rn(dist_sum, nt), mu_norm);
    stats[msg * 2 + 1] = __fdiv_rn(sqrtf(neg_sq), total);
  }
}

template <int kFmt>
int launch_qdq_wide(const float* x, float* deq, float* scales, float* scratch, int n, int d,
                    int per, float qinv, int vec, cudaStream_t s) {
  auto kernel = qdq_wide_kernel<kFmt>;
  constexpr size_t kSmem = static_cast<size_t>(kKeptTiles) * kTileCols * sizeof(float);
  // raise the shared-memory cap once, before any CUDA-graph capture
  static bool configured = false;
  cudaError_t err = cudaSuccess;
  if (!configured) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tpr = (d + kTileCols - 1) / kTileCols;
  const int64_t tiles = static_cast<int64_t>(n) * tpr;
  if (tiles > 0x7fffffff / kTileWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((tiles + per - 1) / per);
  unsigned int* arrived = reinterpret_cast<unsigned int*>(scratch + tiles * kTileWarps);
  return static_cast<int>(grid_sync::launch(kernel, blocks, kTileThreads, kSmem, s, arrived, x,
                                            deq, scales, scratch, arrived, d, tpr,
                                            static_cast<int>(tiles), per, qinv, vec));
}

template <int kFmt>
int launch_wide(const float* x, float* deq, float* scales, float* stats, float* scratch, int m,
                int n, int d, float qinv, cudaStream_t s) {
  const int nchunks = (d + kWideCols - 1) / kWideCols;
  const int64_t rows = static_cast<int64_t>(m) * n;
  float* pmax = scratch;
  float* pdev = pmax + rows * nchunks;
  float* pchunk = pdev + rows * nchunks;
  const int grid_rows = static_cast<int>(rows < 65535 ? rows : 65535);
  wide_rowmax_kernel<<<dim3(nchunks, grid_rows), kWideThreads, 0, s>>>(
      x, pmax, static_cast<int>(rows), d, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_qdq_kernel<kFmt><<<dim3(nchunks, m), kWideThreads, 0, s>>>(
      x, deq, scales, pmax, pdev, pchunk, n, d, nchunks, qinv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_finish_kernel<<<m, kWideThreads, 0, s>>>(pdev, pchunk, stats, n, nchunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface.  Each function launches on `stream` and returns
// cudaGetLastError() (0 = launched); the caller validates shapes, types and
// devices and allocates every output.

// B2 up to 8,192 columns: `warps` (1, 2, 4 or 8) warps a row, `vals` (1, or
// 32 with 8 warps) values a lane, warps * vals * 32 >= D (the caller's
// layout); `vec` (only with 32 values) = D % 4 == 0 and x 16-byte aligned.
extern "C" int repro_quant_dequant(const float* x, float* deq, float* scales, int n, int d,
                                   int fmt, float qinv, int warps, int vals, int vec,
                                   void* stream) {
  if (n <= 0 || d <= 0 || (warps != 1 && warps != 2 && warps != 4 && warps != 8) ||
      (vals != 1 && (vals != kRowVals || warps != 8)) || (vec && vals == 1) ||
      warps * vals * 32 < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtInt8) {
    return launch_rows<kFmtInt8>(x, deq, scales, n, d, qinv, warps, vals, vec, s);
  }
  if (fmt == kFmtFp8E4M3) {
    return launch_rows<kFmtFp8E4M3>(x, deq, scales, n, d, qinv, warps, vals, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0..8] <- kSegCols, kMaxStatsBlocks, kStatsWarps, kMaxStatsRows (the
// stats kernel's layout), kRowThreads, kRowVals (B2's row layout),
// kTileCols, kTileWarps, kKeptTiles (B2's wide tiles): the constants of
// which quant_exchange.py's layout policies keep copies and check them
// against these on first use.
extern "C" int repro_quant_exchange_constants(int* out) {
  out[0] = kSegCols;
  out[1] = kMaxStatsBlocks;
  out[2] = kStatsWarps;
  out[3] = kMaxStatsRows;
  out[4] = kRowThreads;
  out[5] = kRowVals;
  out[6] = kTileCols;
  out[7] = kTileWarps;
  out[8] = kKeptTiles;
  return 0;
}

// B3 up to 8,192 columns and rows: M messages, each a cluster of row_blocks
// x col_blocks blocks (the caller's layout: col_blocks chunks of `segs`
// 256-column segments, row_blocks chunks of `rows` rows, at most 8 blocks),
// `vec` = D % 4 == 0 and x 16-byte aligned.
extern "C" int repro_quant_dequant_stats(const float* x, float* deq, float* scales,
                                         float* stats, int m, int n, int d, int fmt,
                                         float qinv, int row_blocks, int col_blocks, int segs,
                                         int rows, int vec, void* stream) {
  const int64_t cols = static_cast<int64_t>(segs) * kSegCols;
  const int64_t blocks = static_cast<int64_t>(row_blocks) * col_blocks;
  if (m <= 0 || n <= 0 || d <= 0 || row_blocks <= 0 || col_blocks <= 0 ||
      blocks > kMaxStatsBlocks || rows <= 0 || rows > kMaxStatsRows ||
      static_cast<int64_t>(m) * blocks > 0x7fffffff ||
      static_cast<int64_t>(row_blocks) * rows < n ||
      static_cast<int64_t>(row_blocks - 1) * rows >= n || col_blocks * cols < d ||
      (col_blocks - 1) * cols >= d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtInt8) {
    return dispatch_stats<kFmtInt8>(x, deq, scales, stats, m, n, d, qinv, row_blocks,
                                    col_blocks, segs, rows, vec, s);
  }
  if (fmt == kFmtFp8E4M3) {
    return dispatch_stats<kFmtFp8E4M3>(x, deq, scales, stats, m, n, d, qinv, row_blocks,
                                       col_blocks, segs, rows, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// B2's wide path (rows wider than 8,192): a memset of the barrier's
// counter and one cooperative launch of ceil(N * ceil(D / 8,192) / per)
// blocks, which must fit the card at once (else
// cudaErrorCooperativeLaunchTooLarge).  scratch holds N * ceil(D / 8,192)
// * 32 floats of partial maxima, then the 4-byte counter.
extern "C" int repro_quant_dequant_wide(const float* x, float* deq, float* scales,
                                        float* scratch, int n, int d, int fmt, float qinv,
                                        int per, int vec, void* stream) {
  if (n <= 0 || d <= 0 || per <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtInt8) {
    return launch_qdq_wide<kFmtInt8>(x, deq, scales, scratch, n, d, per, qinv, vec, s);
  }
  if (fmt == kFmtFp8E4M3) {
    return launch_qdq_wide<kFmtFp8E4M3>(x, deq, scales, scratch, n, d, per, qinv, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// B3's wide path (D > 8,192): three launches.  scratch holds
// (2 * M * N + 3 * M) * ceil(D / 2,048) floats; m <= 65,535.
extern "C" int repro_quant_dequant_stats_wide(const float* x, float* deq, float* scales,
                                              float* stats, float* scratch, int m, int n,
                                              int d, int fmt, float qinv, void* stream) {
  if (m <= 0 || m > 65535 || n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtInt8) return launch_wide<kFmtInt8>(x, deq, scales, stats, scratch, m, n, d,
                                                    qinv, s);
  if (fmt == kFmtFp8E4M3) return launch_wide<kFmtFp8E4M3>(x, deq, scales, stats, scratch, m,
                                                          n, d, qinv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
