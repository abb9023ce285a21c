// Per-row symmetric quantize -> dequantize of the cut-layer wire, for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernels of src/repro/kernels/quant_exchange.py:
//   quant_dequant       (_quant_kernel)       -> qdq_kernel (rows up to 8,192
//                                                wide), wide_rowmax_kernel +
//                                                wide_qdq_rows_kernel (wider)
//   quant_dequant_stats (_quant_stats_kernel) -> qdq_stats_kernel (up to
//                                                8,192), the wide path (wider)
//
// What bounds them on this card: bytes, and in practice launches.  A
// cut-layer message on the main path is (B, d_c) = (64, 256) f32.  qdq reads
// 4*N*D bytes and writes 4*N*D + 4*N: 131,328 B, 0.04 us at 3.35 TB/s, far
// below the few microseconds a launch costs.  So the design spends nothing
// on bandwidth: one block per row, a loop over the columns with a masked
// tail (any D), the row's amax by warp shuffles plus shared memory.
//
// qdq_stats runs each message in ONE block: a message on the path is one
// batch (N = 64 rows), so the batch mean needs neither a second launch nor a
// cross-block reduction.  One launch takes M messages, one block each (the
// batched round sends R clusters' messages in one launch).  Pass 1
// quantizes each row as qdq does and accumulates the column sums in shared
// memory; each thread owns fixed columns, so every column sum is taken in
// row order.  Pass 2 reads the dequantized rows back and accumulates the
// distances to the mean and the norms.  Every reduction runs in a fixed
// order with no float atomics, so the bits repeat from run to run.
//
// The one block keeps its column sums in shared memory (4 bytes a column),
// so it takes messages up to 8,192 wide.  A wider message (an LM's cut
// activations: S * d_model = 512 * 4,096 = 2,097,152 columns at B = 4) takes
// the wide path, three launches behind one C call over a grid of
// (message, 2,048-column chunk):
//   1. wide_rowmax_kernel: one partial |x| max per (row, chunk);
//   2. wide_qdq_kernel: a block owns one chunk of one message and walks its
//      rows in order: the row's scale from its partial maxima (a max, exact
//      in any order, so the scales and deq are the one-block kernel's bits),
//      deq, the column sums in row order (8 columns a thread, in
//      registers), their mean, then per-(row, chunk) partials of
//      sum (v - mu)^2 and per-chunk partials of sum mu^2, sum min(v, 0)^2
//      and sum v^2;
//   3. wide_finish_kernel: one block per message sums each row's partials in
//      a fixed order, takes the square roots, sums them over the rows in
//      order and finishes [dispersion, support_residual] as qdq_stats_kernel
//      does.
// No float atomics, so reruns are bit-identical; the caller allocates the
// partials' scratch.  One block a row would leave an LM's four rows of 2 M
// columns on four SMs, so B2 takes kernels 1 and the quantize of 2 over the
// same grid for rows wider than 8,192 (two launches behind one C call).
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

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int kFmt>
__global__ void qdq_kernel(const float* __restrict__ x, float* __restrict__ deq,
                           float* __restrict__ scales, int d, float qinv) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const float* xr = x + row * d;
  float* dr = deq + row * d;
  float amax = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) amax = fmaxf(amax, fabsf(xr[j]));
  const float scale = row_scale(block_reduce<true>(amax, red), qinv);
  if (threadIdx.x == 0) scales[row] = scale;
  for (int j = threadIdx.x; j < d; j += blockDim.x) dr[j] = qdq<kFmt>(xr[j], scale);
}

// stats = [dispersion, support_residual] of the dequantized message, as
// core.split.message_stats defines them.
template <int kFmt>
__global__ void qdq_stats_kernel(const float* __restrict__ x, float* __restrict__ deq,
                                 float* __restrict__ scales, float* __restrict__ stats,
                                 int n, int d, float qinv) {
  extern __shared__ float colsum[];  // d floats; column j belongs to thread j % blockDim.x
  __shared__ float red[32];
  // this block's message
  const int64_t msg = blockIdx.x;
  x += msg * n * d;
  deq += msg * n * d;
  scales += msg * n;
  stats += msg * 2;
  for (int j = threadIdx.x; j < d; j += blockDim.x) colsum[j] = 0.f;

  // pass 1: quantize each row, column sums in row order
  for (int r = 0; r < n; ++r) {
    const float* xr = x + static_cast<int64_t>(r) * d;
    float* dr = deq + static_cast<int64_t>(r) * d;
    float amax = 0.f;
    for (int j = threadIdx.x; j < d; j += blockDim.x) amax = fmaxf(amax, fabsf(xr[j]));
    const float scale = row_scale(block_reduce<true>(amax, red), qinv);
    if (threadIdx.x == 0) scales[r] = scale;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float v = qdq<kFmt>(xr[j], scale);
      dr[j] = v;
      colsum[j] += v;
    }
  }

  // pass 2: mean, distances to it, norms.  A thread reads back only the
  // columns it wrote, so it needs no barrier before reading them.
  const float nt = static_cast<float>(n);
  float mu_sq = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float mu = __fdiv_rn(colsum[j], nt);
    colsum[j] = mu;
    mu_sq += mu * mu;
  }
  float dist_sum = 0.f;  // meaningful in thread 0
  float neg_sq = 0.f;
  float tot_sq = 0.f;
  for (int r = 0; r < n; ++r) {
    const float* dr = deq + static_cast<int64_t>(r) * d;
    float dev_sq = 0.f;
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      const float v = dr[j];
      const float dev = v - colsum[j];
      const float neg = fminf(v, 0.f);
      dev_sq += dev * dev;
      neg_sq += neg * neg;
      tot_sq += v * v;
    }
    dist_sum += sqrtf(block_reduce<false>(dev_sq, red));
  }
  mu_sq = block_reduce<false>(mu_sq, red);
  neg_sq = block_reduce<false>(neg_sq, red);
  tot_sq = block_reduce<false>(tot_sq, red);
  if (threadIdx.x == 0) {
    const float mu_norm = fmaxf(sqrtf(mu_sq), kEps);
    const float total = fmaxf(sqrtf(tot_sq), kEps);
    stats[0] = __fdiv_rn(__fdiv_rn(dist_sum, nt), mu_norm);
    stats[1] = __fdiv_rn(sqrtf(neg_sq), total);
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

// B2 on wide rows: one block per (chunk, row), the row's scale from its
// partial maxima (the same bits as qdq_kernel's), then the chunk's deq.
template <int kFmt>
__global__ void wide_qdq_rows_kernel(const float* __restrict__ x, float* __restrict__ deq,
                                     float* __restrict__ scales,
                                     const float* __restrict__ pmax, int rows, int d,
                                     int nchunks, float qinv) {
  __shared__ float red[32];
  const int chunk = blockIdx.x;
  const int c0 = chunk * kWideCols;
  const int c1 = min(d, c0 + kWideCols);
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* pr = pmax + row * nchunks;
    float amax = 0.f;
    for (int c = threadIdx.x; c < nchunks; c += blockDim.x) amax = fmaxf(amax, pr[c]);
    const float scale = row_scale(block_reduce<true>(amax, red), qinv);
    if (chunk == 0 && threadIdx.x == 0) scales[row] = scale;
    const float* xr = x + row * d;
    float* dr = deq + row * d;
    for (int j = c0 + threadIdx.x; j < c1; j += blockDim.x) dr[j] = qdq<kFmt>(xr[j], scale);
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
int launch_wide_qdq(const float* x, float* deq, float* scales, float* pmax, int n, int d,
                    float qinv, cudaStream_t s) {
  const int nchunks = (d + kWideCols - 1) / kWideCols;
  const dim3 grid(nchunks, n < 65535 ? n : 65535);
  wide_rowmax_kernel<<<grid, kWideThreads, 0, s>>>(x, pmax, n, d, nchunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_qdq_rows_kernel<kFmt><<<grid, kWideThreads, 0, s>>>(x, deq, scales, pmax, n, d, nchunks,
                                                           qinv);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int repro_quant_dequant(const float* x, float* deq, float* scales, int n,
                                   int d, int fmt, float qinv, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtInt8) {
    qdq_kernel<kFmtInt8><<<n, threads, 0, s>>>(x, deq, scales, d, qinv);
  } else if (fmt == kFmtFp8E4M3) {
    qdq_kernel<kFmtFp8E4M3><<<n, threads, 0, s>>>(x, deq, scales, d, qinv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_quant_dequant_stats(const float* x, float* deq, float* scales,
                                         float* stats, int m, int n, int d, int fmt,
                                         float qinv, int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  if (fmt == kFmtInt8) {
    qdq_stats_kernel<kFmtInt8><<<m, threads, smem, s>>>(x, deq, scales, stats, n, d, qinv);
  } else if (fmt == kFmtFp8E4M3) {
    qdq_stats_kernel<kFmtFp8E4M3><<<m, threads, smem, s>>>(x, deq, scales, stats, n, d, qinv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B2's wide path (rows wider than 8,192): two launches.  scratch holds
// N * ceil(D / 2,048) floats.
extern "C" int repro_quant_dequant_wide(const float* x, float* deq, float* scales,
                                        float* scratch, int n, int d, int fmt, float qinv,
                                        void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kFmtInt8) return launch_wide_qdq<kFmtInt8>(x, deq, scales, scratch, n, d, qinv, s);
  if (fmt == kFmtFp8E4M3) return launch_wide_qdq<kFmtFp8E4M3>(x, deq, scales, scratch, n, d,
                                                              qinv, s);
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
