// Handoff tamper check: [sum (ref - recv)^2, sum ref^2] per candidate, for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/tamper_check.py:
//   tamper_check_sums (_tamper_kernel) -> tamper_partial_kernel + tamper_finish_kernel
// One call takes all R candidates of a round, ref and recv (R, N*D) f32, and
// writes (R, 2): the counterpart of the reference's jax.vmap over candidates.
//
// What bounds it on this card: bytes.  Each element is read once from each
// input and costs three flops, so at the main path's (5, 3000, 256) it moves
// 2*R*N*D*4 = 30.72 MB: 9.17 us at 3.35 TB/s.  The design spends its effort
// on reading both inputs once, in wide loads, with enough blocks to cover
// the 132 SMs:
//
//   * pass 1: a grid of (P, R) blocks.  Block (p, r) reduces the fixed
//     contiguous chunk [p*kChunk, (p+1)*kChunk) of candidate r with 16-byte
//     loads where both inputs are 16-byte aligned there (a masked scalar
//     tail; any N*D) and writes its partial pair to a (R, P, 2) workspace;
//   * pass 2: one block per candidate sums its P partials.
//
// Determinism.  The accept decision compares the distance with tol = 1e-4,
// so the bits must repeat from run to run.  Every sum runs in a fixed order:
// each thread owns fixed elements, warps reduce by butterfly shuffles and
// the block combines its warps in warp order; there are no float atomics.
// The chunking depends on the shape alone.  On identical inputs every
// difference is exactly 0, so the numerator is exactly 0.0 in any order.
// The TPU kernel carried both sums across a sequential grid in VMEM and
// required N to divide by its block; Hopper's blocks share nothing, hence
// the second pass, and the masked tail removes the divisibility rule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps a block, both passes
constexpr int kVecPerThread = 8;              // float4 loads a thread a chunk
constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * 4 * kVecPerThread;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block in a fixed order, valid in thread 0.  `red` holds
// 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < (kThreads >> 5) ? red[lane] : 0.f;
  if (warp == 0) r = warp_sum(r);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
tamper_partial_kernel(const float* __restrict__ ref, const float* __restrict__ recv,
                      float* __restrict__ partial, int64_t n_elem, int p) {
  __shared__ float red_num[32];
  __shared__ float red_den[32];
  const int64_t cand = blockIdx.y;
  const float* a = ref + cand * n_elem;
  const float* b = recv + cand * n_elem;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = start + kChunk < n_elem ? start + kChunk : n_elem;

  float num = 0.f;
  float den = 0.f;
  int64_t scalar_from = start;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a + start) | reinterpret_cast<uintptr_t>(b + start)) & 15) == 0;
  if (aligned) {
    const int64_t nvec = (end - start) / 4;
    const float4* a4 = reinterpret_cast<const float4*>(a + start);
    const float4* b4 = reinterpret_cast<const float4*>(b + start);
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      const float4 x = a4[i];
      const float4 y = b4[i];
      const float dx = x.x - y.x, dy = x.y - y.y, dz = x.z - y.z, dw = x.w - y.w;
      num += dx * dx;
      num += dy * dy;
      num += dz * dz;
      num += dw * dw;
      den += x.x * x.x;
      den += x.y * x.y;
      den += x.z * x.z;
      den += x.w * x.w;
    }
    scalar_from = start + nvec * 4;
  }
  for (int64_t i = scalar_from + threadIdx.x; i < end; i += kThreads) {
    const float x = a[i];
    const float d = x - b[i];
    num += d * d;
    den += x * x;
  }
  num = block_sum(num, red_num);
  den = block_sum(den, red_den);
  if (threadIdx.x == 0) {
    float* out = partial + (cand * p + blockIdx.x) * 2;
    out[0] = num;
    out[1] = den;
  }
}

__global__ void __launch_bounds__(kThreads)
tamper_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int p) {
  __shared__ float red_num[32];
  __shared__ float red_den[32];
  const int64_t cand = blockIdx.x;
  const float* part = partial + cand * p * 2;
  float num = 0.f;
  float den = 0.f;
  for (int i = threadIdx.x; i < p; i += kThreads) {
    num += part[2 * i];
    den += part[2 * i + 1];
  }
  num = block_sum(num, red_num);
  den = block_sum(den, red_den);
  if (threadIdx.x == 0) {
    out[cand * 2] = num;
    out[cand * 2 + 1] = den;
  }
}

}  // namespace

// C interface.  Launches both passes on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller validates shapes, types
// and devices and allocates `partial` (r * p * 2 floats, p = the number of
// kChunk-element chunks of n_elem) and `out` (r * 2 floats).
extern "C" int repro_tamper_check_chunk() { return static_cast<int>(kChunk); }

extern "C" int repro_tamper_check_sums(const float* ref, const float* recv, float* partial,
                                       float* out, int r, long long n_elem, int p,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 0 || r > 65535 || n_elem <= 0 || p <= 0 ||
      static_cast<long long>(p) * kChunk < n_elem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tamper_partial_kernel<<<dim3(p, r), kThreads, 0, s>>>(ref, recv, partial, n_elem, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tamper_finish_kernel<<<r, kThreads, 0, s>>>(partial, out, p);
  return static_cast<int>(cudaGetLastError());
}
