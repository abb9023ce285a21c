// Handoff tamper check: [sum (ref - recv)^2, sum ref^2] per candidate, and
// the relative distance sqrt(num) / max(sqrt(den), 1e-12) with its verdict
// (distance <= tol; tol = inf when only the distance is wanted), for Hopper
// (sm_90a), in ONE launch, bound to Python through a plain C interface
// (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/tamper_check.py:
//   tamper_check_sums (_tamper_kernel) -> tamper_check_kernel
// and the distance that src/repro/kernels/ops.py::tamper_distance takes of
// its sums.  One call takes all R candidates of a round, ref and recv
// (R, N*D) f32: the counterpart of the reference's jax.vmap over candidates.
//
// What bounds it on this card: bytes.  Each element costs three flops, so
// at the main path's (5, 3000, 256) two distinct inputs move 30.72 MB: 9.17
// us at 3.35 TB/s.  The path's only call, the fused round's verify stage,
// holds the validation activations against themselves (the reference's
// recompute=False), so there the kernel reads ONE 15.36 MB buffer: 4.58 us.
// The design:
//
//   * the grid is sized to the card: P blocks a candidate with P * R a
//     multiple of the SM count (and at least 4 blocks an SM), so every SM
//     streams the same number of bytes; tamper_check.py::tamper_layout
//     chooses P and the chunk (a multiple of 4 elements) and the launcher
//     checks its constants against this library's;
//   * each thread issues all kUnroll 16-byte loads of a group, of both
//     inputs, before its FMAs, through the read-only path (ld.global.nc:
//     the data is read once; an explicit L1::no_allocate hint ran no
//     faster on the card); a masked scalar loop takes the tail and any base
//     that is not 16-byte aligned (any N*D);
//   * the aliased route (ref and recv the same storage) loads each vector
//     once and still forms d = x - x in registers, so an inf or NaN gives a
//     NaN numerator exactly as the reference and the plain version do;
//   * the launch finishes itself: each block writes its (num, den) partial
//     and takes a ticket with release semantics (an integer atom.inc, which
//     the last block wraps back to 0, so a CUDA graph replays it); the thread
//     that draws the last ticket fences (acquire) before its block's
//     barrier, so the whole block is ordered after every partial; a warp a
//     candidate loads all of that candidate's partials at once (one L2
//     round trip for up to 256 chunks) and sums them in chunk order, and
//     writes the sums, the distances (IEEE sqrtf and division, no
//     fast-math: bit-equal to the plain formula on the same sums) and the
//     verdicts.  The finish is the
//     end of a chain (the last ticket's round trip, the fence, one round of
//     loads) that the rest of the card waits out, in place of the second
//     launch of the two-pass design this replaced.
//
// Why a ticket and not a cooperative launch over grid_sync.cuh: the finish
// needs no barrier for the other blocks (they only write one partial and
// leave), a cooperative launch would refuse a grid that is not co-resident
// and grid_sync::launch zeroes its counter with a memset ahead of the kernel
// (a second operation on the stream).  The counter lives in a device buffer
// that the launcher keeps per (device, stream): two launches on different
// streams never share one, and launches on one stream run in order.
//
// Determinism.  The accept decision compares the distance with tol = 1e-4,
// so the bits must repeat from run to run.  Every sum runs in a fixed order:
// each thread owns fixed elements, warps reduce by butterfly shuffles, the
// block combines its warps in warp order, and the finish sums the partials
// in chunk order; there are no float atomics.  The layout depends on the
// shape and the SM count alone.  On identical finite inputs every
// difference is exactly 0, so the numerator is exactly 0.0 in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps a block: a warp a candidate
                                              // in the finish for R <= 8
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                    // float4 loads a thread a group, an input
constexpr int kFinishLoads = 8;               // partials a lane loads at once in the finish
constexpr int64_t kMinChunk = static_cast<int64_t>(kThreads) * 4 * kUnroll;
constexpr float kDenFloor = 1e-12f;

// d = x - y rounded once (never contracted, never folded to 0 when y is x).
__device__ __forceinline__ void accumulate(float x, float y, float& num, float& den) {
  const float d = __fsub_rn(x, y);
  num = fmaf(d, d, num);
  den = fmaf(x, x, den);
}

__device__ __forceinline__ void accumulate4(const float4& x, const float4& y, float& num,
                                            float& den) {
  accumulate(x.x, y.x, num, den);
  accumulate(x.y, y.y, num, den);
  accumulate(x.z, y.z, num, den);
  accumulate(x.w, y.w, num, den);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (P, R): block (p, r) reduces elements [p * chunk, (p + 1) * chunk) of
// candidate r into partial[r][p]; the last block to finish writes sums (R, 2),
// dists (R,) and passed (R,) = dists <= tol.
template <bool kAliased>
__global__ void __launch_bounds__(kThreads)
tamper_check_kernel(const float* __restrict__ ref, const float* __restrict__ recv,
                    float* __restrict__ partial, float* __restrict__ sums,
                    float* __restrict__ dists, unsigned char* __restrict__ passed,
                    unsigned int* __restrict__ ticket, int64_t n_elem, int64_t chunk,
                    float tol) {
  __shared__ float red_num[kWarps];
  __shared__ float red_den[kWarps];
  __shared__ bool last;
  const int p = static_cast<int>(gridDim.x);
  const int r = static_cast<int>(gridDim.y);
  const int64_t cand = blockIdx.y;
  const float* a = ref + cand * n_elem;
  const float* b = kAliased ? a : recv + cand * n_elem;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = start + chunk < n_elem ? start + chunk : n_elem;

  float num = 0.f;
  float den = 0.f;
  int64_t tail = start;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(a + start) | reinterpret_cast<uintptr_t>(b + start);
  if ((bases & 15) == 0) {
    const int64_t nvec = (end - start) >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(a + start);
    const float4* b4 = reinterpret_cast<const float4*>(b + start);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int64_t base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
      float4 x[kUnroll];
      float4 y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        x[u] = i < nvec ? __ldg(a4 + i) : zero;
        if (!kAliased) y[u] = i < nvec ? __ldg(b4 + i) : zero;
      }
      // masked slots add 0 * 0 to a sum of squares: no change
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) accumulate4(x[u], kAliased ? x[u] : y[u], num, den);
    }
    tail = start + nvec * 4;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    const float x = __ldg(a + i);
    accumulate(x, kAliased ? x : __ldg(b + i), num, den);
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  num = warp_sum(num);
  den = warp_sum(den);
  if (lane == 0) {
    red_num[warp] = num;
    red_den[warp] = den;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bn = 0.f;
    float bd = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      bn += red_num[w];
      bd += red_den[w];
    }
    float* out = partial + (cand * p + blockIdx.x) * 2;
    out[0] = bn;
    out[1] = bd;
    // the partial before the ticket; the last ticket wraps the counter to 0
    const unsigned int total = static_cast<unsigned int>(p) * static_cast<unsigned int>(r);
    unsigned int ticket_seen;
    asm volatile("atom.release.gpu.global.inc.u32 %0, [%1], %2;\n"
                 : "=r"(ticket_seen) : "l"(ticket), "r"(total - 1) : "memory");
    last = ticket_seen == total - 1;
    // the acquire: every other block's partial before the barrier below
    // (threadFenceReduction's order)
    if (last) asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  }
  __syncthreads();
  if (!last) return;

  for (int c = warp; c < r; c += kWarps) {
    const float2* part = reinterpret_cast<const float2*>(partial) + static_cast<int64_t>(c) * p;
    float cn = 0.f;
    float cd = 0.f;
    for (int j0 = 0; j0 * 32 < p; j0 += kFinishLoads) {
      float2 v[kFinishLoads];
#pragma unroll
      for (int j = 0; j < kFinishLoads; ++j) {
        const int i = (j0 + j) * 32 + lane;
        v[j] = i < p ? __ldcg(part + i) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kFinishLoads; ++j) {
        cn += v[j].x;
        cd += v[j].y;
      }
    }
    cn = warp_sum(cn);
    cd = warp_sum(cd);
    if (lane == 0) {
      sums[2 * c] = cn;
      sums[2 * c + 1] = cd;
      const float root = sqrtf(cd);
      // max(root, 1e-12) that keeps a NaN, as torch.clamp_min and jnp.maximum do
      const float dist = sqrtf(cn) / (root < kDenFloor ? kDenFloor : root);
      dists[c] = dist;
      passed[c] = dist <= tol ? 1 : 0;
    }
  }
}

}  // namespace

// kThreads, kUnroll, kMinChunk: the constants of which tamper_check.py's
// tamper_layout keeps copies and checks them against these on first use.
extern "C" int repro_tamper_check_constants(int* out) {
  out[0] = kThreads;
  out[1] = kUnroll;
  out[2] = static_cast<int>(kMinChunk);
  return 0;
}

// C interface.  Launches the kernel on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller validates shapes, types
// and devices, lays the grid out (p chunks of `chunk` elements a candidate,
// chunk a multiple of 4 that p chunks just cover), allocates `partial`
// (r * p * 2 floats), `sums` (r * 2), `dists` (r) and `passed` (r bytes),
// and owns `ticket`, one unsigned int that is 0 between launches.
// `aliased` != 0 when ref and recv are the same storage.
extern "C" int repro_tamper_check(const float* ref, const float* recv, float* partial,
                                  float* sums, float* dists, unsigned char* passed,
                                  unsigned int* ticket, int r, long long n_elem,
                                  long long chunk, int p, float tol, int aliased,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 0 || r > 65535 || n_elem <= 0 || chunk <= 0 || chunk % 4 != 0 || p <= 0 ||
      static_cast<long long>(p) * chunk < n_elem ||
      static_cast<long long>(p - 1) * chunk >= n_elem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p, r);
  if (aliased) {
    tamper_check_kernel<true><<<grid, kThreads, 0, s>>>(ref, ref, partial, sums, dists,
                                                        passed, ticket, n_elem, chunk, tol);
  } else {
    tamper_check_kernel<false><<<grid, kThreads, 0, s>>>(ref, recv, partial, sums, dists,
                                                         passed, ticket, n_elem, chunk, tol);
  }
  return static_cast<int>(cudaGetLastError());
}
