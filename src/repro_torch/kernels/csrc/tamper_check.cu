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
// (R, N*D) f32 or bf16: the counterpart of the reference's jax.vmap over
// candidates.  The TPU kernel reads any dtype and casts each block to f32;
// here the kernel is templated on the element type, and a bf16 input (an
// LM's cut activations in the model's dtype) is read as it lies: 16-byte
// loads of 8 bf16, each widened to f32 in registers (exact: a bf16 is the
// top half of an f32), then the same f32 accumulation, chunk order and
// ticket finish as the f32 route.  A cast to f32 before the call would add
// a pass that writes twice the bytes the kernel then reads.
//
// What bounds it on this card: bytes.  Each element costs three flops, so
// at the main path's (5, 3000, 256) two distinct inputs move 30.72 MB: 9.17
// us at 3.35 TB/s.  The path's only call, the fused round's verify stage,
// holds the validation activations against themselves (the reference's
// recompute=False), so there the kernel reads ONE 15.36 MB buffer: 4.58 us.
// Over an LM (Qwen3-8B, the batched round's validation activations
// (2, 8 * 512, 4096) bf16) that buffer is 67.1 MB, more than the 50 MB L2:
// 20.03 us aliased, 40.06 us on distinct inputs.
// The design:
//
//   * the grid is sized to the card: P blocks a candidate with P * R a
//     multiple of the SM count (and at least 4 blocks an SM), so every SM
//     streams the same number of bytes; tamper_check.py::tamper_layout
//     chooses P and the chunk (a multiple of a 16-byte load's elements: 4
//     f32, 8 bf16) and the launcher
//     checks its constants against this library's;
//   * each thread issues all kUnroll 16-byte loads of a group (4 f32 or 8
//     bf16 each), of both inputs, before its FMAs, through the read-only path (ld.global.nc:
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
constexpr int kUnroll = 4;                    // 16-byte loads a thread a group, an input
constexpr int kFinishLoads = 8;               // partials a lane loads at once in the finish
constexpr int64_t kMinChunk = static_cast<int64_t>(kThreads) * 4 * kUnroll;
constexpr float kDenFloor = 1e-12f;

// d = x - y rounded once (never contracted, never folded to 0 when y is x).
__device__ __forceinline__ void accumulate(float x, float y, float& num, float& den) {
  const float d = __fsub_rn(x, y);
  num = fmaf(d, d, num);
  den = fmaf(x, x, den);
}

// The element types: how a 16-byte load (a uint4) unpacks into f32 values,
// in element order, and how one element loads alone.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float (&out)[kVec]) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static float load(const float* p, int64_t i) {
    return __ldg(p + i);
  }
};

// bf16, held as its 16 bits: the f32 with the same top half
template <>
struct Elem<uint16_t> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float (&out)[kVec]) {
    const unsigned int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      out[2 * w] = __uint_as_float(words[w] << 16);          // the lower address
      out[2 * w + 1] = __uint_as_float(words[w] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static float load(const uint16_t* p, int64_t i) {
    return __uint_as_float(static_cast<unsigned int>(__ldg(p + i)) << 16);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (P, R): block (p, r) reduces elements [p * chunk, (p + 1) * chunk) of
// candidate r into partial[r][p]; the last block to finish writes sums (R, 2),
// dists (R,) and passed (R,) = dists <= tol.  T is float or uint16_t (bf16).
template <typename T, bool kAliased>
__global__ void __launch_bounds__(kThreads)
tamper_check_kernel(const T* __restrict__ ref, const T* __restrict__ recv,
                    float* __restrict__ partial, float* __restrict__ sums,
                    float* __restrict__ dists, unsigned char* __restrict__ passed,
                    unsigned int* __restrict__ ticket, int64_t n_elem, int64_t chunk,
                    float tol) {
  using E = Elem<T>;
  constexpr int kVec = E::kVec;
  __shared__ float red_num[kWarps];
  __shared__ float red_den[kWarps];
  __shared__ bool last;
  const int p = static_cast<int>(gridDim.x);
  const int r = static_cast<int>(gridDim.y);
  const int64_t cand = blockIdx.y;
  const T* a = ref + cand * n_elem;
  const T* b = kAliased ? a : recv + cand * n_elem;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t end = start + chunk < n_elem ? start + chunk : n_elem;

  float num = 0.f;
  float den = 0.f;
  int64_t tail = start;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(a + start) | reinterpret_cast<uintptr_t>(b + start);
  if ((bases & 15) == 0) {
    const int64_t nvec = (end - start) / kVec;
    const uint4* a4 = reinterpret_cast<const uint4*>(a + start);
    const uint4* b4 = reinterpret_cast<const uint4*>(b + start);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int64_t base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
      uint4 x[kUnroll];
      uint4 y[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t i = base + u * kThreads;
        x[u] = i < nvec ? __ldg(a4 + i) : zero;
        if (!kAliased) y[u] = i < nvec ? __ldg(b4 + i) : zero;
      }
      // masked slots add 0 * 0 to a sum of squares: no change
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float xs[kVec];
        float ys[kVec];
        E::unpack(x[u], xs);
        E::unpack(kAliased ? x[u] : y[u], ys);
#pragma unroll
        for (int e = 0; e < kVec; ++e) accumulate(xs[e], ys[e], num, den);
      }
    }
    tail = start + nvec * kVec;
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    const float x = E::load(a, i);
    accumulate(x, kAliased ? x : E::load(b, i), num, den);
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

template <typename T>
int launch(const void* ref, const void* recv, float* partial, float* sums, float* dists,
           unsigned char* passed, unsigned int* ticket, int r, long long n_elem,
           long long chunk, int p, float tol, int aliased, cudaStream_t s) {
  const dim3 grid(p, r);
  const T* a = static_cast<const T*>(ref);
  if (aliased) {
    tamper_check_kernel<T, true><<<grid, kThreads, 0, s>>>(a, a, partial, sums, dists, passed,
                                                           ticket, n_elem, chunk, tol);
  } else {
    tamper_check_kernel<T, false><<<grid, kThreads, 0, s>>>(
        a, static_cast<const T*>(recv), partial, sums, dists, passed, ticket, n_elem, chunk,
        tol);
  }
  return static_cast<int>(cudaGetLastError());
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
// chunk a multiple of a 16-byte load's elements that p chunks just cover),
// allocates `partial` (r * p * 2 floats), `sums` (r * 2), `dists` (r) and
// `passed` (r bytes), and owns `ticket`, one unsigned int that is 0 between
// launches.  `aliased` != 0 when ref and recv are the same storage; `dtype`
// is 0 for f32 inputs, 1 for bf16.
extern "C" int repro_tamper_check(const void* ref, const void* recv, float* partial,
                                  float* sums, float* dists, unsigned char* passed,
                                  unsigned int* ticket, int r, long long n_elem,
                                  long long chunk, int p, float tol, int aliased, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 1 ? Elem<uint16_t>::kVec : Elem<float>::kVec;
  if ((dtype != 0 && dtype != 1) || r <= 0 || r > 65535 || n_elem <= 0 || chunk <= 0 ||
      chunk % vec != 0 || p <= 0 || static_cast<long long>(p) * chunk < n_elem ||
      static_cast<long long>(p - 1) * chunk >= n_elem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1) {
    return launch<uint16_t>(ref, recv, partial, sums, dists, passed, ticket, r, n_elem, chunk,
                            p, tol, aliased, s);
  }
  return launch<float>(ref, recv, partial, sums, dists, passed, ticket, r, n_elem, chunk, p,
                       tol, aliased, s);
}
