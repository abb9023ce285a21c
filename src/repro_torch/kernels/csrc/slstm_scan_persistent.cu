// sLSTM time scan for Hopper (sm_90a) as ONE persistent launch a call, bound
// to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/slstm_scan.py:
//   slstm_scan (_slstm_kernel) -> slstm_scan_persistent_kernel, one
//   cooperative launch that runs all T steps (slstm_scan.cu's step kernel,
//   one launch a step, stays the route for the shapes this one cannot take)
// It computes what slstm_scan.cu's header sets out (the head-major gate
// layout, f32 state and arithmetic, pre and r widened in registers); out
// (T, B, d) in pre's dtype.
//
// What bounds it on this card.  Operations: 2 T B 4d dh f32 flops, 256 us
// at the prefill shape (T 512, B 4, d 2,048, H 4) at 67 TFLOP/s, 0.5 us a
// step.  But every step needs all of the previous step's h (at H = 4 unit
// u's four gates come from four heads' R, each reading another dh-slice of
// h), so each step pays one grid-wide dependency.  The step kernel pays it
// as a kernel boundary and re-reads R (8.4 MB in bf16) from L2 every step.
// This kernel pays it as one grid barrier (release/acquire) and keeps R in
// shared memory:
//
//   * one cooperative launch (cudaLaunchAttributeCooperative: the grid is
//     co-resident or the launch fails, never a deadlock) of d / units
//     blocks, `units` (a multiple of 4) chosen by the caller so that the
//     blocks fit one an SM; the launcher checks that the grid fits the
//     card (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count);
//   * a block owns units [u0, u0 + units) with all four gate columns and all
//     B rows.  Its slice of R (4 x units columns of dh entries: 128 KB at
//     the prefill shape, held in f32 where that fits, a bf16 R widened once)
//     is loaded once into shared memory, rows of k with the column groups
//     side by side (one pad slot a row, so lanes that read 32 consecutive k
//     hit distinct banks);
//   * a column group is one gate of 4 consecutive units (one head, as dh %
//     4 == 0), a warp's work: lane l takes k = l, l + 32, ... and
//     accumulates 4 units x 4 rows (8 rows: 32 sums) in registers, one h
//     float4 (4 rows of one k) and one R quad a k: 2 shared loads feed 16
//     (32) FMAs.  The lanes' sums meet in a fixed reduce-scatter butterfly
//     (16 shuffles for 16 sums), so every rerun repeats the bits; the lane
//     left with a sum adds its pre (copied into shared memory a step ahead
//     with cp.async, so that its latency hides behind the step before) and
//     applies its gate's activation (log-sigmoid, tanh, sigmoid), spread
//     over the warps;
//   * the thread of each (row, unit) keeps c, n and m in registers for the
//     whole scan, updates them from the four activated gates and writes
//     out[t] and h;
//   * h is double-buffered in global memory ([2][row group][d][4 rows] f32):
//     step t writes buffer t % 2 and, after the barrier, every block copies
//     all of it (B x d f32, 32 KB at the prefill shape) into shared memory
//     with cp.async.cg (L2 only, never a stale L1 line).  A block writes
//     buffer t % 2 again at step t + 2 only after barrier t + 1, which every
//     block reaches after its reads of step t + 1: one barrier a step;
//   * the barrier (grid_sync.cuh): after a __syncthreads, thread 0 adds one
//     to a counter (zeroed before the launch) with a release reduction and
//     spins with acquire loads (20 ns apart) until all blocks of the step
//     have arrived.  One flag a block, each polled by a thread of every
//     block, measured slower (16,384 pollers in L2 a step), and so did
//     relaxed polls with one fence after them.
// At t = 0 h is 0, so the products are skipped (pre + 0, as the plain
// version adds).  T steps cost one launch, one memset and T - 1 barriers.
//
// Where a gradient is recorded the caller passes two f32 saves: the lane
// that ends with a column's sum also writes z = pre + rec (T, B, 4d), and
// the thread of each (row, unit) its h, c, n, m (4, T, B, d), what
// slstm_scan_bwd.cu's reverse scan reads.  That is an instantiation of its
// own (kSave): with null saves (the serve path) the kernel launched has no
// save code at all (a runtime branch on the pointers read 1.5-1.9% slower,
// parent and change timed in turns on one card).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "persistent_scan.cuh"
#include "slstm_gates.cuh"

namespace {

using scan::cp_async16;
using scan::cp_async_wait_all;
using scan::Quad;
using scan::reduce_scatter;
using scan::widen;
using slstm::from_f32;
using slstm::to_f32;

constexpr int kThreads = 512;                    // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroupUnits = 4;                   // units of a column group
constexpr int kMaxRows = 8;                      // batch rows: one or two groups of 4
constexpr int kMaxSmem = 232448;                 // shared memory a block may use (227 KB)

// cp.async of one quad of T (8 or 16 bytes), zeros where !in
template <typename T>
__device__ __forceinline__ void cp_async_quad(T* dst, const T* src, bool in) {
  constexpr int kBytes = 4 * sizeof(T);
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(kBytes), "r"(in ? kBytes : 0) : "memory");
}

// R's slice held as S, h, the activated gates, and pre of two steps
template <typename T, typename S>
size_t smem_bytes(int d, int dh, int units, int row_groups) {
  return static_cast<size_t>(dh) * (units + 1) * sizeof(typename Quad<S>::type) +
         static_cast<size_t>(row_groups) * d * sizeof(float4) +
         static_cast<size_t>(4) * units * 4 * row_groups * sizeof(float) +
         static_cast<size_t>(2) * 4 * units * 4 * row_groups * sizeof(T);
}

// pre (T, B, 4d), r (H, dh, 4dh), out (T, B, d); hbuf [2][kRowGroups][d][4]
// f32; `arrived` the barrier's counter, 0 at the launch.  S: R's type in
// shared memory (f32 where it fits: no widening in the products).  With
// kSave, z_save (T, B, 4d) and s_save (4, T, B, d) take each step's z and
// state for the backward (slstm_scan_bwd.cu); without it (the serve path)
// the kernel is the one that saves nothing, not a branch in it.
template <typename T, typename S, int kRowGroups, bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
slstm_scan_persistent_kernel(const T* __restrict__ pre, const T* __restrict__ r,
                             T* __restrict__ out, float* __restrict__ hbuf,
                             unsigned int* __restrict__ arrived, float* __restrict__ z_save,
                             float* __restrict__ s_save, int t_len, int b, int d, int dh,
                             int units) {
  using Q = typename Quad<S>::type;
  constexpr int kRows = 4 * kRowGroups;
  constexpr int kSums = kRows * kGroupUnits;     // a lane's sums: [row][unit]
  constexpr int kLanesPerSum = 32 / kSums;
  extern __shared__ __align__(16) unsigned char smem[];
  Q* r_s = reinterpret_cast<Q*>(smem);                             // [dh][units + 1]
  float4* h_s = reinterpret_cast<float4*>(r_s + dh * (units + 1));   // [kRowGroups][d]
  float* z_s = reinterpret_cast<float*>(h_s + kRowGroups * d);      // [4][units][kRows]
  T* pre_s = reinterpret_cast<T*>(z_s + 4 * units * kRows);         // [2][4][kRows][units]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int u0 = blockIdx.x * units;
  const int e4 = 4 * dh;
  const int per_gate = units / kGroupUnits;     // column groups a gate
  const int row_len = units + 1;

  // R's slice, once: column group q = (gate q / per_gate, units u .. u + 3)
  // holds R[head, k, e .. e + 3] at r_s[k][q] (consecutive threads take
  // consecutive groups of one k: coalesced within a gate)
  for (int i = tid; i < units * dh; i += kThreads) {
    const int k = i / units;
    const int q = i - k * units;
    const int g = q / per_gate;
    const int u = u0 + (q - g * per_gate) * kGroupUnits;
    Q v{};
    if (u < d) {
      const int col = g * d + u;
      const int head = col / e4;
      const int e = col - head * e4;
      const auto in = *reinterpret_cast<const typename Quad<T>::type*>(
          r + (static_cast<int64_t>(head) * dh + k) * e4 + e);
      if constexpr (sizeof(S) == sizeof(T)) {
        v = in;
      } else {
        float w[4];
        widen(in, w);
        v = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    r_s[k * row_len + q] = v;
  }

  // pre of step t into pre_s[t % 2], a quad (one gate, row and column
  // group) a thread, zeros past B and d: issued a step ahead, so that its
  // latency hides behind the step before
  auto prefetch_pre = [&](int t) {
    if (tid < kRows * units) {
      const int qd = tid % per_gate;
      const int row = tid / per_gate % kRows;
      const int g = tid / (per_gate * kRows);
      const int u = u0 + qd * kGroupUnits;
      const bool in = row < b && u < d;
      cp_async_quad(pre_s + (((t & 1) * 4 + g) * kRows + row) * units + qd * kGroupUnits,
                    pre + (in ? (static_cast<int64_t>(t) * b + row) * 4 * d + g * d + u : 0),
                    in);
    }
  };
  prefetch_pre(0);

  // the (row, unit) this thread gates, if any, and its state
  const int ul = tid % units;
  const int erow = tid / units;
  const int eu = u0 + ul;
  const bool gates = tid < units * kRows && eu < d;   // writes h (0 for padded rows)
  const bool owner = gates && erow < b;               // a real (row, unit)
  float c = 0.f, n = 0.f, m = slstm::kMInit;
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    if (t > 0) {
      // h_{t-1}, all rows, from L2 into shared memory
      const float4* src = reinterpret_cast<const float4*>(hbuf) +
                          static_cast<int64_t>((t - 1) & 1) * kRowGroups * d;
      for (int i = tid; i < kRowGroups * d; i += kThreads) cp_async16(h_s + i, src + i);
      cp_async_wait_all();
      __syncthreads();
    }

    // each column group's sums, pre added, activated by its gate
    for (int q = warp; q < units; q += kWarps) {
      const int g = q / per_gate;
      const int uq = (q - g * per_gate) * kGroupUnits;
      if (u0 + uq >= d) continue;                    // a dead group (warp-uniform)
      const int idx = lane / kLanesPerSum;           // the sum this lane ends with
      const int row = idx / kGroupUnits;
      const int j = idx % kGroupUnits;
      const bool holds = lane % kLanesPerSum == 0;
      float acc[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
      if (t > 0) {
        const float4* hp = h_s + (g * d + u0 + uq) / e4 * dh;   // the group's head
#pragma unroll 4
        for (int k = lane; k < dh; k += 32) {
          float w[4];
          widen(r_s[k * row_len + q], w);
#pragma unroll
          for (int rg = 0; rg < kRowGroups; ++rg) {
            const float4 hv = hp[rg * d + k];
            const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int jj = 0; jj < kGroupUnits; ++jj) {
                float& a = acc[(rg * 4 + i) * kGroupUnits + jj];
                a = fmaf(hr[i], w[jj], a);
              }
            }
          }
        }
      }
      const float sum = reduce_scatter<kSums>(acc, lane);
      if (holds) {
        const float pz = to_f32(pre_s[(((t & 1) * 4 + g) * kRows + row) * units + uq + j]);
        const float zv = pz + sum;
        z_s[(g * units + uq + j) * kRows + row] = slstm::gate_input(g, zv);
        if constexpr (kSave) {
          if (row < b) {
            z_save[(static_cast<int64_t>(t) * b + row) * 4 * d + g * d + u0 + uq + j] = zv;
          }
        }
      }
    }
    __syncthreads();                                 // z_s complete
    if (t + 1 < t_len) prefetch_pre(t + 1);          // waited for with the next h

    if (gates) {
      float h = 0.f;
      if (owner) {
        float a[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) a[g] = z_s[(g * units + ul) * kRows + erow];
        h = slstm::gate_state(a, c, n, m);
        const int64_t so = (static_cast<int64_t>(t) * b + erow) * d + eu;
        out[so] = from_f32<T>(h);
        if constexpr (kSave) {
          const int64_t plane = static_cast<int64_t>(t_len) * b * d;
          s_save[so] = h;
          s_save[plane + so] = c;
          s_save[2 * plane + so] = n;
          s_save[3 * plane + so] = m;
        }
      }
      hbuf[((static_cast<int64_t>(t & 1) * kRowGroups + erow / 4) * d + eu) * 4 + erow % 4] = h;
    }
    if (t + 1 < t_len) {
      grid_sync::barrier(arrived, static_cast<unsigned int>(t + 1) * gridDim.x);
    }
  }
}

template <typename T, typename S, int kRowGroups, bool kSave>
int launch(const T* pre, const T* r, T* out, float* ws, float* z_save, float* s_save, int t,
           int b, int d, int heads, int units, cudaStream_t stream) {
  const int dh = d / heads;
  const size_t smem = smem_bytes<T, S>(d, dh, units, kRowGroups);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = slstm_scan_persistent_kernel<T, S, kRowGroups, kSave>;
  // raise the shared-memory cap once (before any CUDA-graph capture of the
  // launch), to the largest a call has asked for
  static size_t granted = 0;
  cudaError_t err = cudaSuccess;
  if (smem > granted) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  float* hbuf = ws;
  unsigned int* arrived =
      reinterpret_cast<unsigned int*>(ws + static_cast<int64_t>(2) * kRowGroups * d * 4);
  return static_cast<int>(grid_sync::launch(kernel, (d + units - 1) / units, kThreads, smem,
                                            stream, arrived, pre, r, out, hbuf, arrived,
                                            z_save, s_save, t, b, d, dh, units));
}

template <typename T, typename S>
int dispatch(const void* pre, const void* r, void* out, float* ws, float* z_save,
             float* s_save, int t, int b, int d, int heads, int units, cudaStream_t s) {
  const T* p = static_cast<const T*>(pre);
  const T* w = static_cast<const T*>(r);
  T* o = static_cast<T*>(out);
  const bool save = z_save != nullptr;
  if (b <= 4) {
    return save ? launch<T, S, 1, true>(p, w, o, ws, z_save, s_save, t, b, d, heads, units, s)
                : launch<T, S, 1, false>(p, w, o, ws, z_save, s_save, t, b, d, heads, units, s);
  }
  return save ? launch<T, S, 2, true>(p, w, o, ws, z_save, s_save, t, b, d, heads, units, s)
              : launch<T, S, 2, false>(p, w, o, ws, z_save, s_save, t, b, d, heads, units, s);
}

}  // namespace

// C interface.  One memset and one cooperative launch on `stream`; returns
// the first cudaError_t (0 = launched), cudaErrorCooperativeLaunchTooLarge
// when the grid does not fit the card at once.  The caller validates types,
// devices and contiguity, picks `units` (a multiple of 4, units x rows <=
// 512 with rows = 4 for B <= 4 and 8 for B <= 8) and allocates `out` (T, B,
// d) in pre's dtype and the f32 workspace `ws`: 2 x rows x d floats of h,
// then the barrier's 4-byte counter.  r's base is 16-byte aligned, dh % 4 ==
// 0.
// dtype: 0 = f32, 1 = bf16; `wide_r` holds a bf16 R as f32 in shared memory
// (the caller's choice where that fits).  Where a gradient is recorded,
// z_save (T, B, 4d) and s_save (4, T, B, d), both f32, take each step's z
// and its state h, c, n, m for slstm_scan_bwd.cu; both null otherwise.
extern "C" int repro_slstm_scan_persistent(const void* pre, const void* r, void* out,
                                           float* ws, float* z_save, float* s_save, int t,
                                           int b, int d, int heads, int units, int wide_r,
                                           int dtype, void* stream) {
  const int rows = b <= 4 ? 4 : kMaxRows;
  if (t <= 0 || b <= 0 || b > kMaxRows || d <= 0 || heads <= 0 || d % heads != 0 ||
      (d / heads) % kGroupUnits != 0 || units <= 0 || units % kGroupUnits != 0 ||
      units * rows > kThreads || reinterpret_cast<uintptr_t>(r) % 16 != 0 ||
      (z_save == nullptr) != (s_save == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float, float>(pre, r, out, ws, z_save, s_save, t, b, d, heads, units, s);
  }
  if (dtype == 1 && wide_r) {
    return dispatch<__nv_bfloat16, float>(pre, r, out, ws, z_save, s_save, t, b, d, heads,
                                          units, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(pre, r, out, ws, z_save, s_save, t, b, d,
                                                  heads, units, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0..3] <- kThreads, kGroupUnits, kMaxRows, kMaxSmem: the constants of
// which kernels/slstm_scan.py's route and grid policy keep copies (checked
// against these on first use).
extern "C" int repro_slstm_scan_persistent_constants(int* out) {
  out[0] = kThreads;
  out[1] = kGroupUnits;
  out[2] = kMaxRows;
  out[3] = kMaxSmem;
  return 0;
}
