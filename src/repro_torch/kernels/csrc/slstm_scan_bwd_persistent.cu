// The sLSTM time scan's backward for Hopper (sm_90a) as ONE persistent
// launch a call, bound to Python through a plain C interface (ctypes).
//
// Replaces no TPU kernel: the JAX package trains the sLSTM by XLA autodiff
// of its lax.scan (src/repro/models/xlstm.py: _slstm_step).  It computes
// what slstm_scan_bwd.cu's step kernel computes (that file's header sets
// out the reverse recurrence and its derivative conventions; both kernels
// run slstm_gates.cuh's gate_prep and gate_apply), from the same saves of either
// forward route: z (T, B, 4d) f32 and the state h, c, n, m (4, T, B, d) f32
// in, dz (T, B, 4d) f32 out.  Only the order of the product's sums differs.
//
// What bounds it on this card.  Operations: the per-step product dh_rec[row,
// u] = sum_e dz[t + 1][row, head(u) 4dh + e] R[head(u), k(u), e] is 2 B 4d
// dh f32 flops, 17.2 GFLOP over T at the prefill shape (T 512, B 4, d 2,048,
// H 4): 256 us at 67 TFLOP/s, 0.5 us a step, against ~218 MB read and
// written once (65 us).  Step t - 1 needs all of step t's dz over its
// head's 4dh columns, one grid-wide dependency a step.  The step route pays
// it as a kernel boundary and re-reads R (8.4 MB in bf16) through L2 every
// step, with the carry in a global workspace.  This kernel pays it as one
// grid barrier and keeps R and the carry on chip:
//
//   * one cooperative launch (grid_sync.cuh: the grid is co-resident or the
//     launch fails, never a deadlock) of d / units blocks, `units` (a
//     multiple of 4) chosen by the caller so that the blocks fit one an SM;
//   * a block owns units [u0, u0 + units) and all B rows.  Its rows of R,
//     R[head(u), k(u), 0:4dh] for each of its units (units x 4dh entries:
//     128 KB in f32 at the prefill shape), are loaded once into shared
//     memory as [unit][e], in f32 where that fits, else as bf16 widened in
//     registers;
//   * the product: a group of 4 consecutive units (one head, as dh % 4 ==
//     0) and one of `splits` ranges of e is a warp's work (splits = 16 /
//     groups: 4 groups x 4 e-ranges at the prefill shape, every warp
//     busy).  Lane l walks the range 4 e's at a time (c = lo + l, lo + l +
//     32, ...): one 16-byte load of R a unit and one of dz a row feed 4
//     rows x 4 units x 4 e's of FMAs in registers (8 rows past B 4).  The
//     lanes' 16 (32) sums meet in the forward's fixed reduce-scatter
//     butterfly, each warp's sums go to shared memory, and the owner of a
//     (row, unit) adds its group's e-ranges in order 0, 1, ...: no
//     atomics, the bits repeat run to run;
//   * the thread of each (row, unit) keeps the carry (dc, dn, dm) in
//     registers for the whole scan and applies the gate backward in two
//     parts (slstm_gates.cuh): gate_prep, what needs the forward alone, runs
//     while the block's copy of dz is in flight, and gate_apply, a short
//     chain once the product's sum is known.  It holds the state at t (the
//     step before's "state at t - 1"), so each step reads one new state
//     triple with z[t], staged a step ahead into shared memory with
//     cp.async (as the forward stages pre), and dout[t], loaded after the
//     barrier and first used after the product.  No plain load is in flight
//     when thread 0 (an owner) releases its block's arrival: with z and the
//     state loaded into registers just before the barrier the kernel read
//     5.27 us a step at the prefill shape, after it 4.60 (an H100 80GB HBM3
//     at 700 W, the two timed in turns in one process each);
//   * the exchange: owners write dz[t] into the output itself (a distinct
//     address each t, so no double buffer), and after the barrier every
//     block copies dz[t] over the 4dh columns of each head its units span
//     (B x 4dh f32: 32 KB at the prefill shape; two heads where a block
//     straddles them, dh % units != 0) into shared memory with cp.async.cg
//     (L2 only, never a stale L1 line).  A block's copy of step t's slice
//     and its product end before its writes of step t - 1 and its arrival
//     at the next barrier, so one barrier a step orders everything;
//   * the barrier (grid_sync.cuh): a release add to one counter, acquire
//     polls, as in the forward.
// At t = T - 1 there is no recurrent share, so the product is skipped; T
// steps cost one launch, one memset and T - 1 barriers.  dR stays one f32
// einsum after the scan (kernels/slstm_scan.py::recurrent_weight_grad): a
// block's dR accumulator (units x 4dh f32) would not fit beside R's rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "persistent_scan.cuh"
#include "slstm_gates.cuh"

namespace {

using scan::cp_async16;
using scan::cp_async4;
using scan::cp_async_commit;
using scan::cp_async_wait;
using scan::cp_async_wait_all;
using scan::Quad;
using scan::reduce_scatter;
using scan::widen;
using slstm::to_f32;

constexpr int kThreads = 512;                    // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kGroupUnits = 4;                   // units of a group: one head
constexpr int kMaxRows = 8;                      // batch rows: one or two groups of 4
constexpr int kMaxSmem = 232448;                 // shared memory a block may use (227 KB)

constexpr int kStaged = 7;                       // an owner's staged inputs: z, c, n, m

__host__ __device__ __forceinline__ int groups_of(int units) { return units / kGroupUnits; }

// e-ranges of a group: every warp busy where the groups divide 16
__host__ __device__ __forceinline__ int splits_of(int groups) {
  return groups >= kWarps ? 1 : kWarps / groups;
}

// the most heads a block of `units` consecutive units spans over the grid
int max_span(int d, int dh, int units) {
  int most = 0;
  for (int u0 = 0; u0 < d; u0 += units) {
    const int last = (u0 + units < d ? u0 + units : d) - 1;
    const int span = last / dh - u0 / dh + 1;
    most = span > most ? span : most;
  }
  return most;
}

// R's rows held as S, dz of the heads spanned, the warps' sums, and the
// owners' inputs of two steps
template <typename S>
size_t smem_bytes(int dh, int units, int rows, int span) {
  const int groups = groups_of(units);
  return static_cast<size_t>(units) * 4 * dh * sizeof(S) +
         static_cast<size_t>(span) * rows * 4 * dh * sizeof(float) +
         static_cast<size_t>(groups) * splits_of(groups) * rows * kGroupUnits * sizeof(float) +
         static_cast<size_t>(2) * kStaged * units * rows * sizeof(float);
}

// dout (T, B, d) and r (H, dh, 4dh) in T; z (T, B, 4d) and state (4, T, B,
// d) f32, the forward's saves; dz (T, B, 4d) f32 out, also the exchange;
// `arrived` the barrier's counter, 0 at the launch.  S: R's type in shared
// memory; kRows: 4 or 8 batch rows.
template <typename T, typename S, int kRows>
__global__ void __launch_bounds__(kThreads, 1)
slstm_bwd_persistent_kernel(const T* __restrict__ dout, const T* __restrict__ r,
                            const float* __restrict__ z, const float* __restrict__ state,
                            float* __restrict__ dz, unsigned int* __restrict__ arrived,
                            int t_len, int b, int d, int dh, int units, int span) {
  using Q = typename Quad<S>::type;
  constexpr int kSums = kRows * kGroupUnits;     // a warp's sums: [row][unit]
  constexpr int kLanesPerSum = 32 / kSums;
  extern __shared__ __align__(16) unsigned char smem[];
  Q* r_s = reinterpret_cast<Q*>(smem);                               // [units][dh] quads of e
  float4* dz_s = reinterpret_cast<float4*>(r_s + units * dh);       // [span][kRows][dh]
  float* red = reinterpret_cast<float*>(dz_s + span * kRows * dh);  // [group][split][kSums]
  float* stage = red + groups_of(units) * splits_of(groups_of(units)) * kSums;
                                                         // [2][kStaged][units x kRows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int u0 = blockIdx.x * units;
  const int e4 = 4 * dh;
  const int64_t d4 = 4 * static_cast<int64_t>(d);
  const int groups = groups_of(units);
  const int splits = splits_of(groups);
  const int chunk = (dh + splits - 1) / splits;  // quads of e a range
  const int h_lo = u0 / dh;
  const int nh = ((u0 + units < d ? u0 + units : d) - 1) / dh - h_lo + 1;

  // R's rows, once: unit ul's row, 4 e's a quad (consecutive threads take
  // consecutive quads of one row: coalesced); zeros past d
  for (int i = tid; i < units * dh; i += kThreads) {
    const int ul = i / dh;
    const int c = i - ul * dh;
    const int u = u0 + ul;
    Q v{};
    if (u < d) {
      const int head = u / dh;
      const auto in = *reinterpret_cast<const typename Quad<T>::type*>(
          r + (static_cast<int64_t>(head) * dh + (u - head * dh)) * e4 + 4 * c);
      if constexpr (sizeof(S) == sizeof(T)) {
        v = in;
      } else {
        float w[4];
        widen(in, w);
        v = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    r_s[i] = v;
  }
  // dz's rows past B stay zero (the products read kRows rows)
  for (int i = tid; i < span * kRows * dh; i += kThreads) {
    dz_s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // the (row, unit) this thread owns, if any
  const int ul = tid % units;
  const int erow = tid / units;
  const int eu = u0 + ul;
  const int owners = units * kRows;
  const bool owner = tid < owners && erow < b && eu < d;
  const int64_t bd = static_cast<int64_t>(b) * d;
  const int64_t plane = static_cast<int64_t>(t_len) * bd;
  const int64_t so = static_cast<int64_t>(erow) * d + eu;       // in a (B, d) step
  const int64_t zo = static_cast<int64_t>(erow) * d4 + eu;      // in a (B, 4d) step

  // step t's z and the state (c, n, m) at t - 1 into stage[t % 2], an
  // owner's own slots, with cp.async: one group, issued a step ahead
  auto stage_inputs = [&](int t) {
    float* st = stage + (t & 1) * kStaged * owners + tid;
    const float* zr = z + t * 4 * bd + zo;
#pragma unroll
    for (int g = 0; g < 4; ++g) cp_async4(st + g * owners, zr + g * static_cast<int64_t>(d));
    if (t > 0) {
      const float* sp = state + (t - 1) * bd + so;
#pragma unroll
      for (int v = 1; v < 4; ++v) cp_async4(st + (3 + v) * owners, sp + v * plane);
    }
    cp_async_commit();
  };
  float c_t = 0.f, n_t = 0.f, m_t = 0.f, dc = 0.f, dn = 0.f, dm = 0.f;
  if (owner) {
    const int64_t st = (t_len - 1) * bd + so;
    c_t = state[plane + st];
    n_t = state[2 * plane + st];
    m_t = state[3 * plane + st];
    stage_inputs(t_len - 1);
  }
  cp_async_wait_all();
  __syncthreads();

  for (int t = t_len - 1; t >= 0; --t) {
    const bool last = t == t_len - 1;
    // dout[t], first used after the product, which hides its latency
    const float g_out = owner ? to_f32(dout[t * bd + so]) : 0.f;
    if (!last) {
      // dz[t + 1] of the heads spanned, all rows, from L2 into shared memory
      const float* src = dz + (t + 1) * 4 * bd + static_cast<int64_t>(h_lo) * e4;
      for (int i = tid; i < nh * b * dh; i += kThreads) {
        const int c = i % dh;
        const int row = i / dh % b;
        const int hl = i / (dh * b);
        cp_async16(dz_s + (hl * kRows + row) * dh + c, src + row * d4 + hl * e4 + 4 * c);
      }
      cp_async_commit();
    }
    // while the copy is in flight: the part of the gate backward that needs
    // the forward alone, from the inputs staged a step ago
    slstm::GateGrad grad;
    if (owner) {
      if (!last) cp_async_wait<1>();               // the stage; the copy may fly on
      const float* st = stage + (t & 1) * kStaged * owners + tid;
      const float zv[4] = {st[0], st[owners], st[2 * owners], st[3 * owners]};
      float c_p = 0.f, n_p = 0.f, m_p = slstm::kMInit;
      if (t > 0) {
        c_p = st[4 * owners];
        n_p = st[5 * owners];
        m_p = st[6 * owners];
      }
      grad = slstm::gate_prep(zv, c_t, n_t, m_t, c_p, n_p, m_p);
      // the state at t - 1 is the next step's state at t; its inputs now
      c_t = c_p;
      n_t = n_p;
      m_t = m_p;
      if (t > 0) stage_inputs(t - 1);
    }
    if (!last) {
      if (owner && t > 0) {
        cp_async_wait<1>();                          // the copy; the next stage flies on
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      // each (group, e-range)'s sums over its e's
      for (int w = warp; w < groups * splits; w += kWarps) {
        const int g = w / splits;
        const int s = w - g * splits;
        const int uq = g * kGroupUnits;
        float acc[kSums];
#pragma unroll
        for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
        if (u0 + uq < d) {                           // a live group (warp-uniform)
          const Q* rp = r_s + uq * dh;
          const float4* zp = dz_s + ((u0 + uq) / dh - h_lo) * kRows * dh;
          const int hi = min(dh, (s + 1) * chunk);
#pragma unroll 1
          for (int c = s * chunk + lane; c < hi; c += 32) {
            float w4[kGroupUnits][4];
#pragma unroll
            for (int j = 0; j < kGroupUnits; ++j) widen(rp[j * dh + c], w4[j]);
#pragma unroll
            for (int row = 0; row < kRows; ++row) {
              const float4 zq = zp[row * dh + c];
#pragma unroll
              for (int j = 0; j < kGroupUnits; ++j) {
                float& a = acc[row * kGroupUnits + j];
                a = fmaf(zq.x, w4[j][0], a);
                a = fmaf(zq.y, w4[j][1], a);
                a = fmaf(zq.z, w4[j][2], a);
                a = fmaf(zq.w, w4[j][3], a);
              }
            }
          }
        }
        const float sum = reduce_scatter<kSums>(acc, lane);
        if (lane % kLanesPerSum == 0) red[w * kSums + lane / kLanesPerSum] = sum;
      }
      __syncthreads();                               // red complete
    }

    if (owner) {
      float g_h = g_out;
      if (!last) {
        // the group's e-ranges in order: the same bits every run
        const int g = ul / kGroupUnits;
        const int idx = erow * kGroupUnits + ul % kGroupUnits;
        float rec = 0.f;
        for (int s = 0; s < splits; ++s) rec += red[(g * splits + s) * kSums + idx];
        g_h += rec;
      }
      float dzv[4];
      slstm::gate_apply(grad, g_h, dc, dn, dm, dzv);
      float* dzr = dz + t * 4 * bd + zo;
      dzr[0] = dzv[0];
      dzr[d] = dzv[1];
      dzr[2 * static_cast<int64_t>(d)] = dzv[2];
      dzr[3 * static_cast<int64_t>(d)] = dzv[3];
    }
    if (t > 0) {
      grid_sync::barrier(arrived, static_cast<unsigned int>(t_len - t) * gridDim.x);
    }
  }
}

template <typename T, typename S, int kRows>
int launch(const T* dout, const T* r, const float* z, const float* state, float* dz,
           unsigned int* arrived, int t, int b, int d, int heads, int units,
           cudaStream_t stream) {
  const int dh = d / heads;
  const int span = max_span(d, dh, units);
  const size_t smem = smem_bytes<S>(dh, units, kRows, span);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = slstm_bwd_persistent_kernel<T, S, kRows>;
  // raise the shared-memory cap once (before any CUDA-graph capture of the
  // launch), to the largest a call has asked for
  static size_t granted = 0;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  return static_cast<int>(grid_sync::launch(kernel, (d + units - 1) / units, kThreads, smem,
                                            stream, arrived, dout, r, z, state, dz, arrived,
                                            t, b, d, dh, units, span));
}

template <typename T, typename S>
int dispatch(const void* dout, const void* r, const float* z, const float* state, float* dz,
             unsigned int* arrived, int t, int b, int d, int heads, int units,
             cudaStream_t s) {
  const T* g = static_cast<const T*>(dout);
  const T* w = static_cast<const T*>(r);
  if (b <= 4) return launch<T, S, 4>(g, w, z, state, dz, arrived, t, b, d, heads, units, s);
  return launch<T, S, 8>(g, w, z, state, dz, arrived, t, b, d, heads, units, s);
}

}  // namespace

// C interface.  One memset and one cooperative launch on `stream`; returns
// the first cudaError_t (0 = launched), cudaErrorCooperativeLaunchTooLarge
// when the grid does not fit the card at once.  The caller validates shapes,
// types, devices and contiguity, picks `units` (a multiple of 4, units x
// rows <= 512 with rows = 4 for B <= 4 and 8 for B <= 8) and allocates dz
// (T, B, 4d) f32 and the barrier's 4-byte counter `arrived`.  dout (T, B,
// d) and r (H, dh, 4dh) in one dtype (0 = f32, 1 = bf16), r's base 16-byte
// aligned, dh % 4 == 0; z (T, B, 4d) and state (4, T, B, d) the forward's
// f32 saves.  `wide_r` holds a bf16 R as f32 in shared memory (the
// caller's choice where that fits).
extern "C" int repro_slstm_scan_bwd_persistent(const void* dout, const void* r, const float* z,
                                               const float* state, float* dz,
                                               unsigned int* arrived, int t, int b, int d,
                                               int heads, int units, int wide_r, int dtype,
                                               void* stream) {
  const int rows = b <= 4 ? 4 : kMaxRows;
  if (t <= 0 || b <= 0 || b > kMaxRows || d <= 0 || heads <= 0 || d % heads != 0 ||
      (d / heads) % kGroupUnits != 0 || units <= 0 || units % kGroupUnits != 0 ||
      units * rows > kThreads || reinterpret_cast<uintptr_t>(r) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float, float>(dout, r, z, state, dz, arrived, t, b, d, heads, units, s);
  }
  if (dtype == 1 && wide_r) {
    return dispatch<__nv_bfloat16, float>(dout, r, z, state, dz, arrived, t, b, d, heads,
                                          units, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16, __nv_bfloat16>(dout, r, z, state, dz, arrived, t, b, d,
                                                  heads, units, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[0..3] <- kThreads, kGroupUnits, kMaxRows, kMaxSmem: the constants of
// which kernels/slstm_scan.py's route and grid policy keep copies (checked
// against these on first use).
extern "C" int repro_slstm_scan_bwd_persistent_constants(int* out) {
  out[0] = kThreads;
  out[1] = kGroupUnits;
  out[2] = kMaxRows;
  out[3] = kMaxSmem;
  return 0;
}
