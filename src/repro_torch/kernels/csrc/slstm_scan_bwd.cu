// The sLSTM time scan's backward for Hopper (sm_90a): the reverse-time scan,
// bound to Python through a plain C interface (ctypes).
//
// Replaces no TPU kernel: the JAX package trains the sLSTM by XLA autodiff
// of its lax.scan (src/repro/models/xlstm.py: _slstm_step, slstm_forward);
// its Pallas kernel (src/repro/kernels/slstm_scan.py::slstm_scan) has no
// VJP.  This kernel is the backward of the forward kernels slstm_scan.cu and
// slstm_scan_persistent.cu, which, given a workspace, save each step's f32
// z = pre + rec (T, B, 4d) and its f32 state h, c, n, m (4, T, B, d).
//
// The reverse scan (kernels/slstm_scan.py::slstm_scan_bwd_plain is the same
// recurrence in PyTorch).  From dc = dn = dm = 0 and dh_rec = 0 at t = T - 1,
// at step t, for each (row, unit), with a = lf + m_{t-1}, q = max(n_t, 1):
//
//   dh  = dout[t] + dh_rec
//   dP  = dh / q;  dQ = -dh (so c_t) / q^2          (h = so c_t / q)
//   dct = dc + dP so;  dnt = dn + [n_t >= 1] dQ     (clamp_min passes at n = 1)
//   doo = dP c_t so (1 - so)
//   df  = dct c_{t-1} + dnt n_{t-1};  di = dct tanh(zz) + dnt
//   dzz = dct i (1 - tanh(zz)^2)
//   dmt = dm - di i - df f                          (i = e^{li - m_t}, f = e^{a - m_t})
//   the max(a, li) of m_t splits dmt: all to the larger, half each at a tie
//   dli = di i + dmt [li wins];  da = df f + dmt [a wins]
//   dlf_raw = da sigmoid(-lf_raw);  dm <- da;  dc <- dct f;  dn <- dnt f
//
// dz[t] = (dli, dlf_raw, dzz, doo) is written out (f32; dpre is dz cast to
// pre's dtype), and dh_rec of step t - 1 is the per-head product of dz[t]
// with R^T: unit u = j dh + k of head j takes sum_e dz[t, j 4dh + e] R[j, k, e].
// These are the derivative conventions of the plain version's autograd
// (torch.maximum splits a tie evenly, clamp_min passes its whole gradient
// where n >= 1, logsigmoid' = sigmoid(-x)), so the path through the
// stabilizer m is kept: max(n, 1) breaks m's invariance.  At t = 0 the state
// before is (0, 0, -1e30): f = e^{-1e30 - li} = 0, and df f = 0 carries no
// inf; n_0 = 1 exactly, the tie clamp_min passes.
//
// What bounds it on this card.  Operations, like the forward: the per-step
// product is 2 B 4d dh f32 flops (33.5 MFLOP at the prefill shape T 512, B 4,
// d 2,048, H 4; 17.2 GFLOP over T, 256 us at 67 TFLOP/s), against ~218 MB
// read and written once (z, the state and dz 67.1 MB each in f32, dout and
// R 8.4 MB each in bf16: 65 us at 3.35 TB/s).  But, as in the forward, step
// t - 1 needs all of step t's dz, one grid-wide dependency a step.  This is
// the step route: one launch a step (as slstm_scan.cu runs the forward), R^T
// read through L2 every step (8.4 MB in bf16, a row of R a unit: R[j, k, :]
// is contiguous); slstm_scan_bwd_persistent.cu runs the same scan as one
// cooperative launch and takes every shape its plan fits;
//
//   * a block owns kUnits = 16 units of up to 4 batch rows (grid (d / 16,
//     B / 4), both masked); warp w takes unit u0 + w: its lanes walk e over
//     the unit's row of R (coalesced) against dz[t + 1] of the block's rows
//     (read through L1: the block's 16 units mostly share one head's 4dh
//     columns), 4 sums a lane, then a fixed xor butterfly: no atomics, the
//     bits repeat run to run;
//   * after a __syncthreads, 64 threads (row, unit) apply the gate backward
//     above, write dz[t] and carry (dc, dn, dm) in an f32 workspace, each
//     (row, unit) with one owner.
// dR needs no atomics here: dR[j] = sum_t h_{t-1}[:, j]^T dz_t[:, j] is one
// batched product over the T B rows after the scan (kernels/slstm_scan.py::
// recurrent_weight_grad), from the saved f32 h and dz.
//
// Any (T, B, d, H) with d % H == 0 works; dout and r are f32 or bf16 (one
// dtype), z, the state and dz f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slstm_gates.cuh"

namespace {

using slstm::to_f32;

constexpr int kUnits = 16;                       // units a block: one a warp
constexpr int kRows = 4;                         // batch rows a block
constexpr int kThreads = kUnits * 32;            // 512

// One reverse step.  dout_t, z_t and dz_t point at step t's (B, d), (B, 4d)
// and (B, 4d) rows; dz_next at step t + 1's (unused when last); s_t and
// s_prev at steps t and t - 1 of the state's h plane (planes `plane` floats
// apart: h, c, n, m; s_prev unused when first); carry (3, B, d): dc, dn, dm.
template <typename T>
__global__ void __launch_bounds__(kThreads)
slstm_bwd_step_kernel(const T* __restrict__ dout_t, const T* __restrict__ r,
                      const float* __restrict__ z_t, const float* __restrict__ dz_next,
                      const float* __restrict__ s_t, const float* __restrict__ s_prev,
                      float* __restrict__ dz_t, float* __restrict__ carry, int b, int d,
                      int dh, int64_t plane, int last, int first) {
  __shared__ float red[kRows][kUnits];
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, b - row0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t d4 = 4 * static_cast<int64_t>(d);

  if (!last) {                                   // uniform over the grid
    float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
    const int u = blockIdx.x * kUnits + warp;
    if (u < d) {
      const int e4 = 4 * dh;
      const int head = u / dh;
      const int k = u - head * dh;
      const T* rp = r + (static_cast<int64_t>(head) * dh + k) * e4;
      const float* zp = dz_next + static_cast<int64_t>(row0) * d4 +
                        static_cast<int64_t>(head) * e4;
#pragma unroll 4
      for (int e = lane; e < e4; e += 32) {
        const float w = to_f32(rp[e]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i < rows) acc[i] = fmaf(__ldg(zp + i * d4 + e), w, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float v = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[i][warp] = v;
    }
    __syncthreads();
  }

  if (threadIdx.x >= kRows * kUnits) return;
  const int ul = threadIdx.x % kUnits;
  const int i = threadIdx.x / kUnits;
  const int unit = blockIdx.x * kUnits + ul;
  if (unit >= d || i >= rows) return;
  const int64_t row = row0 + i;
  const int64_t bd = static_cast<int64_t>(b) * d;
  const int64_t s = row * d + unit;
  const float* zr = z_t + row * d4 + unit;
  const float zv[4] = {zr[0], zr[d], zr[2 * static_cast<int64_t>(d)],
                       zr[3 * static_cast<int64_t>(d)]};
  float c_p = 0.f, n_p = 0.f, m_p = slstm::kMInit;
  if (!first) {
    c_p = s_prev[plane + s];
    n_p = s_prev[2 * plane + s];
    m_p = s_prev[3 * plane + s];
  }
  float dc = 0.f, dn = 0.f, dm = 0.f, g_h = to_f32(dout_t[s]);
  if (!last) {
    dc = carry[s];
    dn = carry[bd + s];
    dm = carry[2 * bd + s];
    g_h += red[i][ul];
  }
  float dz[4];
  slstm::gate_apply(slstm::gate_prep(zv, s_t[plane + s], s_t[2 * plane + s],
                                     s_t[3 * plane + s], c_p, n_p, m_p),
                    g_h, dc, dn, dm, dz);
  float* dzr = dz_t + row * d4 + unit;
  dzr[0] = dz[0];
  dzr[d] = dz[1];
  dzr[2 * static_cast<int64_t>(d)] = dz[2];
  dzr[3 * static_cast<int64_t>(d)] = dz[3];
  carry[s] = dc;
  carry[bd + s] = dn;
  carry[2 * bd + s] = dm;
}

template <typename T>
int scan_bwd(const T* dout, const T* r, const float* z, const float* state, float* dz,
             float* carry, int t, int b, int d, int heads, cudaStream_t stream) {
  const int dh = d / heads;
  const int64_t bd = static_cast<int64_t>(b) * d;
  const int64_t plane = static_cast<int64_t>(t) * bd;
  const dim3 grid((d + kUnits - 1) / kUnits, (b + kRows - 1) / kRows);
  for (int step = t - 1; step >= 0; --step) {
    const bool last = step == t - 1;
    const bool first = step == 0;
    slstm_bwd_step_kernel<T><<<grid, kThreads, 0, stream>>>(
        dout + step * bd, r, z + step * 4 * bd, last ? dz : dz + (step + 1) * 4 * bd,
        state + step * bd, first ? state : state + (step - 1) * bd, dz + step * 4 * bd,
        carry, b, d, dh, plane, last, first);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// C interface.  Launches T reverse step kernels on `stream` and returns the
// first cudaError_t (0 = launched).  The caller validates shapes, types and
// devices and allocates dz (T, B, 4d) f32 and the f32 workspace `carry` (3,
// B, d).  dout (T, B, d) and r (H, dh, 4dh) in one dtype (0 = f32, 1 =
// bf16); z (T, B, 4d) and state (4, T, B, d) the forward's f32 saves.
extern "C" int repro_slstm_scan_bwd(const void* dout, const void* r, const float* z,
                                    const float* state, float* dz, float* carry, int t, int b,
                                    int d, int heads, int dtype, void* stream) {
  if (t <= 0 || b <= 0 || d <= 0 || heads <= 0 || d % heads != 0 ||
      (b + kRows - 1) / kRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return scan_bwd(static_cast<const float*>(dout), static_cast<const float*>(r), z, state,
                    dz, carry, t, b, d, heads, s);
  }
  if (dtype == 1) {
    return scan_bwd(static_cast<const __nv_bfloat16*>(dout),
                    static_cast<const __nv_bfloat16*>(r), z, state, dz, carry, t, b, d, heads,
                    s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
