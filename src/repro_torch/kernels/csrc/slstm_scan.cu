// sLSTM time scan for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/slstm_scan.py:
//   slstm_scan (_slstm_kernel) -> slstm_step_kernel, launched once a step
// pre (T, B, 4d) input pre-activations and r (H, dh, 4dh) recurrent weights,
// f32 or bf16 (one dtype); out (T, B, d) hidden states in that dtype.  State
// (h, c, n, m) and arithmetic are f32; r and pre are widened in registers.
// At step t, with h_prev the previous step's h (0 at t = 0):
//
//   z[b, c] = pre[t, b, c] + sum_k h_prev[b, head * dh + k] * r[head, k, e]
//             with head = c / (4 dh), e = c % (4 dh)          (c in [0, 4d))
//   li, lf_raw, zz, oo = z[:, 0:d], z[:, d:2d], z[:, 2d:3d], z[:, 3d:4d]
//   lf = logsigmoid(lf_raw);  m' = max(lf + m, li)            (m starts at -1e30)
//   i = exp(li - m');  f = exp(lf + m - m')
//   c' = f c + i tanh(zz);  n' = f n + i;  h = sigmoid(oo) c' / max(n', 1)
//
// The gate layout.  The reference reshapes the per-head product head-major
// and then splits it into quarters, so head j's R feeds the columns
// [j 4dh, (j+1) 4dh): at H = 4 the whole of gate j for every unit, at H = 2
// gates i and f (head 0) and z and o (head 1).  It is not "[i, f, z, o] per
// head", as the reference kernel's docstring reads: a kernel written from
// that reading agrees at H = 1 only.  Unit u's four gate columns are g d + u,
// g = 0..3, each with its own head.
//
// What bounds it on this card.  Operations, by the roofline: 2 T B 4d dh
// flops in f32 (h is an f32 state), 17.2 GFLOP at the prefill shape (T 512,
// B 4, d 2,048, H 4), 256 us at 67 TFLOP/s, against 50 MB of pre, out and r
// (15 us at 3.35 TB/s).  But the scan is a chain: step t needs all of step
// t - 1's h, so T steps each pay one grid-wide dependency (here a kernel
// boundary), a floor the roofline does not see.  This kernel is the simple
// route: slstm_scan_persistent.cu keeps R and the state on chip across all
// T steps in one cooperative launch and takes every shape whose R fits the
// co-resident grid; this one takes the rest (kernels/slstm_scan.py::
// slstm_route).
//
//   * one launch a step, on the caller's stream; R (8.4 MB in bf16 at the
//     prefill shape) is read from the 50 MB L2 from the second step on;
//   * a block owns 32 units [u0, u0 + 32) of 4 batch rows (grid (d / 32,
//     B / 4), both masked).  It stages h_prev of its rows in shared memory as
//     float4s (the 4 rows of a unit side by side), so one broadcast load
//     feeds 4 FMAs.  Warp w takes gate g = w % 4 and the k range part
//     p = w / 4 of 8 fixed parts of [0, dh); lane l the column g d + u0 + l,
//     so a warp reads 32 consecutive entries of a row of R (coalesced);
//   * after a __syncthreads the partial sums are added part by part, in
//     part order, and 128 threads (unit, row) apply the gating and write c,
//     n, m, h and out[t].  No float atomics: the bits repeat run to run;
//   * h is double-buffered in the workspace (step t reads buffer t % 2 and
//     writes the other), so no block reads an h that another block of the
//     same step writes.  c, n and m of a (row, unit) have one owner.
//
// Any (T, B, d, H) with d % H == 0 and d <= 13,504 (the h_prev staging in
// shared memory) works, not only multiples of 32.
//
// Where a gradient is recorded the caller passes two f32 saves, and the
// gating thread also writes its (row, unit)'s z = pre + rec (T, B, 4d) and
// h, c, n, m (4, T, B, d): what slstm_scan_bwd.cu's reverse scan reads.
// Null saves (the serve path) write nothing more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slstm_gates.cuh"

namespace {

using slstm::from_f32;
using slstm::to_f32;

constexpr int kUnits = 32;                       // units a block: one a lane
constexpr int kGates = 4;
constexpr int kParts = 8;                        // fixed k partition of a dot product
constexpr int kRows = 4;                         // batch rows a block
constexpr int kThreads = kGates * kParts * 32;   // 1,024: warp w = (part, gate)

// One step.  pre_t, out_t point at step t's (B, 4d) and (B, d) rows;
// h_prev/h_next are the two h buffers; first = (t == 0) reads no state.
// z_save (step t's (B, 4d) row of z) and s_save (step t's (B, d) row of the
// state's h plane, planes `plane` floats apart: h, c, n, m) are null unless a
// gradient is recorded.
template <typename T>
__global__ void __launch_bounds__(kThreads)
slstm_step_kernel(const T* __restrict__ pre_t, const T* __restrict__ r,
                  T* __restrict__ out_t, const float* __restrict__ h_prev,
                  float* __restrict__ h_next, float* __restrict__ c, float* __restrict__ n,
                  float* __restrict__ m, float* __restrict__ z_save,
                  float* __restrict__ s_save, int64_t plane, int b, int d, int dh,
                  int first) {
  extern __shared__ float4 h_s[];                       // (d): rows row0..row0+3
  __shared__ float red[kParts][kGates][kRows][kUnits];  // 16 KB of partial sums
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, b - row0);

  for (int j = threadIdx.x; j < d; j += kThreads) {
    float v[kRows] = {0.f, 0.f, 0.f, 0.f};
    if (!first) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < rows) v[i] = h_prev[static_cast<int64_t>(row0 + i) * d + j];
      }
    }
    h_s[j] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = warp % kGates;
  const int part = warp / kGates;
  const int u = blockIdx.x * kUnits + lane;
  float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
  if (u < d) {
    const int e4 = 4 * dh;
    const int col = g * d + u;
    const int head = col / e4;
    const int e = col - head * e4;
    const int kc = (dh + kParts - 1) / kParts;
    const int k0 = part * kc;
    const int k1 = min(k0 + kc, dh);
    const T* rp = r + static_cast<int64_t>(head) * dh * e4 + e;
    const float4* hp = h_s + head * dh;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) {
      const float w = to_f32(rp[static_cast<int64_t>(k) * e4]);
      const float4 hv = hp[k];
      acc[0] = fmaf(hv.x, w, acc[0]);
      acc[1] = fmaf(hv.y, w, acc[1]);
      acc[2] = fmaf(hv.z, w, acc[2]);
      acc[3] = fmaf(hv.w, w, acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) red[part][g][i][lane] = acc[i];
  __syncthreads();

  if (threadIdx.x >= kRows * kUnits) return;
  const int ul = threadIdx.x % kUnits;
  const int i = threadIdx.x / kUnits;
  const int unit = blockIdx.x * kUnits + ul;
  if (unit >= d || i >= rows) return;
  const int64_t row = row0 + i;
  float z[kGates];
#pragma unroll
  for (int gg = 0; gg < kGates; ++gg) {
    float rec = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) rec += red[p][gg][i][ul];
    z[gg] = to_f32(pre_t[row * 4 * d + gg * d + unit]) + rec;
  }
  const int64_t s = row * d + unit;
  float c_s = first ? 0.f : c[s];
  float n_s = first ? 0.f : n[s];
  float m_s = first ? slstm::kMInit : m[s];
  const float h = slstm::gate(z, c_s, n_s, m_s);
  c[s] = c_s;
  n[s] = n_s;
  m[s] = m_s;
  h_next[s] = h;
  out_t[s] = from_f32<T>(h);
  if (z_save != nullptr) {
#pragma unroll
    for (int gg = 0; gg < kGates; ++gg) z_save[row * 4 * d + gg * d + unit] = z[gg];
    s_save[s] = h;
    s_save[plane + s] = c_s;
    s_save[2 * plane + s] = n_s;
    s_save[3 * plane + s] = m_s;
  }
}

// Raise the kernel's dynamic shared memory limit to `smem` once (not on
// every call, so that a call can be captured in a CUDA graph).
template <typename T>
cudaError_t allow_smem(size_t smem) {
  static size_t granted = 0;
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      slstm_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) granted = smem;
  return err;
}

template <typename T>
int scan(const T* pre, const T* r, T* out, float* ws, float* z_save, float* s_save, int t,
         int b, int d, int heads, cudaStream_t stream) {
  const int dh = d / heads;
  const size_t smem = static_cast<size_t>(d) * sizeof(float4);
  cudaError_t err = allow_smem<T>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t bd = static_cast<int64_t>(b) * d;
  float* h_buf[2] = {ws, ws + bd};
  float* c = ws + 2 * bd;
  float* n = ws + 3 * bd;
  float* m = ws + 4 * bd;
  const int64_t plane = static_cast<int64_t>(t) * bd;
  const dim3 grid((d + kUnits - 1) / kUnits, (b + kRows - 1) / kRows);
  for (int step = 0; step < t; ++step) {
    slstm_step_kernel<T><<<grid, kThreads, smem, stream>>>(
        pre + step * 4 * bd, r, out + step * bd, h_buf[step & 1], h_buf[(step + 1) & 1],
        c, n, m, z_save == nullptr ? nullptr : z_save + step * 4 * bd,
        s_save == nullptr ? nullptr : s_save + step * bd, plane, b, d, dh, step == 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// C interface.  Launches T step kernels on `stream` and returns the first
// cudaError_t (0 = launched).  The caller validates shapes, types and
// devices and allocates `out` (T, B, d) in pre's dtype and the f32
// workspace `ws` (5, B, d): h twice, c, n, m.  dtype: 0 = f32, 1 = bf16.
// Where a gradient is recorded, z_save (T, B, 4d) and s_save (4, T, B, d),
// both f32, take each step's z and its state h, c, n, m for
// slstm_scan_bwd.cu; both null otherwise.
extern "C" int repro_slstm_scan(const void* pre, const void* r, void* out, float* ws,
                                float* z_save, float* s_save, int t, int b, int d, int heads,
                                int dtype, void* stream) {
  if (t <= 0 || b <= 0 || d <= 0 || heads <= 0 || d % heads != 0 ||
      (b + kRows - 1) / kRows > 65535 ||
      static_cast<size_t>(d) * sizeof(float4) + sizeof(float) * kParts * kGates * kRows * kUnits >
          227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((z_save == nullptr) != (s_save == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return scan(static_cast<const float*>(pre), static_cast<const float*>(r),
                static_cast<float*>(out), ws, z_save, s_save, t, b, d, heads, s);
  }
  if (dtype == 1) {
    return scan(static_cast<const __nv_bfloat16*>(pre), static_cast<const __nv_bfloat16*>(r),
                static_cast<__nv_bfloat16*>(out), ws, z_save, s_save, t, b, d, heads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
