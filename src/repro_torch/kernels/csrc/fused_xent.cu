// Fused softmax cross-entropy (B4) for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/fused_xent.py:
//   fused_xent (_xent_kernel) -> xent_fwd_kernel + xent_combine_kernel
// and adds the backward's elementwise pass (the reference differentiates
// its plain cross-entropy through XLA; the two products of the backward
// stay cuBLAS calls in the wrapper):
//   xent_grad_kernel: logits -> (softmax(logits) - onehot(label)) * g, in place
//
// Forward: hidden h (T, D) and weights W (D, V), f32 or bf16, int32 labels
// (T,).  Writes loss[t] = lse[t] - (h W)[t, label[t]] and lse[t], both f32.
// The product h W is computed in this kernel, panel by panel, and never
// stored: a block owns BT = 128 rows of h and a run of BV = 128-wide vocab
// panels; each panel's (BT x BV) logits tile lives in registers (an 8 x 8
// tile a thread, f32 FMA over D in steps of 16, operands staged through
// double-buffered shared memory), and each thread folds its 8 columns into
// a running (max, sum of exp) for each of its 8 rows.  At the end of its
// panels a block merges its 16 threads' states per row and writes one
// partial (m, l) per (row, block); a second, tiny kernel (xent_combine.cuh)
// merges the partials of a row in block order.  No (T, V) logits in device
// memory, no atomics, so the bits repeat from run to run.
//
// What bounds it on this card: at the training shape (T 2,048, D 4,096,
// V 151,936, bf16) the function needs 2.55 TFLOP of products (2.58 ms on
// the bf16 tensor cores) and moves 1.26 GB (0.38 ms at 3.35 TB/s), so
// operations bound it.  This kernel runs its math on the f32 FMA units (67
// TFLOP/s peak, 38 ms at best): it is the f32 route (f32, and D or V not a
// multiple of 8); bf16 takes the wgmma/TMA kernel of fused_xent_tc.cu
// (kernels/fused_xent.py::xent_route).
//
//   * Tails: rows past T load as 0 and are not written; columns past V are
//     masked out of the max and the sum; D needs no divisibility.  Labels
//     outside [0, V) pick 0, as the reference's kernel (no panel hits).
//   * The running max starts at -1e30 (the reference's NEG_INF) and a masked
//     column is skipped, so a tile with no live column changes nothing.
//   * The picked logit has exactly one writer in the grid (the thread whose
//     column is the label), into a zeroed (T,) buffer.
//   * lse = m + log(max(l, 1e-30)), the reference's finish.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "xent_combine.cuh"

namespace {

constexpr int kThreads = 256;      // 16 x 16: ty owns rows, tx owns columns
constexpr int BT = 128;            // rows of h a block
constexpr int BV = 128;            // vocab columns a panel
constexpr int BK = 16;             // depth a step
constexpr int LDS = BT + 4;        // shared row stride (16-byte aligned rows)
constexpr float kNegBig = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row i of a thread's 8 is ty * 4 + (i & 3) + (i >> 2) * 64; column j is
// tx * 4 + (j & 3) + (j >> 2) * 64: two float4 reads of shared memory each.
__device__ __forceinline__ int own(int lane16, int i) {
  return lane16 * 4 + (i & 3) + (i >> 2) * 64;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
xent_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                const int* __restrict__ labels, float* __restrict__ part,
                float* __restrict__ picked, int t, int d, int v, int panels_per_block,
                int nsplit) {
  __shared__ __align__(16) float as[2][BK][LDS];   // h tile, transposed: [k][row]
  __shared__ __align__(16) float bs[2][BK][LDS];   // W tile: [k][column]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int row0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int n_panels = (v + BV - 1) / BV;
  const int p_begin = split * panels_per_block;
  const int p_end = min(n_panels, p_begin + panels_per_block);

  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
  }

  float ra[8], rb[8];
  // Tile loads: element e = tid + 256 * j.  h: row e / 16, depth e % 16;
  // W: depth e / 128, column e % 128 (a warp reads 128 contiguous columns).
  auto load = [&](int k0, int col0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = tid + kThreads * j;
      const int r = e >> 4, kk = e & 15;
      const int row = row0 + r, k = k0 + kk;
      ra[j] = (row < t && k < d) ? to_f32(h[static_cast<int64_t>(row) * d + k]) : 0.f;
      const int kb = e >> 7, c = e & 127;
      const int kw = k0 + kb, col = col0 + c;
      rb[j] = (kw < d && col < v) ? to_f32(w[static_cast<int64_t>(kw) * v + col]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = tid + kThreads * j;
      as[buf][e & 15][e >> 4] = ra[j];
      bs[buf][e >> 7][e & 127] = rb[j];
    }
  };

  for (int p = p_begin; p < p_end; ++p) {
    const int col0 = p * BV;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    __syncthreads();                 // the previous panel's readers are done
    load(0, col0);
    store(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < d; k0 += BK) {
      const bool more = k0 + BK < d;
      if (more) load(k0 + BK, col0);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4 + 64]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4 + 64]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (more) store(buf ^ 1);      // its last readers finished before the last sync
      __syncthreads();
      buf ^= 1;
    }

    // Fold the panel into each row's running (m, l); pick the label's logit.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + own(ty, i);
      const int lab = row < t ? labels[row] : -1;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + own(tx, j);
        if (col < v) {
          if (col == lab) picked[row] = acc[i][j];
          mx = fmaxf(mx, acc[i][j]);
        } else {
          acc[i][j] = -INFINITY;
        }
      }
      const float m_new = fmaxf(m[i], mx);      // finite: m starts at -1e30
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += expf(acc[i][j] - m_new);   // 0 where masked
      l[i] = l[i] * expf(m[i] - m_new) + s;
      m[i] = m_new;
    }
  }

  // Merge the 16 column threads of each row (lanes tid ^ 1, 2, 4, 8 share
  // ty), then one partial (m, l) per row and block.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
      m[i] = mn;
    }
    const int row = row0 + own(ty, i);
    if (tx == 0 && row < t) {
      float* out = part + (static_cast<int64_t>(row) * nsplit + split) * 2;
      out[0] = m[i];
      out[1] = l[i];
    }
  }
}

// logits (rows, V) f32, in place: (exp(logit - lse[row]) - [col == label]) * g[row].
__global__ void xent_grad_kernel(float* __restrict__ logits, const float* __restrict__ lse,
                                 const int* __restrict__ labels, const float* __restrict__ g,
                                 int v) {
  const int row = blockIdx.y;
  const float r = lse[row];
  const float gr = g[row];
  const int lab = labels[row];
  float* lr = logits + static_cast<int64_t>(row) * v;
  for (int col = blockIdx.x * blockDim.x + threadIdx.x; col < v;
       col += gridDim.x * blockDim.x) {
    const float p = expf(lr[col] - r);
    lr[col] = (col == lab ? p - 1.f : p) * gr;
  }
}

template <typename T>
int launch_fwd(const void* h, const void* w, const int* labels, float* part, float* picked,
               float* loss, float* lse, int t, int d, int v, int panels_per_block,
               int nsplit, cudaStream_t stream) {
  const dim3 grid((t + BT - 1) / BT, nsplit);
  xent_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, part, picked, t, d, v,
      panels_per_block, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  xent_combine_kernel<<<(t + 127) / 128, 128, 0, stream>>>(part, picked, loss, lse, t,
                                                            nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface.  Each function launches on `stream` and returns its
// cudaError_t (0 = launched).  The caller validates devices, dtypes, shapes
// and contiguity and allocates every buffer: part (T, nsplit, 2) f32
// scratch, picked (T,) f32 zeroed, loss and lse (T,) f32.  dtype: 0 = f32,
// 1 = bf16.  nsplit * panels_per_block must cover ceil(V / 128) panels and
// each block must own at least one.
extern "C" int repro_fused_xent(const void* h, const void* w, const int* labels, float* part,
                                float* picked, float* loss, float* lse, int t, int d, int v,
                                int panels_per_block, int nsplit, int dtype, void* stream) {
  const int n_panels = (v + BV - 1) / BV;
  if (t <= 0 || d <= 0 || v <= 0 || panels_per_block <= 0 || nsplit <= 0 ||
      nsplit > 65535 || (nsplit - 1) * panels_per_block >= n_panels ||
      nsplit * panels_per_block < n_panels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(h, w, labels, part, picked, loss, lse, t, d, v,
                             panels_per_block, nsplit, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(h, w, labels, part, picked, loss, lse, t, d, v,
                                     panels_per_block, nsplit, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// logits (rows, V) f32 contiguous, overwritten by dlogits; lse, g (rows,)
// f32; labels (rows,) int32.
extern "C" int repro_xent_grad(float* logits, const float* lse, const int* labels,
                               const float* g, int rows, int v, void* stream) {
  if (rows <= 0 || rows > 65535 || v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int want = (v + threads * 4 - 1) / (threads * 4);
  const int blocks_x = want < 1024 ? want : 1024;
  xent_grad_kernel<<<dim3(blocks_x, rows), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, lse, labels, g, v);
  return static_cast<int>(cudaGetLastError());
}
