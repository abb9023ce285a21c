// Causal GQA flash attention (prefill) for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention (_flash_kernel) -> flash_fwd_kernel
// q (B, Sq, H, D), k and v (B, Sk, Hkv, D), out (B, Sq, H, D), read and
// written in the model's own layout through strides (no transposes).  Query
// head h of batch b reads KV head h / (H / Hkv) of batch b, the reference's
// index map.  f32 or bf16 in and out; every product and sum in f32 FMA, no
// tensor cores (so f32 stays within 2e-5 of the plain version).  This is
// the f32 route: f32 tensors, head dims 32 and 80, and whatever TMA cannot
// read; bf16 at head dims 64/128/256 takes flash_attention_tc.cu
// (kernels/flash_attention.py::attention_route).
//
// What bounds it on this card: at the serve prefill shape (B 4, S 480, H 32,
// Hkv 8, D 128, bf16) the function moves 39.3 MB (11.7 us at 3.35 TB/s) and
// needs 7.5 GFLOP, 7.6 us of dense bf16 tensor-core math.  This first kernel
// runs its math on the f32 FMA units (67 TFLOP/s peak), so operations bound
// it: the design keeps every score and probability on chip, reads Q, K and V
// once per (query tile, key tile) pair, and blocks the two products in
// registers (a thread owns TM query rows x TN keys of the score tile, then
// TM rows x D/8 output columns).  flash_attention_tc.cu is the wgmma/TMA
// design.
//
//   * grid (ceil(Sq / BQ), H, B); 128 threads; BQ = 16 * TM query rows.
//   * The block walks the key tiles that hold a live key, in ascending order:
//     [max(0, q0 - window + 1), min(Sk, q0 + BQ)): query i sees keys j <= i,
//     and with a window only i - j < window.
//   * Masked entries contribute exactly 0 to the row sum and the
//     accumulator: a masked score is -inf, and exp(-inf - m) == 0 for the
//     finite running max m (which starts at -1e30, as the reference's).  So
//     a tile in which a row has no live key changes nothing, in any tile
//     order, with or without a window.  out = acc / max(l, 1e-30).
//   * Tails: query rows past Sq and keys past the live range load as 0 and
//     are masked or not stored; no divisibility is required.
//   * The window is a runtime argument (0 = none), so one build serves every
//     layer of a local/global stack.
//   * Determinism: every sum runs in a fixed order (no atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 16 row groups x 8 lanes
constexpr float kNegBig = -1e30f; // the reference's NEG_INF: the running max's start

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Tile shapes by head dim: shared memory holds Q (BQ x D), K and V (BK x D)
// and the probabilities (BQ x BK) in f32, rows padded by one float so that
// the column reads of the score product hit distinct banks.
template <int D> struct Tile {
  static constexpr int TM = D > 128 ? 2 : 4;   // query rows a thread
  static constexpr int BQ = 16 * TM;           // query rows a block
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys a tile
  static constexpr int TN = BK / 8;            // keys a thread in the score tile
  static constexpr int DC = D / 8;             // output columns a thread
  static constexpr int LD = D + 1;
  static constexpr int LP = BK + 1;
  static constexpr int kSmem = (BQ * LD + 2 * BK * LD + BQ * LP) * 4;
};

__device__ __forceinline__ float group8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int h,
                 int hkv, int window, float scale) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* qs = smem;                    // BQ x LD
  float* ks = qs + C::BQ * C::LD;      // BK x LD
  float* vs = ks + C::BK * C::LD;      // BK x LD
  float* ps = vs + C::BK * C::LD;      // BQ x LP

  const int tid = threadIdx.x;
  const int tx = tid & 7;              // key / column lane within the row group
  const int ty = tid >> 3;             // row group: rows ty * TM .. + TM - 1
  const int q0 = blockIdx.x * C::BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int64_t q_step = static_cast<int64_t>(h) * D;    // between positions
  const int64_t kv_step = static_cast<int64_t>(hkv) * D;
  const T* qb = q + (static_cast<int64_t>(b) * sq * h + head) * D;
  const T* kb = k + (static_cast<int64_t>(b) * sk * hkv + kvh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * sk * hkv + kvh) * D;

  for (int i = tid; i < C::BQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    qs[r * C::LD + d] = qi < sq ? to_f32(qb[qi * q_step + d]) : 0.f;
  }

  float m[C::TM], l[C::TM], acc[C::TM][C::DC];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = min(sk, q0 + C::BQ);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int kt = k_begin; kt < k_end; kt += C::BK) {
    __syncthreads();                   // the previous tile's readers are done
    for (int i = tid; i < C::BK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = kt + j;
      const bool in = key < k_end;
      ks[j * C::LD + d] = in ? to_f32(kb[key * kv_step + d]) : 0.f;
      vs[j * C::LD + d] = in ? to_f32(vb[key * kv_step + d]) : 0.f;
    }
    __syncthreads();

    float s[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int jj = 0; jj < C::TN; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[C::TM], kv[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) qv[i] = qs[(ty * C::TM + i) * C::LD + d];
#pragma unroll
      for (int jj = 0; jj < C::TN; ++jj) kv[jj] = ks[(tx + 8 * jj) * C::LD + d];
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int jj = 0; jj < C::TN; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int r = ty * C::TM + i;
      const int qi = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < C::TN; ++jj) {
        const int key = kt + tx + 8 * jj;
        const bool live = key <= qi && key < k_end && (window <= 0 || qi - key < window);
        s[i][jj] = live ? s[i][jj] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], group8_max(mx));   // finite: m starts at -1e30
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < C::TN; ++jj) {
        const float p = expf(s[i][jj] - m_new);          // exactly 0 where masked
        ps[r * C::LP + tx + 8 * jj] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + group8_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < C::BK; ++j) {
      float vv[C::DC];
#pragma unroll
      for (int c = 0; c < C::DC; ++c) vv[c] = vs[j * C::LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        const float p = ps[(ty * C::TM + i) * C::LP + j];
#pragma unroll
        for (int c = 0; c < C::DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qi = q0 + ty * C::TM + i;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<int64_t>(b) * sq * h + head) * D + qi * q_step;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) o[tx + 8 * c] = from_f32<T>(acc[i][c] / denom);
    // the row's log-sum-exp of the scaled scores, for the backward
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * h + head) * sq + qi] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int sk, int h, int hkv, int window, float scale, cudaStream_t stream) {
  using C = Tile<D>;
  auto kernel = flash_fwd_kernel<T, D>;
  // Raise the dynamic shared memory cap once, on the first call (before any
  // CUDA-graph capture of the launch).
  static bool configured = false;
  if (!configured && C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  configured = true;
  const dim3 grid((sq + C::BQ - 1) / C::BQ, h, b);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sq, sk, h, hkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out, float* lse, int b,
             int sq, int sk, int h, int hkv, int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface.  Launches one kernel on `stream` and returns its
// cudaError_t (0 = launched).  The caller validates devices, dtypes,
// shapes and contiguity and allocates `out` (B, Sq, H, D) and `lse`
// (B, H, Sq) f32, the rows' log-sum-exp that the backward reads.
// dtype: 0 = f32, 1 = bf16.  head_dim one of 32, 64, 80, 128, 256;
// 1 <= Sq <= Sk.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     float* lse, int b, int sq, int sk, int h, int hkv, int d,
                                     int window, float scale, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || sq > sk || h <= 0 || h > 65535 || hkv <= 0 ||
      h % hkv != 0 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
