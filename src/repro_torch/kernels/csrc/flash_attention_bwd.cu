// The backward of causal GQA flash attention (B5) for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes).
//
// The JAX package has no backward kernel: its training path differentiates
// the attention through XLA.  The port runs the forward through the B5 kernel
// (csrc/flash_attention.cu), so its gradient is a kernel too, written in the
// FlashAttention-2 manner against the forward's conventions: q, out, dout
// (B, Sq, H, D); k, v (B, Sk, Hkv, D); query head h reads KV head
// h / (H / Hkv); query i sees key j where j <= i and, with a window,
// i - j < window; scores scaled by 1/sqrt(D); lse (B, H, Sq) f32 is the
// forward's log-sum-exp of the scaled scores.  Three kernels:
//
//   * delta_kernel: delta[b, h, i] = sum_d dout * out (f32), a warp a row.
//   * dkdv_kernel: one block per (batch, KV head, tile of BKV keys).  It
//     loops over the group's query heads and the query tiles that can see
//     its keys ([k0, Sq) causal, cut at k0 + BKV - 1 + window with a
//     window), recomputes P = exp(S * scale - lse) and dS = P (dP - delta),
//     and accumulates dV += P^T dO and dK += dS^T Q * scale in registers.
//     Key tiles no query sees (keys >= Sq) write zeros.
//   * dq_kernel: one block per (batch, query head, tile of query rows); it
//     walks the key tiles its rows can see, as the forward does, and
//     accumulates dQ += dS K * scale.
//
// Masked entries are -inf scores, so P is exactly 0 there (lse is finite:
// every row sees its own key).  Every sum runs in a fixed order, the GQA sum
// over a group's heads included, with no atomics: the bits repeat from run
// to run.  f32 or bf16 in and out, every product in f32 FMA (no tensor
// cores); tails masked, no divisibility needed; the window is a runtime
// argument; head dims 32, 64, 80, 128, 256 (the forward's).
//
// What bounds it on this card: at the training shape (B 4, S 512, H 32,
// Hkv 8, D 128, bf16, causal) the function needs 10 D flops per live
// (query, key) pair and head (S recomputed once, dV, dP, dQ, dK): 21.5
// GFLOP, 21.8 us on the bf16 tensor cores; it moves 84 MB (q, k, v, out,
// dout, lse in; dq, dk, dv out): 25.1 us at 3.35 TB/s, so bytes bound it.
// This first kernel recomputes S and dP in both the dK/dV and the dQ
// kernels and runs on the f32 FMA units, so operations bound it in
// practice; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 16 row groups x 8 lanes

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

// Tiles by head dim, rows padded by one float against bank conflicts.
template <int D> struct Tile {
  static constexpr int DC = D / 8;             // output columns a thread
  static constexpr int LD = D + 1;
  // dK/dV: a thread owns TK keys of the block's BKV, and TNQ queries of a
  // BQ-query step in the score tile.
  static constexpr int TK = D > 128 ? 1 : 2;
  static constexpr int BKV = 16 * TK;
  static constexpr int BQ = 32;
  static constexpr int TNQ = BQ / 8;
  static constexpr int LPQ = BQ + 1;
  static constexpr int kSmemKV = (2 * BQ * LD + 2 * BKV * LD + 2 * BKV * LPQ + 2 * BQ) * 4;
  // dQ: a thread owns TM query rows of the block's BQR, and TN keys of a
  // BK-key step in the score tile.
  static constexpr int TM = D > 128 ? 2 : 4;
  static constexpr int BQR = 16 * TM;
  static constexpr int BK = 32;
  static constexpr int TN = BK / 8;
  static constexpr int LPK = BK + 1;
  static constexpr int kSmemQ = (2 * BQR * LD + 2 * BK * LD + BQR * LPK + 2 * BQR) * 4;
};

__device__ __forceinline__ bool live(int qi, int key, int sq, int sk, int window) {
  return qi < sq && key < sk && key <= qi && (window <= 0 || qi - key < window);
}

// Rows [r0, r0 + rows) of a (B, S, heads, D) tensor at (b, head) into
// shared memory as f32 (rows past s load as 0).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int b, int s, int heads,
                                          int head, int r0, int rows) {
  const int64_t step = static_cast<int64_t>(heads) * D;
  const T* base = src + (static_cast<int64_t>(b) * s * heads + head) * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = r0 + r;
    dst[r * (D + 1) + d] = row < s ? to_f32(base[row * step + d]) : 0.f;
  }
}

template <typename T>
__global__ void delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                             float* __restrict__ delta, int b, int sq, int h, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(b) * sq * h) return;
  // row = (bi * sq + i) * h + head: the (B, Sq, H) order of the tensors
  const T* o = out + row * d;
  const T* g = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_f32(o[c]), to_f32(g[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int head = static_cast<int>(row % h);
    const int64_t bi_i = row / h;
    const int i = static_cast<int>(bi_i % sq);
    const int bi = static_cast<int>(bi_i / sq);
    delta[(static_cast<int64_t>(bi) * h + head) * sq + i] = s;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int sq,
            int sk, int h, int hkv, int window, float scale) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* qs = smem;                      // BQ x LD
  float* dos = qs + C::BQ * C::LD;       // BQ x LD
  float* ks = dos + C::BQ * C::LD;       // BKV x LD
  float* vs = ks + C::BKV * C::LD;       // BKV x LD
  float* pt = vs + C::BKV * C::LD;       // BKV x LPQ: P^T
  float* dst = pt + C::BKV * C::LPQ;     // BKV x LPQ: dS^T
  float* lse_s = dst + C::BKV * C::LPQ;  // BQ
  float* dlt_s = lse_s + C::BQ;          // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int k0 = blockIdx.x * C::BKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = h / hkv;

  load_rows<T, D>(ks, k, b, sk, hkv, kvh, k0, C::BKV);
  load_rows<T, D>(vs, v, b, sk, hkv, kvh, k0, C::BKV);

  float adk[C::TK][C::DC], adv[C::TK][C::DC];
#pragma unroll
  for (int a = 0; a < C::TK; ++a)
#pragma unroll
    for (int c = 0; c < C::DC; ++c) adk[a][c] = adv[a][c] = 0.f;

  const int q_end = window > 0 ? min(sq, k0 + C::BKV - 1 + window) : sq;
  for (int hh = 0; hh < group; ++hh) {
    const int head = kvh * group + hh;
    const float* lse_h = lse + (static_cast<int64_t>(b) * h + head) * sq;
    const float* dlt_h = delta + (static_cast<int64_t>(b) * h + head) * sq;
    for (int qt = k0; qt < q_end; qt += C::BQ) {
      __syncthreads();                   // the previous step's readers are done
      load_rows<T, D>(qs, q, b, sq, h, head, qt, C::BQ);
      load_rows<T, D>(dos, dout, b, sq, h, head, qt, C::BQ);
      for (int i = tid; i < C::BQ; i += kThreads) {
        const bool in = qt + i < sq;
        lse_s[i] = in ? lse_h[qt + i] : 0.f;
        dlt_s[i] = in ? dlt_h[qt + i] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty * TK + a and queries tx + 8 n.
      float s[C::TK][C::TNQ], dp[C::TK][C::TNQ];
#pragma unroll
      for (int a = 0; a < C::TK; ++a)
#pragma unroll
        for (int n = 0; n < C::TNQ; ++n) s[a][n] = dp[a][n] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[C::TK], vv[C::TK], qv[C::TNQ], gv[C::TNQ];
#pragma unroll
        for (int a = 0; a < C::TK; ++a) {
          kv[a] = ks[(ty * C::TK + a) * C::LD + d];
          vv[a] = vs[(ty * C::TK + a) * C::LD + d];
        }
#pragma unroll
        for (int n = 0; n < C::TNQ; ++n) {
          qv[n] = qs[(tx + 8 * n) * C::LD + d];
          gv[n] = dos[(tx + 8 * n) * C::LD + d];
        }
#pragma unroll
        for (int a = 0; a < C::TK; ++a)
#pragma unroll
          for (int n = 0; n < C::TNQ; ++n) {
            s[a][n] = fmaf(kv[a], qv[n], s[a][n]);
            dp[a][n] = fmaf(vv[a], gv[n], dp[a][n]);
          }
      }
#pragma unroll
      for (int a = 0; a < C::TK; ++a)
#pragma unroll
        for (int n = 0; n < C::TNQ; ++n) {
          const int jr = ty * C::TK + a;
          const int ic = tx + 8 * n;
          const float p = live(qt + ic, k0 + jr, sq, sk, window)
                              ? expf(s[a][n] * scale - lse_s[ic]) : 0.f;
          pt[jr * C::LPQ + ic] = p;
          dst[jr * C::LPQ + ic] = p * (dp[a][n] - dlt_s[ic]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the step's queries, in order.
#pragma unroll 2
      for (int i = 0; i < C::BQ; ++i) {
        float p[C::TK], ds[C::TK];
#pragma unroll
        for (int a = 0; a < C::TK; ++a) {
          p[a] = pt[(ty * C::TK + a) * C::LPQ + i];
          ds[a] = dst[(ty * C::TK + a) * C::LPQ + i];
        }
#pragma unroll
        for (int c = 0; c < C::DC; ++c) {
          const float g = dos[i * C::LD + tx + 8 * c];
          const float x = qs[i * C::LD + tx + 8 * c];
#pragma unroll
          for (int a = 0; a < C::TK; ++a) {
            adv[a][c] = fmaf(p[a], g, adv[a][c]);
            adk[a][c] = fmaf(ds[a], x, adk[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < C::TK; ++a) {
    const int key = k0 + ty * C::TK + a;
    if (key >= sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * sk + key) * hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) {
      dk[off + tx + 8 * c] = from_f32<T>(adk[a][c] * scale);
      dv[off + tx + 8 * c] = from_f32<T>(adv[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, int h, int hkv,
          int window, float scale) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* qs = smem;                        // BQR x LD
  float* dos = qs + C::BQR * C::LD;        // BQR x LD
  float* ks = dos + C::BQR * C::LD;        // BK x LD
  float* vs = ks + C::BK * C::LD;          // BK x LD
  float* dss = vs + C::BK * C::LD;         // BQR x LPK: dS
  float* lse_s = dss + C::BQR * C::LPK;    // BQR
  float* dlt_s = lse_s + C::BQR;           // BQR

  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int q0 = blockIdx.x * C::BQR;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const float* lse_h = lse + (static_cast<int64_t>(b) * h + head) * sq;
  const float* dlt_h = delta + (static_cast<int64_t>(b) * h + head) * sq;

  load_rows<T, D>(qs, q, b, sq, h, head, q0, C::BQR);
  load_rows<T, D>(dos, dout, b, sq, h, head, q0, C::BQR);
  for (int i = tid; i < C::BQR; i += kThreads) {
    const bool in = q0 + i < sq;
    lse_s[i] = in ? lse_h[q0 + i] : 0.f;
    dlt_s[i] = in ? dlt_h[q0 + i] : 0.f;
  }

  float acc[C::TM][C::DC];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int c = 0; c < C::DC; ++c) acc[i][c] = 0.f;

  const int k_end = min(sk, q0 + C::BQR);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_begin; kt < k_end; kt += C::BK) {
    __syncthreads();                     // the previous tile's readers are done
    load_rows<T, D>(ks, k, b, sk, hkv, kvh, kt, C::BK);
    load_rows<T, D>(vs, v, b, sk, hkv, kvh, kt, C::BK);
    __syncthreads();

    float s[C::TM][C::TN], dp[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int n = 0; n < C::TN; ++n) s[i][n] = dp[i][n] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[C::TM], gv[C::TM], kv[C::TN], vv[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) {
        qv[i] = qs[(ty * C::TM + i) * C::LD + d];
        gv[i] = dos[(ty * C::TM + i) * C::LD + d];
      }
#pragma unroll
      for (int n = 0; n < C::TN; ++n) {
        kv[n] = ks[(tx + 8 * n) * C::LD + d];
        vv[n] = vs[(tx + 8 * n) * C::LD + d];
      }
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int n = 0; n < C::TN; ++n) {
          s[i][n] = fmaf(qv[i], kv[n], s[i][n]);
          dp[i][n] = fmaf(gv[i], vv[n], dp[i][n]);
        }
    }
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int n = 0; n < C::TN; ++n) {
        const int r = ty * C::TM + i;
        const int jc = tx + 8 * n;
        const float p = live(q0 + r, kt + jc, sq, sk, window)
                            ? expf(s[i][n] * scale - lse_s[r]) : 0.f;
        dss[r * C::LPK + jc] = p * (dp[i][n] - dlt_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < C::BK; ++j) {
      float ds[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) ds[i] = dss[(ty * C::TM + i) * C::LPK + j];
#pragma unroll
      for (int c = 0; c < C::DC; ++c) {
        const float x = ks[j * C::LD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < C::TM; ++i) acc[i][c] = fmaf(ds[i], x, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qi = q0 + ty * C::TM + i;
    if (qi >= sq) continue;
    T* o = dq + ((static_cast<int64_t>(b) * sq + qi) * h + head) * D;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) o[tx + 8 * c] = from_f32<T>(acc[i][c] * scale);
  }
}

// Raise a kernel's dynamic shared memory cap once, on its first launch.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq, int sk,
           int h, int hkv, int window, float scale, cudaStream_t stream) {
  using C = Tile<D>;
  static bool kv_done = false, q_done = false;
  cudaError_t err = allow_smem(dkdv_kernel<T, D>, C::kSmemKV, &kv_done);
  if (err == cudaSuccess) err = allow_smem(dq_kernel<T, D>, C::kSmemQ, &q_done);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t rows = static_cast<int64_t>(b) * sq * h;
  delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, b, sq, h, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D><<<dim3((sk + C::BKV - 1) / C::BKV, hkv, b), kThreads, C::kSmemKV,
                      stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq,
      sk, h, hkv, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D><<<dim3((sq + C::BQR - 1) / C::BQR, h, b), kThreads, C::kSmemQ, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, sk, h, hkv, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
             int b, int sq, int sk, int h, int hkv, int window, float scale,
             cudaStream_t s) {
  switch (d) {
#define REPRO_CASE(D)                                                                     \
  case D:                                                                                 \
    return launch<T, D>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv,   \
                        window, scale, s);
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(80)
    REPRO_CASE(128)
    REPRO_CASE(256)
#undef REPRO_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface.  Launches the three kernels on `stream` and returns the first
// cudaError_t (0 = launched).  The caller validates devices, dtypes, shapes
// and contiguity, and allocates delta (B, H, Sq) f32 scratch and dq (B, Sq,
// H, D), dk and dv (B, Sk, Hkv, D) in the inputs' dtype.  dtype: 0 = f32,
// 1 = bf16.  head_dim one of 32, 64, 80, 128, 256; 1 <= Sq <= Sk.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const float* lse,
                                         float* delta, void* dq, void* dk, void* dv, int b,
                                         int sq, int sk, int h, int hkv, int d, int window,
                                         float scale, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || sq > sk || h <= 0 || h > 65535 || hkv <= 0 ||
      h % hkv != 0 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk,
                                   h, hkv, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
