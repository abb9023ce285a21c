// One-token GQA decode attention against a KV cache (flash-decoding) for
// Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/decode_attention.py:
//   decode_attention (_decode_kernel) -> decode_partial_kernel + decode_combine_kernel
// q (B, 1, H, D), the cache's k and v (B, S, Hkv, D), out (B, 1, H, D), in
// the model's own layout.  The new token at position `index` attends to the
// cache positions k_pos <= index, and with a window only to
// index - k_pos < window; positions past `index` hold stale or zero cache
// and are never read.  `index` is a host int, or (index_dev != nullptr) an
// int32 the kernel reads on the device; each block computes the live range
// [begin, end) from it and the window.
//
// What bounds it on this card: bytes.  Each live K and V row is read once
// and costs 4 * D flops per query head, so at the serve shape (B 4, Hkv 8,
// D 128, 512 live keys, bf16) the kernel must move 8.4 MB: 2.5 us at
// 3.35 TB/s.  The design reads each K and V row once per KV head and splits
// the key range across blocks to cover the 132 SMs.  This is the f32-FMA
// route of B6 (f32, head dims 32, 80 and 256, rows TMA cannot read);
// decode_attention_tc.cu takes bf16 at head dims 64 and 128:
//
//   * pass 1: a grid of (splits, Hkv * head chunks, B).  A block takes one
//     KV head, up to 8 of its H / Hkv query heads (one warp each) and one
//     contiguous chunk of live keys.  It stages 32 keys at a time into
//     shared memory (f32); lane j scores key j against its warp's head,
//     the warp takes the running max and sum by shuffles, and each lane
//     accumulates D / 32 output columns.  It writes its partial
//     (m, l, acc[D]) to a (B, H, splits, D + 2) f32 workspace;
//   * pass 2: one block per (head, batch) rescales the partials by
//     exp(m_s - M) and divides by max(sum l_s exp(m_s - M), 1e-30).
//
// Masked entries contribute exactly 0 (a masked score is -inf and the
// running max is finite), every sum runs in a fixed order (no atomics), and
// the split depends on the shape and the live range (host index) or the
// cache length (device index) alone, so the bits repeat from run to run.  A
// split past the live range leaves (m, l, acc) = (-1e30, 0, 0), which the
// combine weighs by exp(-1e30 - M) = 0.  The window is a runtime argument.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKeyTile = 32;       // keys staged a step: one per lane
constexpr int kMaxHeads = 8;       // query heads (warps) a block
constexpr int kCombineThreads = 128;
constexpr float kNegBig = -1e30f;  // the reference's NEG_INF: the running max's start

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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D> struct Shape {
  static constexpr int DC = (D + 31) / 32;       // output columns a lane
  static constexpr int LD = D + 1;               // padded K row: lane j reads row j
  static constexpr int kSmem = (kMaxHeads * D + kKeyTile * LD + kKeyTile * D) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kMaxHeads * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ ws,
                      const int* __restrict__ index_dev, int index_host, int s, int h,
                      int hkv, int head_chunks, int window, int chunk, int splits,
                      float scale) {
  using C = Shape<D>;
  extern __shared__ float smem[];
  const int heads = blockDim.x >> 5;             // warps = query heads this block
  float* qs = smem;                              // heads x D
  float* ks = qs + heads * D;                    // kKeyTile x LD
  float* vs = ks + kKeyTile * C::LD;             // kKeyTile x D

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / head_chunks;
  const int group = h / hkv;
  const int h0 = kvh * group + (blockIdx.y % head_chunks) * kMaxHeads;
  const int h_end = min(kvh * group + group, h0 + heads);
  const int b = blockIdx.z;
  const int head = h0 + warp;
  const bool active = head < h_end;

  const int64_t kv_step = static_cast<int64_t>(hkv) * D;
  const T* kb = k + (static_cast<int64_t>(b) * s * hkv + kvh) * D;
  const T* vb = v + (static_cast<int64_t>(b) * s * hkv + kvh) * D;
  const T* qb = q + (static_cast<int64_t>(b) * h + h0) * D;
  for (int i = tid; i < heads * D; i += blockDim.x) {
    qs[i] = h0 + i / D < h_end ? to_f32(qb[i]) : 0.f;
  }

  const int index = index_dev != nullptr ? __ldg(index_dev) : index_host;
  const int k_end = min(index + 1, s);
  const int k_begin = window > 0 ? max(0, index - window + 1) : 0;
  const int lo = k_begin + split * chunk;
  const int hi = min(k_end, lo + chunk);
  float m = kNegBig, l = 0.f;
  float acc[C::DC];
#pragma unroll
  for (int c = 0; c < C::DC; ++c) acc[c] = 0.f;

  for (int t0 = lo; t0 < hi; t0 += kKeyTile) {
    __syncthreads();                             // previous tile's readers are done
    for (int i = tid; i < kKeyTile * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = t0 + j;
      const bool in = key < hi;
      ks[j * C::LD + d] = in ? to_f32(kb[key * kv_step + d]) : 0.f;
      vs[j * D + d] = in ? to_f32(vb[key * kv_step + d]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    const float* qh = qs + warp * D;
    const float* kr = ks + lane * C::LD;
    float sc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) sc = fmaf(qh[d], kr[d], sc);
    sc = t0 + lane < hi ? sc * scale : -INFINITY;
    const float m_new = fmaxf(m, warp_max(sc));  // finite: m starts at -1e30
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);            // exactly 0 where masked
    l = l * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int c = 0; c < C::DC; ++c) acc[c] *= alpha;
#pragma unroll 4
    for (int j = 0; j < kKeyTile; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int c = 0; c < C::DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) acc[c] = fmaf(pj, vs[j * D + d], acc[c]);
      }
    }
  }

  if (!active) return;
  float* w = ws + ((static_cast<int64_t>(b) * h + head) * splits + split) * (D + 2);
  if (lane == 0) {
    w[0] = m;
    w[1] = l;
  }
#pragma unroll
  for (int c = 0; c < C::DC; ++c) {
    const int d = lane + 32 * c;
    if (d < D) w[2 + d] = acc[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out, int h, int d,
                      int splits) {
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const float* w = ws + (static_cast<int64_t>(b) * h + head) * splits * (d + 2);
  float big = kNegBig;
  for (int i = 0; i < splits; ++i) big = fmaxf(big, w[i * (d + 2)]);
  float denom = 0.f;
  for (int i = 0; i < splits; ++i) denom += w[i * (d + 2) + 1] * expf(w[i * (d + 2)] - big);
  denom = fmaxf(denom, 1e-30f);
  T* o = out + (static_cast<int64_t>(b) * h + head) * d;
  for (int c = threadIdx.x; c < d; c += kCombineThreads) {
    float acc = 0.f;
    for (int i = 0; i < splits; ++i) {
      acc += w[i * (d + 2) + 2 + c] * expf(w[i * (d + 2)] - big);
    }
    o[c] = from_f32<T>(acc / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, float* ws,
           const int* index_dev, int index_host, int b, int s, int h, int hkv, int window,
           int chunk, int splits, float scale, cudaStream_t stream) {
  using C = Shape<D>;
  auto kernel = decode_partial_kernel<T, D>;
  // Raise the dynamic shared memory cap once, on the first call (before any
  // CUDA-graph capture of the launch).
  static bool configured = false;
  if (!configured && C::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  configured = true;
  const int group = h / hkv;
  const int heads = group < kMaxHeads ? group : kMaxHeads;
  const int head_chunks = (group + kMaxHeads - 1) / kMaxHeads;
  const dim3 grid(splits, hkv * head_chunks, b);
  const int smem = (heads * D + kKeyTile * C::LD + kKeyTile * D) * 4;
  kernel<<<grid, heads * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ws,
      index_dev, index_host, s, h, hkv, head_chunks, window, chunk, splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<dim3(h, b), kCombineThreads, 0, stream>>>(
      ws, static_cast<T*>(out), h, D, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out, float* ws,
             const int* index_dev, int index_host, int b, int s, int h, int hkv, int window,
             int chunk, int splits, float scale, cudaStream_t stream) {
#define REPRO_DECODE_CASE(D)                                                               \
  case D:                                                                                  \
    return launch<T, D>(q, k, v, out, ws, index_dev, index_host, b, s, h, hkv, window,     \
                        chunk, splits, scale, stream);
  switch (d) {
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(80)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_DECODE_CASE
}

}  // namespace

// C interface.  Launches both passes on `stream` and returns
// cudaGetLastError() (0 = launched).  The caller validates devices, dtypes,
// shapes and contiguity, picks the split into `splits` chunks of `chunk`
// keys that cover the live range of a host `index_host` (or, with
// `index_dev`, every live range the cache length allows), and allocates
// `ws` (B * H * splits * (D + 2) floats) and `out` (B, 1, H, D).  dtype: 0 =
// f32, 1 = bf16.  head_dim one of 32, 64, 80, 128, 256.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* out,
                                      float* ws, const int* index_dev, int index_host, int b,
                                      int s, int h, int hkv, int d, int window, int chunk,
                                      int splits, float scale, int dtype, void* stream) {
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || h > 65535 || hkv <= 0 || h % hkv != 0 ||
      window < 0 || chunk <= 0 || splits <= 0 || splits > 65535 ||
      (index_dev == nullptr && (index_host < 0 || index_host >= s))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(d, q, k, v, out, ws, index_dev, index_host, b, s, h, hkv, window,
                           chunk, splits, scale, st);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(d, q, k, v, out, ws, index_dev, index_host, b, s, h, hkv,
                                   window, chunk, splits, scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
