// Causal GQA flash attention (prefill) on Hopper's tensor cores (sm_90a):
// the bf16 route of B5's forward, bound to Python through a plain C
// interface (ctypes).  flash_attention.cu keeps the f32 route.
//
// Replaces the TPU kernel of src/repro/kernels/flash_attention.py:
//   flash_attention (_flash_kernel) -> flash_fwd_tc_kernel
// q (B, Sq, H, D), k and v (B, Sk, Hkv, D), out (B, Sq, H, D), all bf16 in
// the model's own layout; lse (B, H, Sq) f32, the rows' log-sum-exp of the
// scaled scores, which flash_attention_bwd.cu reads unchanged.  Query head h
// of batch b reads KV head h / (H / Hkv) of batch b.  D is 64, 128 or 256.
//
// What bounds it on this card: operations.  At one 8k prompt of Qwen3-8B
// (1, 8192, 32/8 heads, D 128) the function needs 550 GFLOP of products
// (556 us on the bf16 tensor cores, 989 TFLOP/s) and moves 84 MB (25 us).
// The f32 route runs the same math on the FMA units (67 TFLOP/s peak).  So
// this kernel puts both products on wgmma and keeps the softmax between
// them in registers:
//
//   * grid (ceil(Sq / 128), H, B); 256 threads, two warpgroups of 64 query
//     rows each.  Q (128 x D) stays in shared memory for the whole block.
//   * K and V tiles (BK keys: 128 for D <= 128, 64 for D 256) arrive by TMA
//     (cp.async.bulk.tensor over a 4-D map (D, H, S, B), boxes of 64 columns
//     with a 128-byte swizzle) into a two-stage ring; an mbarrier per stage
//     counts the bytes.  Thread 0 issues the loads of tile i + 2 once both
//     warpgroups are done with tile i, so one tile loads while one computes.
//   * S = Q K^T: wgmma m64nBKk16, both operands from shared memory, K-major.
//     The online softmax runs on the f32 accumulator fragments: a thread
//     holds two rows, and a row's max and sum come from the four lanes that
//     share it (two shuffles).  Scores are scaled by scale * log2(e) and
//     exponentiated with exp2, so m is kept in that base.
//   * P is rounded to bf16 in registers and fed as wgmma's register A operand
//     of O += P V (m64nDk16): the m64nNk16 accumulator layout is the A
//     fragment layout.  V is the MN-major B operand (the transpose bit).
//     The row sum l is taken over the f32 probabilities.
//   * out = O / max(l, 1e-30) in bf16; lse = m * ln 2 + log(max(l, 1e-30)).
//
// Semantics of the f32 route, kept:
//   * causal (key <= query) and, with window > 0, query - key < window;
//   * the running max starts at -1e30 and a masked score is -inf, so it
//     contributes exactly 0; a warpgroup skips a tile none of its rows can
//     see (which would change nothing);
//   * the block walks only the key tiles that hold a live key,
//     [max(0, q0 - window + 1), min(Sk, q0 + 128));
//   * tails in Sq and Sk need no divisibility: TMA fills rows outside the
//     tensor with zeros (masked or not stored);
//   * every sum runs in a fixed order, no atomics: reruns are bit-identical.

#include "sm90.cuh"

#include <math.h>

namespace {

using sm90::desc_sw128;
using sm90::smem_u32;

constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int BQ = 128;             // query rows a block
constexpr float kNegBig = -1e30f;   // the reference's NEG_INF: the running max's start
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D> struct TcTile {
  static constexpr int BK = D <= 128 ? 128 : 64;   // keys a tile
  static constexpr int NB = D / 64;                // 64-column boxes along D
  static constexpr int kQBytes = NB * BQ * 128;
  static constexpr int kKVBytes = NB * BK * 128;   // one stage of K (or of V)
  // Q, two stages of K and of V, three mbarriers, 1,024 bytes of alignment slack
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 64 + 1024;
};

template <int N, int kTransB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) sm90::wgmma_ss_n64<kTransB>(d, a, b, 1);
  else if constexpr (N == 128) sm90::wgmma_ss_n128<kTransB>(d, a, b, 1);
  else sm90::wgmma_ss_n256<kTransB>(d, a, b, 1);
}

template <int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) sm90::wgmma_rs_n64<kTransB>(d, a, b, 1);
  else if constexpr (N == 128) sm90::wgmma_rs_n128<kTransB>(d, a, b, 1);
  else sm90::wgmma_rs_n256<kTransB>(d, a, b, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int sq, int sk, int h, int hkv, int window,
                    float scale_log2) {
  using C = TcTile<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + C::kQBytes;             // [stage][box][BK rows of 128 bytes]
  uint8_t* vs = ks + 2 * C::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * C::kKVBytes);  // Q, stage 0, stage 1

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const int k_end = min(sk, q0 + BQ);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    const int kt = k_begin + tile * BK;
    uint64_t* bar = &bars[1 + stage];
    sm90::mbar_arrive_expect_tx(bar, 2 * C::kKVBytes);
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      sm90::tma_load_4d(ks + stage * C::kKVBytes + j * BK * 128, &tk, bar, 64 * j, kvh, kt, b);
      sm90::tma_load_4d(vs + stage * C::kKVBytes + j * BK * 128, &tv, bar, 64 * j, kvh, kt, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(&bars[0], C::kQBytes);
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
      sm90::tma_load_4d(qs + j * BQ * 128, &tq, &bars[0], 64 * j, head, q0, b);
    load_kv(0, 0);
    if (n_tiles > 1) load_kv(1, 1);
  }

  // this thread's two query rows (the accumulator fragment's rows)
  const int wg_first = q0 + 64 * wg;
  const int row0 = wg_first + 16 * warp + (lane >> 2);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};

  sm90::mbar_wait(&bars[0], 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    const int kt = k_begin + i * BK;
    sm90::mbar_wait(&bars[1 + stage], (i >> 1) & 1);
    const bool seen = kt <= wg_first + 63 && (window <= 0 || kt + BK - 1 > wg_first - window);
    if (seen) {
      // S = Q K^T
      float s[BK / 2];
#pragma unroll
      for (int x = 0; x < BK / 2; ++x) s[x] = 0.f;
      sm90::fence_operands(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int j = kk >> 2;
        const uint64_t da =
            desc_sw128(smem_u32(qs + j * BQ * 128 + wg * 64 * 128 + (kk & 3) * 32), 16, 1024);
        const uint64_t db = desc_sw128(
            smem_u32(ks + stage * C::kKVBytes + j * BK * 128 + (kk & 3) * 32), 16, 1024);
        mma_ss<BK, 0>(s, da, db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);

      // the online softmax: s[4 * j8 + 2 * half + c] is row row0 + 8 * half,
      // key kt + 8 * j8 + 2 * quad + c
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        float mx = -INFINITY;
#pragma unroll
        for (int j8 = 0; j8 < BK / 8; ++j8) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j8 + 2 * half + c;
            const int key = kt + 8 * j8 + 2 * quad + c;
            const bool live = key <= row && key < k_end && (window <= 0 || row - key < window);
            s[idx] = live ? s[idx] * scale_log2 : -INFINITY;
            mx = fmaxf(mx, s[idx]);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[half], mx);        // finite: m starts at -1e30
        const float alpha = exp2f(m[half] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int j8 = 0; j8 < BK / 8; ++j8) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j8 + 2 * half + c;
            s[idx] = exp2f(s[idx] - m_new);           // exactly 0 where masked
            rs += s[idx];
          }
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[half] = l[half] * alpha + rs;
        m[half] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 2 * half] *= alpha;
          o[4 * j + 2 * half + 1] *= alpha;
        }
      }

      // O += P V, P as bf16 A fragments straight from the S accumulator
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = sm90::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = sm90::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = sm90::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = sm90::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      sm90::fence_operands(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_sw128(smem_u32(vs + stage * C::kKVBytes + kk * 16 * 128),
                                       BK * 128, 1024);
        mma_rs<D, 1>(o, pa[kk], db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(o);
    }
    __syncthreads();                 // both warpgroups are done with this stage
    if (tid == 0 && i + 2 < n_tiles) load_kv(i + 2, stage);
  }

  const int64_t q_step = static_cast<int64_t>(h) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= sq) continue;
    const float denom = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* dst = out + (static_cast<int64_t>(b) * sq + row) * q_step +
                         static_cast<int64_t>(head) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(o[4 * j + 2 * half] / denom,
                                                        o[4 * j + 2 * half + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * quad) = pair;
    }
    if (quad == 0)
      lse[(static_cast<int64_t>(b) * h + head) * sq + row] = m[half] * kLn2 + logf(denom);
  }
}

// The 4-D map (D, heads, S, B) of a (B, S, heads, D) bf16 tensor, read in
// boxes of (64, 1, rows, 1).
int encode_bshd(CUtensorMap* map, const void* base, int b, int s, int heads, int d, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(s), static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {2ull * d, 2ull * d * heads, 2ull * d * heads * s};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return sm90::encode_bf16_map(map, base, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int b, int sq,
           int sk, int h, int hkv, int window, float scale, cudaStream_t stream) {
  using C = TcTile<D>;
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, q, b, sq, h, D, BQ);
  if (err == 0) err = encode_bshd(&tk, k, b, sk, hkv, D, C::BK);
  if (err == 0) err = encode_bshd(&tv, v, b, sk, hkv, D, C::BK);
  if (err != 0) return err;
  auto kernel = flash_fwd_tc_kernel<D>;
  // Raise the dynamic shared memory cap once, on the first call (before any
  // CUDA-graph capture of the launch).
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                               lse, sq, sk, h, hkv, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface.  Launches one kernel on `stream` and returns its cudaError_t
// (0 = launched).  The caller validates devices, dtypes, shapes, strides
// and alignment (bf16, contiguous, 16-byte aligned base addresses, which
// with D % 8 == 0 makes every stride TMA needs a multiple of 16 bytes) and
// allocates `out` (B, Sq, H, D) bf16 and `lse` (B, H, Sq) f32.  head_dim
// one of 64, 128, 256; 1 <= Sq <= Sk.
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                        float* lse, int b, int sq, int sk, int h, int hkv,
                                        int d, int window, float scale, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || sq > sk || h <= 0 || h > 65535 || hkv <= 0 ||
      h % hkv != 0 || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, s);
    case 128: return launch<128>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, s);
    case 256: return launch<256>(q, k, v, out, lse, b, sq, sk, h, hkv, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
