// The backward of GQA flash attention (B5), causal or not, on Hopper's
// tensor cores (sm_90a): the bf16 route, bound to Python through a plain C interface
// (ctypes).  flash_attention_bwd.cu keeps the f32-FMA route (f32, head dim
// 32, tensors TMA cannot read).
//
// The JAX package has no backward kernel: its training path differentiates
// attend (src/repro/models/attention.py:82) through XLA.  Conventions of the
// forward (flash_attention_tc.cu): q, out, dout (B, Sq, H, D); k, v (B, Sk,
// Hkv, D), bf16 in the model's own layout; query head h reads KV head
// h / (H / Hkv); query i sees key j where j <= i (causal) and, with
// window > 0, i - j < window; with causal = 0 (a runtime argument, the
// forward's flag) only the window masks, keys ahead of the query stay live
// and Sq may exceed Sk; scores scaled by 1/sqrt(D); lse (B, H, Sq) f32 the
// forward's log-sum-exp.  D is 64, 80, 128 or 256.  Three kernels, the
// f32-FMA route's structure:
//
//   * flash_bwd_delta_kernel: delta[b, h, i] = sum_d dout * out (f32), a
//     warp a row, bf16 pairs, a fixed order.
//   * flash_bwd_dkdv_tc_kernel: one block per (KV head, batch, 128-key
//     tile), two warpgroups of 64 keys (at D 256 64-key tiles, below).  K
//     and V stay in shared memory; the block walks the group's query heads,
//     then the 64-query tiles that can see its keys ([k0, Sq) causal, [0,
//     Sq) not, cut at k0 + 127 + window with a window); Q and dO tiles
//     arrive by TMA into a two-stage ring, an mbarrier a stage;
//     each tile's lse and delta are read through the read-only cache into
//     registers (16 queries a thread).  A warpgroup, a tile:
//       S^T  = K Q^T      wgmma SS m64n64k16, K and Q both K-major;
//       dP^T = V dO^T     SS, both K-major;
//       P^T  = exp2(S^T * scale * log2 e - lse * log2 e), -inf where masked;
//       dS^T = P^T (dP^T - delta);
//       dV  += P^T dO     RS m64nDk16: P^T packed to bf16 from its
//                         accumulator fragment, which is the A fragment (the
//                         forward does so with P); dO the MN-major B operand
//                         (the transpose bit);
//       dK  += dS^T Q     RS, Q MN-major.  dK is scaled once at the end.
//     Causal, key tiles no query sees (keys >= Sq) write zeros; not causal,
//     query 0 sees every key.
//   * flash_bwd_dq_tc_kernel: one block per (query head, batch, 128 query
//     rows), two warpgroups of 64 rows (at D 256 64 rows, below).  Q and dO
//     stay in shared memory; the
//     block walks the live key range [max(0, q0 - window + 1), min(Sk,
//     q0 + 128)) (to Sk when not causal) in 64-key tiles as the forward
//     does, K and V by TMA into a
//     two-stage ring.  S = Q K^T (SS), dP = dO V^T (SS, V K-major), dS as
//     above, dQ += dS K (RS, K MN-major), scaled at the end.
//
// A warpgroup skips a tile in which none of its (query, key) pairs is live
// (which would change nothing); kernels/flash_attention.py::bwd_tc_walks
// computes the same walks and tests/test_torch_bwd_routes.py checks that
// they visit every live pair exactly once.  TMA fills rows outside the
// tensor with zeros (the tails in Sq and Sk need no divisibility), and those
// rows are masked.  Every sum runs in a fixed order, the GQA sum over a
// group's heads included, with no atomics: the bits repeat from run to run.
//
// Load balance.  Under the causal mask key tile 0 sees every query tile and
// the last key tile one or two.  The grid puts the tile index in its
// slowest dimension, heaviest first (key tile 0 first; the dQ kernel's last
// query tile first), so the blocks with the most work start in the first
// wave and the light ones fill in behind them.  Not causal, every tile
// walks the whole other sequence (a window cuts every tile alike but at the
// ends), so the blocks are equal and the order changes nothing.
//
// What bounds it on this card, at the training shape (B 4, S 512, H 32,
// Hkv 8, D 128, causal): the function needs 10 D flops per live (query,
// key) pair and head (S recomputed once, dP, dV, dQ, dK): 21.5 GFLOP,
// 21.8 us on the bf16 tensor cores; it moves 84 MB (q, k, v, out, dout, lse
// in; dq, dk, dv out): 25.1 us at 3.35 TB/s, so bytes bound the function.
// This design recomputes S and dP in the dQ kernel to stay free of atomics:
// 14 D flops per pair, 30.1 GFLOP, 30.4 us, its own bound.
//
// Head dim 80 (H2O-Danube-1.8B): the D 128 kernels at a padded depth DP =
// 128, as the forward does (flash_attention_tc.cu).  The tensor maps keep
// their real dim 0 of 80, so TMA fills columns 80-127 of every box with
// zeros and still delivers whole boxes (the expected bytes are DP's).  S^T,
// dP^T (and S, dP) run over the real depth, 5 steps of 16; dV += P^T dO,
// dK += dS^T Q and dQ += dS K run at N = 128 on zero columns past 80, and
// every store, step and base address uses the real D: a store of 128
// columns would write into the next head's.  Shared memory and registers
// are the D 128 kernels'.  Work: 8 * 80 + 6 * 128 flops a pair and head
// (S^T, dP^T, S, dP over 80; dV, dK, dQ over 128) against 14 * 80 at an
// unpadded depth: 1.26x.
//
// Head dim 256 (Gemma3-12B).  The D 128 layout does not fit: a warpgroup's
// dK and dV for 64 keys x 256 columns are 256 f32 a thread (the cap is
// 255), and 128 resident keys of K and V plus two stages of 64 queries of Q
// and dO are 262,144 + 1,088 bytes of shared memory (the cap is 232,448).
// So at D 256 both kernels hold 64 keys (dK/dV) or 64 rows (dQ) a block,
// and the two warpgroups split D instead of the rows: warpgroup w owns
// columns [128 w, 128 w + 128) of dK and dV (of dQ).  Each computes the
// whole 64 x 64 S^T and dP^T (S and dP) over the 256-deep product itself,
// so no P^T or dS^T crosses shared memory and no named barrier is needed;
// the price is those two products twice: 8 * 256 + 4 * 256 (dK/dV) and
// 8 * 256 + 2 * 256 (dQ) flops a pair and head, 22 D against 14 D, 1.57x
// (about 48 us of tensor-core time at Gemma3's train shape, (4, 512, 16/8,
// 256) causal).  Budgets a block:
//   registers a thread: dK and dV 64 + 64 f32 (dQ 64), S^T and dP^T 32 + 32,
//     their bf16 A fragments 16 + 16: the D 128 kernels' own count;
//   shared memory: K and V (Q and dO) resident, 2 x 64 rows x 512 bytes =
//     65,536; a two-stage ring of 64-row Q and dO (K and V) tiles, 2 x 2 x
//     32,768 = 131,072; three mbarriers and the 1,024-byte alignment slack:
//     197,696 bytes of 232,448.
// Both warpgroups walk the same tiles (kernels/flash_attention.py::
// bwd_tc_walks with the tiles of bwd_tc_tiles(256)), each over its own
// columns: every (pair, column) is still summed once, in a fixed order.

#include "sm90.cuh"

#include <math.h>

namespace {

using sm90::desc_sw128;
using sm90::smem_u32;

constexpr int kThreads = 256;       // two consumer warpgroups
constexpr int BQ = 64;              // dK/dV: queries a step
constexpr int BK = 64;              // dQ: keys a step
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct BwdTile {
  static constexpr int DP = sm90::box_depth(D);    // depth in shared memory
  static constexpr bool kSplit = DP == 256;        // the warpgroups split D, not the rows
  static constexpr int NB = DP / 64;               // 64-column boxes along DP
  static constexpr int BKV = kSplit ? 64 : 128;    // dK/dV: keys a block
  static constexpr int BQR = kSplit ? 64 : 128;    // dQ: query rows a block
  static constexpr int NA = kSplit ? DP / 2 : DP;  // accumulator columns a warpgroup owns
  static constexpr int kStore = kSplit ? NA : D;   // of them, the columns it stores
  // dK/dV: K and V resident, a two-stage ring of Q and dO tiles
  static constexpr int kKVBytes = NB * BKV * 128;
  static constexpr int kQStage = NB * BQ * 128;
  static constexpr int kSmemKV = 2 * kKVBytes + 4 * kQStage + 64 + 1024;
  // dQ: Q and dO resident, a two-stage ring of K and V tiles
  static constexpr int kQBytes = NB * BQR * 128;
  static constexpr int kKStage = NB * BK * 128;
  static constexpr int kSmemQ = 2 * kQBytes + 4 * kKStage + 64 + 1024;
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448, "over the block's shared memory");
  // the first row (key or query) and the first accumulator column of
  // warpgroup wg
  __device__ static int row0(int wg) { return kSplit ? 0 : 64 * wg; }
  __device__ static int col0(int wg) { return kSplit ? NA * wg : 0; }
};

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) sm90::wgmma_rs_n64<1>(d, a, b, 1);
  else sm90::wgmma_rs_n128<1>(d, a, b, 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// The m64n64 accumulator fragment x (f32) as four bf16 A fragments, one a
// 16-deep step of K.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = sm90::pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
  }
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ bool live(int qi, int key, int sq, int sk, int window, bool causal) {
  return qi < sq && key < sk && (!causal || key <= qi) && (window <= 0 || qi - key < window);
}

// Rows (row, row + 8) of an (S, ., D) slice at `base` (row step `step`
// elements) from a thread's m64nN fragment, its first NS columns, times
// `mul`, as bf16 pairs.
template <int N, int NS>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t step, int row, int rows,
                                           int quad, const float (&acc)[N / 2], float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row + 8 * half;
    if (r >= rows) continue;
    __nv_bfloat16* dst = base + static_cast<int64_t>(r) * step + 2 * quad;
#pragma unroll
    for (int j = 0; j < NS / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
  }
}

__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                       const __nv_bfloat16* __restrict__ dout,
                                       float* __restrict__ delta, int b, int sq, int h, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<int64_t>(b) * sq * h) return;
  // row = (bi * sq + i) * h + head: the (B, Sq, H) order of the tensors
  const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(out + row * d);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(dout + row * d);
  float s = 0.f;
  for (int c = lane; c < d / 2; c += 32) {
    const float2 a = __bfloat1622float2(o[c]);
    const float2 x = __bfloat1622float2(g[c]);
    s = fmaf(a.x, x.x, s);
    s = fmaf(a.y, x.y, s);
  }
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int sk, int h, int hkv,
                         int window, int causal, float scale, float scale_log2) {
  using C = BwdTile<D>;
  extern __shared__ uint8_t smem_raw[];
  constexpr int BKV = C::BKV;
  uint8_t* ks = align_1024(smem_raw);        // [box][BKV rows of 128 bytes]
  uint8_t* vs = ks + C::kKVBytes;
  uint8_t* qs = vs + C::kKVBytes;            // [stage][box][BQ rows of 128 bytes]
  uint8_t* dos = qs + 2 * C::kQStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dos + 2 * C::kQStage);  // K/V, stage 0, 1

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;
  const int group = h / hkv;
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(sq, k0 + BKV - 1 + window) : sq;
  const int n_qt = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;
  const int n_tiles = group * n_qt;

  auto load_q = [&](int i, int stage) {
    const int head = kvh * group + i / n_qt;
    const int qt = q_begin + (i % n_qt) * BQ;
    uint64_t* bar = &bars[1 + stage];
    sm90::mbar_arrive_expect_tx(bar, 2 * C::kQStage);
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      sm90::tma_load_4d(qs + stage * C::kQStage + j * BQ * 128, &tq, bar, 64 * j, head, qt, b);
      sm90::tma_load_4d(dos + stage * C::kQStage + j * BQ * 128, &tdo, bar, 64 * j, head, qt, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(&bars[0], 2 * C::kKVBytes);
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      sm90::tma_load_4d(ks + j * BKV * 128, &tk, &bars[0], 64 * j, kvh, k0, b);
      sm90::tma_load_4d(vs + j * BKV * 128, &tv, &bars[0], 64 * j, kvh, k0, b);
    }
    if (n_tiles > 0) load_q(0, 0);
    if (n_tiles > 1) load_q(1, 1);
  }

  const int kw0 = k0 + C::row0(wg);          // this warpgroup's first key
  const int kmax = min(kw0 + 63, sk - 1);
  const int key0 = kw0 + 16 * warp + (lane >> 2);   // this thread's keys: key0, key0 + 8
  const int box0 = C::col0(wg) / 64;         // the box of its first dK/dV column
  float dv_acc[C::NA / 2], dk_acc[C::NA / 2];
  zero(dv_acc);
  zero(dk_acc);

  sm90::mbar_wait(&bars[0], 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    const int head = kvh * group + i / n_qt;
    const int qt = q_begin + (i % n_qt) * BQ;
    sm90::mbar_wait(&bars[1 + stage], (i >> 1) & 1);
    const int qmax = min(qt + BQ - 1, sq - 1);
    const bool seen = kw0 < sk && (!causal || kw0 <= qmax) && (window <= 0 || qt - kmax < window);
    if (seen) {
      const uint8_t* q_st = qs + stage * C::kQStage;
      const uint8_t* do_st = dos + stage * C::kQStage;
      float st[32], dpt[32];
      zero(st);
      zero(dpt);
      sm90::fence_operands(st);
      sm90::fence_operands(dpt);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * BKV * 128 + C::row0(wg) * 128 + (kk & 3) * 32;
        const int boff = (kk >> 2) * BQ * 128 + (kk & 3) * 32;
        sm90::wgmma_ss_n64<0>(st, desc_sw128(smem_u32(ks + off), 16, 1024),
                              desc_sw128(smem_u32(q_st + boff), 16, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * BKV * 128 + C::row0(wg) * 128 + (kk & 3) * 32;
        const int boff = (kk >> 2) * BQ * 128 + (kk & 3) * 32;
        sm90::wgmma_ss_n64<0>(dpt, desc_sw128(smem_u32(vs + off), 16, 1024),
                              desc_sw128(smem_u32(do_st + boff), 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(st);
      sm90::fence_operands(dpt);

      // st[4 * j8 + 2 * half + c] is key key0 + 8 * half, query
      // qt + 8 * j8 + 2 * quad + c
      const float* lse_h = lse + (static_cast<int64_t>(b) * h + head) * sq;
      const float* dlt_h = delta + (static_cast<int64_t>(b) * h + head) * sq;
#pragma unroll
      for (int j8 = 0; j8 < BQ / 8; ++j8) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = qt + 8 * j8 + 2 * quad + c;
          const bool in = qi < sq;
          const float l2 = in ? __ldg(lse_h + qi) * kLog2e : 0.f;
          const float dl = in ? __ldg(dlt_h + qi) : 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int idx = 4 * j8 + 2 * half + c;
            const float sc = live(qi, key0 + 8 * half, sq, sk, window, causal)
                                 ? fmaf(st[idx], scale_log2, -l2) : -INFINITY;
            const float p = exp2f(sc);                 // exactly 0 where masked
            st[idx] = p;
            dpt[idx] = p * (dpt[idx] - dl);
          }
        }
      }
      uint32_t pa[4][4], dsa[4][4];
      pack_a(pa, st);
      pack_a(dsa, dpt);
      sm90::fence_operands(dv_acc);
      sm90::fence_operands(dk_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<C::NA>(dv_acc, pa[kk], desc_sw128(smem_u32(do_st + box0 * BQ * 128 +
                                                          kk * 16 * 128), BQ * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        mma_rs<C::NA>(dk_acc, dsa[kk], desc_sw128(smem_u32(q_st + box0 * BQ * 128 +
                                                           kk * 16 * 128), BQ * 128, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dv_acc);
      sm90::fence_operands(dk_acc);
    }
    __syncthreads();                 // both warpgroups are done with this stage
    if (tid == 0 && i + 2 < n_tiles) load_q(i + 2, stage);
  }

  const int64_t step = static_cast<int64_t>(hkv) * D;
  const int64_t base = (static_cast<int64_t>(b) * sk) * step + static_cast<int64_t>(kvh) * D +
                       C::col0(wg);
  store_rows<C::NA, C::kStore>(dk + base, step, key0, sk, quad, dk_acc, scale);
  store_rows<C::NA, C::kStore>(dv + base, step, key0, sk, quad, dv_acc, 1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int sq,
                       int sk, int h, int hkv, int window, int causal, float scale,
                       float scale_log2) {
  using C = BwdTile<D>;
  extern __shared__ uint8_t smem_raw[];
  constexpr int BQR = C::BQR;
  uint8_t* qs = align_1024(smem_raw);        // [box][BQR rows of 128 bytes]
  uint8_t* dos = qs + C::kQBytes;
  uint8_t* ks = dos + C::kQBytes;            // [stage][box][BK rows of 128 bytes]
  uint8_t* vs = ks + 2 * C::kKStage;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * C::kKStage);  // Q/dO, stage 0, 1

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQR;     // the heaviest tile first
  const int kvh = head / (h / hkv);
  const int k_end = causal ? min(sk, q0 + BQR) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int i, int stage) {
    const int kt = k_begin + i * BK;
    uint64_t* bar = &bars[1 + stage];
    sm90::mbar_arrive_expect_tx(bar, 2 * C::kKStage);
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      sm90::tma_load_4d(ks + stage * C::kKStage + j * BK * 128, &tk, bar, 64 * j, kvh, kt, b);
      sm90::tma_load_4d(vs + stage * C::kKStage + j * BK * 128, &tv, bar, 64 * j, kvh, kt, b);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(&bars[0], 2 * C::kQBytes);
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      sm90::tma_load_4d(qs + j * BQR * 128, &tq, &bars[0], 64 * j, head, q0, b);
      sm90::tma_load_4d(dos + j * BQR * 128, &tdo, &bars[0], 64 * j, head, q0, b);
    }
    if (n_tiles > 0) load_kv(0, 0);
    if (n_tiles > 1) load_kv(1, 1);
  }

  const int qw0 = q0 + C::row0(wg);          // this warpgroup's first row
  const int qmax = min(qw0 + 63, sq - 1);
  const int row0 = qw0 + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
  float l2[2], dl[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const int64_t at = (static_cast<int64_t>(b) * h + head) * sq + row;
    l2[half] = row < sq ? lse[at] * kLog2e : 0.f;
    dl[half] = row < sq ? delta[at] : 0.f;
  }
  const int box0 = C::col0(wg) / 64;         // the box of its first dQ column
  float dq_acc[C::NA / 2];
  zero(dq_acc);

  sm90::mbar_wait(&bars[0], 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    const int kt = k_begin + i * BK;
    sm90::mbar_wait(&bars[1 + stage], (i >> 1) & 1);
    const int kmax = min(kt + BK - 1, sk - 1);
    const bool seen = qw0 < sq && (!causal || kt <= qmax) && (window <= 0 || qw0 - kmax < window);
    if (seen) {
      const uint8_t* k_st = ks + stage * C::kKStage;
      const uint8_t* v_st = vs + stage * C::kKStage;
      float s[32], dp[32];
      zero(s);
      zero(dp);
      sm90::fence_operands(s);
      sm90::fence_operands(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * BQR * 128 + C::row0(wg) * 128 + (kk & 3) * 32;
        const int boff = (kk >> 2) * BK * 128 + (kk & 3) * 32;
        sm90::wgmma_ss_n64<0>(s, desc_sw128(smem_u32(qs + off), 16, 1024),
                              desc_sw128(smem_u32(k_st + boff), 16, 1024), 1);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * BQR * 128 + C::row0(wg) * 128 + (kk & 3) * 32;
        const int boff = (kk >> 2) * BK * 128 + (kk & 3) * 32;
        sm90::wgmma_ss_n64<0>(dp, desc_sw128(smem_u32(dos + off), 16, 1024),
                              desc_sw128(smem_u32(v_st + boff), 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(s);
      sm90::fence_operands(dp);

      // s[4 * j8 + 2 * half + c] is row row0 + 8 * half, key kt + 8 * j8 + 2 * quad + c
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
#pragma unroll
        for (int j8 = 0; j8 < BK / 8; ++j8) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j8 + 2 * half + c;
            const float sc = live(row, kt + 8 * j8 + 2 * quad + c, sq, sk, window, causal)
                                 ? fmaf(s[idx], scale_log2, -l2[half]) : -INFINITY;
            s[idx] = exp2f(sc) * (dp[idx] - dl[half]);   // dS, exactly 0 where masked
          }
        }
      }
      uint32_t dsa[4][4];
      pack_a(dsa, s);
      sm90::fence_operands(dq_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_rs<C::NA>(dq_acc, dsa[kk], desc_sw128(smem_u32(k_st + box0 * BK * 128 +
                                                           kk * 16 * 128), BK * 128, 1024));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_operands(dq_acc);
    }
    __syncthreads();                 // both warpgroups are done with this stage
    if (tid == 0 && i + 2 < n_tiles) load_kv(i + 2, stage);
  }

  const int64_t step = static_cast<int64_t>(h) * D;
  store_rows<C::NA, C::kStore>(dq + (static_cast<int64_t>(b) * sq) * step +
                                   static_cast<int64_t>(head) * D + C::col0(wg),
                               step, row0, sq, quad, dq_acc, scale);
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
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq, int sk,
           int h, int hkv, int window, int causal, float scale, cudaStream_t stream) {
  using C = BwdTile<D>;
  if ((sk + C::BKV - 1) / C::BKV > 65535 || (sq + C::BQR - 1) / C::BQR > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the dK/dV kernel reads Q and dO in BQ-row tiles, K and V in BKV rows;
  // the dQ kernel Q and dO in BQR rows, K and V in BK-row tiles; every map
  // over the real D (TMA fills a padded box's columns past it with zeros)
  CUtensorMap q_kv, do_kv, k_kv, v_kv, q_q, do_q, k_q, v_q;
  int err = encode_bshd(&q_kv, q, b, sq, h, D, BQ);
  if (err == 0) err = encode_bshd(&do_kv, dout, b, sq, h, D, BQ);
  if (err == 0) err = encode_bshd(&k_kv, k, b, sk, hkv, D, C::BKV);
  if (err == 0) err = encode_bshd(&v_kv, v, b, sk, hkv, D, C::BKV);
  if (err == 0) err = encode_bshd(&q_q, q, b, sq, h, D, C::BQR);
  if (err == 0) err = encode_bshd(&do_q, dout, b, sq, h, D, C::BQR);
  if (err == 0) err = encode_bshd(&k_q, k, b, sk, hkv, D, BK);
  if (err == 0) err = encode_bshd(&v_q, v, b, sk, hkv, D, BK);
  if (err != 0) return err;
  auto dkdv = flash_bwd_dkdv_tc_kernel<D>;
  auto dqk = flash_bwd_dq_tc_kernel<D>;
  // Raise the dynamic shared memory caps once, on the first call (before any
  // CUDA-graph capture of the launches).
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::kSmemKV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemQ);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int64_t rows = static_cast<int64_t>(b) * sq * h;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), delta, b,
      sq, h, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 = scale * kLog2e;
  dkdv<<<dim3(hkv, b, (sk + C::BKV - 1) / C::BKV), kThreads, C::kSmemKV, stream>>>(
      q_kv, k_kv, v_kv, do_kv, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, sk, h, hkv, window, causal, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dqk<<<dim3(h, b, (sq + C::BQR - 1) / C::BQR), kThreads, C::kSmemQ, stream>>>(
      q_q, k_q, v_q, do_q, lse, delta, static_cast<__nv_bfloat16*>(dq), sq, sk, h, hkv, window,
      causal, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface.  Launches the three kernels on `stream` and returns the first
// cudaError_t (0 = launched).  The caller validates devices, dtypes, shapes,
// strides and alignment (bf16, contiguous, 16-byte aligned base addresses,
// which with D % 8 == 0 makes every stride TMA needs a multiple of 16 bytes)
// and allocates delta (B, H, Sq) f32 scratch, dq (B, Sq, H, D) and dk, dv
// (B, Sk, Hkv, D) bf16.  head_dim 64, 80, 128 or 256; Sq, Sk >= 1, Sq <= Sk
// when causal; not causal, every row must see a key (Sq < Sk + window with a
// window), which the caller checks.
extern "C" int repro_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const float* lse,
                                            float* delta, void* dq, void* dk, void* dv, int b,
                                            int sq, int sk, int h, int hkv, int d, int window,
                                            int causal, float scale, void* stream) {
  if (b <= 0 || b > 65535 || sq <= 0 || sk <= 0 || (causal && sq > sk) || h <= 0 || hkv <= 0 ||
      h % hkv != 0 || window < 0 || (!causal && window > 0 && sq >= sk + window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv,
                               window, causal, scale, s);
    case 80: return launch<80>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv,
                               window, causal, scale, s);
    case 128: return launch<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv,
                                 window, causal, scale, s);
    case 256: return launch<256>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, sq, sk, h, hkv,
                                 window, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tiles of each head dim, which kernels/flash_attention.py::
// bwd_tc_tiles copies (build.check_constants holds them equal): for D 64,
// 80, 128, 256 in turn, DP, keys a dK/dV block, rows a dQ block and whether
// the warpgroups split D; then BQ and BK.
extern "C" int repro_flash_attention_bwd_tc_constants(int* out) {
  const int tiles[4][4] = {
      {BwdTile<64>::DP, BwdTile<64>::BKV, BwdTile<64>::BQR, BwdTile<64>::kSplit},
      {BwdTile<80>::DP, BwdTile<80>::BKV, BwdTile<80>::BQR, BwdTile<80>::kSplit},
      {BwdTile<128>::DP, BwdTile<128>::BKV, BwdTile<128>::BQR, BwdTile<128>::kSplit},
      {BwdTile<256>::DP, BwdTile<256>::BKV, BwdTile<256>::BQR, BwdTile<256>::kSplit}};
  for (int i = 0; i < 16; ++i) out[i] = tiles[i / 4][i % 4];
  out[16] = BQ;
  out[17] = BK;
  return 0;
}
