// Fused softmax cross-entropy (B4) backward on Hopper's tensor cores
// (sm_90a): the bf16 route's logit gradient, bound to Python through a plain
// C interface (ctypes).  fused_xent.cu keeps the f32 route (cuBLAS f32
// logits, xent_grad in place).
//
// The JAX package has no backward kernel: its training path differentiates
// the chunked cross-entropy (src/repro/models/model.py:258, _chunked_xent)
// through XLA, which leaves the products to the matrix unit.  For one chunk
// of C rows, hidden h (C, D) and weights W (D, V) bf16, this kernel writes
//
//   dl[t, j] = bf16((exp((h W)[t, j] - lse[t]) - [j == label[t]]) * g[t])
//
// (C, V) bf16, with lse the forward's log-sum-exp and g the upstream
// gradient of the per-token loss.  Labels outside [0, V) subtract nothing
// (the plain version's rule); columns past V and rows past C are not
// written.  kernels/fused_xent.py::xent_backward_tc then runs dh_c = dl W^T
// and dW += h_c^T dl on cuBLAS in bf16, the two products XLA's autodiff
// computes outside any kernel.  No (T, V) f32 tensor and no f32 copy of W
// exists on this route.
//
// What bounds it on this card: operations.  At the training shape (T 2,048,
// D 4,096, V 151,936) the recompute is 2.55 TFLOP (2.58 ms on the bf16
// tensor cores) against 0.62 GB of dl written and 1.26 GB read (0.56 ms).
// The mainloop is the forward's (fused_xent_tc.cu):
//
//   * grid (ceil(C / 128), nsplit), one block an SM; a block owns 128 rows
//     and a run of 256-wide vocab panels (panels_per_block, from
//     fused_xent.py::xent_splits); 256 threads, two warpgroups of 64 rows.
//     Every output tile is written once by one block, so no partial state
//     and no combine pass.  Row blocks run fastest in the grid, so the
//     blocks that share a W panel run together and read it from L2; h (one
//     chunk, 14.5 MB) stays in L2.  A block walks its panels in one flat
//     sequence of (panel, 64-deep step of D) loads, so the next panel's
//     loads are in flight during a panel's epilogue: that is why the grid
//     is a run of panels a block and not one tile a block.
//   * h's (128 x 64) box is K-major; W's (64 x 256) slab, four 64-column
//     boxes, is MN-major (the transpose bit); both arrive by TMA with a
//     128-byte swizzle into a four-stage ring, an mbarrier a stage.  Each
//     step is four wgmma m64n256k16 per warpgroup, f32 accumulators; a step
//     waits for the previous step's products only, then a block barrier
//     frees that stage and thread 0 refills it.
//   * Epilogue of a panel, on the f32 accumulator fragments: p = exp(logit -
//     lse), minus 1 at the label's column, times g, rounded to bf16 and
//     stored straight from the fragment as bf16 pairs (coalesced stores, no
//     TMA store: a warp writes 8 rows x 16 bytes a store, and consecutive
//     stores of a thread fill the rows' 32-byte sectors, which L2 merges
//     before the write-back).
//
// Exactness.  A product of two bf16 values is exact in f32, so the wgmma
// logits with f32 accumulation equal the f32 route's SGEMM of the same bf16
// values up to the order of the sum; the f32 route also rounds dl to bf16
// before its two products.  The only change in numerics is summation order.
// No atomics: the bits repeat from run to run.

#include "sm90.cuh"

#include <math.h>

namespace {

using sm90::desc_sw128;
using sm90::smem_u32;

constexpr int kThreads = 256;      // two consumer warpgroups
constexpr int BT = 128;            // rows of h a block
constexpr int BV = 256;            // vocab columns a panel
constexpr int BKD = 64;            // depth of D a step
constexpr int kStages = 4;
constexpr int kABytes = BT * BKD * 2;                  // 16 KB: h's box
constexpr int kBBytes = BKD * BV * 2;                  // 32 KB: four W boxes of 8 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + kStages * 8 + 1024;

__global__ void __launch_bounds__(kThreads, 1)
xent_bwd_tc_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
                   const int* __restrict__ labels, const float* __restrict__ lse,
                   const float* __restrict__ g, __nv_bfloat16* __restrict__ dl, int t, int d,
                   int v, int panels_per_block) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int row_base = blockIdx.x * BT;
  const int n_panels = (v + BV - 1) / BV;
  const int p_begin = blockIdx.y * panels_per_block;
  const int p_end = min(n_panels, p_begin + panels_per_block);
  const int nk = (d + BKD - 1) / BKD;
  const int n_steps = (p_end - p_begin) * nk;

  auto load = [&](int step) {
    const int s = step % kStages;
    const int col0 = (p_begin + step / nk) * BV;
    const int k0 = (step % nk) * BKD;
    uint8_t* a = ring + s * kStageBytes;
    uint8_t* bw = a + kABytes;
    sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
    sm90::tma_load_2d(a, &th, &full[s], k0, row_base);
#pragma unroll
    for (int j = 0; j < BV / 64; ++j)
      sm90::tma_load_2d(bw + j * BKD * 128, &tw, &full[s], col0 + 64 * j, k0);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int step = 0; step < kStages - 1 && step < n_steps; ++step) load(step);
  }

  // this thread's two rows; acc[4 * j + 2 * half + c] is row row0 + 8 * half,
  // panel column 8 * j + 2 * quad + c
  const int row0 = row_base + 64 * wg + 16 * warp + (lane >> 2);
  int lab[2];
  float lse_r[2], g_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const bool in = row < t;
    lab[half] = in ? labels[row] : -1;
    lse_r[half] = in ? lse[row] : 0.f;
    g_r[half] = in ? g[row] : 0.f;
  }
  float acc[BV / 2];
#pragma unroll
  for (int i = 0; i < BV / 2; ++i) acc[i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int s = step % kStages;
    sm90::mbar_wait(&full[s], (step / kStages) & 1);
    const uint8_t* a = ring + s * kStageBytes;
    const uint8_t* bw = a + kABytes;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKD / 16; ++kk) {
      const uint64_t da = desc_sw128(smem_u32(a + wg * 64 * 128 + kk * 32), 16, 1024);
      const uint64_t db = desc_sw128(smem_u32(bw + kk * 16 * 128), BKD * 128, 1024);
      sm90::wgmma_ss_n256<1>(acc, da, db, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();           // the previous step's products are done
    __syncthreads();                 // ... in both warpgroups: its stage is free
    if (tid == 0 && step + kStages - 1 < n_steps) load(step + kStages - 1);

    if (step % nk == nk - 1) {
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      const int col0 = (p_begin + step / nk) * BV;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row < t) {
          __nv_bfloat16* dst = dl + static_cast<int64_t>(row) * v + col0 + 2 * quad;
#pragma unroll
          for (int j = 0; j < BV / 8; ++j) {
            const int col = col0 + 8 * j + 2 * quad;     // even; V is a multiple of 8
            if (col < v) {
              float x[2];
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const float p = expf(acc[4 * j + 2 * half + c] - lse_r[half]);
                x[c] = (col + c == lab[half] ? p - 1.f : p) * g_r[half];
              }
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(x[0], x[1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < BV / 2; ++i) acc[i] = 0.f;
      sm90::fence_operands(acc);
    }
  }
}

}  // namespace

// C interface.  Launches the kernel on `stream` and returns its cudaError_t
// (0 = launched).  The caller validates devices, dtypes, shapes and
// alignment (bf16, contiguous, 16-byte aligned bases, D and V multiples of 8
// so that TMA's row strides are multiples of 16 bytes) and allocates dl (t,
// V) bf16; h, labels, lse and g point at the chunk's first row.
// nsplit * panels_per_block must cover ceil(V / 256) panels and each block
// must own at least one.
extern "C" int repro_xent_dlogits_tc(const void* h, const void* w, const int* labels,
                                     const float* lse, const float* g, void* dl, int t, int d,
                                     int v, int panels_per_block, int nsplit, void* stream) {
  const int n_panels = (v + BV - 1) / BV;
  if (t <= 0 || d <= 0 || v <= 0 || d % 8 != 0 || v % 8 != 0 || panels_per_block <= 0 ||
      nsplit <= 0 || nsplit > 65535 || (nsplit - 1) * panels_per_block >= n_panels ||
      nsplit * panels_per_block < n_panels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap th, tw;
  const uint64_t h_dims[2] = {static_cast<uint64_t>(d), static_cast<uint64_t>(t)};
  const uint64_t h_strides[1] = {2ull * d};
  const uint32_t h_box[2] = {BKD, BT};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(v), static_cast<uint64_t>(d)};
  const uint64_t w_strides[1] = {2ull * v};
  const uint32_t w_box[2] = {64, BKD};
  int err = sm90::encode_bf16_map(&th, h, 2, h_dims, h_strides, h_box);
  if (err == 0) err = sm90::encode_bf16_map(&tw, w, 2, w_dims, w_strides, w_box);
  if (err != 0) return err;
  // Raise the dynamic shared memory cap once, on the first call (before any
  // CUDA-graph capture of the launch).
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        xent_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((t + BT - 1) / BT, nsplit);
  xent_bwd_tc_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      th, tw, labels, lse, g, static_cast<__nv_bfloat16*>(dl), t, d, v, panels_per_block);
  return static_cast<int>(cudaGetLastError());
}
