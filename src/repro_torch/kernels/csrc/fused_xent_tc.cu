// Fused softmax cross-entropy (B4) forward on Hopper's tensor cores
// (sm_90a): the bf16 route, bound to Python through a plain C interface
// (ctypes).  fused_xent.cu keeps the f32 route and the backward's
// elementwise pass.
//
// Replaces the TPU kernel of src/repro/kernels/fused_xent.py:
//   fused_xent (_xent_kernel) -> xent_fwd_tc_kernel + xent_combine_kernel
// hidden h (T, D) and weights W (D, V), bf16, int32 labels (T,).  Writes
// loss[t] = lse[t] - (h W)[t, label[t]] and lse[t], both f32, without the
// (T, V) logits in device memory.
//
// What bounds it on this card: operations.  At the training shape (T 2,048,
// D 4,096, V 151,936) the products are 2.55 TFLOP (2.58 ms on the bf16
// tensor cores at 989 TFLOP/s) against 1.26 GB moved (0.38 ms).  The f32
// route runs them on the FMA units (67 TFLOP/s peak, 38 ms at best).  So
// this kernel runs the product on wgmma and folds each panel into the
// running softmax state in registers:
//
//   * grid (ceil(T / 128), nsplit); a block owns 128 rows of h and a run of
//     256-wide vocab panels (panels_per_block, from xent_splits); 256
//     threads, two warpgroups of 64 rows each.
//   * A flat sequence of (panel, 64-deep step of D) loads: h's (128 x 64)
//     box and W's (64 x 256) slab (four 64-column boxes) arrive by TMA with
//     a 128-byte swizzle into a four-stage ring, an mbarrier a stage; the
//     sequence runs on across panels, so the next panel's loads are in
//     flight during a panel's epilogue.  h (16.8 MB at the training shape)
//     is re-read from L2 for each panel.
//   * Each step is four wgmma m64n256k16 per warpgroup with f32
//     accumulators: h K-major, W MN-major (row-major (D, V), the transpose
//     bit).  A step waits for the previous step's products only
//     (wait_group 1), then a block barrier frees that step's stage and
//     thread 0 refills it.
//   * Epilogue of a panel: columns >= V masked to -inf; each thread folds
//     its two rows' 64 columns into a running (m, l), merged across the
//     quad of lanes that share the rows; the single thread holding
//     (row, label) writes `picked`.  At the end one partial (m, l) per
//     (row, block); xent_combine_kernel (xent_combine.cuh, shared with the
//     f32 route) merges a row's partials in block order.  No atomics: the
//     bits repeat from run to run.
//   * Edge rules of the f32 route: labels outside [0, V) pick 0, the running
//     max starts at -1e30, lse = m + log(max(l, 1e-30)).  Rows past T and
//     columns past V or D load as zeros (TMA's fill).

#include "sm90.cuh"
#include "xent_combine.cuh"

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
constexpr float kNegBig = -1e30f;

__global__ void __launch_bounds__(kThreads, 1)
xent_fwd_tc_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tw,
                   const int* __restrict__ labels, float* __restrict__ part,
                   float* __restrict__ picked, int t, int d, int v, int panels_per_block,
                   int nsplit) {
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
  const int split = blockIdx.y;
  const int n_panels = (v + BV - 1) / BV;
  const int p_begin = split * panels_per_block;
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
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    lab[half] = row < t ? labels[row] : -1;
  }
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};
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
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BV / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * half + c;
            const int col = col0 + 8 * j + 2 * quad + c;
            if (col < v) {
              if (col == lab[half]) picked[row] = acc[idx];
              mx = fmaxf(mx, acc[idx]);
            } else {
              acc[idx] = -INFINITY;
            }
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[half], mx);       // finite: m starts at -1e30
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BV / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) sum += expf(acc[4 * j + 2 * half + c] - m_new);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[half] = l[half] * expf(m[half] - m_new) + sum;
        m[half] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BV / 2; ++i) acc[i] = 0.f;
      sm90::fence_operands(acc);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (quad == 0 && row < t) {
      float* o = part + (static_cast<int64_t>(row) * nsplit + split) * 2;
      o[0] = m[half];
      o[1] = l[half];
    }
  }
}

}  // namespace

// C interface.  Launches the two kernels on `stream` and returns the first
// cudaError_t (0 = launched).  The caller validates devices, dtypes, shapes
// and alignment (bf16, contiguous, 16-byte aligned bases, D and V multiples
// of 8 so that TMA's row strides are multiples of 16 bytes) and allocates
// every buffer: part (T, nsplit, 2) f32 scratch, picked (T,) f32 zeroed,
// loss and lse (T,) f32.  nsplit * panels_per_block must cover ceil(V / 256)
// panels and each block must own at least one.
extern "C" int repro_fused_xent_tc(const void* h, const void* w, const int* labels, float* part,
                                   float* picked, float* loss, float* lse, int t, int d, int v,
                                   int panels_per_block, int nsplit, void* stream) {
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
        xent_fwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + BT - 1) / BT, nsplit);
  xent_fwd_tc_kernel<<<grid, kThreads, kSmem, s>>>(th, tw, labels, part, picked, t, d, v,
                                                   panels_per_block, nsplit);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  xent_combine_kernel<<<(t + 127) / 128, 128, 0, s>>>(part, picked, loss, lse, t, nsplit);
  return static_cast<int>(cudaGetLastError());
}
