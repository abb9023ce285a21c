// One-token GQA decode attention against a KV cache on Hopper's tensor
// cores (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernel of src/repro/kernels/decode_attention.py:
//   decode_attention (_decode_kernel) -> decode_tc_kernel (bf16, head_dim 64
//   or 128, 16-byte aligned rows; decode_attention.cu is the f32-FMA route
//   for everything else)
// q (B, 1, H, D), the cache's k and v (B, S, Hkv, D), out (B, 1, H, D), in
// the model's own layout.  The new token at position `index` attends to the
// cache positions k_pos <= index, and with a window only to
// index - k_pos < window; positions past `index` are never read.  `index`
// is a host int, or (index_dev != nullptr) an int32 the kernel reads on the
// device, so that a captured decode step can advance it without a host
// round trip.
//
// What bounds it on this card: bytes.  Each live K and V row is read once
// and costs 4 * D flops per query head (GQA: 4 heads a KV head for
// Qwen3-8B), so at the serve shape (B 4, Hkv 8, D 128, 480 live keys) the
// kernel must move 7.9 MB (2.37 us at 3.35 TB/s) and at (8, 32,768, 8, 128)
// 1.07 GB (320.6 us).  The design keeps enough bytes in flight and does the
// arithmetic on the tensor cores:
//
//   * a thread-block cluster of `splits` (<= 8) blocks takes one (batch, KV
//     head, 16 query heads of its group); block `rank` takes the contiguous
//     chunk [begin + rank * chunk, + chunk) of the live keys [begin, end);
//   * a block streams its chunk through a ring of kStages (3 at D 128, 4 at
//     D 64) stages of 64 keys of K and V, bf16, by 16-byte cp.async copies
//     (LDGSTS): 32 KB a stage at D 128, two stages in flight behind the one
//     being computed.  The launcher sizes the split so that an SM holds at
//     most one block (decode_attention.py::decode_tc_splits: one streaming
//     block an SM reads faster than two).  The rows are stored
//     with their 16-byte chunks XOR-swizzled by row % 8, so ldmatrix reads
//     them without bank conflicts;
//   * each of the 4 warps takes 16 keys of every stage: S = Q K^T on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate) with the group's query
//     heads on M (padded to 16: the rows are wasted, the bound is bytes)
//     and q held in registers as A fragments for the whole chunk; an online
//     softmax over its keys (running max from -1e30, so a masked score, -inf,
//     contributes exactly 0); then O += P V on the same instruction, with P
//     taken from the S accumulator as the A fragment (FA2's register layout:
//     the C fragments of two n8 blocks are the A fragment of one k16 step).
//     **P is rounded to bf16 for P V**; the row sums l add the unrounded f32
//     p;
//   * the 4 warps' (m, l, acc) are merged in warp order into the block's
//     state in shared memory; after cluster.sync() every block reads the
//     cluster's states through distributed shared memory and combines them
//     in rank order for its share of the outputs, divides by max(l, 1e-30)
//     and writes bf16.  One launch; no workspace; no float atomics, so the
//     bits repeat from run to run.
//
// The split depends on the shape and on the live range (host index) or the
// cache length (device index) alone.  With a device index a block past the
// live range loads nothing and leaves (m, l, acc) = (-1e30, 0, 0), which
// the combine weighs by exp(-1e30 - M) = 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileKeys = 64;       // keys a stage
constexpr int kWarps = 4;           // 16 keys of a stage each
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;           // query heads a block: the mma's M
constexpr int kMaxSplits = 8;       // blocks a cluster (the portable maximum)
constexpr float kNegBig = -1e30f;   // the reference's NEG_INF: the running max's start

template <int D> struct Cfg {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kChunks = D / 8;                        // 16-byte chunks a row
  static constexpr int kTileBytes = kTileKeys * D * 2;         // K or V of one stage
  static constexpr int kRingBytes = kStages * 2 * kTileBytes;
  // a row of a state: m, l, 6 floats of padding, acc[D].  The stride D + 8
  // puts the 8 rows a half-warp writes in distinct banks (float2 stores)
  static constexpr int kStride = D + 8;
  static constexpr int kStateFloats = kRows * kStride;
  static constexpr int kPartBytes = kWarps * kStateFloats * 4; // the warps' states
  static constexpr int kLoopBytes = kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
  static constexpr int kSmem = kLoopBytes + kStateFloats * 4;
};

// ---------------------------------------------------------------------------
// PTX wrappers: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x = lo (the lower address)
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The shared address of 16-byte chunk `c` of row `r` of a swizzled tile.
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 const int* __restrict__ index_dev, int index_host, int s, int h, int hkv,
                 int head_chunks, int window, int chunk, float scale) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);                  // after the loop
  float* state = reinterpret_cast<float*>(smem + C::kLoopBytes); // kRows x kStride
  const uint32_t ring = smem_u32(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;          // the fragment's row (and row + 8)
  const int t4 = lane & 3;          // the fragment's column pair
  const int kvh = blockIdx.y / head_chunks;
  const int group = h / hkv;
  const int h0 = kvh * group + (blockIdx.y % head_chunks) * kRows;
  const int rows = min(kRows, kvh * group + group - h0);    // live query heads
  const int b = blockIdx.z;

  const int index = index_dev != nullptr ? __ldg(index_dev) : index_host;
  const int end = min(index + 1, s);
  const int begin = window > 0 ? max(0, index - window + 1) : 0;
  const int lo = begin + rank * chunk;
  const int hi = min(end, lo + chunk);
  const int n_tiles = lo < hi ? (hi - lo + kTileKeys - 1) / kTileKeys : 0;

  const int64_t row_step = static_cast<int64_t>(hkv) * D;    // elements from key to key
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * s * hkv + kvh) * D;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * s * hkv + kvh) * D;

  // q as A fragments for every 16-wide step of D, zero in the padding rows
  uint32_t qa[D / 16][4];
  {
    const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * h + h0) * D;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(qb + g * D);
    const uint32_t* q8 = reinterpret_cast<const uint32_t*>(qb + (g + 8) * D);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = (ks * 16 + 2 * t4) >> 1;                  // in bf16 pairs
      qa[ks][0] = g < rows ? q0[c] : 0u;
      qa[ks][1] = g + 8 < rows ? q8[c] : 0u;
      qa[ks][2] = g < rows ? q0[c + 4] : 0u;
      qa[ks][3] = g + 8 < rows ? q8[c + 4] : 0u;
    }
  }

  // stage `slot` <- keys [t0, t0 + 64) of K and V; rows past `hi` are zeros
  auto load_tile = [&](int slot, int t0) {
    const uint32_t ks = ring + slot * 2 * C::kTileBytes;
    const uint32_t vs = ks + C::kTileBytes;
#pragma unroll
    for (int i = tid; i < kTileKeys * C::kChunks; i += kThreads) {
      const int r = i / C::kChunks;
      const int c = i - r * C::kChunks;
      const int key = t0 + r;
      const bool in = key < hi;
      const int64_t off = (in ? key : lo) * row_step + c * 8;
      cp_async16(tile_addr<D>(ks, r, c), kb + off, in ? 16 : 0);
      cp_async16(tile_addr<D>(vs, r, c), vb + off, in ? 16 : 0);
    }
  };

  float m0 = kNegBig, m1 = kNegBig;   // rows g, g + 8
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, lo + st * kTileKeys);
    cp_async_commit();
  }

  // ldmatrix lane roles: lane l addresses row l % 8 of matrix l / 8
  const int mat = lane >> 3;
  const int mrow = lane & 7;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();                  // tile t landed; tile t - 1's slot is free
    {
      const int nt = t + C::kStages - 1;
      if (nt < n_tiles) load_tile(nt % C::kStages, lo + nt * kTileKeys);
      cp_async_commit();
    }
    const uint32_t ks = ring + (t % C::kStages) * 2 * C::kTileBytes;
    const uint32_t vs = ks + C::kTileBytes;
    const int kw = warp * 16;         // this warp's 16 keys of the stage

    // S = Q K^T: two n8 blocks of keys
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kstep = 0; kstep < D / 16; ++kstep) {
      // matrices: (keys 0-7, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 0-7),
      // (keys 8-15, d 8-15) of this warp's keys and this 16-wide step
      uint32_t kf[4];
      ldmatrix_x4(tile_addr<D>(ks, kw + (mat >> 1) * 8 + mrow, kstep * 2 + (mat & 1)), kf);
      mma_bf16(sc[0], qa[kstep], kf[0], kf[1]);
      mma_bf16(sc[1], qa[kstep], kf[2], kf[3]);
    }

    // the online softmax over these 16 keys
    const int key0 = lo + t * kTileKeys + kw + 2 * t4;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool live = key0 + nb * 8 + j < hi;
        sc[nb][j] = live ? sc[nb][j] * scale : -INFINITY;
        sc[nb][2 + j] = live ? sc[nb][2 + j] * scale : -INFINITY;
        mx0 = fmaxf(mx0, sc[nb][j]);
        mx1 = fmaxf(mx1, sc[nb][2 + j]);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float n0 = fmaxf(m0, mx0);  // finite: m starts at -1e30
    const float n1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - n0);
    const float a1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sc[nb][j] = expf(sc[nb][j] - n0);          // exactly 0 where masked
        sc[nb][2 + j] = expf(sc[nb][2 + j] - n1);
        ps0 += sc[nb][j];
        ps1 += sc[nb][2 + j];
      }
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      acc[nd][0] *= a0;
      acc[nd][1] *= a0;
      acc[nd][2] *= a1;
      acc[nd][3] *= a1;
    }

    // O += P V: P (16 heads x 16 keys) is the A fragment, bf16
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[0][0], sc[0][1]);
    pa[1] = pack_bf16(sc[0][2], sc[0][3]);
    pa[2] = pack_bf16(sc[1][0], sc[1][1]);
    pa[3] = pack_bf16(sc[1][2], sc[1][3]);
#pragma unroll
    for (int nd = 0; nd < D / 8; nd += 2) {
      // matrices (transposed): (keys 0-7, d 0-7), (keys 8-15, d 0-7),
      // (keys 0-7, d 8-15), (keys 8-15, d 8-15) of columns nd * 8 ..
      uint32_t vf[4];
      ldmatrix_x4_trans(tile_addr<D>(vs, kw + (mat & 1) * 8 + mrow, nd + (mat >> 1)), vf);
      mma_bf16(acc[nd], pa, vf[0], vf[1]);
      mma_bf16(acc[nd + 1], pa, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: it takes the warps' states

  // each warp's (m, l, acc) -> part[warp]
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  {
    float* pw = part + warp * C::kStateFloats;
    const bool live0 = g < rows;      // padding rows are never read
    const bool live1 = g + 8 < rows;
    if (t4 == 0) {
      if (live0) *reinterpret_cast<float2*>(pw + g * C::kStride) = make_float2(m0, l0);
      if (live1) *reinterpret_cast<float2*>(pw + (g + 8) * C::kStride) = make_float2(m1, l1);
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int c = 8 + nd * 8 + 2 * t4;
      if (live0) {
        *reinterpret_cast<float2*>(pw + g * C::kStride + c) = make_float2(acc[nd][0], acc[nd][1]);
      }
      if (live1) {
        *reinterpret_cast<float2*>(pw + (g + 8) * C::kStride + c) =
            make_float2(acc[nd][2], acc[nd][3]);
      }
    }
  }
  __syncthreads();

  // the block's state: the warps merged in warp order
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float wm[kWarps], wl[kWarps], wa[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pr = part + w * C::kStateFloats + r * C::kStride;
      wm[w] = pr[0];
      wl[w] = pr[1];
      wa[w] = pr[8 + d];
    }
    float big = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, wm[w]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(wm[w] - big);
      l += wl[w] * c;
      a += wa[w] * c;
    }
    state[r * C::kStride + 8 + d] = a;
    if (d == 0) {
      state[r * C::kStride] = big;
      state[r * C::kStride + 1] = l;
    }
  }
  cluster.sync();                     // every block's state is visible to the cluster

  // the cluster's states combined in rank order; block `rank` writes
  // outputs rank * kThreads + tid, + splits * kThreads, ...  Each output's
  // loads from the peers are issued together, then summed in rank order.
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * h + h0) * D;
  for (int i = rank * kThreads + tid; i < rows * D; i += splits * kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float pm[kMaxSplits], pl[kMaxSplits], pa[kMaxSplits];
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      pm[p] = kNegBig;
      pl[p] = pa[p] = 0.f;
      if (p < splits) {
        const float* sp = (p == rank ? state : cluster.map_shared_rank(state, p)) + r * C::kStride;
        pm[p] = sp[0];
        pl[p] = sp[1];
        pa[p] = sp[8 + d];
      }
    }
    float big = kNegBig;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) big = fmaxf(big, pm[p]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxSplits; ++p) {
      if (p < splits) {
        const float c = expf(pm[p] - big);
        l += pl[p] * c;
        a += pa[p] * c;
      }
    }
    ob[r * D + d] = __float2bfloat16_rn(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();                     // no block leaves while a peer reads its state
}

// Once, on the first call (before any CUDA-graph capture of a launch):
// raise the kernel's shared-memory cap.
template <int D> int configure() {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

template <int D>
cudaLaunchConfig_t launch_config(int splits, dim3 grid, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Cfg<D>::kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of `splits` blocks the card holds at once.
template <int D> int max_clusters(int splits, int* out) {
  int err = configure<D>();
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<D>(splits, dim3(splits, 1, 1), nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, decode_tc_kernel<D>, &cfg));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const int* index_dev,
           int index_host, int b, int s, int h, int hkv, int window, int chunk, int splits,
           float scale, cudaStream_t stream) {
  const int err = configure<D>();
  if (err != 0) return err;
  const int group = h / hkv;
  const int head_chunks = (group + kRows - 1) / kRows;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config<D>(splits, dim3(splits, hkv * head_chunks, b), stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, decode_tc_kernel<D>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), index_dev, index_host, s, h, hkv, head_chunks, window,
      chunk, scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface.  One launch on `stream`; returns cudaGetLastError() (0 =
// launched).  The caller validates devices, dtypes (bf16), shapes,
// contiguity and 16-byte alignment, and picks the split: `splits` (1-8)
// blocks of `chunk` keys (a multiple of 64) that cover the live keys, or,
// with `index_dev`, every live range the cache length allows.  head_dim 64
// or 128.
// *out <- how many clusters of `splits` (1-8) blocks the card holds at once
// at head_dim d (cudaOccupancyMaxActiveClusters); the caller sizes the split
// so that a launch's clusters fit in one wave.  A cluster is never shrunk to
// fit by the kernel itself: the split, and so the bits, would change.
// out[0..2] <- kTileKeys, kRows, kMaxSplits: decode_attention.py's split
// policy keeps copies of them and checks them against these on first use.
extern "C" int repro_decode_attention_tc_constants(int* out) {
  out[0] = kTileKeys;
  out[1] = kRows;
  out[2] = kMaxSplits;
  return 0;
}

extern "C" int repro_decode_attention_tc_clusters(int d, int splits, int* out) {
  if (splits <= 0 || splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64: return max_clusters<64>(splits, out);
    case 128: return max_clusters<128>(splits, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_decode_attention_tc(const void* q, const void* k, const void* v,
                                         void* out, const int* index_dev, int index_host,
                                         int b, int s, int h, int hkv, int d, int window,
                                         int chunk, int splits, float scale, void* stream) {
  if (b <= 0 || b > 65535 || s <= 0 || h <= 0 || hkv <= 0 || h % hkv != 0 ||
      hkv * ((h / hkv + kRows - 1) / kRows) > 65535 || window < 0 || chunk <= 0 ||
      chunk % kTileKeys != 0 || splits <= 0 || splits > kMaxSplits ||
      (index_dev == nullptr && (index_host < 0 || index_host >= s))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, index_dev, index_host, b, s, h, hkv, window, chunk, splits, scale, st);
    case 128: return launch<128>(q, k, v, out, index_dev, index_host, b, s, h, hkv, window, chunk, splits, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
