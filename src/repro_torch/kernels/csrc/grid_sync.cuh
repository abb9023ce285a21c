// One grid-wide barrier inside a cooperative launch, and the launch itself:
// what the persistent kernels (slstm_scan_persistent.cu's scan,
// quant_exchange.cu's wide quantize) share.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace grid_sync {

// Every block of the grid arrives before any leaves; `target` = the
// arrivals counted once this barrier is passed (the counter only grows, so
// barrier i of a launch waits for (i + 1) x gridDim.x).  Thread 0 adds its
// block's arrival with release semantics (after the block barrier, so the
// block's writes come first) and spins with acquire loads, a short sleep
// between polls (fewer polls of the one L2 line).
__device__ __forceinline__ void barrier(unsigned int* arrived, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(arrived) : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(arrived) : "memory");
      if (seen < target) __nanosleep(20);
    } while (seen < target);
  }
  __syncthreads();
}

// Zero the barrier's counter on `stream` and launch `kernel` over `blocks`
// blocks of `threads` as one cooperative grid (cudaLaunchAttributeCooperative:
// co-resident, or the launch fails, never a deadlock).  Returns the first
// cudaError_t, cudaErrorCooperativeLaunchTooLarge when the grid exceeds
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM count.  The caller
// raises the kernel's shared-memory cap first where `smem` needs it.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), int blocks, int threads, size_t smem,
                   cudaStream_t stream, unsigned int* arrived, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (static_cast<int64_t>(per_sm) * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(arrived, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace grid_sync
