// What the sLSTM scan's two persistent kernels (slstm_scan_persistent.cu's
// forward, slstm_scan_bwd_persistent.cu's reverse scan) share: R's quads
// and their widening to f32, cp.async copies into shared memory, and the
// fixed reduce-scatter butterfly that meets a warp's partial sums.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace scan {

// R's four consecutive entries: float4 in f32, 4 x bf16 in bf16
template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ void widen(const float4 v, float (&w)[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void widen(const uint2 v, float (&w)[4]) {
  w[0] = __uint_as_float(v.x << 16);
  w[1] = __uint_as_float(v.x & 0xffff0000u);
  w[2] = __uint_as_float(v.y << 16);
  w[3] = __uint_as_float(v.y & 0xffff0000u);
}

// 16 bytes from global memory through L2 only (never a stale L1 line: what
// another block wrote before a grid barrier)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 4 bytes, through L1 (what no block writes during the launch)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's most recent groups are in
// flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  cp_async_commit();
  cp_async_wait<0>();
}

// The warp's kN sums (kN = 16 or 32, each split over the 32 lanes) reduced
// in a fixed butterfly that halves the values a lane carries each round
// (kCount of them, exchanged with lane ^ kOff): lane l ends with the whole
// sum of value l / (32 / kN) (lane pairs alike at kN = 16).
template <int kN, int kCount = kN, int kOff = 16>
__device__ __forceinline__ float reduce_scatter(float (&v)[kN], int lane) {
  if constexpr (kOff == 0) {
    return v[0];
  } else if constexpr (kCount > 1) {
    const bool upper = (lane & kOff) != 0;
#pragma unroll
    for (int i = 0; i < kCount / 2; ++i) {
      const float send = upper ? v[i] : v[i + kCount / 2];
      const float keep = upper ? v[i + kCount / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
    }
    return reduce_scatter<kN, kCount / 2, kOff / 2>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], kOff);
    return reduce_scatter<kN, 1, kOff / 2>(v, lane);
  }
}

}  // namespace scan
