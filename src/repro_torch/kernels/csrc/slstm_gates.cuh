// The sLSTM gating shared by the scan's two kernels (slstm_scan.cu's step
// kernel and slstm_scan_persistent.cu): the stored types widened to f32 and
// narrowed back, and one (row, unit)'s stabilized exponential gating.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace slstm {

constexpr float kMInit = -1e30f;                 // the reference kernel's start of m

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

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Gate g's activation of its pre-activation z: li as it is, the log-sigmoid
// of lf_raw, the tanh of zz, the sigmoid of oo.
__device__ __forceinline__ float gate_input(int g, float z) {
  switch (g) {
    case 1: return log_sigmoid(z);
    case 2: return tanhf(z);
    case 3: return sigmoid(z);
    default: return z;
  }
}

// The state update of one (row, unit) from its four activated gates a =
// (li, lf, tanh(zz), sigmoid(oo)); (c, n, m) updated in place; returns h.
__device__ __forceinline__ float gate_state(const float (&a)[4], float& c, float& n, float& m) {
  const float m_new = fmaxf(a[1] + m, a[0]);
  const float ig = expf(a[0] - m_new);
  const float fg = expf(a[1] + m - m_new);
  c = fg * c + ig * a[2];
  n = fg * n + ig;
  m = m_new;
  return a[3] * c / fmaxf(n, 1.f);
}

// z = (li, lf_raw, zz, oo) of one (row, unit); the state (c, n, m) is
// updated in place; returns h.
__device__ __forceinline__ float gate(const float (&z)[4], float& c, float& n, float& m) {
  const float a[4] = {z[0], log_sigmoid(z[1]), tanhf(z[2]), sigmoid(z[3])};
  return gate_state(a, c, n, m);
}

}  // namespace slstm
