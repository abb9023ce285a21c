// The sLSTM gating shared by the scan's kernels (the forward's
// slstm_scan.cu and slstm_scan_persistent.cu, the backward's
// slstm_scan_bwd.cu and slstm_scan_bwd_persistent.cu): the stored types
// widened to f32 and narrowed back, one (row, unit)'s stabilized
// exponential gating, and its reverse step.
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

// The reverse step of one (row, unit), the recurrence slstm_scan_bwd.cu's
// header sets out, in two parts.  gate_prep takes what depends on the
// forward alone: z = (li, lf_raw, zz, oo) of step t and the state (c, n, m)
// at t and at t - 1 (at t = 0 the start (0, 0, kMInit)); gate_apply then
// takes g_h, the gradient of h_t (dout[t] plus step t + 1's share through
// R), and the carry (dc, dn, dm) from step t + 1 (0 at the last step),
// updated in place to step t's, and writes dz, the gradient of z.  Both
// backward kernels run the same two parts (the persistent one computes the
// first while its copy of dz is in flight), so the two routes differ only
// in the order of the product's sums.
struct GateGrad {
  float li, a, ig, fg, so, tz, q, p, c_t, c_p, n_p, sneg;
  bool passes;                                   // n_t >= 1: clamp_min passes dq
};

__device__ __forceinline__ GateGrad gate_prep(const float (&z)[4], float c_t, float n_t,
                                              float m_t, float c_p, float n_p, float m_p) {
  GateGrad k;
  k.li = z[0];
  k.a = log_sigmoid(z[1]) + m_p;
  k.tz = tanhf(z[2]);
  k.so = sigmoid(z[3]);
  k.ig = expf(k.li - m_t);
  k.fg = expf(k.a - m_t);
  k.q = fmaxf(n_t, 1.f);
  k.p = k.so * c_t;
  k.c_t = c_t;
  k.c_p = c_p;
  k.n_p = n_p;
  k.sneg = sigmoid(-z[1]);
  k.passes = n_t >= 1.f;
  return k;
}

__device__ __forceinline__ void gate_apply(const GateGrad& k, float g_h, float& dc, float& dn,
                                           float& dm, float (&dz)[4]) {
  const float dp = g_h / k.q;
  const float dq = -g_h * k.p / (k.q * k.q);
  const float dct = dc + dp * k.so;
  const float dnt = dn + (k.passes ? dq : 0.f);
  const float doo = dp * k.c_t * k.so * (1.f - k.so);
  const float df = dct * k.c_p + dnt * k.n_p;
  const float di = dct * k.tz + dnt;
  const float dzz = dct * k.ig * (1.f - k.tz * k.tz);
  const float de_i = di * k.ig;
  const float de_f = df * k.fg;
  const float dmt = dm - de_i - de_f;
  const float to_a = k.a < k.li ? 0.f : (k.a == k.li ? 0.5f * dmt : dmt);
  const float to_li = k.li < k.a ? 0.f : (k.a == k.li ? 0.5f * dmt : dmt);
  const float da = de_f + to_a;
  dz[0] = de_i + to_li;
  dz[1] = da * k.sneg;
  dz[2] = dzz;
  dz[3] = doo;
  dc = dct * k.fg;
  dn = dnt * k.fg;
  dm = da;
}

}  // namespace slstm
