// B4's second pass, shared by fused_xent.cu and fused_xent_tc.cu: one thread
// per row merges the row's nsplit partials (m, l) in block order and writes
// lse = m + log(max(l, 1e-30)) and loss = lse - picked.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void xent_combine_kernel(const float* __restrict__ part,
                                    const float* __restrict__ picked,
                                    float* __restrict__ loss, float* __restrict__ lse,
                                    int t, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= t) return;
  const float* pr = part + static_cast<int64_t>(row) * nsplit * 2;
  float mx = -1e30f;   // the reference's NEG_INF
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pr[2 * s]);
  float sum = 0.f;
  for (int s = 0; s < nsplit; ++s) sum += pr[2 * s + 1] * expf(pr[2 * s] - mx);
  const float r = mx + logf(fmaxf(sum, 1e-30f));
  lse[row] = r;
  loss[row] = r - picked[row];
}

}  // namespace
