// The rows of B5's non-causal mode that hold no live key, shared by both
// forward kernels (flash_attention.cu, flash_attention_tc.cu).
//
// With causal == 0 and a window, query q sees key k where q - k < window, so
// a query at or past Sk + window - 1 sees none.  The reference kernel
// (src/repro/kernels/flash_attention.py, block_q = block_k = 128 by default
// in kernels/ops.py) masks such a row's scores to -1e30 in every key tile its
// query tile finds live, and its running max stays -1e30: each of those keys
// then weighs exp(0) = 1, and the row comes out as the mean of v over them,
// or 0 where its query tile finds no live key tile at all.  The live tiles of
// a query tile are the key tiles kj with kj * bk + bk - 1 > qt * bq - window,
// a suffix of the keys, so the row's value is the mean of v over
// [dead_row_begin(q), Sk) (0 where that is empty).
// kernels/flash_attention.py::dead_row_begin is the same rule in Python.
#pragma once

__device__ __forceinline__ int dead_row_begin(int q, int sq, int sk, int window) {
  const int bq = sq < 128 ? sq : 128;     // the reference op's tiles
  const int bk = sk < 128 ? sk : 128;
  const int x = (q / bq) * bq - window - bk + 1;
  return x < 0 ? 0 : (x / bk + 1) * bk;
}
