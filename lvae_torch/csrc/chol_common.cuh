// Device code shared by the batched Cholesky+inverse kernel (chol_inv.cu)
// and the fused B-chain kernel (b_chain.cu).
//
// Every routine works on one n x n matrix held in shared memory with a padded
// row stride ld = n + 1 (column walks then touch n distinct banks), and is
// called by all threads of the block: thread i owns row i (or column i), so
// the block needs at least n threads. Each routine ends in a __syncthreads.
//
// Pivots are not clamped or guarded: a matrix that is not positive definite
// gives NaN (rsqrtf of a negative pivot), in that matrix only.

#pragma once

#include <cuda_runtime.h>

namespace lvae {

// Column (left-looking) Cholesky of the lower triangle of s_l, in place:
// afterwards s_l's lower triangle holds L with A = L L^T (the strict upper
// triangle is left as it was). Returns, in every thread, the sum of the log
// pivots, log det A.
__device__ __forceinline__ float column_cholesky(float* s_l, int n, int ld) {
  const int i = threadIdx.x;
  float logdet = 0.0f;
  for (int j = 0; j < n; ++j) {
    if (i >= j && i < n) {
      float acc = s_l[i * ld + j];
      for (int k = 0; k < j; ++k) acc -= s_l[i * ld + k] * s_l[j * ld + k];
      s_l[i * ld + j] = acc;
    }
    __syncthreads();
    const float piv = s_l[j * ld + j];
    logdet += logf(piv);
    const float inv_d = rsqrtf(piv);
    __syncthreads();
    if (i >= j && i < n) s_l[i * ld + j] *= inv_d;
    __syncthreads();
  }
  return logdet;
}

// s_m = L^-1 by forward substitution, thread c owning column c of the
// identity. Rows above c come out as exact zeros (0 - 0) / L_rr.
__device__ __forceinline__ void lower_inverse(const float* s_l, float* s_m, int n,
                                              int ld) {
  const int c = threadIdx.x;
  if (c < n) {
    for (int r = 0; r < n; ++r) {
      float s = (r == c) ? 1.0f : 0.0f;
      for (int k = 0; k < r; ++k) s -= s_l[r * ld + k] * s_m[k * ld + c];
      s_m[r * ld + c] = s / s_l[r * ld + r];
    }
  }
  __syncthreads();
}

// Entry (r, c) of A^-1 = M^T M for M = L^-1 lower triangular: the sum starts
// at max(r, c). Entries (r, c) and (c, r) multiply the same pairs in the same
// order, so the inverse is bitwise symmetric.
__device__ __forceinline__ float inverse_entry(const float* s_m, int n, int ld,
                                               int r, int c) {
  float acc = 0.0f;
  for (int k = max(r, c); k < n; ++k) acc += s_m[k * ld + r] * s_m[k * ld + c];
  return acc;
}

}  // namespace lvae
