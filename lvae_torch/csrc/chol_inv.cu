// Batched small-matrix Cholesky + inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lvae_tpu/kernels_pallas/cholesky.py
// (_chol_inv_pallas / _chol_inv_kernel). Input: a contiguous f32 stack
// A[B, n, n] of SPD matrices, 2 <= n <= 64. Output: L = chol(A), lower
// triangular with exact zeros above the diagonal, and A^-1 = L^-T L^-1, full
// and symmetric (entry (i, j) and (j, i) are summed in the same order, so the
// result is bitwise symmetric).
//
// Bound on an H100: memory. The function reads A once and writes L and A^-1
// once, 3 * B * n^2 * 4 bytes at 3.35 TB/s; its arithmetic is about n^3
// flops per matrix (n^3/3 each for the factor, the triangular inverse and
// the product), far below the f32 peak at these sizes. At the serving fold
// shape (B = 32 * 100, n = 20) that is 15.4 MB, 4.6 us.
//
// Design, simple first: one thread block per matrix; the matrix and its
// inverse factor live in dynamic shared memory sized to n, with a padded row
// stride (n + 1) so that column walks do not hit one bank (2 * 64 * 65 * 4 B
// = 33 KB at n = 64, 3.4 KB at n = 20, which lets many blocks share an SM).
// Threads run over rows in the column Cholesky (one __syncthreads per
// step), over columns of the identity in the forward substitution for
// M = L^-1, and over output entries for A^-1 = M^T M; those three steps are
// chol_common.cuh, shared with the fused B-chain kernel. Left for later: at
// n = 20 only 20 threads of a 32-thread block do work in the factor and
// substitution loops, and there is one matrix per block, so a fold of 3200
// matrices launches 3200 tiny blocks. Packing several matrices into one
// block (a warp per matrix) is the next step once its time is measured
// against the bound.
//
// Pivots are not clamped or guarded: a non-SPD block gives NaN, as the TPU
// kernel's rsqrt does, and callers rely on that to detect a failed update.

#include <cuda_runtime.h>

#include "chol_common.cuh"

namespace {

constexpr int kMaxN = 64;

__global__ void chol_inv_kernel(const float* __restrict__ a,
                                float* __restrict__ l_out,
                                float* __restrict__ inv_out, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* s_l = smem;            // A, overwritten by L (lower part)
  float* s_m = smem + n * ld;   // M = L^-1 (lower triangular)

  const long long base = static_cast<long long>(blockIdx.x) * n * n;
  const int tid = threadIdx.x;
  const int nn = n * n;

  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int r = idx / n;
    const int c = idx - r * n;
    s_l[r * ld + c] = a[base + idx];
  }
  __syncthreads();

  lvae::column_cholesky(s_l, n, ld);
  lvae::lower_inverse(s_l, s_m, n, ld);

  for (int idx = tid; idx < nn; idx += blockDim.x) {
    const int r = idx / n;
    const int c = idx - r * n;
    inv_out[base + idx] = lvae::inverse_entry(s_m, n, ld, r, c);
    l_out[base + idx] = (c <= r) ? s_l[r * ld + c] : 0.0f;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lvae_chol_inv_f32(const void* a, void* l, void* inv,
                                 long long batch, int n, void* stream) {
  if (n < 2 || n > kMaxN || batch < 0 || batch > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem = 2u * n * (n + 1) * sizeof(float);  // <= 33,280 B < 48 KB
  chol_inv_kernel<<<static_cast<unsigned>(batch), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(l),
      static_cast<float*>(inv), n);
  return static_cast<int>(cudaGetLastError());
}
