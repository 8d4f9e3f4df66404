// Batched small-matrix Cholesky + inverse for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lvae_tpu/kernels_pallas/cholesky.py
// (_chol_inv_pallas / _chol_inv_kernel). Input: a contiguous f32 stack
// A[B, n, n] of SPD matrices, 2 <= n <= 64. Output: L = chol(A), lower
// triangular with exact zeros above the diagonal, and A^-1 = L^-T L^-1, full
// and bitwise symmetric.
//
// Bound on an H100. Bytes: the function reads A once and writes L and A^-1
// once, 3 * B * n^2 * 4 bytes at 3.35 TB/s (0.41 us at [32, 60, 60], 4.6 us at
// the serving fold [3200, 20, 20]); flops: about n^3 a matrix, far below the
// f32 peak. Neither is reachable at these sizes: a matrix is a chain of n
// dependent pivot steps and n - 1 substitution steps, and at [32, 60, 60] the
// byte bound is less than one launch. So the design shortens each step of the
// chain and spreads it over threads:
//
// * a team of threads owns a matrix (chol_common.cuh). For n <= 32 a team is
//   one warp, one thread a row (barriers are __syncwarp), and a block holds
//   several teams; for 32 < n <= 64 a team is a whole block, 64 rows of
//   `lanes` threads each. The launch plan (team size, teams a block, blocks,
//   threads, shared bytes) is made in Python, in kernels_cuda/chol_plan.py,
//   and checked here: the entry point refuses a plan it does not take with
//   cudaErrorInvalidValue.
// * right-looking Cholesky (a row's threads own it; one team barrier a pivot
//   step) and forward substitution (a column of L^-1's threads own it; a
//   __syncwarp a step); then the lower triangle of A^-1 (inverse_entry)
//   over the team, mirrored on the way out so that the stores of L and A^-1
//   stay coalesced.
// * per team in shared memory: A (then L, with A^-1's strict lower triangle
//   transposed above it) and M = L^-1, each n x (n + 1), and A^-1's
//   diagonal; at most 48 KB a block (the plan keeps it).
//
// L and A^-1 are bit-equal to the left-looking kernel this replaced: the same
// operations in the same order for every entry (chol_common.cuh's head note),
// with the build flags of kernels_cuda/build.py.
//
// Pivots are not clamped or guarded: a non-SPD block gives NaN, as the TPU
// kernel's rsqrt does, and callers rely on that to detect a failed update.

#include <cuda_runtime.h>

#include "chol_common.cuh"

namespace {

constexpr int kMaxN = 64;
constexpr int kDefaultSmem = 48 * 1024;

template <class Team>
__device__ __forceinline__ void chol_inv_matrix(const Team& team, const float* __restrict__ a,
                                                float* __restrict__ l_out,
                                                float* __restrict__ inv_out, float* s_l,
                                                int n, int lanes) {
  const int ld = n + 1;
  float* s_m = s_l + n * ld;   // the factor's column buffers, then M = L^-1
  float* diag = s_m + n * ld;  // A^-1's diagonal
  const int nn = n * n;
  for (int idx = team.rank; idx < nn; idx += team.size) {
    const int r = idx / n;
    s_l[r * ld + idx - r * n] = a[idx];
  }
  team.sync();

  lvae::right_looking_cholesky(team, s_l, s_m, n, ld, lanes);
  lvae::right_looking_lower_inverse(team, s_l, s_m, n, ld, lanes);

  // A^-1's lower triangle: the diagonal into diag, the rest transposed into
  // s_l's strict upper triangle (L keeps the lower one)
  const int tri = n * (n + 1) / 2;
  for (int e = team.rank; e < tri; e += team.size) {
    int r, c;
    lvae::tri_index(e, &r, &c);
    const float v = lvae::inverse_entry(s_m, n, ld, r, c);
    if (r == c) {
      diag[r] = v;
    } else {
      s_l[c * ld + r] = v;
    }
  }
  team.sync();

  for (int idx = team.rank; idx < nn; idx += team.size) {
    const int r = idx / n;
    const int c = idx - r * n;
    inv_out[idx] = (r == c) ? diag[r] : s_l[min(r, c) * ld + max(r, c)];
    l_out[idx] = (c <= r) ? s_l[r * ld + c] : 0.0f;
  }
}

// n <= 32: one warp a matrix, blockDim.x / 32 matrices a block.
__global__ void chol_inv_warp_kernel(const float* __restrict__ a, float* __restrict__ l_out,
                                     float* __restrict__ inv_out, long long batch, int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / lvae::kWarp;
  const long long mat = static_cast<long long>(blockIdx.x) * (blockDim.x / lvae::kWarp) + warp;
  if (mat >= batch) return;  // the last block's spare warps; no block barrier follows
  const lvae::WarpTeam team{static_cast<int>(threadIdx.x) & (lvae::kWarp - 1)};
  const long long base = mat * n * n;
  chol_inv_matrix(team, a + base, l_out + base, inv_out + base,
                  smem + warp * lvae::chol_team_floats(n), n, 1);
}

// One block a matrix, blockDim.x / team_rows(n) threads a row.
__global__ void chol_inv_block_kernel(const float* __restrict__ a, float* __restrict__ l_out,
                                      float* __restrict__ inv_out, int n) {
  extern __shared__ float smem[];
  const lvae::BlockTeam team{static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x)};
  const long long base = static_cast<long long>(blockIdx.x) * n * n;
  chol_inv_matrix(team, a + base, l_out + base, inv_out + base, smem, n,
                  team.size / lvae::team_rows(n));
}

}  // namespace

// Launches on `stream` with the plan of kernels_cuda/chol_plan.py and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments or
// a plan the kernel does not take: warp teams (team 32) for n <= 32, or one
// team a block of team_rows(n) rows (32 or 64) times a power of two of
// threads, more than a warp; blocks covering the batch with no empty block;
// exactly the shared bytes the teams need, at most 48 KB.
extern "C" int lvae_chol_inv_f32(const void* a, void* l, void* inv, long long batch, int n,
                                 int team, int teams, int blocks, int threads, int smem,
                                 void* stream) {
  if (n < 2 || n > kMaxN || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const bool warp_teams = team == lvae::kWarp && n <= lvae::kWarp;
  const bool block_team = team > lvae::kWarp && teams == 1 && lvae::valid_block_team(team, n);
  if (!(warp_teams || block_team) || teams < 1 || threads != team * teams || threads > 1024 ||
      blocks < 1 || static_cast<long long>(blocks) * teams < batch ||
      static_cast<long long>(blocks - 1) * teams >= batch ||
      smem != teams * lvae::chol_team_floats(n) * static_cast<int>(sizeof(float)) ||
      smem > kDefaultSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  float* pl = static_cast<float*>(l);
  float* pi = static_cast<float*>(inv);
  if (warp_teams) {
    chol_inv_warp_kernel<<<blocks, threads, smem, s>>>(pa, pl, pi, batch, n);
  } else {
    chol_inv_block_kernel<<<blocks, threads, smem, s>>>(pa, pl, pi, n);
  }
  return static_cast<int>(cudaGetLastError());
}
