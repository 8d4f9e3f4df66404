// Device code shared by the batched Cholesky+inverse kernel (chol_inv.cu, K2)
// and the fused B-chain kernel (b_chain.cu, K1): a team-based, right-looking
// factorisation of one small SPD matrix.
//
// A team is the set of threads that owns one matrix: one warp (WarpTeam, 32
// threads, synchronised by __syncwarp, several teams a block) for n <= 32, one
// thread a row; or a whole block (BlockTeam, __syncthreads) of `lanes` threads
// a row for 64 rows (n <= 64) or 128 (n <= 128). Every routine is called by
// all threads of the team, and ends in a team barrier. A matrix sits in shared memory with a
// padded row stride ld = n + 1 (column walks then touch n distinct banks).
//
// What bounds these routines is the chain of dependent steps, not bytes or
// flops: n pivot steps for the factor, n - 1 for the substitution. So each
// step's work is spread over the team with one owner a row or column, no
// index arithmetic beyond a loop, and loads batched ahead of stores:
//   * the factor: row i belongs to its lanes. At step j every thread reads the
//     pivot and column j (unscaled) from a shared buffer, applies the rank-1
//     update to its share of its row, and lane 0 publishes the row's entry of
//     column j + 1 into the other buffer: one team barrier a step.
//   * the substitution M = L^-1: column c of M belongs to its lanes, which
//     take part in the steps k >= c, reading column k of L: a __syncwarp
//     between steps, no team barrier.
//   * A^-1 = M^T M: inverse_entry over the lower triangle, spread over the team.
//
// Bit-equality with the left-looking routines this header replaced: every
// entry of L, of M and of A^-1 is computed by the same operations in the
// same order as before; only which thread does it, and when, changed.
//   L:  s[i][c] <- fma(-L[i][k], L[c][k], s[i][c]) for k = 0 .. c-1 ascending
//       (one fma per step, never a panel's products summed first), with
//       L[c][k] = s[c][k] * rsqrtf(pivot_k) recomputed by each reader; the
//       diagonal is pivot * rsqrtf(pivot);
//   M:  m[r][c] <- fma(-L[r][k], M[k][c], m[r][c]) for k = c .. r-1 ascending
//       from 0, then an IEEE division by L[r][r]; M[c][c] = 1 / L[c][c] (the
//       left-looking loop's k < c terms added exact zeros, which leave the
//       sum unchanged);
//   A^-1: inverse_entry, as it was.
// That rests on the build flags too (kernels_cuda/build.py: -O3, FMA
// contraction on, no --use_fast_math, so rsqrtf, logf and "/" stay as they
// were and the old loops' "acc -= a * b" was the fma written out here).
//
// Contracts: exact zeros above L's diagonal (written by the callers' output
// pass), A^-1 bitwise symmetric (entries (r, c) and (c, r) multiply the same
// pairs in the same order), log det summed from the pivots in j order, and no
// pivot guard: a matrix that is not positive definite gives NaN (rsqrtf of a
// negative pivot), in that matrix only.

#pragma once

#include <cuda_runtime.h>

namespace lvae {

constexpr int kWarp = 32;

struct WarpTeam {
  int rank;  // lane
  static constexpr int size = kWarp;
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  // The team's sum of v in rank 0 (a fixed shuffle tree: deterministic).
  __device__ __forceinline__ float sum(float v, float* /*red*/) const {
    for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
  }
};

struct BlockTeam {
  int rank;  // threadIdx.x
  int size;  // blockDim.x, a multiple of 32
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  // The team's sum of v in rank 0: each warp's shuffle tree, then the warps'
  // partials added in warp order (deterministic). red holds size / 32 floats.
  __device__ __forceinline__ float sum(float v, float* red) const {
    for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((rank & (kWarp - 1)) == 0) red[rank / kWarp] = v;
    __syncthreads();
    float total = 0.0f;
    if (rank == 0) {
      for (int w = 0; w < size / kWarp; ++w) total += red[w];
    }
    return total;
  }
};

// Rows a team of threads_per_row * team_rows(n) threads covers: a warp's 32,
// or a block team's 64 or 128.
__host__ __device__ constexpr int team_rows(int n) { return n <= 32 ? 32 : (n <= 64 ? 64 : 128); }

// Whether `threads` form a block team for n: team_rows(n) rows times a power
// of two of lanes, at most 1024 threads.
__host__ __device__ constexpr bool valid_block_team(int threads, int n) {
  return threads <= 1024 && threads % team_rows(n) == 0 &&
         ((threads / team_rows(n)) & (threads / team_rows(n) - 1)) == 0;
}

// Row a and column b <= a of entry e of a lower triangle enumerated row by
// row: e = a (a + 1) / 2 + b. (The float root is only a first guess.)
__device__ __forceinline__ void tri_index(int e, int* a, int* b) {
  const float x = 8.0f * static_cast<float>(e) + 1.0f;
  int r = static_cast<int>((x * rsqrtf(x) - 1.0f) * 0.5f);
  if ((r + 1) * (r + 2) / 2 <= e) {
    ++r;
  } else if (r * (r + 1) / 2 > e) {
    --r;
  }
  *a = r;
  *b = e - r * (r + 1) / 2;
}

constexpr int kBatch = 4;  // entries a thread loads before it stores any

// Right-looking Cholesky of the lower triangle of s (n x n, stride ld), in
// place: afterwards s's lower triangle holds L (the strict upper triangle is
// not read or written). Row i belongs to the `lanes` consecutive threads
// i * lanes .. i * lanes + lanes - 1 (lanes a power of two up to 32, so they
// share a warp); lane h of them updates the columns c = j + 1 + h (mod
// lanes). col is 2n floats of scratch: at step j, cur[r] holds row r's entry
// of column j, unscaled. Returns log det A in every thread of the team.
template <class Team>
__device__ __forceinline__ float right_looking_cholesky(const Team& team, float* s, float* col,
                                                        int n, int ld, int lanes) {
  const int i = team.rank / lanes;
  const int h = team.rank - i * lanes;
  float* row = s + i * ld;
  float* cur = col;
  float* nxt = col + n;
  if (i < n && h == 0) cur[i] = row[0];
  team.sync();
  float logdet = 0.0f;
  for (int j = 0; j < n; ++j) {
    const float piv = cur[j];
    logdet += logf(piv);
    const float inv_d = rsqrtf(piv);
    if (i >= j && i < n) {
      const float lij = cur[i] * inv_d;  // L[i][j]; the diagonal is pivot * rsqrtf(pivot)
      if (h == 0) row[j] = lij;
      // row[c] <- fma(-L[i][j], L[c][j], row[c]) for j < c <= i
      int c = j + 1 + h;
      for (; c + (kBatch - 1) * lanes <= i; c += kBatch * lanes) {
        float v[kBatch], l[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = row[c + u * lanes];
          l[u] = cur[c + u * lanes] * inv_d;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) row[c + u * lanes] = fmaf(-lij, l[u], v[u]);
      }
      for (; c <= i; c += lanes) row[c] = fmaf(-lij, cur[c] * inv_d, row[c]);
      if (i > j && h == 0) nxt[i] = row[j + 1];  // column j + 1, complete for row i
    }
    team.sync();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return logdet;
}

// M = L^-1 from L in s's lower triangle into m (n x n, stride ld), exact
// zeros above the diagonal, by right-looking forward substitution. Column c
// belongs to `lanes` consecutive threads, as rows do in the factor; they take
// part in steps k >= c (rows r > k subtract L[r][k] M[k][c], lane h taking
// r = k + 1 + h (mod lanes); row k + 1 has then had its last update and lane
// 0 divides it by L[k+1][k+1]). A column's lanes share a warp, so a step ends
// in __syncwarp, not a team barrier; the threads of a warp read the same few
// L[r][k] at once (broadcasts).
template <class Team>
__device__ __forceinline__ void right_looking_lower_inverse(const Team& team, const float* s,
                                                            float* m, int n, int ld, int lanes) {
  const int c = team.rank / lanes;
  const int h = team.rank - c * lanes;
  if (c < n) {
    const float inv_dc = 1.0f / s[c * ld + c];
    for (int r = h; r < n; r += lanes) m[r * ld + c] = (r == c) ? inv_dc : 0.0f;
  }
  __syncwarp();
  for (int k = 0; k < n - 1; ++k) {
    if (c <= k) {
      const float mkc = m[k * ld + c];
      int r = k + 1 + h;
      for (; r + (kBatch - 1) * lanes < n; r += kBatch * lanes) {
        float v[kBatch], l[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          v[u] = m[(r + u * lanes) * ld + c];
          l[u] = s[(r + u * lanes) * ld + k];
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) m[(r + u * lanes) * ld + c] = fmaf(-l[u], mkc, v[u]);
      }
      for (; r < n; r += lanes) m[r * ld + c] = fmaf(-s[r * ld + k], mkc, m[r * ld + c]);
      if (h == 0) m[(k + 1) * ld + c] = m[(k + 1) * ld + c] / s[(k + 1) * ld + k + 1];
    }
    __syncwarp();
  }
  team.sync();
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

// Shared floats one team's matrix needs: A (then L, and A^-1's strict lower
// triangle transposed into its strict upper one), M (the factor's column
// buffers before it), and A^-1's diagonal.
__host__ __device__ constexpr int chol_team_floats(int n) { return 2 * n * (n + 1) + n; }

}  // namespace lvae
