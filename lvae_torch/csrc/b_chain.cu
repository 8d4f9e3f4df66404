// Fused per-subject B-operator chain for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lvae_tpu/kernels_pallas/b_chain.py
// (_b_chain_pallas / _make_body). For every (latent l, subject s) block of a
// Hensman training batch it computes, from constrained kernel parameters and
// the subject's covariates:
//
//   K1[t, u] = sum_c spec1 component c at (x_t, x_u), times mask_t mask_u
//   B        = K1 + diag(mask * sigma2_l + (1 - mask))   (unit pivots on padding)
//   L        = chol(B), M = L^-1, B^-1 = M^T M            -> iB[l, s]
//   log|B|   = sum_j log pivot_j                          -> logdet[l, s]
//   tr(B^-1 K0), K0 the spec0 block, built the same way   -> tr[l, s]
//
// Inputs (f32, contiguous): s0, g0 [L, C0] and s1, g1 [L, C1] (scale and
// 1 / (2 lengthscale^2)), sigma2 [L], covariates xb [S, T, Q], mask [S, T].
// Outputs: iB [L, S, T, T] (batch-major, no relayout), logdet and tr [L, S];
// the caller sums the last two over S, so the result does not depend on the
// order in which blocks finish (no atomics).
//
// The kernel spec is static in the JAX package; here it arrives as a small
// int table read into SpecTable, a __grid_constant__ kernel argument (the
// layout and the component math are component.cuh, shared with
// kernel_matrix.cu).
//
// Bound on an H100. Bytes: the function reads the covariates, mask and
// parameters (a few KB) and writes iB once, L*S*T^2*4 bytes: 1.02 MB at the
// training shape L=32, S=20, T=20, 0.31 us at 3.35 TB/s; flops: about T^3 a
// block plus a few per component and entry, 0.08 us at 67 TFLOP/s f32.
// Neither is reachable: each block is a chain of T pivot steps and T - 1
// substitution steps, and the bound is less than one launch. The design
// shortens each step of the chain and spreads it over threads:
//
// * a team owns an (l, s) block (chol_common.cuh): one warp, one thread a
//   row, for T <= 32, several teams a thread block; a whole thread block for
//   32 < T <= 128, 64 or 128 rows of `lanes` threads each. The launch plan is
//   made in kernels_cuda/chol_plan.py and checked here.
// * per team in shared memory: B (then L, with B^-1's strict lower triangle
//   transposed above it) and M, each T x (T + 1), B^-1's diagonal, the
//   covariates [T, Q], the mask and 32 floats for the trace's warp partials.
//   One shape serves 2 <= T <= 128: at T = 128 that is 136 KB, above the 48
//   KB default, so the launch raises the block's dynamic shared-memory limit.
// * B's lower triangle (all the factor reads) is built over the team, the
//   diagonal term seeding each accumulator as the TPU kernel does; then the
//   right-looking factor (one team barrier a pivot step) and substitution (a
//   __syncwarp a step); then the lower triangle of B^-1 (inverse_entry),
//   mirrored on the way out.
// * tr(B^-1 K0) = sum over the lower triangle of w * B^-1[r][c] * K0[r][c],
//   w = 1 on the diagonal and 2 below it (both factors are exactly symmetric),
//   each K0 entry rebuilt from the covariates while the B^-1 entry is in hand,
//   so no K0 buffer exists. Its order is fixed: each thread adds its entries in
//   the order rank, rank + size, ... of the row-by-row triangle; a warp's
//   partials are added by a shuffle tree (offsets 16, 8, 4, 2, 1); a block
//   team's warps' sums are then added in warp order. Deterministic, but not the
//   order of the kernel this replaced, so tr rounds differently.
//
// B^-1 and log|B| are bit-equal to the left-looking kernel this replaced: the
// same operations in the same order for every entry (chol_common.cuh's head
// note), with the build flags of kernels_cuda/build.py.
//
// Pivots are not guarded (rsqrtf): a block that is not positive definite
// gives NaN in that block's outputs only.

#include <cuda_runtime.h>

#include "chol_common.cuh"
#include "component.cuh"

namespace {

constexpr int kMaxT = 128;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;

struct SpecTable {
  int c0;  // spec0 components: comp[0, c0)
  int c1;  // spec1 components: comp[c0, c0 + c1)
  lvae::Component comp[2 * lvae::kMaxComponents];
};

// Shared floats one team needs: chol_common's matrices, covariates, mask and
// the trace's warp partials.
__host__ __device__ constexpr int team_floats(int t, int q) {
  return lvae::chol_team_floats(t) + t * q + t + 32;
}

struct ChainArgs {
  const float* s0;
  const float* g0;
  const float* s1;
  const float* g1;
  const float* sigma2;
  const float* xb;
  const float* mask;
  float* ib;
  float* logdet_out;
  float* tr_out;
  int n_subj, t, q;
};

template <class Team>
__device__ __forceinline__ void b_chain_block(const Team& team, const ChainArgs& p,
                                              const SpecTable& spec, long long blk,
                                              float* s_l, int lanes) {
  const int t = p.t;
  const int q = p.q;
  const int ld = t + 1;
  float* s_m = s_l + t * ld;     // the factor's column buffers, then M = L^-1
  float* diag = s_m + t * ld;    // B^-1's diagonal
  float* s_x = diag + t;         // covariates [T, Q]
  float* s_mask = s_x + t * q;   // mask [T]
  float* s_red = s_mask + t;     // the trace's warp partials

  const int l = static_cast<int>(blk / p.n_subj);
  const int s = static_cast<int>(blk - static_cast<long long>(l) * p.n_subj);
  const int tt = t * t;
  const int tri = t * (t + 1) / 2;

  for (int idx = team.rank; idx < t * q; idx += team.size) {
    s_x[idx] = p.xb[static_cast<long long>(s) * t * q + idx];
  }
  for (int idx = team.rank; idx < t; idx += team.size) {
    s_mask[idx] = p.mask[static_cast<long long>(s) * t + idx];
  }
  team.sync();

  // B's lower triangle = diag(mask * sigma2 + (1 - mask)) + masked K1, the
  // diagonal seeding the accumulator
  const float sig2 = p.sigma2[l];
  const float* s1_l = p.s1 + l * spec.c1;
  const float* g1_l = p.g1 + l * spec.c1;
  for (int e = team.rank; e < tri; e += team.size) {
    int r, c;
    lvae::tri_index(e, &r, &c);
    const float mr = s_mask[r];
    const float mm = mr * s_mask[c];
    float acc = (r == c) ? (mr * sig2 + (1.0f - mr)) : 0.0f;
    for (int k = 0; k < spec.c1; ++k) {
      acc += lvae::component_term(spec.comp[spec.c0 + k], s_x + r * q, 1, s_x + c * q,
                                  1, mm, s1_l[k], g1_l[k]);
    }
    s_l[r * ld + c] = acc;
  }
  team.sync();

  const float logdet = lvae::right_looking_cholesky(team, s_l, s_m, t, ld, lanes);
  lvae::right_looking_lower_inverse(team, s_l, s_m, t, ld, lanes);

  // B^-1's lower triangle (the diagonal into diag, the rest transposed into
  // s_l's strict upper triangle), and tr(B^-1 K0)
  const float* s0_l = p.s0 + l * spec.c0;
  const float* g0_l = p.g0 + l * spec.c0;
  float tr = 0.0f;
  for (int e = team.rank; e < tri; e += team.size) {
    int r, c;
    lvae::tri_index(e, &r, &c);
    const float v = lvae::inverse_entry(s_m, t, ld, r, c);
    if (r == c) {
      diag[r] = v;
    } else {
      s_l[c * ld + r] = v;
    }
    const float mm = s_mask[r] * s_mask[c];
    float k0 = 0.0f;
    for (int k = 0; k < spec.c0; ++k) {
      k0 += lvae::component_term(spec.comp[k], s_x + r * q, 1, s_x + c * q, 1, mm,
                                 s0_l[k], g0_l[k]);
    }
    tr += ((r == c) ? v : 2.0f * v) * k0;
  }
  tr = team.sum(tr, s_red);
  team.sync();  // B^-1's lower triangle complete before the mirrored stores
  if (team.rank == 0) {
    p.tr_out[blk] = tr;
    p.logdet_out[blk] = logdet;
  }

  float* ib_blk = p.ib + blk * tt;
  for (int idx = team.rank; idx < tt; idx += team.size) {
    const int r = idx / t;
    const int c = idx - r * t;
    ib_blk[idx] = (r == c) ? diag[r] : s_l[min(r, c) * ld + max(r, c)];
  }
}

// T <= 32: one warp an (l, s) block, blockDim.x / 32 of them a thread block.
__global__ void b_chain_warp_kernel(const ChainArgs p, long long blocks_total,
                                    const __grid_constant__ SpecTable spec) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / lvae::kWarp;
  const long long blk =
      static_cast<long long>(blockIdx.x) * (blockDim.x / lvae::kWarp) + warp;
  if (blk >= blocks_total) return;  // the last block's spare warps; no block barrier follows
  const lvae::WarpTeam team{static_cast<int>(threadIdx.x) & (lvae::kWarp - 1)};
  b_chain_block(team, p, spec, blk, smem + warp * team_floats(p.t, p.q), 1);
}

// One thread block an (l, s) block, blockDim.x / team_rows(T) threads a row.
__global__ void b_chain_block_kernel(const ChainArgs p, const __grid_constant__ SpecTable spec) {
  extern __shared__ float smem[];
  const lvae::BlockTeam team{static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x)};
  b_chain_block(team, p, spec, blockIdx.x, smem, team.size / lvae::team_rows(p.t));
}

// Sets the kernel's dynamic shared-memory limit where smem needs it, then
// launches it.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int blocks, int threads, int smem, cudaStream_t st, Args... args) {
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` with the plan of kernels_cuda/chol_plan.py and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for arguments or
// a plan the kernel does not take (the rules of chol_inv.cu's entry point,
// with 128 rows for 64 < T <= 128, and at most 227 KB of shared memory, the
// block's limit raised above 48 KB). `table` is a host array of (c0 + c1) rows of lvae::kRow ints,
// spec0's components first.
extern "C" int lvae_b_chain_f32(const void* s0, const void* g0, const void* s1,
                                const void* g1, const void* sigma2,
                                const void* xb, const void* mask, void* ib,
                                void* logdet, void* tr, int n_lat, int n_subj,
                                int t, int q, const int* table, int c0, int c1,
                                int team, int teams, int blocks, int threads, int smem,
                                void* stream) {
  if (t < 2 || t > kMaxT || n_lat < 0 || n_subj < 0 || q < 1 || c0 < 1 ||
      c1 < 1 || c0 > lvae::kMaxComponents || c1 > lvae::kMaxComponents) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(n_lat) * n_subj;
  if (total == 0) return 0;
  const bool warp_teams = team == lvae::kWarp && t <= lvae::kWarp;
  const bool block_team = team > lvae::kWarp && teams == 1 && lvae::valid_block_team(team, t);
  if (!(warp_teams || block_team) || teams < 1 || threads != team * teams || threads > 1024 ||
      blocks < 1 || static_cast<long long>(blocks) * teams < total ||
      static_cast<long long>(blocks - 1) * teams >= total ||
      smem != teams * team_floats(t, q) * static_cast<int>(sizeof(float)) ||
      smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  SpecTable spec;
  spec.c0 = c0;
  spec.c1 = c1;
  for (int k = 0; k < c0 + c1; ++k) {
    if (!lvae::read_component(table + k * lvae::kRow, q, &spec.comp[k])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }

  const ChainArgs p{
      static_cast<const float*>(s0), static_cast<const float*>(g0),
      static_cast<const float*>(s1), static_cast<const float*>(g1),
      static_cast<const float*>(sigma2), static_cast<const float*>(xb),
      static_cast<const float*>(mask), static_cast<float*>(ib),
      static_cast<float*>(logdet), static_cast<float*>(tr), n_subj, t, q};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp_teams) return launch(b_chain_warp_kernel, blocks, threads, smem, st, p, total, spec);
  return launch(b_chain_block_kernel, blocks, threads, smem, st, p, spec);
}
