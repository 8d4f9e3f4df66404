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
// Bound on an H100: memory. The function reads the covariates, mask and
// parameters (a few KB) and writes iB once, L*S*T^2*4 bytes: 1.02 MB at the
// training shape L=32, S=20, T=20, 0.31 us at 3.35 TB/s. Its arithmetic is
// about T^3 flops per block for the factor, the triangular inverse and the
// product, plus a few flops per component and entry for K0 and K1: 5.1 Mflop
// at that shape, 0.08 us at 67 TFLOP/s f32.
//
// Design, simple first: one thread block per (l, s) block, roundup(T, 32)
// threads. Covariates and mask sit in shared memory; B, then L in place, and
// M each take a T x (T+1) buffer (padded stride: column walks hit distinct
// banks). One shape covers 2 <= T <= 128: two 128 x 129 f32 buffers are 132 KB,
// above the 48 KB default, so the launch raises the block's dynamic
// shared-memory limit. The diagonal term seeds the B accumulator, as the TPU
// kernel does. tr(B^-1 K0) recomputes each K0 entry from the covariates while
// the B^-1 entry is in hand, so no K0 buffer exists; each thread sums its
// entries, then a fixed warp-shuffle tree reduces them (deterministic). The
// factor, the substitution and the inverse entries are chol_common.cuh, shared
// with chol_inv.cu. Left for later: at T = 20 a block is one 32-thread warp
// running a serial chain, and 640 such blocks fill the card poorly; packing
// several (l, s) blocks per thread block is the next step once measured.
//
// Pivots are not guarded (rsqrtf): a block that is not positive definite
// gives NaN in that block's outputs only.

#include <cuda_runtime.h>

#include "chol_common.cuh"
#include "component.cuh"

namespace {

constexpr int kMaxT = 128;

struct SpecTable {
  int c0;  // spec0 components: comp[0, c0)
  int c1;  // spec1 components: comp[c0, c0 + c1)
  lvae::Component comp[2 * lvae::kMaxComponents];
};

__global__ void b_chain_kernel(const float* __restrict__ s0,
                               const float* __restrict__ g0,
                               const float* __restrict__ s1,
                               const float* __restrict__ g1,
                               const float* __restrict__ sigma2,
                               const float* __restrict__ xb,
                               const float* __restrict__ mask,
                               float* __restrict__ ib,
                               float* __restrict__ logdet_out,
                               float* __restrict__ tr_out, int n_subj, int t,
                               int q, const __grid_constant__ SpecTable spec) {
  extern __shared__ float smem[];
  const int ld = t + 1;
  float* s_l = smem;               // B, then L in its lower triangle
  float* s_m = s_l + t * ld;       // M = L^-1
  float* s_x = s_m + t * ld;       // covariates [T, Q]
  float* s_mask = s_x + t * q;     // mask [T]
  float* s_red = s_mask + t;       // one partial trace per warp

  const int blk = blockIdx.x;  // = l * S + s
  const int l = blk / n_subj;
  const int s = blk - l * n_subj;
  const int tid = threadIdx.x;
  const int tt = t * t;

  for (int idx = tid; idx < t * q; idx += blockDim.x) {
    s_x[idx] = xb[static_cast<long long>(s) * t * q + idx];
  }
  for (int idx = tid; idx < t; idx += blockDim.x) {
    s_mask[idx] = mask[static_cast<long long>(s) * t + idx];
  }
  __syncthreads();

  // B = diag(mask * sigma2 + (1 - mask)) + masked K1, the diagonal seeding
  // the accumulator
  const float sig2 = sigma2[l];
  const float* s1_l = s1 + l * spec.c1;
  const float* g1_l = g1 + l * spec.c1;
  for (int idx = tid; idx < tt; idx += blockDim.x) {
    const int r = idx / t;
    const int c = idx - r * t;
    const float mr = s_mask[r];
    const float mm = mr * s_mask[c];
    float acc = (r == c) ? (mr * sig2 + (1.0f - mr)) : 0.0f;
    for (int k = 0; k < spec.c1; ++k) {
      acc += lvae::component_term(spec.comp[spec.c0 + k], s_x + r * q, 1, s_x + c * q,
                                  1, mm, s1_l[k], g1_l[k]);
    }
    s_l[r * ld + c] = acc;
  }
  __syncthreads();

  const float logdet = lvae::column_cholesky(s_l, t, ld);
  lvae::lower_inverse(s_l, s_m, t, ld);

  // B^-1 out, and tr(B^-1 K0) with each K0 entry rebuilt in place
  const float* s0_l = s0 + l * spec.c0;
  const float* g0_l = g0 + l * spec.c0;
  float* ib_blk = ib + static_cast<long long>(blk) * tt;
  float tr = 0.0f;
  for (int idx = tid; idx < tt; idx += blockDim.x) {
    const int r = idx / t;
    const int c = idx - r * t;
    const float v = lvae::inverse_entry(s_m, t, ld, r, c);
    ib_blk[idx] = v;
    const float mm = s_mask[r] * s_mask[c];
    float k0 = 0.0f;
    for (int k = 0; k < spec.c0; ++k) {
      k0 += lvae::component_term(spec.comp[k], s_x + r * q, 1, s_x + c * q, 1, mm,
                                 s0_l[k], g0_l[k]);
    }
    tr += v * k0;
  }
  for (int off = 16; off > 0; off >>= 1) tr += __shfl_down_sync(0xffffffffu, tr, off);
  if ((tid & 31) == 0) s_red[tid >> 5] = tr;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) total += s_red[w];
    tr_out[blk] = total;
    logdet_out[blk] = logdet;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take. `table` is a
// host array of (c0 + c1) rows of lvae::kRow ints, spec0's components first.
extern "C" int lvae_b_chain_f32(const void* s0, const void* g0, const void* s1,
                                const void* g1, const void* sigma2,
                                const void* xb, const void* mask, void* ib,
                                void* logdet, void* tr, int n_lat, int n_subj,
                                int t, int q, const int* table, int c0, int c1,
                                void* stream) {
  if (t < 2 || t > kMaxT || n_lat < 0 || n_subj < 0 || q < 1 || c0 < 1 ||
      c1 < 1 || c0 > lvae::kMaxComponents || c1 > lvae::kMaxComponents) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(n_lat) * n_subj;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;

  SpecTable spec;
  spec.c0 = c0;
  spec.c1 = c1;
  for (int k = 0; k < c0 + c1; ++k) {
    if (!lvae::read_component(table + k * lvae::kRow, q, &spec.comp[k])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }

  const int threads = ((t + 31) / 32) * 32;
  const size_t smem =
      (2u * t * (t + 1) + static_cast<size_t>(t) * q + t + 32) * sizeof(float);
  if (smem > 232448u) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        b_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  b_chain_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(g0),
      static_cast<const float*>(s1), static_cast<const float*>(g1),
      static_cast<const float*>(sigma2), static_cast<const float*>(xb),
      static_cast<const float*>(mask), static_cast<float*>(ib),
      static_cast<float*>(logdet), static_cast<float*>(tr), n_subj, t, q, spec);
  return static_cast<int>(cudaGetLastError());
}
