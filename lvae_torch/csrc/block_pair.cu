// Block-pair kernel stacks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lvae_tpu/kernels_pallas/kernel_matrix.py
// (_block_pair_pallas / _make_block_pair_body). From constrained parameters
// of both kernel specs, scale0, g0 [L, C0] and scale1, g1 [L, C1] with
// g = 1 / (2 lengthscale^2), per-subject covariates xb [S, T, Q] and the
// validity mask [S, T] (all f32, contiguous) it writes the masked per-subject
// blocks of both specs,
//
//   K0[l, s, t1, t2] = sum_c scale0[l, c] * mm * disc_c * exp(-sqd_c g0[l, c])
//   K1[l, s, t1, t2] = the same over spec1,   mm = mask[s, t1] * mask[s, t2]
//
// exactly [L, S, T, T] each, with no padding. The TPU kernel lays the pair
// axis (t1, t2) out as T*T lanes so that the two specs share the covariate
// loads; here the sharing is per thread: each thread owns one (s, t1, t2)
// pair and forms every component's data-only factors (mask product,
// equality, both-one and centred categorical factors, squared distance) once,
// in registers, for both specs; the loop over latents then reads only them
// and the parameters. The component math is component.cuh's, shared with
// b_chain.cu (K1) and kernel_matrix.cu (K3).
//
// Bound on an H100: memory. Both stacks are written once, 2*L*S*T*T*4 bytes
// (2.05 MB at the Hensman batch [32, 20, 20, 20], 0.6 us at 3.35 TB/s); the
// covariates, mask and parameters are a few KB. At that size the launch
// itself costs more than the bound.
//
// Design, simple first: a block is one subject's tile of kBlock consecutive
// pairs, t2 fastest, so each latent's stores are coalesced; grid.x walks the
// subjects' tiles and grid.y the latent chunks of kLatChunk latents, so that
// the Hensman shape (8,000 pairs) fills the card with 320 blocks instead of
// 40. kLatChunk is a compile-time constant, so that the latent loop unrolls
// (as a launch argument it made the kernel 1.6x slower on an H100); the
// caller passes the value it sized shared memory with, and a mismatch is
// refused. The subject's
// T x Q covariates and T mask entries are staged in shared memory (dynamic,
// any T the device's per-block limit takes), the chunk's parameters of both
// specs too. expf, not __expf, as in K3: the plain version's exp is the
// reference.

#include <cuda_runtime.h>

#include "component.cuh"

namespace {

constexpr int kBlock = 256;    // pairs (threads) per block
constexpr int kLatChunk = 4;   // latents per block: LAT_CHUNK of block_pair.py

struct PairSpec {
  int c0;
  int c1;
  lvae::Component comp[2 * lvae::kMaxComponents];  // spec0's, then spec1's
};

__global__ void block_pair_kernel(const float* __restrict__ s0,
                                  const float* __restrict__ g0,
                                  const float* __restrict__ s1,
                                  const float* __restrict__ g1,
                                  const float* __restrict__ xb,
                                  const float* __restrict__ mask,
                                  float* __restrict__ out0,
                                  float* __restrict__ out1, int n_lat,
                                  int n_subj, int t, int q, int tiles,
                                  const __grid_constant__ PairSpec spec) {
  extern __shared__ float smem[];
  const int c0 = spec.c0;
  const int c1 = spec.c1;
  float* s_x = smem;                          // [T, Q] the subject's covariates
  float* s_m = s_x + t * q;                   // [T] its mask
  float* s_s0 = s_m + t;                      // [kLatChunk, C0]
  float* s_g0 = s_s0 + kLatChunk * c0;        // [kLatChunk, C0]
  float* s_s1 = s_g0 + kLatChunk * c0;        // [kLatChunk, C1]
  float* s_g1 = s_s1 + kLatChunk * c1;        // [kLatChunk, C1]

  const int tid = threadIdx.x;
  const int subj = blockIdx.x / tiles;
  const int tile = blockIdx.x - subj * tiles;
  const int l0 = blockIdx.y * kLatChunk;
  const int n_l = min(kLatChunk, n_lat - l0);

  const float* x_subj = xb + static_cast<long long>(subj) * t * q;
  for (int i = tid; i < t * q; i += kBlock) s_x[i] = x_subj[i];
  for (int i = tid; i < t; i += kBlock) s_m[i] = mask[static_cast<long long>(subj) * t + i];
  for (int i = tid; i < n_l * c0; i += kBlock) {
    s_s0[i] = s0[l0 * c0 + i];
    s_g0[i] = g0[l0 * c0 + i];
  }
  for (int i = tid; i < n_l * c1; i += kBlock) {
    s_s1[i] = s1[l0 * c1 + i];
    s_g1[i] = g1[l0 * c1 + i];
  }
  __syncthreads();

  const int tt = t * t;
  const int pair = tile * kBlock + tid;
  if (pair >= tt) return;
  const int t1 = pair / t;
  const int t2 = pair - t1 * t;
  const float* x1 = s_x + t1 * q;
  const float* x2 = s_x + t2 * q;
  const float mm = s_m[t1] * s_m[t2];

  // data-only factors of every component of both specs, once for all latents
  float disc[2 * lvae::kMaxComponents];
  float sqd[2 * lvae::kMaxComponents];
#pragma unroll
  for (int c = 0; c < 2 * lvae::kMaxComponents; ++c) {
    if (c < c0 + c1) {
      const lvae::Component& comp = spec.comp[c];
      disc[c] = lvae::component_disc(comp, x1, 1, x2, 1, mm);
      sqd[c] = comp.rbf_col >= 0 ? lvae::component_sqdist(comp, x1, 1, x2, 1) : 0.0f;
    }
  }

  const long long plane = static_cast<long long>(n_subj) * tt;
  const long long base = static_cast<long long>(subj) * tt + pair;
  for (int j = 0; j < n_l; ++j) {
    float acc0 = 0.0f;
    float acc1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 2 * lvae::kMaxComponents; ++c) {
      if (c < c0) {
        acc0 += lvae::component_value(spec.comp[c].rbf_col >= 0, disc[c], sqd[c],
                                      s_s0[j * c0 + c], s_g0[j * c0 + c]);
      } else if (c < c0 + c1) {
        const int k = c - c0;
        acc1 += lvae::component_value(spec.comp[c].rbf_col >= 0, disc[c], sqd[c],
                                      s_s1[j * c1 + k], s_g1[j * c1 + k]);
      }
    }
    const long long at = (l0 + j) * plane + base;
    out0[at] = acc0;
    out1[at] = acc1;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take, shared memory
// beyond the device's per-block limit included. `table` is a host array of
// c0 + c1 rows of lvae::kRow ints, spec0's rows first; lat_chunk must be
// kLatChunk.
extern "C" int lvae_block_pair_f32(const void* s0, const void* g0, const void* s1,
                                   const void* g1, const void* xb, const void* mask,
                                   void* out0, void* out1, int n_lat, int n_subj,
                                   int t, int q, const int* table, int c0, int c1,
                                   int lat_chunk, void* stream) {
  if (n_lat < 0 || n_subj < 0 || t < 1 || q < 1 || c0 < 1 || c1 < 1 ||
      lat_chunk != kLatChunk || c0 > lvae::kMaxComponents || c1 > lvae::kMaxComponents) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PairSpec spec;
  spec.c0 = c0;
  spec.c1 = c1;
  for (int k = 0; k < c0 + c1; ++k) {
    if (!lvae::read_component(table + k * lvae::kRow, q, &spec.comp[k])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n_lat == 0 || n_subj == 0) return 0;

  const size_t smem = (static_cast<size_t>(t) * q + t +
                       2u * static_cast<size_t>(kLatChunk) * (c0 + c1)) * sizeof(float);
  if (smem > 48u * 1024u) {  // the device refuses a size beyond its limit
    const cudaError_t err = cudaFuncSetAttribute(
        block_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tt = static_cast<long long>(t) * t;
  const int tiles = static_cast<int>((tt + kBlock - 1) / kBlock);
  const long long blocks_x = static_cast<long long>(n_subj) * tiles;
  const int chunks = (n_lat + kLatChunk - 1) / kLatChunk;
  if (blocks_x > 2147483647LL || chunks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(chunks));
  block_pair_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), static_cast<const float*>(g0),
      static_cast<const float*>(s1), static_cast<const float*>(g1),
      static_cast<const float*>(xb), static_cast<const float*>(mask),
      static_cast<float*>(out0), static_cast<float*>(out1), n_lat, n_subj, t, q, tiles,
      spec);
  return static_cast<int>(cudaGetLastError());
}
