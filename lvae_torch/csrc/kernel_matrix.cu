// Tiled additive kernel matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lvae_tpu/kernels_pallas/kernel_matrix.py
// (_kernel_matrix_pallas / _make_kernel_body). From constrained parameters
// scale [L, C] and g = 1 / (2 lengthscale^2) [L, C] and covariates
// x1 [N1, Q], x2 [N2, Q] (all f32, contiguous) it writes the whole stack
//
//   K[l, i, j] = sum_c scale[l, c] * disc_c(x1_i, x2_j) * exp(-sqd_c(x1_i, x2_j) g[l, c])
//
// exactly [L, N1, N2], with no padding and no slice afterwards: per entry
// every component's discrete factors (equality, both-one, centred
// categorical) and squared distance are formed once, in registers, and the
// loop over the L latents reads only them and the parameters. No
// per-component [L, N1, N2] intermediate reaches device memory. The spec is
// an int table (component.cuh, shared with b_chain.cu), passed by value.
//
// Bound on an H100: memory. The output is written once, L*N1*N2*4 bytes:
// 512 MB at the standard regime's closed-KL shape [32, 2000, 2000], 0.153 ms
// at 3.35 TB/s; the inputs are a few KB. Its arithmetic is one expf and
// about four flops per RBF component, latent and entry, and two flops per
// other component: at that shape with the HealthMNIST spec (3 RBF
// components of 5) about 2.4 Gflop with 384 M expf, 0.036 ms at the f32
// peak, so the writes set the bound.
//
// Design, simple first: one thread per output column j of a 256-wide tile
// (threads along j, so each latent's row segment is one coalesced 1 KB
// store), one output row i per block row of the grid (a grid-stride loop
// over rows past 65535). The block stages the parameters and its x2 tile,
// transposed to [Q, 256] so that reads are conflict-free, in shared memory;
// x1's row is broadcast from shared memory. Components are unrolled to the
// table's limit, so their data-only factors stay in registers. expf, not
// __expf: the plain version's exp is the reference to 1e-5.

#include <cuda_runtime.h>

#include "component.cuh"

namespace {

constexpr int kTile = 256;  // threads per block, along j
constexpr int kMaxRowsInGrid = 65535;

struct KernelSpec {
  int c;
  lvae::Component comp[lvae::kMaxComponents];
};

__global__ void kernel_matrix_kernel(const float* __restrict__ scale,
                                     const float* __restrict__ g,
                                     const float* __restrict__ x1,
                                     const float* __restrict__ x2,
                                     float* __restrict__ out, int n_lat,
                                     int n1, int n2, int q,
                                     const __grid_constant__ KernelSpec spec) {
  extern __shared__ float smem[];
  const int nc = spec.c;
  float* s_scale = smem;                   // [L, C]
  float* s_g = s_scale + n_lat * nc;       // [L, C]
  float* s_x2 = s_g + n_lat * nc;          // [Q, kTile], x2's tile transposed
  float* s_x1 = s_x2 + q * kTile;          // [Q], the current row of x1

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kTile;
  const int j = j0 + tid;

  for (int idx = tid; idx < n_lat * nc; idx += kTile) {
    s_scale[idx] = scale[idx];
    s_g[idx] = g[idx];
  }
  for (int idx = tid; idx < q * kTile; idx += kTile) {
    const int col = idx / kTile;
    const int jj = idx - col * kTile;
    s_x2[idx] = (j0 + jj < n2) ? x2[static_cast<long long>(j0 + jj) * q + col] : 0.0f;
  }

  const long long plane = static_cast<long long>(n1) * n2;
  for (int i = blockIdx.y; i < n1; i += gridDim.y) {
    for (int col = tid; col < q; col += kTile) {
      s_x1[col] = x1[static_cast<long long>(i) * q + col];
    }
    __syncthreads();

    // data-only factors of every component at (i, j), once for all latents
    float disc[lvae::kMaxComponents];
    float sqd[lvae::kMaxComponents];
#pragma unroll
    for (int c = 0; c < lvae::kMaxComponents; ++c) {
      if (c < nc) {
        const lvae::Component& comp = spec.comp[c];
        disc[c] = lvae::component_disc(comp, s_x1, 1, s_x2 + tid, kTile, 1.0f);
        sqd[c] = comp.rbf_col >= 0
                     ? lvae::component_sqdist(comp, s_x1, 1, s_x2 + tid, kTile)
                     : 0.0f;
      }
    }

    if (j < n2) {
      float* out_ij = out + static_cast<long long>(i) * n2 + j;
      for (int l = 0; l < n_lat; ++l) {
        const float* sc_l = s_scale + l * nc;
        const float* g_l = s_g + l * nc;
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < lvae::kMaxComponents; ++c) {
          if (c < nc) {
            acc += lvae::component_value(spec.comp[c].rbf_col >= 0, disc[c], sqd[c],
                                         sc_l[c], g_l[c]);
          }
        }
        out_ij[l * plane] = acc;
      }
    }
    __syncthreads();  // s_x1 is rewritten for the next row
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take. `table` is a
// host array of c rows of lvae::kRow ints.
extern "C" int lvae_kernel_matrix_f32(const void* scale, const void* g,
                                      const void* x1, const void* x2, void* out,
                                      int n_lat, int n1, int n2, int q,
                                      const int* table, int c, void* stream) {
  if (n_lat < 0 || n1 < 0 || n2 < 0 || q < 1 || c < 1 ||
      c > lvae::kMaxComponents) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KernelSpec spec;
  spec.c = c;
  for (int k = 0; k < c; ++k) {
    if (!lvae::read_component(table + k * lvae::kRow, q, &spec.comp[k])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n_lat == 0 || n1 == 0 || n2 == 0) return 0;

  const size_t smem =
      (2u * static_cast<size_t>(n_lat) * c + static_cast<size_t>(q) * kTile + q) *
      sizeof(float);
  if (smem > 232448u) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48u * 1024u) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n2 + kTile - 1) / kTile, n1 < kMaxRowsInGrid ? n1 : kMaxRowsInGrid);
  kernel_matrix_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scale), static_cast<const float*>(g),
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<float*>(out), n_lat, n1, n2, q, spec);
  return static_cast<int>(cudaGetLastError());
}
