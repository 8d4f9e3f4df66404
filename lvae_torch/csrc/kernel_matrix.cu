// Tiled additive kernel matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lvae_tpu/kernels_pallas/kernel_matrix.py
// (_kernel_matrix_pallas / _make_kernel_body). From constrained parameters
// scale [L, C] and g = 1 / (2 lengthscale^2) [L, C] and covariates
// x1 [N1, Q], x2 [N2, Q] (all f32, contiguous) it writes the whole stack
//
//   K[l, i, j] = sum_c scale[l, c] * disc_c(x1_i, x2_j) * exp(-sqd_c(x1_i, x2_j) g[l, c])
//
// exactly [L, N1, N2], with no padding: per entry every component's
// discrete factors (equality, both-one, centred categorical) and squared
// distance are formed once, in registers, and the loop over the L latents
// reads only them and the parameters, summing the components in order
// through component.cuh's component_value (shared with b_chain.cu and
// block_pair.cu). No per-component [L, N1, N2] intermediate reaches device
// memory. The spec is an int table passed by value.
//
// Bound on an H100: memory, with the arithmetic close behind. The output is
// written once, L*N1*N2*4 bytes: 512 MB at the standard regime's closed-KL
// shape [32, 2000, 2000], 0.153 ms at 3.35 TB/s; the inputs are a few KB.
// The HealthMNIST joined spec has 4 RBF components of 5 (sqexp_kernel and
// three cat_int_kernel terms), so that shape takes 4 * 32 * 4 M = 512 M
// accurate expf (never __expf: the plain version's exp is the reference).
// At the MUFU rate (16 a clock an SM) plus expf's range reduction and
// scaling (about 8 FP32 instructions each) that is 0.14-0.2 ms of work
// on 132 SMs: the same order as the writes. Measured on an H100 (PERF.md
// §6) with the earlier one-entry-a-thread kernel: its stores alone took
// 0.165 ms (3.1 TB/s), its arithmetic alone 0.63 ms, of which expf 0.13;
// the rest were the per-entry parameter loads and flops. So the design
// cuts arithmetic: 4 entries share each parameter load, and the symmetric
// walk halves the factors and the expf.
//
// Design. The launch geometry (tiles, walks, vector width, shared bytes,
// the symmetric decision) is kernels_cuda/km_plan.py's; the entry point
// recomputes it and refuses another.
// * A block of 256 threads owns a 2-D tile and stages, once, the
//   parameters, its rows of x1 and its columns of x2 in shared memory,
//   behind one barrier. A thread owns 4 consecutive columns of a row: it
//   forms their factors, then for each latent sums the 4 entries and
//   stores them with one 16-byte store (a scalar store an entry where
//   N2 % 4 != 0, which leaves rows unaligned, or at the ragged edge).
// * General walk: tiles of 8 rows x 128 columns, a warp a row, its 32
//   lanes along it (512 contiguous bytes a latent): 4,000 blocks at
//   N = 2000, 325 at N = 520.
// * Symmetric walk, when x1 is x2 (same storage; the wrapper decides):
//   square 32 x 32 tiles with I >= J only, off-diagonal tiles first. A
//   thread owns 4 columns of one row for all latents. Off-diagonal tiles
//   are also written transposed at (J, I): 8 latents at a time go through
//   a [8][32][33] shared buffer (conflict-free both ways), so both stores
//   stay coalesced. Every factor is bitwise symmetric in its two rows (==,
//   a + b == 2 and (a - b)^2 are), so the mirrored entries are exactly
//   those the general walk computes there, and the expf and factor work
//   halves.
// * The factor arrays (4 entries x 2 factors a component, in registers) are
//   compiled for 6, 8 and 16 components, chosen by the plan: the joined
//   HealthMNIST spec's 5 take the 6, whose symmetric kernel fits three
//   blocks an SM. Measured on an H100 at [32, 2000, 2000] (PERF.md §6):
//   the 6-component arrays and three blocks an SM took the symmetric walk
//   from 0.256 to 0.214 ms, and rows of 8 instead of 32 the general walk at
//   N = 520 from 0.131 to 0.043 ms.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "component.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kGenRows = 8;    // GEN_ROWS of km_plan.py: a row a warp
constexpr int kGenCols = 128;  // GEN_COLS
constexpr int kSymTile = 32;   // SYM_TILE
constexpr int kSymLat = 8;     // SYM_LAT
constexpr int kSymStride = kSymTile + 1;
constexpr int kMaxSmem = 232448;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxGridY = 65535;

struct KernelSpec {
  int c;
  lvae::Component comp[lvae::kMaxComponents];
};

// The data-only factors of every component at the thread's kVec entries:
// row x1 (stride 1) against the columns x2 + k of a [Q, cols] tile.
template <int MAXC>
__device__ __forceinline__ void entry_factors(const KernelSpec& spec, const float* x1,
                                              const float* x2, int cols,
                                              float (&disc)[MAXC][kVec],
                                              float (&sqd)[MAXC][kVec]) {
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < spec.c) {
      const lvae::Component& comp = spec.comp[c];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        disc[c][k] = lvae::component_disc(comp, x1, 1, x2 + k, cols, 1.0f);
        sqd[c][k] = comp.rbf_col >= 0 ? lvae::component_sqdist(comp, x1, 1, x2 + k, cols)
                                      : 0.0f;
      }
    }
  }
}

// The kVec entries of latent l, each summed over the components in order.
template <int MAXC>
__device__ __forceinline__ void entry_values(const KernelSpec& spec, const float* sc_l,
                                             const float* g_l,
                                             const float (&disc)[MAXC][kVec],
                                             const float (&sqd)[MAXC][kVec],
                                             float (&acc)[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < spec.c) {
      const bool rbf = spec.comp[c].rbf_col >= 0;
      const float sc = sc_l[c];
      const float gc = g_l[c];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        acc[k] += lvae::component_value(rbf, disc[c][k], sqd[c][k], sc, gc);
      }
    }
  }
}

// `valid` entries from p: one 16-byte store when all kVec are valid and the
// row takes it, else one store an entry.
__device__ __forceinline__ void store_entries(float* p, const float (&v)[kVec], int valid,
                                              bool vec) {
  if (vec && valid == kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < valid) p[k] = v[k];
    }
  }
}

// Stages [L, C] scale and g, `rows` rows of x [n, q] from r0 as [rows, q],
// and `cols` rows of y [m, q] from c0 transposed as [q, cols]; rows past the
// end are zeros (their entries are never stored).
__device__ __forceinline__ void stage(const float* __restrict__ scale,
                                      const float* __restrict__ g, int nlc, float* s_scale,
                                      float* s_g, const float* __restrict__ x, int n, int r0,
                                      int rows, float* s_x, const float* __restrict__ y,
                                      int m, int c0, int cols, float* s_y, int q) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < nlc; idx += kThreads) {
    s_scale[idx] = scale[idx];
    s_g[idx] = g[idx];
  }
  for (int idx = tid; idx < rows * q; idx += kThreads) {
    const int r = idx / q;
    s_x[idx] = (r0 + r < n) ? x[static_cast<long long>(r0) * q + idx] : 0.0f;
  }
  for (int idx = tid; idx < q * cols; idx += kThreads) {
    const int col = idx / cols;
    const int jj = idx - col * cols;
    s_y[idx] = (c0 + jj < m) ? y[static_cast<long long>(c0 + jj) * q + col] : 0.0f;
  }
}

template <int MAXC>
__global__ void __launch_bounds__(kThreads)
    kernel_matrix_general(const float* __restrict__ scale, const float* __restrict__ g,
                          const float* __restrict__ x1, const float* __restrict__ x2,
                          float* __restrict__ out, int n_lat, int n1, int n2, int q, bool vec,
                          const __grid_constant__ KernelSpec spec) {
  extern __shared__ float smem[];
  const int nc = spec.c;
  float* s_scale = smem;                  // [L, C]
  float* s_g = s_scale + n_lat * nc;      // [L, C]
  float* s_x1 = s_g + n_lat * nc;         // [kGenRows, Q]
  float* s_x2 = s_x1 + kGenRows * q;      // [Q, kGenCols]
  const int i0 = blockIdx.y * kGenRows;
  const int j0 = blockIdx.x * kGenCols;
  stage(scale, g, n_lat * nc, s_scale, s_g, x1, n1, i0, kGenRows, s_x1, x2, n2, j0, kGenCols,
        s_x2, q);
  __syncthreads();

  const int r = threadIdx.x >> 5;  // the warp's row
  const int jj = (threadIdx.x & 31) * kVec;
  const int i = i0 + r;
  const int j = j0 + jj;
  if (i >= n1 || j >= n2) return;  // no barrier follows
  const int valid = min(kVec, n2 - j);
  const long long plane = static_cast<long long>(n1) * n2;
  float disc[MAXC][kVec];
  float sqd[MAXC][kVec];
  entry_factors<MAXC>(spec, s_x1 + r * q, s_x2 + jj, kGenCols, disc, sqd);
  float* out_ij = out + static_cast<long long>(i) * n2 + j;
  for (int l = 0; l < n_lat; ++l) {
    float acc[kVec];
    entry_values<MAXC>(spec, s_scale + l * nc, s_g + l * nc, disc, sqd, acc);
    store_entries(out_ij + l * plane, acc, valid, vec);
  }
}

// Tile (I, J), I >= J, of symmetric block b of a walk of `tiles` tiles a
// side: the off-diagonal tiles row by row, then the diagonal (sym_tile of
// km_plan.py).
__device__ __forceinline__ void sym_tile(long long b, int tiles, int* ti, int* tj) {
  const long long off = static_cast<long long>(tiles) * (tiles - 1) / 2;
  if (b >= off) {
    *ti = *tj = static_cast<int>(b - off);
    return;
  }
  long long i = static_cast<long long>((1.0 + sqrt(1.0 + 8.0 * static_cast<double>(b))) / 2.0);
  while (i * (i - 1) / 2 > b) --i;
  while ((i + 1) * i / 2 <= b) ++i;
  *ti = static_cast<int>(i);
  *tj = static_cast<int>(b - i * (i - 1) / 2);
}

// With the 6-component factor arrays three blocks fit an SM (at most 85
// registers a thread, no spills on an H100); larger arrays keep two.
template <int MAXC>
__global__ void __launch_bounds__(kThreads, MAXC <= 6 ? 3 : 1)
    kernel_matrix_symmetric(const float* __restrict__ scale, const float* __restrict__ g,
                            const float* __restrict__ x, float* __restrict__ out, int n_lat,
                            int n, int q, int tiles, bool vec,
                            const __grid_constant__ KernelSpec spec) {
  extern __shared__ float smem[];
  const int nc = spec.c;
  float* s_scale = smem;                  // [L, C]
  float* s_g = s_scale + n_lat * nc;      // [L, C]
  float* s_xi = s_g + n_lat * nc;         // [kSymTile, Q]: tile I's rows
  float* s_xj = s_xi + kSymTile * q;      // [Q, kSymTile]: tile J's rows, transposed
  float* s_buf = s_xj + q * kSymTile;     // [kSymLat, kSymTile, kSymStride]
  int ti, tj;
  sym_tile(blockIdx.x, tiles, &ti, &tj);
  const int i0 = ti * kSymTile;
  const int j0 = tj * kSymTile;
  const bool mirror = ti != tj;
  stage(scale, g, n_lat * nc, s_scale, s_g, x, n, i0, kSymTile, s_xi, x, n, j0, kSymTile, s_xj,
        q);
  __syncthreads();

  const int tid = threadIdx.x;
  const int r = tid >> 3;             // the thread's row in the tile
  const int jj = (tid & 7) * kVec;    // its first column
  const int i = i0 + r;
  const int j = j0 + jj;
  const int valid = i < n ? max(0, min(kVec, n - j)) : 0;
  // the transposed store: row j0 + r of the output, columns i0 + jj...
  const int mrow = j0 + r;
  const int mcol = i0 + jj;
  const int mvalid = mrow < n ? max(0, min(kVec, n - mcol)) : 0;
  const long long plane = static_cast<long long>(n) * n;
  float* out_ij = out + static_cast<long long>(i) * n + j;
  float* out_ji = out + static_cast<long long>(mrow) * n + mcol;

  float disc[MAXC][kVec];
  float sqd[MAXC][kVec];
  entry_factors<MAXC>(spec, s_xi + r * q, s_xj + jj, kSymTile, disc, sqd);
  for (int l0 = 0; l0 < n_lat; l0 += kSymLat) {
    const int nl = min(kSymLat, n_lat - l0);
    for (int dl = 0; dl < nl; ++dl) {
      const int l = l0 + dl;
      float acc[kVec];
      entry_values<MAXC>(spec, s_scale + l * nc, s_g + l * nc, disc, sqd, acc);
      if (valid > 0) store_entries(out_ij + l * plane, acc, valid, vec);
      if (mirror) {
        float* row = s_buf + (dl * kSymTile + r) * kSymStride + jj;
#pragma unroll
        for (int k = 0; k < kVec; ++k) row[k] = acc[k];
      }
    }
    if (mirror) {  // uniform over the block
      __syncthreads();
      for (int dl = 0; dl < nl; ++dl) {
        const float* col = s_buf + dl * kSymTile * kSymStride + jj * kSymStride + r;
        float v[kVec];
#pragma unroll
        for (int k = 0; k < kVec; ++k) v[k] = col[k * kSymStride];
        if (mvalid > 0) store_entries(out_ji + (l0 + dl) * plane, v, mvalid, vec);
      }
      __syncthreads();  // s_buf is rewritten for the next latents
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Launches on `stream` with the plan of kernels_cuda/km_plan.py (k3_plan)
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments or a plan the kernel does not take: `symmetric` only for one x
// (x1 == x2, n1 == n2); `vec` only where N2 % 4 == 0 and `out` is 16-byte
// aligned; the grid, shared bytes and component bucket exactly the plan's.
// `table` is a host array of c rows of lvae::kRow ints.
extern "C" int lvae_kernel_matrix_f32(const void* scale, const void* g, const void* x1,
                                      const void* x2, void* out, int n_lat, int n1, int n2,
                                      int q, const int* table, int c, int symmetric, int vec,
                                      int grid_x, int grid_y, int smem, int bucket,
                                      void* stream) {
  if (n_lat < 0 || n1 < 0 || n2 < 0 || q < 1 || c < 1 || c > lvae::kMaxComponents) {
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

  const long long params = 2LL * n_lat * c;
  const long long tile = symmetric ? 2LL * kSymTile * q + static_cast<long long>(kSymLat) *
                                                              kSymTile * kSymStride
                                   : static_cast<long long>(kGenRows + kGenCols) * q;
  const long long want_smem = (params + tile) * static_cast<long long>(sizeof(float));
  const int tiles = (n1 + kSymTile - 1) / kSymTile;
  const long long want_x = symmetric ? static_cast<long long>(tiles) * (tiles + 1) / 2
                                     : (n2 + kGenCols - 1) / kGenCols;
  const long long want_y = symmetric ? 1 : (n1 + kGenRows - 1) / kGenRows;
  const bool can_vec = n2 % kVec == 0 && reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int want_bucket = c <= 6 ? 6 : c <= 8 ? 8 : 16;
  if ((symmetric && (x1 != x2 || n1 != n2)) || (vec && !can_vec) || smem != want_smem ||
      smem > kMaxSmem || grid_x != want_x || grid_y != want_y || want_y > kMaxGridY ||
      bucket != want_bucket) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ps = static_cast<const float*>(scale);
  const float* pg = static_cast<const float*>(g);
  const float* p1 = static_cast<const float*>(x1);
  const float* p2 = static_cast<const float*>(x2);
  float* po = static_cast<float*>(out);
  cudaError_t err;
  if (symmetric) {
    auto kernel = bucket == 6   ? kernel_matrix_symmetric<6>
                  : bucket == 8 ? kernel_matrix_symmetric<8>
                                : kernel_matrix_symmetric<16>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid_x, kThreads, smem, s>>>(ps, pg, p1, po, n_lat, n1, q, tiles, vec != 0, spec);
  } else {
    auto kernel = bucket == 6   ? kernel_matrix_general<6>
                  : bucket == 8 ? kernel_matrix_general<8>
                                : kernel_matrix_general<16>;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(grid_x, grid_y), kThreads, smem, s>>>(ps, pg, p1, p2, po, n_lat, n1, n2, q,
                                                        vec != 0, spec);
  }
  return static_cast<int>(cudaGetLastError());
}
