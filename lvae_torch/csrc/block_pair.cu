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
// exactly [L, S, T, T] each, with no padding; a ghost subject (mask all
// zero) is all zeros. The TPU kernel lays the pair axis (t1, t2) out as T*T
// lanes so that the two specs share the covariate loads; here the sharing
// is per thread: a thread forms every component's data-only factors (mask
// product, equality, both-one and centred categorical factors, squared
// distance) once, in registers, for both specs, and the loop over its
// latents reads only them and the parameters. The component math is
// component.cuh's, shared with b_chain.cu (K1) and kernel_matrix.cu (K3);
// expf, not __expf, as in K3.
//
// Bound on an H100: memory. Both stacks are written once, 2*L*S*T*T*4 bytes
// (2.05 MB at the Hensman batch [32, 20, 20, 20], 0.6 us at 3.35 TB/s); the
// covariates, mask and parameters are a few KB. At that size one launch and
// one short wave cost more than the bound: the design keeps that wave short
// and full.
//
// Design: a flat walk over the S*T*T plane with no idle threads and no
// per-subject padding. A thread owns 4 consecutive flat entries (they may
// cross a subject boundary; (s, t1, t2) is decoded once and carried) of one
// latent (grid.y). Component by component it forms the 4 entries' factors
// and adds their terms, each entry's sum in component order: the 4 entries'
// work overlaps and no factor array is kept. It stores each stack's 4
// entries with one 16-byte store wherever S*T*T % 4 == 0 (scalar stores
// otherwise, and in the last partial quad). No shared memory and no block
// barrier: the covariates and the mask are read through the cache, the
// latent's parameters a component a lane and broadcast by warp shuffles.
// At this size a thread's chain of dependent loads sets the time (one
// thread alone takes 6 us of the 7 on an H100, PERF.md §6): loaded a
// component at a time, the parameters would cost a memory round trip
// each. One latent a thread keeps the chain short (2 or 4 took longer):
// a pair's compares and difference are formed again for each latent,
// which costs less than a longer chain. The geometry is
// kernels_cuda/km_plan.py's (k4_plan); the entry point recomputes it and
// refuses another.

#include <cuda_runtime.h>

#include "component.cuh"

namespace {

constexpr int kThreads = 256;  // K4_THREADS of km_plan.py
constexpr int kVec = 4;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxGridY = 65535;
constexpr long long kMaxInt = 2147483647LL;

struct PairSpec {
  int c0;
  int c1;
  lvae::Component comp[2 * lvae::kMaxComponents];  // spec0's, then spec1's
};

__global__ void __launch_bounds__(kThreads)
    block_pair_kernel(const float* __restrict__ s0, const float* __restrict__ g0,
                      const float* __restrict__ s1, const float* __restrict__ g1,
                      const float* __restrict__ xb, const float* __restrict__ mask,
                      float* __restrict__ out0, float* __restrict__ out1, int t, int q,
                      int plane, bool vec, const __grid_constant__ PairSpec spec) {
  // Every lane of a warp runs to the end, so that the shuffles below see the
  // whole warp; a lane past the plane works on entry 0 and stores nothing.
  const long long fl = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  const int f = fl < plane ? static_cast<int>(fl) : 0;
  const int valid = fl < plane ? min(kVec, plane - f) : 0;
  const int c0 = spec.c0;
  const int cc = c0 + spec.c1;
  const int l = blockIdx.y;
  const int lane = threadIdx.x & (kWarp - 1);

  // the latent's parameters, a component a lane (cc <= 32), loaded at once
  // and broadcast by shuffles: one memory round trip, not one a component
  float lane_sc = 0.0f;
  float lane_g = 0.0f;
  if (lane < c0) {
    lane_sc = __ldg(s0 + l * c0 + lane);
    lane_g = __ldg(g0 + l * c0 + lane);
  } else if (lane < cc) {
    lane_sc = __ldg(s1 + l * spec.c1 + lane - c0);
    lane_g = __ldg(g1 + l * spec.c1 + lane - c0);
  }

  // the thread's entries: rows of x and the mask product (a slot past the
  // plane repeats the first entry and is never stored)
  const float* x1[kVec];
  const float* x2[kVec];
  float mm[kVec];
  const int tt = t * t;
  int s = f / tt;
  int t1 = (f - s * tt) / t;
  int t2 = f - s * tt - t1 * t;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (k == 0 || k < valid) {
      x1[k] = xb + static_cast<long long>(s * t + t1) * q;
      x2[k] = xb + static_cast<long long>(s * t + t2) * q;
      mm[k] = mask[s * t + t1] * mask[s * t + t2];
      if (++t2 == t) {  // the next flat entry
        t2 = 0;
        if (++t1 == t) {
          t1 = 0;
          ++s;
        }
      }
    } else {
      x1[k] = x1[0];
      x2[k] = x2[0];
      mm[k] = mm[0];
    }
  }

  // each entry's sum over the components of each spec, in order; the four
  // entries' terms of one component are independent, so they overlap
  float acc0[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc1[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < cc; ++c) {
    const lvae::Component& comp = spec.comp[c];
    const bool rbf = comp.rbf_col >= 0;
    const float sc = __shfl_sync(kFullMask, lane_sc, c);
    const float gc = __shfl_sync(kFullMask, lane_g, c);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float d = lvae::component_disc(comp, x1[k], 1, x2[k], 1, mm[k]);
      const float sqd = rbf ? lvae::component_sqdist(comp, x1[k], 1, x2[k], 1) : 0.0f;
      if (c < c0) {
        acc0[k] += lvae::component_value(rbf, d, sqd, sc, gc);
      } else {
        acc1[k] += lvae::component_value(rbf, d, sqd, sc, gc);
      }
    }
  }
  if (valid == 0) return;

  const long long at = static_cast<long long>(l) * plane + f;
  if (vec && valid == kVec) {
    *reinterpret_cast<float4*>(out0 + at) = make_float4(acc0[0], acc0[1], acc0[2], acc0[3]);
    *reinterpret_cast<float4*>(out1 + at) = make_float4(acc1[0], acc1[1], acc1[2], acc1[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (k < valid) {
        out0[at + k] = acc0[k];
        out1[at + k] = acc1[k];
      }
    }
  }
}

}  // namespace

// Launches on `stream` with the plan of kernels_cuda/km_plan.py (k4_plan)
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for arguments or a plan the kernel does not take: S*T*T within the 32-bit
// flat index; `vec` only where S*T*T % 4 == 0; the grid exactly the plan's
// (`latents` = L). `table` is a host array of c0 + c1 rows of
// lvae::kRow ints, spec0's rows first.
extern "C" int lvae_block_pair_f32(const void* s0, const void* g0, const void* s1,
                                   const void* g1, const void* xb, const void* mask,
                                   void* out0, void* out1, int n_lat, int n_subj, int t, int q,
                                   const int* table, int c0, int c1, int vec, int blocks,
                                   int latents, void* stream) {
  if (n_lat < 0 || n_subj < 0 || t < 1 || q < 1 || c0 < 1 || c1 < 1 ||
      c0 > lvae::kMaxComponents || c1 > lvae::kMaxComponents) {
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

  const long long plane = static_cast<long long>(n_subj) * t * t;
  const long long quads = (plane + kVec - 1) / kVec;
  const long long want_blocks = (quads + kThreads - 1) / kThreads;
  if (plane + kVec > kMaxInt || (vec && plane % kVec != 0) ||
      blocks != want_blocks || latents != n_lat || n_lat > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(latents));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  block_pair_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(s0), static_cast<const float*>(g0),
      static_cast<const float*>(s1), static_cast<const float*>(g1),
      static_cast<const float*>(xb), static_cast<const float*>(mask),
      static_cast<float*>(out0), static_cast<float*>(out1), t, q,
      static_cast<int>(plane), vec != 0, spec);
  return static_cast<int>(cudaGetLastError());
}
