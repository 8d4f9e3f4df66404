// One-pass flat Adam update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lvae_tpu/kernels_pallas/adam.py
// (_adam_pallas / _adam_kernel). Over flat f32 vectors m, v, g of length n it
// computes, in one pass, optax.adam's update:
//
//   m' = b1 m + (1 - b1) g,   v' = b2 v + (1 - b2) g^2
//   d  = -lr (m' c1) / (sqrt(v' c2) + eps),   c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t)
//
// writing m' and v' in place and the parameter delta d. The bias
// corrections arrive either as scalars from the host, as the TPU kernel takes
// them from SMEM, or as the step count t in device memory (`count`, not
// null), so that a step captured in a CUDA graph reads the count that the
// replay advanced: thread 0 of each block then computes c1 and c2 in double
// from the double b1 and b2 and rounds them to f32, as the host computes
// them. (1 - b1) and (1 - b2) arrive rounded once from double, so the kernel
// multiplies by the same f32 constants as the plain version. This is optax's
// form (eps outside the square root of the corrected v), not
// torch.optim.Adam's sqrt(v) / sqrt(bc2).
//
// Bound on an H100: memory. Three vectors are read and three written once,
// 24 n bytes: 38 MB for the HealthMNIST ConvVAE's 1.59 M parameters, 11 us
// at 3.35 TB/s; the dozen flops per element are far below the f32 peak.
//
// Design, simple first: a grid-stride loop, one element per thread and
// step, 256 threads a block and at most 16 blocks per SM; neighbouring
// threads touch neighbouring words, so every access is coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

__global__ void adam_kernel(float* __restrict__ m, float* __restrict__ v,
                            const float* __restrict__ g, float* __restrict__ d,
                            long long n, float b1, float one_minus_b1, float b2,
                            float one_minus_b2, float lr, float eps, float c1,
                            float c2, const long long* __restrict__ count,
                            double b1d, double b2d) {
  if (count != nullptr) {  // uniform over the grid: every thread reaches the barrier
    __shared__ float corr[2];
    if (threadIdx.x == 0) {
      const double t = static_cast<double>(*count);
      corr[0] = static_cast<float>(1.0 / (1.0 - pow(b1d, t)));
      corr[1] = static_cast<float>(1.0 / (1.0 - pow(b2d, t)));
    }
    __syncthreads();
    c1 = corr[0];
    c2 = corr[1];
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float mi = b1 * m[i] + one_minus_b1 * gi;
    const float vi = b2 * v[i] + one_minus_b2 * (gi * gi);
    m[i] = mi;
    v[i] = vi;
    d[i] = (-lr) * (mi * c1) / (sqrtf(vi * c2) + eps);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success). With
// `count` null the kernel takes c1 and c2; else it reads t from `count` and
// computes them from b1d and b2d.
extern "C" int lvae_adam_f32(void* m, void* v, const void* g, void* d,
                             long long n, float b1, float one_minus_b1,
                             float b2, float one_minus_b2, float lr, float eps,
                             float c1, float c2, const void* count, double b1d,
                             double b2d, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(g), static_cast<float*>(d), n, b1, one_minus_b1,
      b2, one_minus_b2, lr, eps, c1, c2, static_cast<const long long*>(count), b1d,
      b2d);
  return static_cast<int>(cudaGetLastError());
}
