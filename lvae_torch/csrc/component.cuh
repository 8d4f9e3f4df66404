// The additive kernel's component math, shared by the fused B-chain kernel
// (b_chain.cu, K1) and the tiled kernel-matrix kernel (kernel_matrix.cu, K3):
// the one source of it on the card, as kernels_pallas/kernel_matrix.py:
// component_term is for the TPU kernels.
//
// A kernel spec is static in the JAX package; here it reaches a kernel as a
// host int table, one row of kRow ints per component:
//   rbf_col, n_eq, eq[kMaxEq], n_and, and[kMaxAnd], cat_col, cat_num
// (unused slots 0; rbf_col and cat_col -1 when absent), which the launcher
// reads into Component structs passed by value. Semantics (float ==, as the
// JAX package): an equality factor is 1 iff x1[col] == x2[col], a both-one
// factor 1 iff x1[col] + x2[col] == 2, the centred categorical factor 1 if
// equal else -1 / (num - 1), and the RBF factor exp(-(x1 - x2)^2 g) with
// g = 1 / (2 lengthscale^2), all times the component's scale.
//
// A covariate row is a pointer and a stride: x[col * stride].

#pragma once

#include <cuda_runtime.h>

namespace lvae {

constexpr int kMaxComponents = 16;  // per spec
constexpr int kMaxEq = 4;
constexpr int kMaxAnd = 4;
constexpr int kRow = 1 + 1 + kMaxEq + 1 + kMaxAnd + 2;

struct Component {
  int rbf_col;
  int n_eq;
  int eq[kMaxEq];
  int n_and;
  int and_cols[kMaxAnd];
  int cat_col;
  int cat_num;
};

// Reads one table row into `comp`; false when the row does not fit q
// covariate columns or the table's limits.
inline bool read_component(const int* row, int q, Component* comp) {
  comp->rbf_col = row[0];
  comp->n_eq = row[1];
  for (int e = 0; e < kMaxEq; ++e) comp->eq[e] = row[2 + e];
  comp->n_and = row[2 + kMaxEq];
  for (int e = 0; e < kMaxAnd; ++e) comp->and_cols[e] = row[3 + kMaxEq + e];
  comp->cat_col = row[3 + kMaxEq + kMaxAnd];
  comp->cat_num = row[4 + kMaxEq + kMaxAnd];
  if (comp->rbf_col >= q || comp->n_eq < 0 || comp->n_eq > kMaxEq ||
      comp->n_and < 0 || comp->n_and > kMaxAnd || comp->cat_col >= q ||
      (comp->cat_col >= 0 && comp->cat_num < 2)) {
    return false;
  }
  for (int e = 0; e < comp->n_eq; ++e) {
    if (comp->eq[e] < 0 || comp->eq[e] >= q) return false;
  }
  for (int e = 0; e < comp->n_and; ++e) {
    if (comp->and_cols[e] < 0 || comp->and_cols[e] >= q) return false;
  }
  return true;
}

// The discrete part of a component at rows x1, x2, times mm (the mask
// product, or 1): the product of its equality, both-one and centred
// categorical factors.
__device__ __forceinline__ float component_disc(const Component& comp,
                                                const float* x1, int s1,
                                                const float* x2, int s2,
                                                float mm) {
  float d = mm;
  for (int e = 0; e < comp.n_eq; ++e) {
    const int col = comp.eq[e];
    d *= (x1[col * s1] == x2[col * s2]) ? 1.0f : 0.0f;
  }
  for (int e = 0; e < comp.n_and; ++e) {
    const int col = comp.and_cols[e];
    d *= ((x1[col * s1] + x2[col * s2]) == 2.0f) ? 1.0f : 0.0f;
  }
  if (comp.cat_col >= 0) {
    const int col = comp.cat_col;
    d *= (x1[col * s1] == x2[col * s2])
             ? 1.0f
             : -1.0f / static_cast<float>(comp.cat_num - 1);
  }
  return d;
}

// The squared distance of the RBF column (call only when rbf_col >= 0).
__device__ __forceinline__ float component_sqdist(const Component& comp,
                                                  const float* x1, int s1,
                                                  const float* x2, int s2) {
  const float diff = x1[comp.rbf_col * s1] - x2[comp.rbf_col * s2];
  return diff * diff;
}

// The scaled term from the data-only parts: sc * exp(-sqd g) * d with an RBF
// factor, sc * d without.
__device__ __forceinline__ float component_value(bool rbf, float d, float sqd,
                                                 float sc, float g) {
  return rbf ? sc * expf(-sqd * g) * d : sc * d;
}

// One component's term at rows x1, x2: mm is the mask product, sc the
// scale, g = 1 / (2 lengthscale^2).
__device__ __forceinline__ float component_term(const Component& comp,
                                                const float* x1, int s1,
                                                const float* x2, int s2,
                                                float mm, float sc, float g) {
  const bool rbf = comp.rbf_col >= 0;
  const float d = component_disc(comp, x1, s1, x2, s2, mm);
  const float sqd = rbf ? component_sqdist(comp, x1, s1, x2, s2) : 0.0f;
  return component_value(rbf, d, sqd, sc, g);
}

}  // namespace lvae
