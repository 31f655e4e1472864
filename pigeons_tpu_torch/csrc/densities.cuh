// The densities the slice-sampler kernels evaluate on the device.
//
// A path describes itself to the kernels as a Density kind plus a few
// float32 parameters (pigeons_tpu_torch/paths.py: DeviceDensity). Each
// function here repeats, operation for operation, the batched torch density
// of pigeons_tpu_torch/paths.py and pigeons_tpu_torch/models/library.py,
// which in turn follow XLA's CPU evaluation of the JAX densities
// (pigeons_tpu/paths.py, pigeons_tpu/models/library.py:51-56, 81-87,
// 377-378, pigeons_tpu/models/target.py:142-143): squares are summed in
// coordinate order with one fused multiply-add per term, and __fmaf_rn stands
// exactly where that backend contracts a multiply into an add.

#pragma once

#include "common.cuh"

namespace pigeons {

// kToyMvn: a(beta) * sum(x^2), a = -precision(beta) / 2, params (precision0,
// precision1). The others interpolate (1 - beta) ref + beta target between
// the reference N(0, sigma^2 I), params[0] = 1 / sigma, and the target:
// kFunnel params[1] = 1 / scale; kBanana params[1..4] = 1 / s_a, -log s_a,
// 1 / (scale s_b), -log(scale s_b); kMvn params[1] = -precision / 2.
enum Density { kToyMvn = 0, kFunnel = 1, kBanana = 2, kMvn = 3 };

constexpr int kMaxDensityParams = 8;
struct DensityParams {
  float v[kMaxDensityParams];
};

// A lane's state as a density reads it: coordinate i is x[i * stride], with
// coordinate c (if any) read as q, the slice machine's query.
struct LaneView {
  const float* x;
  int stride;
  int c;
  float q;
  __device__ __forceinline__ float operator()(int i) const { return i == c ? q : x[i * stride]; }
};

// sum_i (scale x_i)^2 in coordinate order.
__device__ inline float sum_squares(const LaneView& s, int d, float scale) {
  const float m0 = s(0) * scale;
  float acc = m0 * m0;
  for (int i = 1; i < d; ++i) {
    const float m = s(i) * scale;
    acc = __fmaf_rn(m, m, acc);
  }
  return acc;
}

// w * v with 0 * (-inf) = 0 at both ends of the path (paths.py: _guarded_mul).
__device__ __forceinline__ float interpolate(float beta, float lref, float ltgt) {
  const float w0 = 1.0f - beta;
  const float a = w0 == 0.0f ? 0.0f : w0 * lref;
  const float b = beta == 0.0f ? 0.0f : beta * ltgt;
  return a + b;
}

__device__ __forceinline__ float toy_coord_factor(float beta, float precision0, float precision1) {
  return __fmaf_rn(beta, precision1, (1.0f - beta) * precision0) * -0.5f;
}

// -0.5 (log 2 pi + z^2) - log(scale) with z = (y - loc) / scale
// (models/distributions.py: normal_logpdf, one term).
__device__ __forceinline__ float normal_term(float y, float loc, float inv_scale, float neg_log_scale) {
  const float z = (y - loc) * inv_scale;
  return __fmaf_rn(-__fmaf_rn(z, z, f32(0x3FEB3F8Eu)), 0.5f, neg_log_scale);  // log(2 pi)
}

__device__ inline float funnel_target(const LaneView& s, int d, float inv_scale) {
  const float y = s(0);
  const float m = y * f32(0x3EAAAAABu);                            // y / 3
  const float lp_y = __fmaf_rn(-(m * m), 0.5f, f32(0xC0011F8Eu));  // -log 3 - log(2 pi) / 2
  const float u = y * inv_scale;                                   // log of the x's deviation
  const float sd = cephes_expf(u);
  float lp_x = 0.0f;
  for (int i = 1; i < d; ++i) {
    const float q = s(i) / sd;
    const float t = __fmaf_rn(q * q, -0.5f, -u) + f32(0xBF6B3F8Eu);  // -log(2 pi) / 2
    lp_x = i == 1 ? t : lp_x + t;
  }
  return lp_y + lp_x;
}

__device__ inline float banana_target(const LaneView& s, int d, const DensityParams& p) {
  const float x = s(0);
  const float lp_x = normal_term(x, 0.0f, p.v[1], p.v[2]);
  const float xx = x * x;
  float lp_y = 0.0f;
  for (int i = 1; i < d; ++i) {
    const float t = normal_term(s(i), xx, p.v[3], p.v[4]);
    lp_y = i == 1 ? t : lp_y + t;
  }
  return lp_x + lp_y;
}

// The path's log density at beta, NaN read as -inf (the runtime's guard for
// out-of-support queries).
template <Density K>
__device__ inline float log_density(const LaneView& s, int d, float beta, const DensityParams& p) {
  float lp;
  if constexpr (K == kToyMvn) {
    lp = toy_coord_factor(beta, p.v[0], p.v[1]) * sum_squares(s, d, 1.0f);
  } else {
    const float lref = sum_squares(s, d, p.v[0]) * -0.5f;
    float ltgt;
    if constexpr (K == kFunnel) {
      ltgt = funnel_target(s, d, p.v[1]);
    } else if constexpr (K == kBanana) {
      ltgt = banana_target(s, d, p);
    } else {
      static_assert(K == kMvn, "unknown density");
      ltgt = sum_squares(s, d, 1.0f) * p.v[1];
    }
    lp = interpolate(beta, lref, ltgt);
  }
  return nan_to_neg_inf(lp);
}

// Coordinate terms f(v) of the separable densities, each with a per-lane
// factor a; NaN reads as -inf. The toy path's term is (a v) v with
// a = toy_coord_factor(beta). The variational leg's mean-field Gaussian term
// (ROADMAP queue 1, item 9a) is the next case.
enum CoordTerm { kToyQuadratic = 0 };

template <CoordTerm kTerm>
__device__ __forceinline__ float coord_term(float a, float v) {
  static_assert(kTerm == kToyQuadratic, "unknown coordinate term");
  return nan_to_neg_inf((a * v) * v);
}

}  // namespace pigeons
