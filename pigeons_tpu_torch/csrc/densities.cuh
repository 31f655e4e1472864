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

// sum_i m_i^2 in coordinate order, m_i = term(i): one fused multiply-add per
// term after the first.
template <class Term>
__device__ __forceinline__ float sum_squares(const Term& term, int d) {
  const float m0 = term(0);
  float acc = m0 * m0;
  for (int i = 1; i < d; ++i) {
    const float m = term(i);
    acc = __fmaf_rn(m, m, acc);
  }
  return acc;
}

// term(first) + term(first + 1) + ... in coordinate order; 0 without terms.
template <class Term>
__device__ __forceinline__ float sum_in_order(const Term& term, int first, int d) {
  float acc = 0.0f;
  for (int i = first; i < d; ++i) {
    const float t = term(i);
    acc = i == first ? t : acc + t;
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

// A density is evaluated in three steps, so that the threads of a group can
// share out the middle one (sweep_slice.cu) while every operation and its
// order stay those of the batched torch density:
//   prepare      what all terms need; it depends on coordinate 0 alone
//                (funnel: u = y / scale, sd = exp(u) and y's own term; banana:
//                x^2 and x's own term);
//   target_term  the target's term of one coordinate i >= first_term
//                (funnel, banana: x_i's normal term; kMvn, kToyMvn: the m_i of
//                the sum of squares);
//   finish       the reference's and the target's in-order sums over the
//                terms, the interpolation and the NaN guard.
struct Prepared {
  float shift;  // funnel: u; banana: x^2
  float sd;     // funnel: exp(u)
  float lp0;    // coordinate 0's own term
};

template <Density K>
constexpr int first_term = (K == kFunnel || K == kBanana) ? 1 : 0;

template <Density K>
__device__ inline Prepared prepare(float x0, const DensityParams& p) {
  Prepared r{0.0f, 0.0f, 0.0f};
  if constexpr (K == kFunnel) {
    const float m = x0 * f32(0x3EAAAAABu);                          // y / 3
    r.lp0 = __fmaf_rn(-(m * m), 0.5f, f32(0xC0011F8Eu));            // -log 3 - log(2 pi) / 2
    r.shift = x0 * p.v[1];                                          // log of the x's deviation
    r.sd = cephes_expf(r.shift);
  } else if constexpr (K == kBanana) {
    r.lp0 = normal_term(x0, 0.0f, p.v[1], p.v[2]);
    r.shift = x0 * x0;
  }
  return r;
}

template <Density K>
__device__ __forceinline__ float target_term(float v, const Prepared& pr, const DensityParams& p) {
  if constexpr (K == kFunnel) {
    const float q = v / pr.sd;
    return __fmaf_rn(q * q, -0.5f, -pr.shift) + f32(0xBF6B3F8Eu);  // -log(2 pi) / 2
  } else if constexpr (K == kBanana) {
    return normal_term(v, pr.shift, p.v[3], p.v[4]);
  } else {
    return v * 1.0f;
  }
}

// The path's log density at beta from the target's terms, NaN read as -inf
// (the runtime's guard for out-of-support queries). `s` is the state, for the
// reference's sum of squares; term(i) is target_term of coordinate i.
template <Density K, class Term>
__device__ inline float finish(const LaneView& s, const Term& term, int d, float beta,
                               const Prepared& pr, const DensityParams& p) {
  float lp;
  if constexpr (K == kToyMvn) {
    lp = toy_coord_factor(beta, p.v[0], p.v[1]) * sum_squares(term, d);
  } else {
    const float inv_sigma = p.v[0];
    const float lref = sum_squares([&](int i) { return s(i) * inv_sigma; }, d) * -0.5f;
    float ltgt;
    if constexpr (K == kFunnel || K == kBanana) {
      ltgt = pr.lp0 + sum_in_order(term, 1, d);
    } else {
      static_assert(K == kMvn, "unknown density");
      ltgt = sum_squares(term, d) * p.v[1];
    }
    lp = interpolate(beta, lref, ltgt);
  }
  return nan_to_neg_inf(lp);
}

// The three steps by one thread: the form the torch twin follows.
template <Density K>
__device__ inline float log_density(const LaneView& s, int d, float beta, const Prepared& pr,
                                    const DensityParams& p) {
  return finish<K>(s, [&](int i) { return target_term<K>(s(i), pr, p); }, d, beta, pr, p);
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
