// The densities the slice-sampler kernels evaluate on the device.
//
// A path describes itself to the kernels as a Density kind plus a few
// float32 parameters and, for a BayesianModel, its data arrays and its prior
// table (pigeons_tpu_torch/paths.py: DeviceDensity). Each function here
// repeats, operation for operation, the batched torch density of
// pigeons_tpu_torch/paths.py, pigeons_tpu_torch/models/library.py,
// models/bayesian.py and models/distributions.py, which in turn follow XLA's
// CPU evaluation of the JAX densities (pigeons_tpu/paths.py,
// pigeons_tpu/models/library.py, models/bayesian.py, models/distributions.py,
// pigeons_tpu/models/target.py:142-143): sums run in the order in which that
// backend adds them, and __fmaf_rn stands exactly where it contracts a
// multiply into an add.

#pragma once

#include "common.cuh"

namespace pigeons {

// kToyMvn: a(beta) * sum(x^2), a = -precision(beta) / 2, params (precision0,
// precision1). The others interpolate (1 - beta) ref + beta target. For
// kFunnel, kBanana and kMvn the reference is N(0, sigma^2 I), params[0] =
// 1 / sigma, and the target has params: kFunnel params[1] = 1 / scale; kBanana
// params[1..4] = 1 / s_a, -log s_a, 1 / (scale s_b), -log(scale s_b); kMvn
// params[1] = -precision / 2.
//
// The last three are BayesianModel paths (models/bayesian.py): the reference
// is the model's prior, read from a PriorTable, and the target is prior +
// likelihood, the likelihood a function of the constrained values and of the
// model's data in DensityArrays (models/library.py):
// kHierarchicalNormal  state (theta_trans[G], mu, log tau, log sigma), data
//                      [G, n] in arrays[0], params[1] = n;
// kEightSchools        state (theta_trans[J], mu, log tau), arrays y[J],
//                      sigma[J], log(sigma)[J];
// kUnid                state logit(p1), logit(p2); params[1..3] = the binomial's
//                      log coefficient, successes, trials - successes;
// kLogisticRegression  state (w[d - 1], b), arrays X [n, d - 1] row-major and
//                      y [n], params[1] = n;
// kBernoulli           state logit(theta), array y [n] (0 / 1), params[1] = n;
// kEightSchoolsCentered state (theta[J], mu, log tau), arrays y[J], sigma[J],
//                      log(sigma)[J], params[1..2] = 1 / 20, -log 20 (the
//                      pseudo-prior's): the three sums of library.py:
//                      CenteredEightSchoolsLikelihood, 3 J terms;
// kMrna                state the logits of lt0, lkm0, lbeta, ldelta, lsigma
//                      (their Uniform blocks of the prior table map them),
//                      arrays ts [n], ys [n], params[1] = n.
// A BayesianModel kind takes params[0] = 0 under its own prior; params[0] =
// 1 / sigma makes the reference N(0, sigma^2 I), blended as kMvn's is.
//
// kUser is a density the user supplies as CUDA source (user_density.cuh):
// it is compiled into a library of its own, never into the library's, and
// its params[1..7] are the user's.
enum Density {
  kToyMvn = 0, kFunnel = 1, kBanana = 2, kMvn = 3,
  kHierarchicalNormal = 4, kEightSchools = 5, kUnid = 6, kLogisticRegression = 7,
  kBernoulli = 8, kEightSchoolsCentered = 9, kMrna = 10, kUser = 11
};

template <Density K>
constexpr bool is_bayesian = K == kHierarchicalNormal || K == kEightSchools || K == kUnid ||
                             K == kLogisticRegression || K == kBernoulli ||
                             K == kEightSchoolsCentered || K == kMrna;

constexpr int kMaxDensityParams = 8;
struct DensityParams {
  float v[kMaxDensityParams];
};

// The float32 arrays a density reads besides the state: device pointers with
// their lengths; the kernel reads them where they lie.
constexpr int kMaxDensityArrays = 4;
struct DensityArrays {
  const float* ptr[kMaxDensityArrays];
  int n[kMaxDensityArrays];
};

// A BayesianModel's prior as data: one block per prior, coordinates offset ..
// offset + size of the unconstrained state, a distribution and the bijector
// to its support. p: kNormal (loc, 1 / scale, -log scale); kHalfCauchy
// (1 / scale, log 2 - log(pi scale)); kUniform (lo, hi - lo, the block's
// constant log density, log(hi - lo)); kBeta (a - 1, b - 1, -log B(a, b) as
// XLA folds it), on (0, 1). A row of the launcher's table is (offset, size,
// dist, bijector, p[0..3]) as eight floats. kCauchy (loc, 1 / scale,
// -log(pi scale)) on the real line; kExponential (-rate, log rate) and
// kLogNormal (loc, 1 / scale, -log scale) on exp(u).
enum PriorKind {
  kNormal = 0, kHalfCauchy = 1, kUniform = 2, kBeta = 3, kCauchy = 4, kExponential = 5,
  kLogNormal = 6
};
enum BijectorKind { kIdentity = 0, kPositive = 1, kInterval = 2 };
constexpr int kMaxPriorBlocks = 8;
struct PriorBlock {
  int offset, size, dist, bijector;
  float p[4];
};
struct PriorTable {
  int n;
  PriorBlock block[kMaxPriorBlocks];
};

// A mean-field Gaussian variational reference (variational/gaussian.py) for
// the lanes that follow it: half_log_norm[i] = -0.5 log((2 pi std_i) std_i),
// computed once per block. use is the lane's own: isvar > 0 and active > 0.
struct VariationalLane {
  bool use;
  const float *mean, *std, *half_log_norm;
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

// term(first) + term(first + 1) + ... in order; 0 without terms.
template <class Term>
__device__ __forceinline__ float sum_in_order(const Term& term, int first, int end) {
  float acc = 0.0f;
  for (int i = first; i < end; ++i) {
    const float t = term(i);
    acc = i == first ? t : acc + t;
  }
  return acc;
}

// How many partial sums XLA's CPU code keeps for the sum of a [n_rows,
// n_per_row] array (library.py: row_partials): 4 or 8 for exactly that many
// rows, none below 16 rows, from 16 on 8 or 4, whichever leaves fewer than 4
// rows over.
__device__ __host__ inline int row_partials(int n_rows) {
  if (n_rows == 4 || n_rows == 8) return n_rows;
  if (n_rows < 16) return 1;
  return n_rows % 8 < 4 ? 8 : 4;
}

// The sum of n_rows * n_per_row terms in the order of library.py:
// sum_by_rows: P = row_partials(n_rows) partial sums, row r in partial
// r mod P, each adding its rows' terms in order, combined by halving
// ((s0 + s2) + (s1 + s3) for P = 4); then the rows past the last full P, in
// order. P = 1: every term in order.
template <class Term>
__device__ inline float sum_by_rows(const Term& term, int n_rows, int n_per_row) {
  const int P = row_partials(n_rows);
  if (P == 1) return sum_in_order(term, 0, n_rows * n_per_row);
  const int n_main = n_rows / P * P;
  float s[8];
  for (int l = 0; l < P; ++l) {
    float acc = 0.0f;
    for (int r = l; r < n_main; r += P)
      for (int j = 0; j < n_per_row; ++j) {
        const float t = term(r * n_per_row + j);
        acc = (r == l && j == 0) ? t : acc + t;
      }
    s[l] = acc;
  }
  for (int h = P / 2; h >= 1; h /= 2)
    for (int l = 0; l < h; ++l) s[l] = s[l] + s[l + h];
  float acc = s[0];
  for (int i = n_main * n_per_row; i < n_rows * n_per_row; ++i) acc = acc + term(i);
  return acc;
}

// The sum of n terms in the order of library.py: sum_by_windows (XLA's CPU
// code for a long row): the row padded with zeros to a multiple of `window`,
// half of the padding in front; each window added up in order from 0, then
// the windows' sums in order from 0. Adding a padding zero changes nothing,
// so the padding is skipped.
template <class Term>
__device__ inline float sum_by_windows(const Term& term, int n, int window) {
  const int lead = ((window - n % window) % window) / 2;
  float total = 0.0f;
  for (int start = -lead; start < n; start += window) {
    float acc = 0.0f;
    const int end = start + window < n ? start + window : n;
    for (int i = start < 0 ? 0 : start; i < end; ++i) acc = acc + term(i);
    total = total + acc;
  }
  return total;
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

constexpr uint32_t kLog2Pi = 0x3FEB3F8Eu;  // log(2 pi)

// -0.5 (log 2 pi + z^2) - log(scale) with z = (y - loc) / scale
// (models/distributions.py: normal_logpdf, one term).
__device__ __forceinline__ float normal_term(float y, float loc, float inv_scale, float neg_log_scale) {
  const float z = (y - loc) * inv_scale;
  return __fmaf_rn(-__fmaf_rn(z, z, f32(kLog2Pi)), 0.5f, neg_log_scale);
}

// The same for a scale that is no constant, of a residual res = y - loc: a
// true division (models/library.py: _observation_terms, MrnaLikelihood.terms).
__device__ __forceinline__ float residual_term(float res, float scale, float neg_log_scale) {
  const float z = res / scale;
  return __fmaf_rn(__fmaf_rn(z, z, f32(kLog2Pi)), -0.5f, neg_log_scale);
}

__device__ __forceinline__ float observation_term(float y, float loc, float scale, float neg_log_scale) {
  return residual_term(y - loc, scale, neg_log_scale);
}

// log |dx/du| summed over a block's coordinates (models/distributions.py:
// Positive.forward, Interval.forward).
template <class View>
__device__ inline float block_log_jacobian(const View& s, const PriorBlock& b) {
  return sum_in_order(
      [&](int i) {
        const float u = s(b.offset + i);
        if (b.bijector == kPositive) return u;
        return (b.p[3] + -softplus(-u)) + -softplus(u);
      },
      0, b.size);
}

// A block's log density of its constrained values (models/distributions.py:
// Normal.log_prob, HalfCauchy.log_prob, Beta.log_prob, Cauchy.log_prob,
// Exponential.log_prob, LogNormal.log_prob), the bijector applied here.
template <class View>
__device__ inline float block_log_prob(const View& s, const PriorBlock& b) {
  if (b.dist == kCauchy) {
    return sum_in_order(
        [&](int i) {
          const float z = (s(b.offset + i) - b.p[0]) * b.p[1];
          return b.p[2] - cephes_log1pf(z * z);
        },
        0, b.size);
  }
  if (b.dist == kExponential) {
    return sum_in_order(
        [&](int i) { return __fmaf_rn(cephes_expf(s(b.offset + i)), b.p[0], b.p[1]); }, 0,
        b.size);
  }
  if (b.dist == kLogNormal) {  // log(exp(u)) as the torch form takes it: not folded
    return sum_in_order(
        [&](int i) {
          const float lx = cephes_logf(cephes_expf(s(b.offset + i)));
          const float z = (lx - b.p[0]) * b.p[1];
          return __fmaf_rn(__fmaf_rn(z, z, f32(kLog2Pi)), -0.5f, b.p[2]) - lx;
        },
        0, b.size);
  }
  if (b.dist == kBeta) {  // x = sigmoid(u), the unit interval's
    return sum_in_order(
        [&](int i) {
          const float x = sigmoid(s(b.offset + i));
          return __fmaf_rn(cephes_logf(x), b.p[0], b.p[1] * cephes_log1pf(-x)) + b.p[2];
        },
        0, b.size);
  }
  if (b.dist == kNormal) {
    const auto t = [&](int i) {
      const float z = (s(b.offset + i) - b.p[0]) * b.p[1];
      return __fmaf_rn(z, z, f32(kLog2Pi));
    };
    if (b.p[2] == 0.0f) {  // the halving is the multiply that feeds the sum
      float acc = t(0) * -0.5f;
      for (int i = 1; i < b.size; ++i) acc = __fmaf_rn(t(i), -0.5f, acc);
      return acc;
    }
    return sum_in_order([&](int i) { return __fmaf_rn(t(i), -0.5f, b.p[2]); }, 0, b.size);
  }
  // kHalfCauchy on exp(u)
  return sum_in_order(
      [&](int i) {
        const float z = cephes_expf(s(b.offset + i)) * b.p[0];
        return b.p[1] - cephes_log1pf(z * z);
      },
      0, b.size);
}

// The constant log densities of the kUniform blocks, added in block order:
// XLA folds them into one (models/bayesian.py: _prior_of). *any: whether
// there is one that is not 0.
__device__ inline float prior_constant(const PriorTable& table, bool* any) {
  float c = 0.0f;
  *any = false;
  for (int k = 0; k < table.n; ++k) {
    const PriorBlock& b = table.block[k];
    if (b.dist != kUniform || b.p[2] == 0.0f) continue;
    c = *any ? c + b.p[2] : b.p[2];
    *any = true;
  }
  return c;
}

// models/bayesian.py: log_prior. The log-Jacobian first, one summand per
// block that has one, then one summand per block whose log density is not a
// constant, then the blocks' constants as one summand (prior_constant).
template <class View>
__device__ inline float log_prior(const View& s, const PriorTable& table) {
  float lp = 0.0f;
  bool first = true;
  for (int k = 0; k < table.n; ++k) {
    const PriorBlock& b = table.block[k];
    if (b.bijector == kIdentity) continue;
    const float lj = block_log_jacobian(s, b);
    lp = first ? lj : lp + lj;
    first = false;
  }
  for (int k = 0; k < table.n; ++k) {
    const PriorBlock& b = table.block[k];
    if (b.dist != kUniform) lp = lp + block_log_prob(s, b);
  }
  bool any;
  const float c = prior_constant(table, &any);
  return any ? lp + c : lp;
}

// What log_prior adds for block b of the state: its log-Jacobian (lj) and its
// log density (lp), each 0 where log_prior adds none of it.
struct BlockTerms {
  float lj, lp;
};

template <class View>
__device__ inline BlockTerms block_terms(const View& s, const PriorBlock& b) {
  return {b.bijector == kIdentity ? 0.0f : block_log_jacobian(s, b),
          b.dist == kUniform ? 0.0f : block_log_prob(s, b)};
}

// The block that holds coordinate c.
__device__ inline int block_of(const PriorTable& table, int c) {
  int k = 0;
  while (k + 1 < table.n && table.block[k + 1].offset <= c) ++k;
  return k;
}

// log_prior from each block's terms, lj[k] and lp[k], but block kq's (if any)
// from q: the same additions in the same order.
__device__ inline float combine_prior(const PriorTable& table, const float* lj, const float* lp,
                                      int kq, BlockTerms q) {
  float acc = 0.0f;
  bool first = true;
  for (int k = 0; k < table.n; ++k) {
    if (table.block[k].bijector == kIdentity) continue;
    const float v = k == kq ? q.lj : lj[k];
    acc = first ? v : acc + v;
    first = false;
  }
  for (int k = 0; k < table.n; ++k) {
    if (table.block[k].dist != kUniform) acc = acc + (k == kq ? q.lp : lp[k]);
  }
  bool any;
  const float c = prior_constant(table, &any);
  return any ? acc + c : acc;
}

// The constrained values of a state, block by block (models/bayesian.py:
// BayesianModel.constrain): u itself, exp(u), or on an interval lo + (hi -
// lo) sigmoid(u) (a Uniform block's p[0], p[1]; a Beta block's (0, 1), where
// the torch form keeps sigmoid(u), which the fused map with 1 and 0 is).
template <class View>
__device__ inline void constrain(const View& s, const PriorTable& table, float* theta) {
  for (int k = 0; k < table.n; ++k) {
    const PriorBlock& b = table.block[k];
    for (int i = b.offset; i < b.offset + b.size; ++i) {
      const float u = s(i);
      theta[i] = b.bijector == kIdentity ? u
                 : b.bijector == kPositive ? cephes_expf(u)
                 : b.dist == kUniform ? __fmaf_rn(sigmoid(u), b.p[1], b.p[0])
                                      : sigmoid(u);
    }
  }
}

// The normal reference N(0, sigma^2 I), inv_sigma = 1 / sigma: -0.5 times the
// sum of squares of x / sigma (models/target.py: StandardNormalReference).
template <class View>
__device__ __forceinline__ float normal_reference(const View& s, int d, float inv_sigma) {
  return sum_squares([&](int i) { return s(i) * inv_sigma; }, d) * -0.5f;
}

// The variational reference's term of coordinate i at value u, and its log
// density, coordinates added in order (variational/gaussian.py:
// GaussianReference.log_density).
__device__ __forceinline__ float variational_term(const VariationalLane& v, int i, float u) {
  const float q = (u - v.mean[i]) / v.std[i];
  return v.half_log_norm[i] - (q * q) * 0.5f;
}

template <class View>
__device__ inline float variational_log_density(const View& s, int d, const VariationalLane& v) {
  return sum_in_order([&](int i) { return variational_term(v, i, s(i)); }, 0, d);
}

// A density is evaluated in three steps, so that the threads of a group can
// share out the middle one (sweep_slice.cu) while every operation and its
// order stay those of the batched torch density:
//   prepare      what all terms need of the state. It depends on a few
//                coordinates only (prepare_reads): coordinate 0 for the funnel
//                (u = y / scale, sd = exp(u), y's own term) and the banana
//                (x^2, x's own term); the scalars mu, tau, sigma of the
//                hierarchical models; both coordinates of kUnid (p = p1 p2);
//                nothing for kLogisticRegression, whose every term reads
//                every coordinate;
//   target_term  term t of the target, first_term <= t < end_term: the
//                normal term of coordinate t (funnel, banana), the m_t of the
//                sum of squares (kMvn, kToyMvn), the likelihood's term of
//                observation t (Bayesian models);
//   finish       the reference's density, the in-order sums over the terms,
//                the interpolation and the NaN guard.
struct Prepared {
  float a;  // funnel: u; banana: x^2; hierarchical: mu; unid: p; kBernoulli: log theta;
            // kMrna: t0
  float b;  // funnel: exp(u); hierarchical: tau; kBernoulli: log1p(-theta); kMrna: km0
  float c;  // funnel, banana: coordinate 0's own term; kHierarchicalNormal, kMrna: sigma
  float e;  // kHierarchicalNormal, kMrna: -log sigma; kEightSchoolsCentered: -log tau
  float f, g, h;  // kMrna: -beta, -delta, delta - beta (1 where near)
  bool near;      // kMrna: |delta - beta| < 1e-7
};

template <Density K>
constexpr int first_term = (K == kFunnel || K == kBanana) ? 1 : 0;

// One past the last term's index, from the state's width.
template <Density K>
__device__ __host__ inline int end_term(int d, const DensityParams& p) {
  if constexpr (K == kHierarchicalNormal) return (d - 3) * (int)p.v[1];
  if constexpr (K == kEightSchools) return d - 2;
  if constexpr (K == kEightSchoolsCentered) return 3 * (d - 2);
  if constexpr (K == kUnid) return 1;
  if constexpr (K == kLogisticRegression || K == kBernoulli || K == kMrna) return (int)p.v[1];
  return d;
}

// Whether prepare reads coordinate c.
template <Density K>
__device__ __forceinline__ bool prepare_reads(int c, int d) {
  if constexpr (K == kFunnel || K == kBanana) return c == 0;
  if constexpr (K == kHierarchicalNormal) return c >= d - 3;
  if constexpr (K == kEightSchools || K == kEightSchoolsCentered) return c >= d - 2;
  return K == kUnid || K == kBernoulli || K == kMrna;
}

// kMrna: parameter k of the five from its coordinate u and its Uniform block,
// lo + (hi - lo) sigmoid(u), then 10^q; the near test whenever beta or delta
// is new (each of beta, delta is the exact negation of what r keeps).
__device__ inline void mrna_parameter(Prepared& r, int k, float u, const PriorBlock& b) {
  const float q = __fmaf_rn(sigmoid(u), b.p[1], b.p[0]);
  const float v = glibc_pow10f(q);
  if (k == 0) {
    r.a = v;
  } else if (k == 1) {
    r.b = v;
  } else if (k == 4) {
    r.c = v;
    r.e = -(q == 0.0f ? 0.0f : f32(0x40135D8Eu) * q);  // log(10^q) = q log(10)
  } else {
    if (k == 2) r.f = -v;
    else r.g = -v;
    const float dmb = -r.g - -r.f;
    r.near = fabsf(dmb) < 1e-7f;
    r.h = r.near ? 1.0f : dmb;
  }
}

template <Density K>
__device__ inline Prepared prepare(const LaneView& s, int d, const DensityParams& p,
                                   const PriorTable& prior) {
  Prepared r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, false};
  if constexpr (K == kFunnel) {
    const float x0 = s(0);
    const float m = x0 * f32(0x3EAAAAABu);                          // y / 3
    r.c = __fmaf_rn(-(m * m), 0.5f, f32(0xC0011F8Eu));              // -log 3 - log(2 pi) / 2
    r.a = x0 * p.v[1];                                              // log of the x's deviation
    r.b = cephes_expf(r.a);
  } else if constexpr (K == kBanana) {
    const float x0 = s(0);
    r.c = normal_term(x0, 0.0f, p.v[1], p.v[2]);
    r.a = x0 * x0;
  } else if constexpr (K == kHierarchicalNormal) {
    r.a = s(d - 3);
    r.b = cephes_expf(s(d - 2));
    r.c = cephes_expf(s(d - 1));
    r.e = -s(d - 1);  // log(exp(u)) is u
  } else if constexpr (K == kEightSchools) {
    r.a = s(d - 2);
    r.b = cephes_expf(s(d - 1));
  } else if constexpr (K == kUnid) {
    r.a = sigmoid(s(0)) * sigmoid(s(1));
  } else if constexpr (K == kBernoulli) {
    const float theta = sigmoid(s(0));
    r.a = cephes_logf(theta);
    r.b = cephes_log1pf(-theta);
  } else if constexpr (K == kEightSchoolsCentered) {
    r.a = s(d - 2);
    r.b = cephes_expf(s(d - 1));
    r.e = -s(d - 1);  // log(exp(u)) is u
  } else if constexpr (K == kMrna) {
    for (int k = 0; k < 5; ++k) mrna_parameter(r, k, s(k), prior.block[k]);
  }
  return r;
}

// prepare for the state of s (coordinate s.c holding s.q) from `cur`, the
// current state's: kMrna recomputes the queried coordinate's parameter only
// (one 10^q, not five), every other kind all of prepare.
template <Density K>
__device__ inline Prepared prepare_query(const Prepared& cur, const LaneView& s, int d,
                                         const DensityParams& p, const PriorTable& prior) {
  if constexpr (K == kMrna) {
    Prepared r = cur;
    mrna_parameter(r, s.c, s.q, prior.block[s.c]);
    return r;
  } else {
    return prepare<K>(s, d, p, prior);
  }
}

// kMrna: get_mu's level over km0 at t - t0 = tmt0 (library.py: _mrna_shape):
// tmt0 where delta is near beta, else exp(a) - exp(b) over delta - beta with
// a = -beta tmt0, b = -delta tmt0, as -exp(a) expm1(b - a) for a > b and
// exp(b) expm1(a - b) else. Written as one exp and one expm1 of the larger
// and the smaller of a and b, so that the threads of a warp whose terms lie
// on either side of t0 take one path.
__device__ __forceinline__ float mrna_shape(float tmt0, const Prepared& pr) {
  const float a = pr.f * tmt0, b = pr.g * tmt0;
  const bool a_hi = a > b;
  const float hi = a_hi ? a : b, lo = a_hi ? b : a;
  const float e = cephes_expf(hi);
  const float diff = (a_hi ? -e : e) * xla_expm1f(lo - hi);
  return pr.near ? tmt0 : diff / pr.h;
}

// The residual y - km0 * shape of observation t (the level is 0 before t0),
// as XLA's vectorised loop forms it, in the runtime's pass and inside the
// JAX slice kernel alike: the first n - n mod 8 observations (the loop's
// body, t < n_body) contract it into one fused multiply-add, the rest round
// the product first.
__device__ __forceinline__ float mrna_residual(int t, int n_body, float y, float tmt0, float km0,
                                               float shape) {
  const float res = t < n_body ? __fmaf_rn(-km0, shape, y) : y - km0 * shape;
  return tmt0 <= 0.0f ? y : res;
}

// The body of XLA's loop over mRNA's n observations: whole vectors of 8.
__device__ __host__ __forceinline__ int mrna_body(int n) { return n - n % 8; }

// kHierarchicalNormal's term of observation t, in group (row) r.
__device__ __forceinline__ float group_term(const LaneView& s, int r, int t, const Prepared& pr,
                                            const DensityArrays& arr) {
  const float theta = __fmaf_rn(s(r), pr.b, pr.a);
  return observation_term(arr.ptr[0][t], theta, pr.c, pr.e);
}

template <Density K>
__device__ __forceinline__ float target_term(const LaneView& s, int t, const Prepared& pr,
                                             const DensityParams& p, const DensityArrays& arr) {
  if constexpr (K == kFunnel) {
    const float q = s(t) / pr.b;
    return __fmaf_rn(q * q, -0.5f, -pr.a) + f32(0xBF6B3F8Eu);  // -log(2 pi) / 2
  } else if constexpr (K == kBanana) {
    return normal_term(s(t), pr.a, p.v[3], p.v[4]);
  } else if constexpr (K == kHierarchicalNormal) {
    return group_term(s, t / (int)p.v[1], t, pr, arr);
  } else if constexpr (K == kEightSchools) {
    const float theta = __fmaf_rn(s(t), pr.b, pr.a);
    return observation_term(arr.ptr[0][t], theta, arr.ptr[1][t], -arr.ptr[2][t]);
  } else if constexpr (K == kUnid) {
    const float acc = __fmaf_rn(cephes_logf(pr.a), p.v[2], p.v[1]);
    return __fmaf_rn(cephes_log1pf(-pr.a), p.v[3], acc);
  } else if constexpr (K == kBernoulli) {
    return arr.ptr[0][t] > 0.0f ? pr.a : pr.b;
  } else if constexpr (K == kEightSchoolsCentered) {
    // [A, B, C]: theta ~ N(mu, tau), y ~ N(theta, sigma), the pseudo-prior N(0, 20)
    const int J = arr.n[0];
    if (t < J) return observation_term(s(t), pr.a, pr.b, pr.e);
    if (t < 2 * J) return observation_term(arr.ptr[0][t - J], s(t - J), arr.ptr[1][t - J],
                                           -arr.ptr[2][t - J]);
    return normal_term(s(t - 2 * J), 0.0f, p.v[1], p.v[2]);
  } else if constexpr (K == kMrna) {
    // get_mu with its selects, then the normal term of observation t
    const float tmt0 = arr.ptr[0][t] - pr.a;
    const float res = mrna_residual(t, mrna_body(arr.n[0]), arr.ptr[1][t], tmt0, pr.b,
                                    mrna_shape(tmt0, pr));
    return residual_term(res, pr.c, pr.e);
  } else if constexpr (K == kLogisticRegression) {
    // row t of the design matrix times w, column by column, then + b
    const int n_w = arr.n[0] / arr.n[1];
    const float* row = arr.ptr[0] + t * n_w;
    float logit = row[0] * s(0);
    for (int k = 1; k < n_w; ++k) logit = __fmaf_rn(row[k], s(k), logit);
    logit = logit + s(n_w);
    return arr.ptr[1][t] * logit - softplus(logit);
  } else {
    return s(t) * 1.0f;
  }
}

// The path's log density at beta from the target's terms, NaN read as -inf
// (the runtime's guard for out-of-support queries). `s` is the state, for the
// reference's density; term(t) is target_term t. A lane under the variational
// reference (var.use) has that reference's density, var_ref(), for the path's
// own and the path's target at beta = 1 (paths.py: VariationalPath).
template <Density K, class Term, class VarRef>
__device__ inline float finish(const LaneView& s, const Term& term, int d, float beta,
                               const Prepared& pr, const DensityParams& p,
                               const PriorTable& prior, const VariationalLane& var,
                               const VarRef& var_ref) {
  float lref, ltgt;
  if constexpr (K == kToyMvn) {
    const float sq = sum_squares(term, d);
    if (!var.use) return nan_to_neg_inf(toy_coord_factor(beta, p.v[0], p.v[1]) * sq);
    ltgt = toy_coord_factor(1.0f, p.v[0], p.v[1]) * sq;
    lref = 0.0f;
  } else if constexpr (is_bayesian<K>) {
    const float lprior = log_prior(s, prior);
    // the model's own prior, or (params[0] = 1 / sigma) a normal reference
    lref = p.v[0] == 0.0f || var.use ? lprior : normal_reference(s, d, p.v[0]);
    float lik;
    if constexpr (K == kHierarchicalNormal) {
      lik = sum_by_rows(term, d - 3, (int)p.v[1]);
    } else if constexpr (K == kLogisticRegression || K == kMrna) {
      lik = sum_by_windows(term, end_term<K>(d, p), 32);
    } else if constexpr (K == kEightSchoolsCentered) {
      const int J = d - 2;
      lik = (sum_in_order(term, 0, J) + sum_in_order(term, J, 2 * J)) -
            sum_in_order(term, 2 * J, 3 * J);
    } else {
      lik = sum_in_order(term, 0, end_term<K>(d, p));
    }
    ltgt = lprior + lik;
  } else {
    lref = var.use ? 0.0f : normal_reference(s, d, p.v[0]);
    if constexpr (K == kFunnel || K == kBanana) {
      ltgt = pr.c + sum_in_order(term, 1, d);
    } else {
      static_assert(K == kMvn, "unknown density");
      ltgt = sum_squares(term, d) * p.v[1];
    }
  }
  if (var.use) {
    lref = var_ref();
    // the fixed path at beta = 1, 0 * ref + 1 * target
    if constexpr (K != kToyMvn) ltgt = 0.0f + ltgt;
  }
  return nan_to_neg_inf(interpolate(beta, lref, ltgt));
}

// The three steps by one thread: the form the torch twin follows.
template <Density K>
__device__ inline float log_density(const LaneView& s, int d, float beta, const Prepared& pr,
                                    const DensityParams& p, const DensityArrays& arr,
                                    const PriorTable& prior, const VariationalLane& var) {
  return finish<K>(s, [&](int t) { return target_term<K>(s, t, pr, p, arr); }, d, beta, pr, p,
                   prior, var, [&] { return variational_log_density(s, d, var); });
}

// Coordinate terms f(v) of the separable densities, NaN read as -inf.
//
// kToyQuadratic: (a v) v with the lane's factor a; the toy path's
// a = toy_coord_factor(beta).
//
// kVariationalQuadratic: the term of a variational leg over such a path
// (pigeons_tpu/pt.py:703-712; paths.py: VariationalPath.coord_log_density with
// a mean-field Gaussian reference). A lane with use_var set (isvar > 0 and the
// reference active) has gm(1 - beta, l_ref) + gm(beta, (a_target v) v), gm the
// guarded multiply of interpolate(), a_target the factor at beta = 1 and
//   l_ref = -0.5 log((2 pi std_c) std_c) - 0.5 ((v - mean_c) / std_c)^2
// for the coordinate's own mean_c and std_c; every other lane keeps (a v) v,
// so before activation and on the fixed leg the bits are kToyQuadratic's. As
// XLA's CPU backend evaluates it: a true division, the Cephes log, no fused
// multiply-add (both products by 0.5 are exact). log_norm, the first summand
// of l_ref, depends on the coordinate alone and is computed once for it.
//
// kUserCoord: a user's two coordinate terms, compiled from CUDA source into a
// library of its own (user_density.cuh: user_coord_term), blended at the
// lane's beta as interpolate() blends them.
enum CoordTerm { kToyQuadratic = 0, kVariationalQuadratic = 1, kUserCoord = 2 };

struct CoordParams {
  float a;                    // the lane's factor
  float beta, w0;             // the lane's beta and 1 - beta
  bool use_var;               // the lane follows the variational reference
  float a_target;             // the path's factor at beta = 1
  float mean, std, log_norm;  // the coordinate's
  int c;                      // the coordinate (kUserCoord)
};

__device__ __forceinline__ float quadratic_term(float a, float v) {
  return nan_to_neg_inf((a * v) * v);
}

__device__ __forceinline__ float gaussian_log_norm(float std) {
  return -0.5f * cephes_logf((f32(0x40C90FDBu) * std) * std);  // 2 pi
}

template <CoordTerm kTerm>
__device__ __forceinline__ float coord_term(const CoordParams& t, float v) {
  static_assert(kTerm == kToyQuadratic || kTerm == kVariationalQuadratic,
                "unknown coordinate term");
  if constexpr (kTerm == kVariationalQuadratic) {
    if (t.use_var) {
      const float q = (v - t.mean) / t.std;
      const float l_ref = t.log_norm - 0.5f * (q * q);
      const float l_tgt = (t.a_target * v) * v;
      const float from_ref = t.w0 == 0.0f ? 0.0f : t.w0 * l_ref;
      const float from_tgt = t.beta == 0.0f ? 0.0f : t.beta * l_tgt;
      return nan_to_neg_inf(from_ref + from_tgt);
    }
  }
  return quadratic_term(t.a, v);
}

}  // namespace pigeons
