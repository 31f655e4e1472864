// Densities a user supplies as CUDA source, for kernel K2 (sweep_slice.cu,
// density kind kUser) and kernel K1 (banded_slice.cu, coordinate term
// kUserCoord).
//
// A user's source (pigeons_tpu_torch/device_source.py: DeviceSource) is CUDA
// C++ text that defines, at global scope, the one hook of its kind:
//
//   target      __device__ float pigeons_user_target(
//                   const float* x, int d, const float* params,
//                   const pigeons::DensityArrays& arrays);
//               the target's log density of the state x[0 .. d - 1]. The path
//               is (1 - beta) ref + beta target with the reference N(0, sigma^2
//               I) that K2 evaluates itself (as it does kMvn's).
//   path        __device__ float pigeons_user_path(
//                   const float* x, int d, float beta, const float* params,
//                   const pigeons::DensityArrays& arrays);
//               a CustomPath's log density at beta, used as it is.
//   likelihood  __device__ float pigeons_user_log_likelihood(
//                   const float* theta, const float* u, int d, const float* params,
//                   const pigeons::DensityArrays& arrays);
//               a BayesianModel's log likelihood: theta the constrained values
//               (the bijectors of the prior table applied, in the order of the
//               model's priors), u the unconstrained state (where a positive
//               parameter's log is needed, u is it: the torch form reads it as
//               q["log_name"]). K2 adds the log prior from its table; the
//               reference is the prior, or N(0, sigma^2 I) (params[0] = 1 /
//               sigma, as for the library's kinds).
//   coord       __device__ float pigeons_user_ref_coord(
//                   float v, int c, const float* params,
//                   const pigeons::DensityArrays& arrays);
//               __device__ float pigeons_user_target_coord(...the same...);
//               the reference's and the target's term of coordinate c at v, for
//               K1: the lane's term is (1 - beta) ref + beta target with
//               0 * (-inf) read as 0 (paths.py: _guarded_mul).
//
// params are the source's float32 parameters (at most 7) and arrays its
// float32 device arrays (at most kMaxDensityArrays; arrays.ptr[i], arrays.n[i]
// their lengths), as the source's torch form receives them. Every result is
// read with NaN as -inf.
//
// What a source may call: everything in namespace pigeons (common.cuh,
// densities.cuh), in particular the Cephes cephes_logf, cephes_expf and
// cephes_log1pf, softplus and sigmoid that f32math.log / exp / log1p and
// distributions.softplus / sigmoid are; __fmaf_rn where the torch form calls
// f32math.fma; sum_in_order and sum_squares; IEEE +, -, *, / and sqrtf. The
// kernels are built with --fmad=false: nothing is fused that the source does
// not fuse itself, so a source that does the torch form's float32 operations
// in its order gives its bits. Other math functions of CUDA (logf, expf, ...)
// are not the torch form's and break that.
//
// The source is compiled into a library of its own (_build.py: build_user,
// -DPIGEONS_USER_SOURCE and -DPIGEONS_USER_HOOK), with K2's instances (one
// thread a lane, or groups of 8, 16, 32 that speculate the machine's queries,
// each thread with its own copy of the state) or K1's (the user's term), never
// with the library's kinds.

#pragma once

#include "densities.cuh"

// the hook the source defines: 0 target, 1 path, 2 likelihood, 3 coord
#ifndef PIGEONS_USER_HOOK
#define PIGEONS_USER_HOOK 0
#endif

__device__ float pigeons_user_target(const float* x, int d, const float* params,
                                     const pigeons::DensityArrays& arrays);
__device__ float pigeons_user_path(const float* x, int d, float beta, const float* params,
                                   const pigeons::DensityArrays& arrays);
__device__ float pigeons_user_log_likelihood(const float* theta, const float* u, int d,
                                             const float* params,
                                             const pigeons::DensityArrays& arrays);
__device__ float pigeons_user_ref_coord(float v, int c, const float* params,
                                        const pigeons::DensityArrays& arrays);
__device__ float pigeons_user_target_coord(float v, int c, const float* params,
                                           const pigeons::DensityArrays& arrays);

namespace pigeons {

enum UserHook { kUserTarget = 0, kUserPath = 1, kUserLikelihood = 2, kUserCoordTerms = 3 };
constexpr int kUserHook = PIGEONS_USER_HOOK;

// Floats of scratch a lane needs besides its state: the constrained values.
__device__ __host__ inline int user_scratch_floats(int d) {
  return kUserHook == kUserLikelihood ? d : 0;
}

// The path's log density of the lane's state x [d] (the query in place) at
// beta, as finish() blends the library's kinds; theta [d] is the lane's
// scratch. The user's parameters are params.v[1..7]. (A template, so that
// only the source's hook is compiled.)
template <int H = kUserHook>
__device__ inline float user_log_density(const float* x, float* theta, int d, float beta,
                                         const DensityParams& p, const DensityArrays& arr,
                                         const PriorTable& prior, const VariationalLane& var) {
  const LaneView s{x, 1, -1, 0.0f};
  const float* up = p.v + 1;
  float lref = 0.0f, ltgt;
  if constexpr (H == kUserPath) {
    if (!var.use) return nan_to_neg_inf(pigeons_user_path(x, d, beta, up, arr));
    ltgt = pigeons_user_path(x, d, 1.0f, up, arr);  // the fixed path at beta = 1
  } else if constexpr (H == kUserLikelihood) {
    const float lprior = log_prior(s, prior);
    constrain(s, prior, theta);
    ltgt = lprior + pigeons_user_log_likelihood(theta, x, d, up, arr);
    lref = p.v[0] == 0.0f || var.use ? lprior : normal_reference(s, d, p.v[0]);
    if (var.use) ltgt = 0.0f + ltgt;  // 0 * ref + 1 * target
  } else {
    static_assert(H == kUserTarget, "K2 takes the target, path and likelihood hooks");
    ltgt = pigeons_user_target(x, d, up, arr);
    if (!var.use) lref = normal_reference(s, d, p.v[0]);
    else ltgt = 0.0f + ltgt;
  }
  if (var.use) lref = variational_log_density(s, d, var);
  return nan_to_neg_inf(interpolate(beta, lref, ltgt));
}

// K1's kUserCoord term of coordinate t.c at v for the lane's beta.
__device__ __forceinline__ float user_coord_term(const CoordParams& t, const float* params,
                                                 const DensityArrays& arr, float v) {
  const float lref = pigeons_user_ref_coord(v, t.c, params, arr);
  const float ltgt = pigeons_user_target_coord(v, t.c, params, arr);
  return nan_to_neg_inf(interpolate(t.beta, lref, ltgt));
}

}  // namespace pigeons

// the source itself, at global scope (its hooks may call pigeons:: helpers)
#ifdef PIGEONS_USER_SOURCE
#include PIGEONS_USER_SOURCE
#endif
