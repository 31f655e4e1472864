"""Densities given as CUDA source beside their torch forms
(``device_source.DeviceSource``), one for each hook of the slice kernels:

* :func:`grouped_normal_model`: a ``BayesianModel`` whose likelihood is a
  source, ``y[i] ~ N(mu + tau theta_trans[group[i]], sigma)``, each term
  added in order; :func:`hierarchical_normal_source` is the library's
  ``hierarchical_normal()`` written so (its priors, its data), and
  :func:`model_u` a model over 4 groups with Cauchy, LogNormal and
  Exponential priors. Both run one library: the text is the same.
* :func:`funnel_source`: Neal's funnel as a ``"target"`` source under
  ``N(0, sigma^2 I)``.
* :func:`custom_path_source`: ``log prior + beta log likelihood`` as a
  ``"path"`` source of a ``CustomPath``.
* :func:`normal_product_source`: a product of normals with per-coordinate
  means and scales, and ``N(0, 3^2)`` per coordinate as the reference, as a
  ``"coord"`` source for kernel K1.

Each source does its torch form's float32 operations in their order (a
fused multiply-add where the torch form calls ``f32math.fma``, the Cephes
``exp``), so the kernels give the twins' bits. Constants that are not exact
in float32 are passed as params, rounded once, and both forms read them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import f32math, rng
from ..device_source import DeviceSource, SourceCoordTarget, SourceLikelihood, SourceTarget
from ..paths import sum_squares
from .bayesian import BayesianModel
from .distributions import (_LOG_2PI_F32, Cauchy, Exponential, HalfCauchy, LogNormal, Normal,
                            sum_in_order)
from .library import hierarchical_normal_data
from .target import CustomPath, CustomPathTarget

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass(frozen=True)
class NormalDraws:
    """``sigma * z`` for standard normals ``z [..., dim]`` of keys ``[..., 2]``:
    iid draws of ``N(0, sigma^2 I)`` (a picklable ``sample_reference``)."""

    dim: int
    sigma: float = 1.0

    def __call__(self, keys):
        return float(np.float32(self.sigma)) * rng.normal(keys, (self.dim,))


GROUPED_NORMAL_CUDA = r"""
using namespace pigeons;

// y[i] ~ N(mu + tau theta_trans[group[i]], sigma), the terms added in order.
// params: the offsets of mu, sigma, tau and theta_trans in the state;
// arrays: y [n], group [n] (group indices as floats).
__device__ float pigeons_user_log_likelihood(const float* theta, const float* u, int d,
                                             const float* params, const DensityArrays& arrays) {
  const int i_mu = (int)params[0], i_sigma = (int)params[1], i_tau = (int)params[2];
  const int i_theta = (int)params[3];
  const float mu = theta[i_mu], sigma = theta[i_sigma], tau = theta[i_tau];
  const float neg_log_sigma = -u[i_sigma];  // log(exp(u)) is u
  const float* y = arrays.ptr[0];
  const float* group = arrays.ptr[1];
  float acc = 0.0f;
  for (int i = 0; i < arrays.n[0]; ++i) {
    const float loc = __fmaf_rn(theta[i_theta + (int)group[i]], tau, mu);
    const float z = (y[i] - loc) / sigma;
    const float t = __fmaf_rn(__fmaf_rn(z, z, f32(kLog2Pi)), -0.5f, neg_log_sigma);
    acc = i == 0 ? t : acc + t;
  }
  return acc;
}
"""


def grouped_normal_terms(q, params, arrays):
    """The torch form of ``GROUPED_NORMAL_CUDA``, batched over ``q``'s
    leading dimensions."""
    del params
    y, group = arrays
    loc = f32math.fma(q["theta_trans"][..., group.long()], q["tau"][..., None], q["mu"][..., None])
    z = (y - loc) / q["sigma"][..., None]
    t = f32math.fma(f32math.fma(z, z, _LOG_2PI_F32), -0.5, -q["log_sigma"][..., None])
    return sum_in_order(t)


def grouped_normal_model(priors: dict, y, group) -> BayesianModel:
    """A ``BayesianModel`` with priors ``mu``, ``sigma`` (on the positive
    reals), ``tau`` and ``theta_trans`` in any order and the grouped normal
    likelihood of ``y [n]`` with ``group [n]`` as a source."""
    if set(priors) != {"mu", "sigma", "tau", "theta_trans"}:
        raise ValueError(f"the grouped normal likelihood reads mu, sigma, tau and theta_trans, "
                         f"not {sorted(priors)}")
    offsets, off = {}, 0
    for name, dist in priors.items():
        offsets[name] = off
        off += dist.size
    source = DeviceSource(
        GROUPED_NORMAL_CUDA, "likelihood", grouped_normal_terms,
        params=tuple(float(offsets[k]) for k in ("mu", "sigma", "tau", "theta_trans")),
        arrays=(torch.as_tensor(y, dtype=torch.float32).reshape(-1),
                torch.as_tensor(group, dtype=torch.float32).reshape(-1)))
    return BayesianModel(priors, SourceLikelihood(source))


def hierarchical_normal_source(n_groups: int = 20, n_per_group: int = 10, seed: int = 0,
                               data=None) -> BayesianModel:
    """``hierarchical_normal()`` (its priors and data) with its likelihood as
    a source: the same law, its 200 terms added in order where the library's
    kernel adds them by rows."""
    if data is None:
        data = hierarchical_normal_data(n_groups, n_per_group, seed)
    data = torch.as_tensor(data, dtype=torch.float32)
    n_groups, n_per_group = data.shape
    group = torch.arange(n_groups * n_per_group) // n_per_group
    return grouped_normal_model(
        {"theta_trans": Normal(shape=(n_groups,)), "mu": Normal(scale=5.0),
         "tau": HalfCauchy(scale=2.5), "sigma": HalfCauchy(scale=2.5)},
        data.reshape(-1), group)


def model_u_data(seed: int = 0):
    """20 observations in 4 groups of 5: ``y`` from numpy seed ``seed``."""
    rs = np.random.RandomState(seed)
    group = np.arange(20) // 5
    y = (rs.normal(size=20) * 1.5 + np.array([-1.0, 0.0, 1.0, 2.5])[group]).astype(np.float32)
    return y, group


def model_u(seed: int = 0) -> BayesianModel:
    """Model U: ``y[20] ~ N(mu + tau theta_trans[g], sigma)`` over 4 groups,
    ``mu ~ Cauchy(0, 5)``, ``sigma ~ LogNormal(0, 1)``, ``tau ~
    Exponential(1)``, ``theta_trans ~ Normal(shape=(4,))`` (d = 7)."""
    y, group = model_u_data(seed)
    return grouped_normal_model(
        {"mu": Cauchy(0.0, 5.0), "sigma": LogNormal(0.0, 1.0), "tau": Exponential(1.0),
         "theta_trans": Normal(shape=(4,))}, y, group)


FUNNEL_CUDA = r"""
using namespace pigeons;

// Neal's funnel: y = x[0] ~ N(0, 3), x[i] ~ N(0, exp(y / 2)). params: 1 / 3,
// -log 3 - log(2 pi) / 2, -log(2 pi) / 2.
__device__ float pigeons_user_target(const float* x, int d, const float* params,
                                     const DensityArrays& arrays) {
  const float y = x[0];
  const float m = y * params[0];
  const float head = (m * m) * -0.5f + params[1];
  const float sd = cephes_expf(y * 0.5f);
  float acc = 0.0f;
  for (int i = 1; i < d; ++i) {
    const float q = x[i] / sd;
    const float t = ((q * q) * -0.5f - y * 0.5f) + params[2];
    acc = i == 1 ? t : acc + t;
  }
  return head + acc;
}
"""


def funnel_terms(x, params, arrays):
    """The torch form of ``FUNNEL_CUDA``."""
    del arrays
    y = x[..., 0]
    m = y * params[0]
    head = (m * m) * -0.5 + params[1]
    q = x[..., 1:] / f32math.exp(y * 0.5)[..., None]
    return head + sum_in_order(((q * q) * -0.5 - (y * 0.5)[..., None]) + params[2])


def funnel_source(dim: int = 10, sigma: float = 1.0) -> SourceTarget:
    """Neal's funnel in ``dim`` coordinates as a ``"target"`` source, from
    ``N(0, sigma^2 I)``."""
    consts = (1.0 / 3.0, -math.log(3.0) - HALF_LOG_2PI, -HALF_LOG_2PI)
    return SourceTarget(DeviceSource(FUNNEL_CUDA, "target", funnel_terms, params=consts), dim,
                        sigma)


CUSTOM_PATH_CUDA = r"""
using namespace pigeons;

// log prior + beta log likelihood: N(0, I) and N(m, s^2 I); params: 1 / s,
// arrays: m [d].
__device__ float pigeons_user_path(const float* x, int d, float beta, const float* params,
                                   const DensityArrays& arrays) {
  const float* m = arrays.ptr[0];
  const float lp = sum_squares([&](int i) { return x[i] * 1.0f; }, d) * -0.5f;
  const float ll = sum_squares([&](int i) { return (x[i] - m[i]) * params[0]; }, d) * -0.5f;
  return lp + beta * ll;
}
"""


def custom_path_terms(x, beta, params, arrays):
    """The torch form of ``CUSTOM_PATH_CUDA``; ``beta`` broadcasts against
    ``x[..., 0]``."""
    (m,) = arrays
    return sum_squares(x * 1.0) * -0.5 + beta * (sum_squares((x - m) * params[0]) * -0.5)


def custom_path_source(dim: int = 4, scale: float = 0.5, seed: int = 0) -> CustomPathTarget:
    """A ``CustomPath`` with a ``"path"`` source: from ``N(0, I)`` (beta = 0)
    to the posterior of a normal likelihood with means from numpy seed
    ``seed`` and scale ``scale`` (beta = 1)."""
    m = torch.from_numpy(np.random.RandomState(seed).normal(size=dim).astype(np.float32))
    source = DeviceSource(CUSTOM_PATH_CUDA, "path", custom_path_terms,
                          params=(float(np.float32(1.0) / np.float32(scale)),), arrays=(m,))
    return CustomPathTarget(CustomPath(source.path, NormalDraws(dim), source=source), dim)


NORMAL_PRODUCT_CUDA = r"""
using namespace pigeons;

// the reference's term, N(0, 3^2): params 1 / 3 and -log 3 - log(2 pi) / 2
__device__ float pigeons_user_ref_coord(float v, int c, const float* params,
                                        const DensityArrays& arrays) {
  const float q = v * params[0];
  return (q * q) * -0.5f + params[1];
}

// the target's, N(mu_c, scale_c^2): arrays mu [d], scale [d] and
// -log scale_c - log(2 pi) / 2 [d]
__device__ float pigeons_user_target_coord(float v, int c, const float* params,
                                           const DensityArrays& arrays) {
  const float q = (v - arrays.ptr[0][c]) / arrays.ptr[1][c];
  return (q * q) * -0.5f + arrays.ptr[2][c];
}
"""


def normal_product_ref(v, c, params, arrays):
    """The torch form of ``pigeons_user_ref_coord``."""
    del c, arrays
    q = v * params[0]
    return (q * q) * -0.5 + params[1]


def normal_product_target(v, c, params, arrays):
    """The torch form of ``pigeons_user_target_coord``; ``c`` broadcasts
    against ``v``."""
    del params
    mu, scale, log_norm = (a[c] for a in arrays)
    q = (v - mu) / scale
    return (q * q) * -0.5 + log_norm


REF_SCALE = 3.0


def normal_product_source(dim: int = 100) -> SourceCoordTarget:
    """The product of ``N(mu_c, scale_c^2)``, ``mu = linspace(-1, 1.5)``,
    ``scale = linspace(0.5, 2)``, from ``N(0, 3^2)`` per coordinate, as a
    ``"coord"`` source: both ends normalized, so log Z = 0."""
    mu = np.linspace(-1.0, 1.5, dim).astype(np.float32)
    scale = np.linspace(0.5, 2.0, dim).astype(np.float32)
    log_norm = (-np.log(scale.astype(np.float64)) - HALF_LOG_2PI).astype(np.float32)
    source = DeviceSource(
        NORMAL_PRODUCT_CUDA, "coord", normal_product_target,
        params=(1.0 / REF_SCALE, -math.log(REF_SCALE) - HALF_LOG_2PI),
        arrays=tuple(torch.from_numpy(a) for a in (mu, scale, log_norm)),
        torch_ref_fn=normal_product_ref)
    return SourceCoordTarget(source, dim, NormalDraws(dim, REF_SCALE))
