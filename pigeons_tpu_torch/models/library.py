"""Example targets: Neal's funnel, the banana and the flat-prior isotropic
Gaussian with raw (unconstrained) densities, and the ``BayesianModel``
targets hierarchical normal, eight schools (non-centred), the
unidentifiable binomial and logistic regression.

Counterpart of the same names of ``pigeons_tpu/models/library.py``, with
batched ``log_density(x [..., d]) -> [...]``. Of that module's
``BayesianModel`` targets, ``eight_schools(centered=True)``,
``bernoulli_target`` and ``mrna_target`` are not ported yet (ROADMAP queue 1,
item 11b).

Each density is written operation for operation as XLA's CPU backend
evaluates the JAX one (read off its optimized LLVM IR): divisions by
constants are multiplications by float32 reciprocals, ``log(exp(u))`` is
``u``, added constants are folded into one, and a multiply feeding an add is
one fused multiply-add. The slice kernel's ``csrc/densities.cuh`` follows the
same steps, so the three agree bit for bit.

Each raw density is written in the three steps in which the kernel evaluates
it, so that a group of threads can share out the middle one: ``prepare`` (what
all terms need, a function of coordinate 0 alone), ``term`` (one coordinate's
term, elementwise) and ``finish`` (the in-order sum of the terms and what
``prepare`` kept of coordinate 0); ``log_density`` is the three in a row. A
``BayesianModel``'s likelihood has the last two, with one term per
observation (``terms``, ``finish``); what its terms share (``mu``, ``tau``,
``sigma``) comes from ``BayesianModel.constrain``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import f32math, rng
from ..paths import (BANANA, EIGHT_SCHOOLS, FUNNEL, HIERARCHICAL_NORMAL, LOGISTIC_REGRESSION,
                     MVN as MVN_KIND, UNID, sum_squares)
from .bayesian import BayesianModel
from .distributions import (
    _LOG_2PI_F32,
    LOG_2PI,
    HalfCauchy,
    Normal,
    Uniform,
    binomial_log_coefficient,
    binomial_logpmf,
    normal_constants,
    normal_terms,
    sigmoid,
    softplus,
    sum_in_order,
)
from .target import Reference, StandardNormalReference, Target

_NEG_HALF_LOG_2PI = float(np.float32(-0.5 * LOG_2PI))
_INV_3 = float(np.float32(1.0) / np.float32(3.0))
# -log(3) - log(2 pi) / 2, the two constants folded in float32
_FUNNEL_Y_CONST = float(-(np.float32(math.log(3.0)) + np.float32(0.5 * LOG_2PI)))
_S_A = math.sqrt(10.0)  # banana: sqrt(1 / (2 * (1/20)))
_S_B = math.sqrt(0.1)  # banana: sqrt(1 / (2 * 5))


def _split2(keys):
    """``jax.random.split(key)`` for every key: with partitionable threefry,
    child ``i`` is ``fold_in(key, i)``."""
    return rng.fold_in(keys, 0), rng.fold_in(keys, 1)


@dataclass(frozen=True)
class Funnel(Target):
    """Neal's funnel: ``y ~ N(0, 3)``, ``x_i | y ~ N(0, exp(y / scale))``;
    the state is ``(y, x_1, ..., x_{n_x})``."""

    n_x: int = 9
    scale: float = 1.0

    @property
    def dim(self):
        return self.n_x + 1

    @property
    def _inv_scale(self) -> float:
        return float(np.float32(1.0) / np.float32(self.scale))

    def prepare(self, y):
        """``(u, sd, lp_y)``: the log of the x's deviation, the deviation and
        y's own term."""
        m = y * _INV_3
        lp_y = f32math.fma(-(m * m), 0.5, _FUNNEL_Y_CONST)
        u = y * self._inv_scale
        return u, f32math.exp(u), lp_y

    def term(self, x, prep):
        """The terms of ``x [..., k]``, any of the x coordinates."""
        u, sd, _ = prep
        q = x / sd[..., None]
        return f32math.fma(q * q, -0.5, -u[..., None]) + _NEG_HALF_LOG_2PI

    def finish(self, prep, terms):
        return prep[2] + sum_in_order(terms)

    def log_density(self, s):
        prep = self.prepare(s[..., 0])
        return self.finish(prep, self.term(s[..., 1:], prep))

    def device_target(self):
        return FUNNEL, (self._inv_scale,)

    def default_reference(self) -> Reference:
        return StandardNormalReference(self.dim, sigma=3.0).as_reference()

    def sample_iid_target(self, keys):
        """Forward simulation for keys ``[..., 2]``."""
        ky, kx = _split2(keys)
        y = 3.0 * rng.normal(ky)
        x = f32math.exp(y * self._inv_scale)[..., None] * rng.normal(kx, (self.n_x,))
        return torch.cat([y[..., None], x], dim=-1)


@dataclass(frozen=True)
class Banana(Target):
    """n-dimensional banana: ``x ~ N(0, s_a)``, ``y_i | x ~ N(x^2, scale s_b)``
    with ``s_a = sqrt(10)``, ``s_b = sqrt(0.1)``; the state is ``(x, y_1, ...)``."""

    n_y: int = 9
    scale: float = 1.0

    @property
    def dim(self):
        return self.n_y + 1

    def prepare(self, x):
        """``(x^2, lp_x)``: the y's mean and x's own term."""
        return x * x, normal_terms(x, 0.0, _S_A)

    def term(self, y, prep):
        """The terms of ``y [..., k]``, any of the y coordinates."""
        return normal_terms(y, prep[0][..., None], self.scale * _S_B)

    def finish(self, prep, terms):
        return prep[1] + sum_in_order(terms)

    def log_density(self, s):
        prep = self.prepare(s[..., 0])
        return self.finish(prep, self.term(s[..., 1:], prep))

    def device_target(self):
        return BANANA, (*normal_constants(_S_A), *normal_constants(self.scale * _S_B))

    def default_reference(self) -> Reference:
        return StandardNormalReference(self.dim, sigma=3.0).as_reference()

    def sample_iid_target(self, keys):
        """Forward simulation for keys ``[..., 2]``."""
        kx, ky = _split2(keys)
        x = float(np.float32(_S_A)) * rng.normal(kx)
        noise = float(np.float32(self.scale * _S_B)) * rng.normal(ky, (self.n_y,))
        return torch.cat([x[..., None], (x * x)[..., None] + noise], dim=-1)


@dataclass(frozen=True)
class MVN(Target):
    """Flat-prior isotropic Gaussian ``-precision / 2 * sum(x^2)``."""

    dim: int
    precision: float = 1.0

    @property
    def _factor(self) -> float:
        return float(np.float32(-0.5 * self.precision))

    def prepare(self, x0):
        """Nothing: no term needs another coordinate."""
        del x0
        return ()

    def term(self, x, prep):
        """The ``m_i`` of the sum of squares, for every coordinate."""
        del prep
        return x * 1.0

    def finish(self, prep, terms):
        del prep
        return sum_squares(terms) * self._factor

    def log_density(self, x):
        prep = self.prepare(x[..., 0])
        return self.finish(prep, self.term(x, prep))

    def device_target(self):
        return MVN_KIND, (self._factor,)

    def default_reference(self) -> Reference:
        return StandardNormalReference(self.dim, sigma=2.0 / math.sqrt(self.precision)).as_reference()


def funnel(n_x: int = 9, scale: float = 1.0) -> Funnel:
    return Funnel(n_x, scale)


def banana(n_y: int = 9, scale: float = 1.0) -> Banana:
    return Banana(n_y, scale)


def mvn_target(dim: int, precision: float = 1.0) -> MVN:
    return MVN(int(dim), precision)


# ---------------------------------------------------------------------------
# Bayesian models (priors + likelihood, constrained parameters)
# ---------------------------------------------------------------------------
#
# A likelihood is an object: called with the dict of constrained tensors it
# gives the batched log likelihood, ``device()`` describes it to the slice
# kernel as (density kind, float32 parameters, data arrays), ``to(device)``
# moves its data, and ``terms`` / ``finish`` are the two steps the kernel's
# threads share out (each observation's term; their sum in order).


def _observation_terms(y, loc, scale, neg_log_scale):
    """``-0.5 (log 2 pi + z^2) - log(scale)`` with ``z = (y - loc) / scale``
    for a scale that is not a constant: a true division, two fused
    multiply-adds."""
    z = (y - loc) / scale
    return f32math.fma(f32math.fma(z, z, _LOG_2PI_F32), -0.5, neg_log_scale)


class HierarchicalNormalLikelihood:
    """``data[g, i] ~ N(mu + theta_trans[g] tau, sigma)``: ``n_groups *
    n_per_group`` terms, summed by rows (:func:`sum_by_rows`)."""

    def __init__(self, data: torch.Tensor):
        self.data = data.to(torch.float32).contiguous()  # [n_groups, n_per_group]

    def to(self, device):
        return HierarchicalNormalLikelihood(self.data.to(device))

    def device(self):
        return HIERARCHICAL_NORMAL, (float(self.data.shape[1]),), (self.data.reshape(-1),)

    def terms(self, q):
        """``[..., n_groups * n_per_group]``. ``log(sigma)`` is the
        unconstrained coordinate itself (XLA folds ``log(exp(u))`` to ``u``),
        which ``constrain`` hands on as ``q["log_sigma"]``."""
        theta = f32math.fma(q["theta_trans"], q["tau"][..., None], q["mu"][..., None])
        sigma = q["sigma"][..., None, None]
        t = _observation_terms(self.data, theta[..., None], sigma, -q["log_sigma"][..., None, None])
        return t.reshape(t.shape[:-2] + (-1,))

    def finish(self, terms):
        return sum_by_rows(terms, self.data.shape[1])

    def __call__(self, q):
        return self.finish(self.terms(q))


def row_partials(n_rows: int) -> int:
    """How many partial sums XLA's CPU code keeps when it adds up a ``[n_rows,
    n_per_row]`` array: its loop over the rows is vectorised, by 8 or by 4
    rows, only from 16 rows on (and for exactly 4 or 8 rows); the width is
    the one that leaves fewer than 4 rows over. Read off the JAX kernel's
    returned densities at 1 to 27 rows (3 to 16 columns); from 28 rows on
    XLA adds in yet another order, which this rule does not give (within
    float32 rounding of it: ``tests/test_torch_sweep_bayesian.py``)."""
    if n_rows in (4, 8):
        return n_rows
    if n_rows < 16:
        return 1
    return 8 if n_rows % 8 < 4 else 4


def sum_by_rows(terms, n_per_row: int):
    """Sum of ``terms [..., n_rows * n_per_row]`` in the order in which XLA's
    CPU code adds a ``[n_rows, n_per_row]`` array: with ``P =
    row_partials(n_rows)`` partial sums, row ``r`` going to partial ``r mod
    P`` (rows past the last full ``P`` excepted) and each partial adding its
    rows' elements in order, the partials combined by halving (``P = 4``:
    ``(s0 + s2) + (s1 + s3)``; ``P = 8``: ``((s0 + s4) + (s2 + s6)) + ((s1 +
    s5) + (s3 + s7))``), then the rows past the last full ``P`` added in
    order; with ``P = 1`` all elements in order."""
    n_rows = terms.shape[-1] // n_per_row
    P = row_partials(n_rows)
    if P == 1:
        return sum_in_order(terms)
    rows = terms.reshape(terms.shape[:-1] + (n_rows, n_per_row))
    n_main = n_rows // P
    groups = rows[..., : P * n_main, :].reshape(terms.shape[:-1] + (n_main, P, n_per_row))
    # [..., P, n_main * n_per_row]: a partial's elements in the order it adds them
    s = sum_in_order(groups.transpose(-3, -2).reshape(terms.shape[:-1] + (P, -1)))
    while s.shape[-1] > 1:
        half = s.shape[-1] // 2
        s = s[..., :half] + s[..., half:]
    acc = s[..., 0]
    rest = rows[..., P * n_main:, :].reshape(terms.shape[:-1] + (-1,))
    for i in range(rest.shape[-1]):
        acc = acc + rest[..., i]
    return acc


class EightSchoolsLikelihood:
    """Non-centred eight schools: ``y[j] ~ N(mu + theta_trans[j] tau,
    sigma[j])`` with known ``sigma``; ``log(sigma)`` is folded on the host."""

    def __init__(self, y, sigma, log_sigma=None):
        self.y = y.to(torch.float32).contiguous()
        self.sigma = sigma.to(torch.float32).contiguous()
        self.log_sigma = f32math.log(self.sigma) if log_sigma is None else log_sigma

    def to(self, device):
        return EightSchoolsLikelihood(self.y.to(device), self.sigma.to(device),
                                      self.log_sigma.to(device))

    def device(self):
        return EIGHT_SCHOOLS, (), (self.y, self.sigma, self.log_sigma)

    def terms(self, q):
        theta = f32math.fma(q["theta_trans"], q["tau"][..., None], q["mu"][..., None])
        return _observation_terms(self.y, theta, self.sigma, -self.log_sigma)

    def finish(self, terms):
        return sum_in_order(terms)

    def __call__(self, q):
        return self.finish(self.terms(q))


@dataclass(frozen=True)
class UnidLikelihood:
    """``successes ~ Binomial(trials, p1 p2)``: one term."""

    n_trials: int
    n_successes: int

    def to(self, device):
        del device
        return self

    def device(self):
        s, t = float(self.n_successes), float(self.n_trials)
        return UNID, (binomial_log_coefficient(s, t), s, t - s), ()

    def terms(self, q):
        return binomial_logpmf(float(self.n_successes), float(self.n_trials),
                               q["p1"] * q["p2"])[..., None]

    def finish(self, terms):
        return terms[..., 0]

    def __call__(self, q):
        return self.finish(self.terms(q))


def sum_by_windows(terms, window: int = 32):
    """Sum of ``terms [..., n]`` in the order in which XLA's CPU code adds a
    long row: the row is padded with zeros to a multiple of ``window``, half
    of the padding in front, each window is added up in order from 0, and the
    windows' sums are added in order from 0 (its reduce-window rewrite of a
    reduction; read off the compiled module at n = 200, where the windows are
    the elements 0..19, 20..51, ..., 180..199). With ``window = 32`` it is
    the order of the JAX slice kernel's densities at n = 16, 33, 64, 100,
    200, 256 and 500 observations of 10 covariates and at 200 of 3
    (``tests/summation_order_study.py``); not at n = 31, nor with a single
    covariate, where the densities agree within float32 rounding."""
    n = terms.shape[-1]
    pad = (-n) % window
    zeros = terms.new_zeros(terms.shape[:-1] + (pad // 2,)), terms.new_zeros(
        terms.shape[:-1] + (pad - pad // 2,))
    rows = torch.cat([zeros[0], terms, zeros[1]], dim=-1).reshape(terms.shape[:-1] + (-1, window))
    partial = torch.zeros_like(rows[..., 0])
    for i in range(window):
        partial = partial + rows[..., i]
    total = torch.zeros_like(partial[..., 0])
    for j in range(partial.shape[-1]):
        total = total + partial[..., j]
    return total


class LogisticRegressionLikelihood:
    """``y[i] ~ Bernoulli(sigmoid(X[i] . w + b))`` written as ``y z -
    softplus(z)``: one term per observation, each a dot product of a row of
    the design matrix accumulated in column order with one fused multiply-add
    per column (XLA's ``dot``), summed by windows."""

    def __init__(self, X: torch.Tensor, y: torch.Tensor):
        self.X = X.to(torch.float32).contiguous()  # [n, d]
        self.y = y.to(torch.float32).contiguous()  # [n]

    def to(self, device):
        return LogisticRegressionLikelihood(self.X.to(device), self.y.to(device))

    def device(self):
        return LOGISTIC_REGRESSION, (float(self.X.shape[0]),), (self.X.reshape(-1), self.y)

    def terms(self, q):
        w = q["w"][..., None, :]  # [..., 1, d]
        logits = self.X[:, 0] * w[..., 0]
        for k in range(1, self.X.shape[1]):
            logits = f32math.fma(self.X[:, k], w[..., k], logits)
        logits = logits + q["b"][..., None]
        return self.y * logits - softplus(logits)

    def finish(self, terms):
        return sum_by_windows(terms)

    def __call__(self, q):
        return self.finish(self.terms(q))


def logistic_regression_data(n: int = 200, d: int = 10, seed: int = 0):
    """The synthetic design matrix ``[n, d]`` and labels ``[n]`` of
    :func:`logistic_regression`, drawn as the JAX package draws them from the
    three children of ``key(seed)``: standard normal ``X`` and true weights,
    labels ``uniform < sigmoid(X @ w_true)``."""
    k1, k2, k3 = (rng.fold_in(rng.key(seed), i) for i in range(3))
    X = rng.normal(k1, (n, d))
    w_true = rng.normal(k2, (d,))
    logits = X[:, 0] * w_true[0]
    for k in range(1, d):
        logits = f32math.fma(X[:, k], w_true[k], logits)
    y = (rng.uniform(k3, (n,)) < sigmoid(logits)).to(torch.float32)
    return X, y


def logistic_regression(n: int = 200, d: int = 10, seed: int = 0, X=None, y=None) -> BayesianModel:
    """Bayesian logistic regression on synthetic data (the target of bench
    config 2); ``X [n, d]`` and ``y [n]`` replace the synthetic data."""
    if X is None:
        X, y = logistic_regression_data(n, d, seed)
    X, y = torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    return BayesianModel(
        {"w": Normal(shape=(X.shape[1],), scale=2.0), "b": Normal(scale=2.0)},
        LogisticRegressionLikelihood(X, y),
    )


def unid_target(n_trials: int = 100, n_successes: int = 50) -> BayesianModel:
    """Unidentifiable binomial: ``p1, p2 ~ U(0, 1)``; ``successes ~
    Binomial(trials, p1 p2)``. Its logZ is known exactly
    (:func:`unid_analytic_log_z`)."""
    return BayesianModel({"p1": Uniform(), "p2": Uniform()},
                         UnidLikelihood(int(n_trials), int(n_successes)))


def unid_analytic_log_z(n_trials: int = 100, n_successes: int = 50) -> float:
    """Exact log marginal likelihood of the unid model: the integral of
    ``P(S = s | p = p1 p2)`` over the uniform priors."""
    from scipy.integrate import dblquad
    from scipy.stats import binom

    val, _ = dblquad(
        lambda p2, p1: binom.pmf(n_successes, n_trials, p1 * p2),
        0.0, 1.0, 0.0, 1.0,
    )
    return float(np.log(val))


_EIGHT_SCHOOLS_Y = [28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0]
_EIGHT_SCHOOLS_SIGMA = [15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0]


def eight_schools(centered: bool = False, y=None, sigma=None) -> BayesianModel:
    """Eight schools, non-centred: ``theta = mu + tau theta_trans``; ``y
    [J]`` and ``sigma [J]`` replace the schools' effects and standard errors."""
    if centered:
        raise NotImplementedError(
            "eight_schools(centered=True) is not ported yet (ROADMAP queue 1, item 11b)")
    y = torch.as_tensor(_EIGHT_SCHOOLS_Y if y is None else y, dtype=torch.float32)
    sigma = torch.as_tensor(_EIGHT_SCHOOLS_SIGMA if sigma is None else sigma, dtype=torch.float32)
    likelihood = EightSchoolsLikelihood(y, sigma)
    return BayesianModel(
        {"theta_trans": Normal(shape=(y.shape[0],)), "mu": Normal(scale=5.0),
         "tau": HalfCauchy(scale=5.0)},
        likelihood,
    )


def hierarchical_normal_data(n_groups: int = 20, n_per_group: int = 10, seed: int = 0):
    """The synthetic observations ``[n_groups, n_per_group]`` of
    :func:`hierarchical_normal`, drawn as the JAX package draws them: group
    means ``1 + 0.7 z`` from the first child of ``key(seed)``, observations
    ``mean + 0.5 z`` from the second."""
    k1, k2 = _split2(rng.key(seed))
    group_means = rng.normal(k1, (n_groups,)) * float(np.float32(0.7)) + 1.0
    return rng.normal(k2, (n_groups, n_per_group)) * 0.5 + group_means[:, None]


def hierarchical_normal(n_groups: int = 20, n_per_group: int = 10, seed: int = 0,
                        data=None) -> BayesianModel:
    """Hierarchical normal model on synthetic data, non-centred; ``data
    [n_groups, n_per_group]`` replaces the synthetic observations."""
    if data is None:
        data = hierarchical_normal_data(n_groups, n_per_group, seed)
    data = torch.as_tensor(data, dtype=torch.float32)
    return BayesianModel(
        {
            "theta_trans": Normal(shape=(data.shape[0],)),
            "mu": Normal(scale=5.0),
            "tau": HalfCauchy(scale=2.5),
            "sigma": HalfCauchy(scale=2.5),
        },
        HierarchicalNormalLikelihood(data),
    )
