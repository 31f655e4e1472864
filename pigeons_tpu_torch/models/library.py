"""Example targets: Neal's funnel, the banana and the flat-prior isotropic
Gaussian with raw (unconstrained) densities; the ``BayesianModel`` targets
hierarchical normal, eight schools (centred and non-centred), the
unidentifiable binomial, logistic regression, the Bernoulli model and the
mRNA transfection model; and the mixed targets with ordinal and Bool
coordinates, ``poisson_count_target`` and ``binary_mixture_target`` (the
Ising model is in ``models/ising.py``).

Counterpart of the same names of ``pigeons_tpu/models/library.py``, with
batched ``log_density(x [..., d]) -> [...]``.

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
from pathlib import Path

import numpy as np
import torch

from .. import f32math, rng
from ..paths import (BANANA, BERNOULLI, EIGHT_SCHOOLS, EIGHT_SCHOOLS_CENTERED, FUNNEL,
                     HIERARCHICAL_NORMAL, LOGISTIC_REGRESSION, MRNA, MVN as MVN_KIND, UNID,
                     sum_squares)
from .bayesian import BayesianModel
from .distributions import (
    _LOG_2PI_F32,
    LOG_2PI,
    Beta,
    HalfCauchy,
    Normal,
    Uniform,
    _const_log,
    _f32,
    _recip,
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
        ky, kx = rng.split(keys).unbind(-2)
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
        kx, ky = rng.split(keys).unbind(-2)
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


def _poisson(keys, rate: float):
    """Poisson(``rate``) draws for keys ``[..., 2]``, as float32: the law of
    ``jax.random.poisson``, not its stream. One uniform a draw, inverted
    through the float64 distribution function (its tail past ``rate + 30
    sqrt(rate) + 30`` has probability below 1e-100)."""
    u = rng.uniform(keys).double()
    k_max = int(rate + 30.0 * math.sqrt(rate) + 30.0)
    k = torch.arange(k_max + 1, dtype=torch.float64, device=keys.device)
    cdf = torch.cumsum(torch.exp(k * math.log(rate) - torch.lgamma(k + 1.0) - rate), 0)
    return torch.searchsorted(cdf, u).clamp_max(k_max).to(torch.float32)


@dataclass(frozen=True)
class PoissonCount(Target):
    """Mixed integer / continuous toy target: ``k ~ Poisson(rate)`` (an
    ordinal coordinate, ``integer_mask``) beside ``n_cont`` iid ``N(0, 1)``
    coordinates; its reference is the target itself. The state carries whole
    values at the count coordinate."""

    rate: float = 5.0
    n_cont: int = 1

    @property
    def dim(self):
        return 1 + self.n_cont

    @property
    def integer_mask(self):
        m = np.zeros(self.dim, bool)
        m[0] = True
        return m

    def log_density(self, s):
        """``k log(rate) - lgamma(k + 1) - rate`` plus the normal terms, -inf
        where ``k`` is negative or not whole."""
        k, x = s[..., 0], s[..., 1:]
        valid = (k >= 0) & (torch.abs(k - torch.round(k)) < 0.5)
        lp_k = f32math.fma(k, _f32(math.log(self.rate)), -f32math.lgamma(k + 1.0)) - _f32(self.rate)
        lp_x = sum_in_order(f32math.fma(-0.5 * x, x, _NEG_HALF_LOG_2PI))
        return torch.where(valid, lp_k + lp_x, torch.full_like(lp_k, -float("inf")))

    def default_reference(self) -> Reference:
        return Reference(log_density=self.log_density, sample_iid=self.sample_iid_target)

    def sample_iid_target(self, keys):
        kk, kx = rng.split(keys).unbind(-2)
        return torch.cat([_poisson(kk, self.rate)[..., None], rng.normal(kx, (self.n_cont,))], dim=-1)

    def initialization(self, keys):
        return self.sample_iid_target(keys)


def poisson_count_target(rate: float = 5.0, n_cont: int = 1) -> PoissonCount:
    return PoissonCount(rate, n_cont)


@dataclass(frozen=True)
class BinaryMixture(Target):
    """Mixed Bool / continuous toy target: ``b_i ~ Bernoulli(p)`` for ``i =
    1, 2`` (``binary_mask``) and ``x_j | b ~ N(mu (b_1 + b_2), 1)``. The
    reference is Bernoulli(1/2) on the Bool block and ``N(0, 3)`` on the
    continuous one. States carry {0., 1.} at the Bool coordinates."""

    p: float = 0.4
    mu: float = 1.5
    n_cont: int = 2

    @property
    def dim(self):
        return 2 + self.n_cont

    @property
    def binary_mask(self):
        m = np.zeros(self.dim, bool)
        m[:2] = True
        return m

    @staticmethod
    def _valid(b):
        return ((b == 0.0) | (b == 1.0)).all(dim=-1)

    def log_density(self, s):
        b, x = s[..., :2], s[..., 2:]
        lp_b = sum_in_order(f32math.fma(b, _f32(math.log(self.p)), (1.0 - b) * _f32(math.log(1.0 - self.p))))
        m = _f32(self.mu) * sum_in_order(b)
        dev = x - m[..., None]
        lp_x = sum_in_order(f32math.fma(dev * dev, -0.5, _NEG_HALF_LOG_2PI))
        return torch.where(self._valid(b), lp_b + lp_x, torch.full_like(lp_x, -float("inf")))

    def default_reference(self) -> Reference:
        n_c = self.n_cont
        const = _f32(-(_const_log(3.0) + 0.5 * LOG_2PI))

        def ref_log_density(s):
            b, x = s[..., :2], s[..., 2:]
            z = x * _INV_3
            lp = _f32(-2.0 * math.log(2.0)) + sum_in_order(f32math.fma(z * z, -0.5, const))
            return torch.where(self._valid(b), lp, torch.full_like(lp, -float("inf")))

        def ref_sample(keys):
            kb, kx = rng.split(keys).unbind(-2)
            b = (rng.uniform(kb, (2,)) < 0.5).to(torch.float32)
            return torch.cat([b, 3.0 * rng.normal(kx, (n_c,))], dim=-1)

        return Reference(log_density=ref_log_density, sample_iid=ref_sample)

    def sample_iid_target(self, keys):
        kb, kx = rng.split(keys).unbind(-2)
        b = (rng.uniform(kb, (2,)) < _f32(self.p)).to(torch.float32)
        x = _f32(self.mu) * b.sum(-1, keepdim=True) + rng.normal(kx, (self.n_cont,))
        return torch.cat([b, x], dim=-1)

    def initialization(self, keys):
        return self.default_reference().sample_iid(keys)


def binary_mixture_target(p: float = 0.4, mu: float = 1.5, n_cont: int = 2) -> BinaryMixture:
    return BinaryMixture(p, mu, n_cont)


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
    for r in rest.unbind(-1):
        acc = acc + r
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
    for col in rows.unbind(-1):
        partial = partial + col
    total = torch.zeros_like(partial[..., 0])
    for p in partial.unbind(-1):
        total = total + p
    return total


# the most observations at which the logistic regression takes its column form
# (LogisticRegressionLikelihood): XLA's CPU code adds up to 32 windows' sums in order
COLUMN_FORM_MAX_OBSERVATIONS = 32 * 32


class LogisticRegressionLikelihood:
    """``y[i] ~ Bernoulli(sigmoid(X[i] . w + b))`` written as ``y z -
    softplus(z)``, in one of two forms, chosen by the number of observations.

    The column form (:meth:`sweep`): one term per observation, each a dot
    product of a row of the design matrix accumulated in column order with
    one fused multiply-add per column, summed by windows. It is what the
    general slice kernel computes at every shape (``device``, ``terms``,
    ``finish``). The dense form (:meth:`dense`): ``z = w @ X.T + b`` as one
    float32 product, ``y z - softplus(z)`` and ``torch.sum``, with no
    emulated float32 arithmetic: on the card the product is one cuBLAS call,
    where the column form is some 14 float64 operations over ``[lanes, n]``
    per column.

    The call takes the column form up to ``COLUMN_FORM_MAX_OBSERVATIONS`` =
    1,024 observations and the dense form above (``uses_dense``).
    ``tests/logistic_form_study.py`` counts the lanes of 64 whose density each
    form gives bit for bit against ``jit(vmap(log_density))`` of the JAX
    model, column / dense: 56 / 35 at 200 x 10, 64 / 20 at 1,024 x 10, 64 /
    22 at 1,024 x 32, 49 / 30 at 1,024 x 128; above 1,024 observations 27 /
    23 at 1,025 x 10, 13 / 31 at 2,048 x 10, 23 / 41 at 4,096 x 256, 10 / 29
    at 8,192 x 256. There XLA still multiplies in column order (the logits are
    the column form's, bit for bit), but it adds more than 32 windows' sums
    by windows again, which ``sum_by_windows`` and the kernel do not: in that
    order the column form would give 55 to 64 lanes of 64 with 10
    covariates, 58 to 60 at 4,096 and 8,192 observations of 128 or 256 (the
    study's ``windows_of_windows``). Each form is within float32 rounding of the
    JAX density at every shape of the study: 5e-7 relative, and 1e-6 of the
    lane's largest gradient component.
    """

    def __init__(self, X: torch.Tensor, y: torch.Tensor):
        self.X = X.to(torch.float32).contiguous()  # [n, d]
        self.y = y.to(torch.float32).contiguous()  # [n]
        self.uses_dense = self.X.shape[0] > COLUMN_FORM_MAX_OBSERVATIONS

    def to(self, device):
        return LogisticRegressionLikelihood(self.X.to(device), self.y.to(device))

    def device(self):
        return LOGISTIC_REGRESSION, (float(self.X.shape[0]),), (self.X.reshape(-1), self.y)

    def column_logits(self, q):
        """``X @ w + b`` in column order, a fused multiply-add per column."""
        w = q["w"][..., None, :].unbind(-1)  # d columns [..., 1]: one node for autograd
        logits = self.X[:, 0] * w[0]
        for k in range(1, self.X.shape[1]):
            logits = f32math.fma(self.X[:, k], w[k], logits)
        return logits + q["b"][..., None]

    def terms(self, q):
        logits = self.column_logits(q)
        return self.y * logits - softplus(logits)

    def finish(self, terms):
        return sum_by_windows(terms)

    def sweep(self, q):
        """The column form: the likelihood as the general slice kernel
        evaluates it."""
        return self.finish(self.terms(q))

    def dense_logits(self, q):
        """``X @ w + b`` as one float32 product."""
        return torch.matmul(q["w"], self.X.T) + q["b"][..., None]

    def dense(self, q):
        """The dense form. ``F.softplus`` is ``log1p(exp(z))`` up to ``z =
        20`` and ``z`` above, where the two agree in float32; it keeps
        ``logaddexp(z, 0)``'s values at +-inf and NaN, and its gradient is
        JAX's rule for it, ``sigmoid(z)`` (1 above 20)."""
        z = self.dense_logits(q)
        return torch.sum(self.y * z - torch.nn.functional.softplus(z), dim=-1)

    def __call__(self, q):
        return self.dense(q) if self.uses_dense else self.sweep(q)


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


_PSEUDO_SCALE = 20.0  # the centred model's pseudo-prior on theta


class CenteredEightSchoolsLikelihood:
    """Centred eight schools: ``theta[j] ~ N(mu, tau)`` and ``y[j] ~
    N(theta[j], sigma[j])``, with the pseudo-prior ``N(0, 20)`` of theta
    (its prior in the model, so that the reference is iid-sampleable)
    divided back out: three sums of ``J`` terms, ``(A + B) - C``, each in
    order (``terms`` lays them out ``[A, B, C]``).

    ``B`` has two forms. Inside the slice kernel, which receives ``y`` and
    ``sigma`` as array inputs, it divides by ``sigma`` and reads ``log
    sigma`` through the Cephes log (:meth:`sweep`, K2 and its twin); in the
    runtime's density pass XLA folds the constant arrays into their float32
    reciprocals and logs (:meth:`__call__`)."""

    def __init__(self, y, sigma, log_sigma=None):
        self.y = y.to(torch.float32).contiguous()
        self.sigma = sigma.to(torch.float32).contiguous()
        self.log_sigma = f32math.log(self.sigma) if log_sigma is None else log_sigma
        # the runtime's folded constants
        self.inv_sigma = torch.tensor([_recip(v) for v in self.sigma.tolist()], device=self.y.device)
        self.neg_log_sigma = torch.tensor([-_const_log(v) for v in self.sigma.tolist()],
                                          device=self.y.device)

    def to(self, device):
        return CenteredEightSchoolsLikelihood(self.y.to(device), self.sigma.to(device),
                                              self.log_sigma.to(device))

    def device(self):
        return (EIGHT_SCHOOLS_CENTERED, normal_constants(_PSEUDO_SCALE),
                (self.y, self.sigma, self.log_sigma))

    def _terms(self, q, observation):
        theta, log_tau = q["theta"], q["log_tau"][..., None]
        a = _observation_terms(theta, q["mu"][..., None], q["tau"][..., None], -log_tau)
        return torch.cat([a, observation, normal_terms(theta, 0.0, _PSEUDO_SCALE)], dim=-1)

    def terms(self, q):
        """The kernel's terms ``[..., 3 J]``."""
        return self._terms(q, _observation_terms(self.y, q["theta"], self.sigma, -self.log_sigma))

    def finish(self, terms):
        a, b, c = terms.chunk(3, dim=-1)
        return (sum_in_order(a) + sum_in_order(b)) - sum_in_order(c)

    def sweep(self, q):
        return self.finish(self.terms(q))

    def __call__(self, q):
        z = (self.y - q["theta"]) * self.inv_sigma
        observation = f32math.fma(f32math.fma(z, z, _LOG_2PI_F32), -0.5, self.neg_log_sigma)
        return self.finish(self._terms(q, observation))


def eight_schools(centered: bool = False, y=None, sigma=None) -> BayesianModel:
    """Eight schools; ``y [J]`` and ``sigma [J]`` replace the schools' effects
    and standard errors. Non-centred: ``theta = mu + tau theta_trans``;
    centred: ``theta`` itself, under the pseudo-prior ``N(0, 20)``
    (:class:`CenteredEightSchoolsLikelihood`)."""
    y = torch.as_tensor(_EIGHT_SCHOOLS_Y if y is None else y, dtype=torch.float32)
    sigma = torch.as_tensor(_EIGHT_SCHOOLS_SIGMA if sigma is None else sigma, dtype=torch.float32)
    if centered:
        return BayesianModel(
            {"theta": Normal(shape=(y.shape[0],), scale=_PSEUDO_SCALE), "mu": Normal(scale=5.0),
             "tau": HalfCauchy(scale=5.0)},
            CenteredEightSchoolsLikelihood(y, sigma),
        )
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
    k1, k2 = rng.split(rng.key(seed)).unbind(-2)
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


class BernoulliLikelihood:
    """``y[i] ~ Bernoulli(theta)``: ``where(y > 0, log theta, log1p(-theta))``
    for each observation, added in order."""

    def __init__(self, y):
        self.y = y.to(torch.float32).contiguous()

    def to(self, device):
        return BernoulliLikelihood(self.y.to(device))

    def device(self):
        return BERNOULLI, (float(self.y.numel()),), (self.y,)

    def terms(self, q):
        p = q["theta"][..., None]
        return torch.where(self.y > 0, f32math.log(p), f32math.log1p(-p))

    def finish(self, terms):
        return sum_in_order(terms)

    def __call__(self, q):
        return self.finish(self.terms(q))


_BERNOULLI_DATA = [0, 1, 0, 0, 0, 0, 0, 0, 0, 1]


def bernoulli_target(data=None) -> BayesianModel:
    """``theta ~ Beta(1, 1)``, ``data[i] ~ Bernoulli(theta)``; ``data``
    (0/1) replaces the ten observations. With the default data the
    evidence is ``B(3, 9)``: ``log B(3, 9) = -6.204558``."""
    y = torch.as_tensor(np.asarray(_BERNOULLI_DATA if data is None else data, dtype=np.float32))
    return BayesianModel({"theta": Beta(1.0, 1.0)}, BernoulliLikelihood(y))


def load_mrna_data():
    """``(ts [150], ys [150])``: the Ballnus et al. (2017) transfection data,
    the port's own copy of the file the JAX package reads."""
    raw = np.loadtxt(Path(__file__).parent / "data" / "Ballnus_et_al_2017_M1a.csv", delimiter=",")
    return (torch.tensor(raw[:, 0], dtype=torch.float32),
            torch.tensor(raw[:, 1], dtype=torch.float32))


_MRNA_NAMES = ("lt0", "lkm0", "lbeta", "ldelta", "lsigma")
_LN10_F32 = float(np.float32(math.log(10.0)))


def mrna_mean(tmt0, km0, beta, delta):
    """The expected level at ``t - t0 = tmt0``: ``km0 / (delta - beta)
    (e^{-beta tmt0} - e^{-delta tmt0})`` by the expm1 form of ``get_mu``
    (``pigeons_tpu/models/library.py``), with its selects (``km0 tmt0``
    where ``|delta - beta| < 1e-7``, 0 where ``tmt0 <= 0``): a lane's value
    of the branch not taken may be infinite or NaN and is discarded, not
    multiplied by 0. A subnormal level is kept (XLA's code flushes it to
    0): it is then subtracted from an observation of 1e-3 or more, which it
    cannot change. ``km0``, ``beta``, ``delta`` ``[..., 1]``."""
    dmb = delta - beta
    a, b = -beta * tmt0, -delta * tmt0
    diff = torch.where(a > b, -f32math.exp(a) * f32math.expm1(b - a),
                       f32math.exp(b) * f32math.expm1(a - b))
    near = torch.abs(dmb) < 1e-7
    val = km0 * torch.where(near, tmt0, diff / torch.where(near, torch.ones_like(dmb), dmb))
    return torch.where(tmt0 <= 0.0, torch.zeros_like(val), val)


class MrnaLikelihood:
    """``ys[i] ~ N(mu(ts[i]), sigma)`` with ``mu`` from :func:`mrna_mean`;
    the five parameters are ``log10`` of ``t0``, ``km0``, ``beta``,
    ``delta`` and ``sigma`` (``f32math.pow10``, glibc's ``powf`` as XLA's CPU
    code calls it). XLA rewrites ``log(10 ** lsigma)`` to ``lsigma log(10)``
    (0 where ``lsigma`` is 0). The 150 terms are summed by windows of 32
    (:func:`sum_by_windows`) in the runtime's pass (its reduce-window, read
    off the compiled module) and inside the slice kernel alike
    (``tests/summation_order_study.py``)."""

    def __init__(self, ts, ys):
        self.ts = ts.to(torch.float32).contiguous()
        self.ys = ys.to(torch.float32).contiguous()

    def to(self, device):
        return MrnaLikelihood(self.ts.to(device), self.ys.to(device))

    def device(self):
        return MRNA, (float(self.ts.numel()),), (self.ts, self.ys)

    def terms(self, q):
        t0, km0, beta, delta, sigma = (f32math.pow10(q[n])[..., None] for n in _MRNA_NAMES)
        lsigma = q["lsigma"][..., None]
        log_sigma = torch.where(lsigma == 0.0, torch.zeros_like(lsigma), _LN10_F32 * lsigma)
        mu = mrna_mean(self.ts - t0, km0, beta, delta)
        return _observation_terms(self.ys, mu, sigma, -log_sigma)

    def finish(self, terms):
        return sum_by_windows(terms)

    def __call__(self, q):
        return self.finish(self.terms(q))


def mrna_target(ts=None, ys=None) -> BayesianModel:
    """The mRNA transfection model (Ballnus et al. 2017 data): five
    log10-scale parameters with uniform priors; ``ts [n]`` and ``ys [n]``
    replace the 150 observations (:func:`load_mrna_data`)."""
    if ts is None:
        ts, ys = load_mrna_data()
    ts, ys = torch.as_tensor(ts, dtype=torch.float32), torch.as_tensor(ys, dtype=torch.float32)
    return BayesianModel(
        {"lt0": Uniform(-2.0, 1.0), "lkm0": Uniform(-5.0, 5.0), "lbeta": Uniform(-5.0, 5.0),
         "ldelta": Uniform(-5.0, 5.0), "lsigma": Uniform(-2.0, 2.0)},
        MrnaLikelihood(ts, ys),
    )
