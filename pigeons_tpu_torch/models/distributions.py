"""Distributions on batched tensors: log densities, iid samplers and
bijectors to unconstrained space.

Counterpart of ``pigeons_tpu/models/distributions.py``. A distribution has an
event ``shape``; ``log_prob(x [..., *shape]) -> [...]`` sums over the event
and ``sample(keys [..., 2]) -> [..., *shape]`` draws one event per key. A
bijector's ``forward(u [..., *shape])`` returns the constrained value and the
log-Jacobian ``[...]`` summed over the event.

Every function is written as XLA's CPU backend evaluates the JAX one with
constant parameters: a division by a constant is a multiplication by its
float32 reciprocal, logs of constants are folded (computed here with the same
Cephes polynomial), a multiply that feeds an add is one fused multiply-add,
and an event is summed in order. ``Normal``, ``HalfCauchy`` and ``Uniform``
with their bijectors are bit for bit the JAX ones, in the densities and inside
the slice kernel (whose prior table names them, ``csrc/densities.cuh``), and
so is ``Beta`` wherever its constant (three ``gammaln``s that XLA folds) is
XLA's (``tests/test_torch_library_models.py``); the others are held to a
float32 tolerance (``tests/test_torch_bayesian.py``). Every one has a
``device_block``, a row of the slice kernel's prior table, which the kernel
evaluates with the torch form's operations
(``tests/test_torch_user_density.py``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from .. import f32math, rng

LOG_2PI = math.log(2.0 * math.pi)
_LOG_2PI_F32 = float(np.float32(LOG_2PI))


@functools.lru_cache(maxsize=None)
def normal_constants(scale: float) -> tuple[float, float]:
    """``(1 / scale, -log(scale))`` in float32, the two constants that
    :func:`normal_logpdf` needs for a fixed ``scale``."""
    s = np.float32(scale)
    neg_log = -f32math.log(torch.tensor(s, dtype=torch.float32))
    return float(np.float32(1.0) / s), float(neg_log)


def normal_terms(y, loc, scale: float):
    """``-0.5 (log 2 pi + z^2) - log(scale)`` for every element of ``y``, with
    ``z = (y - loc) / scale`` and a constant ``scale``.

    Evaluated as XLA evaluates the JAX function: the division by the constant
    is a multiplication by its float32 reciprocal, and ``log 2 pi + z^2`` and
    the halving are fused multiply-adds."""
    inv_scale, neg_log_scale = normal_constants(scale)
    z = (y - loc) * inv_scale
    return f32math.fma(-f32math.fma(z, z, _LOG_2PI_F32), 0.5, neg_log_scale)


def _add_in_order(terms):
    cols = terms.unbind(-1)
    acc = cols[0]
    for c in cols[1:]:
        acc = acc + c
    return acc


class _SumInOrder(torch.autograd.Function):
    """The in-order sum as one autograd node: every term's gradient is the
    sum's, which is what the chain of adds hands back, bit for bit, without
    a node for each add and a stack of the columns' gradients (at 256 terms
    those were half of a gradient evaluation's host time)."""

    @staticmethod
    def forward(terms):
        acc = _add_in_order(terms)
        return acc.clone() if terms.shape[-1] == 1 else acc  # not a view of the input

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shape = inputs[0].shape

    @staticmethod
    def vmap(info, in_dims, terms):
        return _SumInOrder.apply(terms.movedim(in_dims[0], 0)), 0

    @staticmethod
    def backward(ctx, g):
        return g[..., None].expand(ctx.shape)


def sum_in_order(terms):
    """Sum over the last axis, added in coordinate order as XLA's CPU code and
    the slice kernel add them; 0 where there is no term."""
    if terms.shape[-1] == 0:
        return torch.zeros(terms.shape[:-1], dtype=terms.dtype, device=terms.device)
    return _SumInOrder.apply(terms) if f32math.needs_grad(terms) else _add_in_order(terms)


def normal_logpdf(y, loc, scale: float):
    """:func:`normal_terms` of ``y [..., k]`` summed over the last axis in
    coordinate order."""
    return sum_in_order(normal_terms(y, loc, scale))


def _event(x, shape):
    """``x [..., *shape]`` with the event flattened: ``[..., size]``."""
    return x.reshape(x.shape[: x.dim() - len(shape)] + (-1,))


@functools.lru_cache(maxsize=None)
def _const_log(v: float) -> float:
    """``log(v)`` of a constant as the JAX package folds it: the float32
    Cephes polynomial."""
    return float(f32math.log(torch.tensor(v, dtype=torch.float32)))


def _recip(v: float) -> float:
    return float(np.float32(1.0) / np.float32(v))


def _f32(v: float) -> float:
    return float(np.float32(v))


def _softplus(x):
    out = torch.clamp_min(x, 0.0) + f32math.log1p(f32math.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def _sigmoid(x):
    return 1.0 / (f32math.exp(-x) + 1.0)


def _finite_or_zero(v):
    """JAX's ``_replace_inf``: ``+inf`` read as 0."""
    return torch.where(v == float("inf"), torch.zeros_like(v), v)


@f32math.elementwise_vmap
class _Softplus(torch.autograd.Function):
    """The gradient of ``jnp.logaddexp(x, 0)`` is its custom JVP rule,
    ``exp(x - softplus(x))`` with ``+inf`` read as 0, not the derivative of
    the expression: at ``x = 0`` that of ``max(x, 0)`` is a convention. The
    rule's ``exp`` is torch's (within an ulp of XLA's): the backward holds
    no bits, and the emulated one is some 200 launches a call."""

    @staticmethod
    def forward(x):
        return _softplus(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_finite_or_zero(x) - _finite_or_zero(out))


@f32math.elementwise_vmap
class _Sigmoid(torch.autograd.Function):
    """The gradient of ``lax.logistic`` is ``s (1 - s)``; the quotient's own
    derivative is NaN where ``exp(-x)`` overflows."""

    @staticmethod
    def forward(x):
        return _sigmoid(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as XLA evaluates it."""
    return _Softplus.apply(x) if f32math.needs_grad(x) else _softplus(x)


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA's CPU backend expands it: ``1 / (1 + exp(-x))``."""
    return _Sigmoid.apply(x) if f32math.needs_grad(x) else _sigmoid(x)


# ---------------------------------------------------------------------------
# bijectors: unconstrained u -> constrained x, with log |dx/du|
# ---------------------------------------------------------------------------

# bijector kinds of csrc/densities.cuh
IDENTITY, POSITIVE, INTERVAL = 0, 1, 2


class Identity:
    kind = IDENTITY

    def forward(self, u, shape=()):
        return u, torch.zeros(u.shape[: u.dim() - len(shape)], dtype=u.dtype, device=u.device)

    def inverse(self, x):
        return x


class Positive:
    """``x = exp(u)``, Stan's lower-bound transform."""

    kind = POSITIVE

    def forward(self, u, shape=()):
        return f32math.exp(u), sum_in_order(_event(u, shape))

    def inverse(self, x):
        return f32math.log(x)


@dataclass(frozen=True)
class Interval:
    """``x = lo + (hi - lo) sigmoid(u)``, Stan's two-sided transform."""

    lo: float
    hi: float
    kind = INTERVAL

    @property
    def log_width(self) -> float:
        return _const_log(self.hi - self.lo)

    def forward(self, u, shape=()):
        s = sigmoid(u)
        x = s if (self.lo, self.hi) == (0.0, 1.0) else f32math.fma(s, _f32(self.hi - self.lo), _f32(self.lo))
        terms = (self.log_width + log_sigmoid(u)) + log_sigmoid(-u)
        return x, sum_in_order(_event(terms, shape))

    def inverse(self, x, fused: bool = True):
        """``logit((x - lo) / (hi - lo))``, the division a multiplication by
        the width's float32 reciprocal as XLA compiles it; with ``fused``
        false a true division, as the JAX package's op-by-op evaluation."""
        if fused:
            t = (x - _f32(self.lo)) * _recip(self.hi - self.lo)
        else:  # a tensor divisor: torch's CUDA division by a Python number multiplies
            t = (x - _f32(self.lo)) / x.new_full((), _f32(self.hi - self.lo))
        t = torch.clamp(t, _f32(1e-7), _f32(1.0 - 1e-7))
        return f32math.log(t) - f32math.log1p(-t)


# ---------------------------------------------------------------------------
# distributions (with event shape, used as priors / references)
# ---------------------------------------------------------------------------

# distribution kinds of csrc/densities.cuh (the kernel's prior table)
NORMAL, HALF_CAUCHY, UNIFORM, BETA, CAUCHY, EXPONENTIAL, LOG_NORMAL = range(7)


@dataclass(frozen=True)
class Distribution:
    # keyword-only so subclass parameters (loc, scale, ...) stay positional
    shape: Tuple[int, ...] = field(default=(), kw_only=True)

    bijector = Identity()
    # (kind, three float32 parameters) of the kernel's prior table, or None
    # where the kernel has no such block
    device_block = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def log_prob(self, x):  # summed over the event
        raise NotImplementedError

    def sample(self, keys, fused: bool = True):
        """Draws for ``keys [..., 2]``, as the runtime's compiled scan gives
        them (``fused``: constants folded, multiply-adds fused) or as an
        eager call does; the two agree where the distribution does not say
        otherwise."""
        raise NotImplementedError


@dataclass(frozen=True)
class Normal(Distribution):
    loc: float = 0.0
    scale: float = 1.0

    @property
    def device_block(self):
        return NORMAL, (_f32(self.loc), _recip(self.scale), -_const_log(self.scale))

    def log_prob(self, x):
        _, (loc, inv_scale, neg_log_scale) = self.device_block
        z = (_event(x, self.shape) - loc) * inv_scale
        t = f32math.fma(z, z, _LOG_2PI_F32)
        if neg_log_scale == 0.0:
            # the halving is the multiply that feeds the event's sum
            cols = t.unbind(-1)
            acc = cols[0] * -0.5
            for c in cols[1:]:
                acc = f32math.fma(c, -0.5, acc)
            return acc
        return sum_in_order(f32math.fma(t, -0.5, neg_log_scale))

    def sample(self, keys, fused: bool = True):
        return f32math.fma(rng.normal(keys, self.shape), _f32(self.scale), _f32(self.loc))


@dataclass(frozen=True)
class Uniform(Distribution):
    lo: float = 0.0
    hi: float = 1.0

    @property
    def bijector(self):
        return Interval(self.lo, self.hi)

    @property
    def total(self) -> float:
        """The event's log density, a constant: ``size`` times
        ``-log(hi - lo)`` added in float32."""
        c, acc = np.float32(-_const_log(self.hi - self.lo)), np.float32(0.0)
        for _ in range(self.size):
            acc = np.float32(acc + c)
        return float(acc)

    @property
    def device_block(self):
        return UNIFORM, (_f32(self.lo), _f32(self.hi - self.lo), self.total)

    def log_prob(self, x):
        batch = x.shape[: x.dim() - len(self.shape)]
        return torch.full(batch, self.total, dtype=x.dtype, device=x.device)

    def sample(self, keys, fused: bool = True):
        """``jax.random.uniform(key, shape, lo, hi)`` as XLA compiles it: the
        scaling and the shift one fused multiply-add; with ``fused`` false
        two roundings, as the JAX package's op-by-op evaluation."""
        if not fused:
            return rng.uniform(keys, self.shape, self.lo, self.hi)
        u = rng.uniform(keys, self.shape)
        lo = torch.tensor(_f32(self.lo), device=keys.device)
        return torch.maximum(lo, f32math.fma(u, float(np.float32(self.hi) - np.float32(self.lo)),
                                             _f32(self.lo)))


def _gammaln(v: float) -> np.float32:
    """``gammaln`` of a constant as the JAX package folds it (float32 Lanczos)."""
    return np.float32(float(f32math.lgamma(torch.tensor(v, dtype=torch.float32))))


_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554707,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)


def _folded_gammaln(v: float) -> np.float32:
    """``gammaln`` of a constant ``v >= 0.5`` as XLA's constant folding
    evaluates it: the Lanczos sum that the JAX package's ``gammaln`` is
    lowered to, one float32 operation at a time, with correctly rounded
    ``log`` and ``log1p`` and no fused multiply-add. Not the runtime's
    :func:`f32math.lgamma`: ``gammaln(2)`` folds to 2^-21, not 0. Equal to
    XLA's folded value at 0.5, 0.7, 1, 1.5, 2, 2.5, 3, 9 and 12 (so
    ``Beta(1, 1)``, ``Beta(3, 9)``, ``Beta(0.5, 0.7)`` and ``Beta(1, 1.5)``
    are bitwise), within 1 ulp of it elsewhere (71 of 315 arguments drawn
    in [0.5, 50] differ, 3.5, 4 and 5.5 among them): XLA's folding takes
    some step that this does not repeat."""
    f = np.float32
    z = f(f(v) - f(1.0))
    a = f(_LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        a = f(a + f(f(c) / f(z + f(i + 1))))
    lanczos_half = f(7.5)
    t = f(lanczos_half + z)
    log_t = f(f(math.log(7.5)) + f(math.log1p(float(f(z / lanczos_half)))))
    r = f(f(f(z + f(0.5)) - f(t / log_t)) * log_t)
    return f(f(f((math.log(2.0) + math.log(math.pi)) / 2.0) + r) + f(math.log(float(a))))


@dataclass(frozen=True)
class Beta(Distribution):
    a: float = 1.0
    b: float = 1.0

    @property
    def bijector(self):
        return Interval(0.0, 1.0)

    @property
    def log_norm(self) -> float:
        """``-log B(a, b)``, folded as XLA folds it (:func:`_folded_gammaln`)."""
        g = _folded_gammaln
        return float(-((g(self.a) + g(self.b)) - g(self.a + self.b)))

    @property
    def device_block(self):
        return BETA, (_f32(self.a - 1), _f32(self.b - 1), self.log_norm)

    def log_prob(self, x):
        """``(a - 1) log x + (b - 1) log1p(-x) - log B(a, b)`` as XLA evaluates
        it: the first product fused into the sum, the constant added last
        (with ``a = b = 1`` the products by 0 stay, as in XLA's code)."""
        _, (a1, b1, log_norm) = self.device_block
        x = _event(x, self.shape)
        return sum_in_order(f32math.fma(f32math.log(x), a1, b1 * f32math.log1p(-x)) + log_norm)

    def sample(self, keys, fused: bool = True):
        """``jax.random.beta`` (``rng.beta``): its stream, compiled
        (``fused``, the reference chain's draws) or eager (the initial
        states)."""
        return rng.beta(keys, self.a, self.b, self.shape, fused)


def cauchy(keys, shape=()):
    """``jax.random.cauchy``: ``tan(pi (u - 0.5))`` with ``u`` uniform on
    ``[eps, 1)``. The argument is the JAX one, bit for bit; its tangent is
    taken in float64 and rounded, so that the CPU and the card give the same
    float32 (torch's float32 tangents differ between them), within 2 ulp of
    XLA's."""
    u = rng.uniform(keys, shape, float(np.finfo(np.float32).eps), 1.0)
    return torch.tan((_f32(math.pi) * (u - 0.5)).to(torch.float64)).to(torch.float32)


@dataclass(frozen=True)
class Cauchy(Distribution):
    loc: float = 0.0
    scale: float = 1.0

    @property
    def device_block(self):
        return CAUCHY, (_f32(self.loc), _recip(self.scale), -_const_log(math.pi * self.scale))

    def log_prob(self, x):
        _, (loc, inv_scale, log_norm) = self.device_block
        z = (_event(x, self.shape) - loc) * inv_scale
        return sum_in_order(log_norm - f32math.log1p(z * z))

    def sample(self, keys, fused: bool = True):
        return f32math.fma(cauchy(keys, self.shape), _f32(self.scale), _f32(self.loc))


@dataclass(frozen=True)
class HalfCauchy(Distribution):
    scale: float = 1.0

    bijector = Positive()

    @property
    def log_norm(self) -> float:
        """``log 2 - log(pi scale)``, folded in float32."""
        return float(np.float32(_const_log(2.0)) - np.float32(_const_log(math.pi * self.scale)))

    @property
    def device_block(self):
        return HALF_CAUCHY, (_recip(self.scale), self.log_norm, 0.0)

    def log_prob(self, x):
        z = _event(x, self.shape) * _recip(self.scale)
        return sum_in_order(self.log_norm - f32math.log1p(z * z))

    def sample(self, keys, fused: bool = True):
        return torch.abs(_f32(self.scale) * cauchy(keys, self.shape))


@dataclass(frozen=True)
class Exponential(Distribution):
    rate: float = 1.0

    bijector = Positive()

    @property
    def device_block(self):
        return EXPONENTIAL, (-_f32(self.rate), _const_log(self.rate), 0.0)

    def log_prob(self, x):
        _, (neg_rate, log_rate, _) = self.device_block
        return sum_in_order(f32math.fma(_event(x, self.shape), neg_rate, log_rate))

    def sample(self, keys, fused: bool = True):
        u = rng.uniform(keys, self.shape)
        return -f32math.log1p(-u) * _recip(self.rate)


@dataclass(frozen=True)
class LogNormal(Distribution):
    loc: float = 0.0
    scale: float = 1.0

    bijector = Positive()

    @property
    def device_block(self):
        return LOG_NORMAL, (_f32(self.loc), _recip(self.scale), -_const_log(self.scale))

    def log_prob(self, x):
        _, (loc, inv_scale, neg_log_scale) = self.device_block
        lx = f32math.log(_event(x, self.shape))
        z = (lx - loc) * inv_scale
        t = f32math.fma(z, z, _LOG_2PI_F32)
        return sum_in_order(f32math.fma(t, -0.5, neg_log_scale) - lx)

    def sample(self, keys, fused: bool = True):
        return f32math.exp(f32math.fma(rng.normal(keys, self.shape), _f32(self.scale), _f32(self.loc)))


# ---------------------------------------------------------------------------
# likelihood helpers
# ---------------------------------------------------------------------------


def bernoulli_logpmf(y, p):
    """``sum(where(y > 0, log p, log1p(-p)))`` over the last axis, in order."""
    return sum_in_order(torch.where(y > 0, f32math.log(p), f32math.log1p(-p)))


def binomial_log_coefficient(successes: float, trials: float) -> float:
    """``log C(trials, successes)`` from three float32 ``gammaln``s, as the JAX
    package folds it."""
    return float((_gammaln(trials + 1.0) - _gammaln(successes + 1.0))
                 - _gammaln(trials - successes + 1.0))


def binomial_logpmf(successes: float, trials: float, p):
    """With constant counts: two fused multiply-adds onto the coefficient."""
    logc = binomial_log_coefficient(successes, trials)
    acc = f32math.fma(f32math.log(p), _f32(successes), logc)
    return f32math.fma(f32math.log1p(-p), _f32(trials - successes), acc)
