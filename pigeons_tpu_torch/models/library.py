"""Example targets with raw (unconstrained) densities: Neal's funnel, the
banana and the flat-prior isotropic Gaussian.

Counterpart of the same classes of ``pigeons_tpu/models/library.py``, with
batched ``log_density(x [..., d]) -> [...]``. The targets built on
``BayesianModel`` wait for that frontend (ROADMAP queue 1, item 11b).

Each density is written operation for operation as XLA's CPU backend
evaluates the JAX one (read off its optimized LLVM IR): divisions by
constants are multiplications by float32 reciprocals, ``log(exp(u))`` is
``u``, added constants are folded into one, and a multiply feeding an add is
one fused multiply-add. The slice kernel's ``csrc/densities.cuh`` follows the
same steps, so the three agree bit for bit.

Each density is written in the three steps in which the kernel evaluates it,
so that a group of threads can share out the middle one: ``prepare`` (what
all terms need, a function of coordinate 0 alone), ``term`` (one coordinate's
term, elementwise) and ``finish`` (the in-order sum of the terms and what
``prepare`` kept of coordinate 0); ``log_density`` is the three in a row.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import f32math, rng
from ..paths import BANANA, FUNNEL, MVN as MVN_KIND, sum_squares
from .distributions import LOG_2PI, normal_constants, normal_terms, sum_in_order
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
