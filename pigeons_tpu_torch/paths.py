"""Annealing paths: continuums of distributions indexed by beta in [0, 1].

Counterpart of ``pigeons_tpu/paths.py``. A path's ``log_density(x, beta)``
takes a batch of states ``x [..., d]`` and betas that broadcast against
``x[..., 0]``, and returns ``[...]``: the batch dimension the JAX package
gets from ``vmap`` is written out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from . import f32math, rng


# density kinds of csrc/densities.cuh (enum Density)
TOY_MVN, FUNNEL, BANANA, MVN = 0, 1, 2, 3


class DeviceDensity(NamedTuple):
    """How a path describes itself to the general-density slice kernel: a
    density kind of ``csrc/densities.cuh`` and its float32 parameters. For the
    interpolating kinds ``params[0]`` is the normal reference's ``1 / sigma``
    and the rest are the target's constants."""

    kind: int
    params: tuple


def sum_squares(m):
    """``sum(m * m)`` over the last axis, summed in coordinate order with one
    fused multiply-add per term. This is how the slice kernel and XLA's CPU
    code accumulate it, so that densities agree bit for bit."""
    acc = m[..., 0] * m[..., 0]
    for i in range(1, m.shape[-1]):
        acc = f32math.fma(m[..., i], m[..., i], acc)
    return acc


def _guarded_mul(w, v):
    """``w * v`` with the convention ``0 * (-inf) = 0`` (the reference
    interpolator's endpoint short-circuit)."""
    return torch.where(w == 0.0, torch.zeros_like(v), w * v)


@dataclass(frozen=True)
class InterpolatingPath:
    """Linear path ``(1 - beta) ref(x) + beta target(x)`` between two batched
    log densities ``x [..., d] -> [...]``; ``sample_reference(keys) -> x``
    draws iid reference states for keys ``[..., 2]``."""

    ref_log_density: Callable
    target_log_density: Callable
    sample_reference: Optional[Callable] = None
    # set when the slice kernel can evaluate both endpoints on the device
    device: Optional[DeviceDensity] = None

    def log_density(self, x, beta):
        lref = self.ref_log_density(x)
        ltgt = self.target_log_density(x)
        return _guarded_mul(1.0 - beta, lref) + _guarded_mul(beta, ltgt)

    def device_density(self) -> Optional[DeviceDensity]:
        return self.device

    @property
    def has_iid_reference(self) -> bool:
        return self.sample_reference is not None


@dataclass(frozen=True)
class ScaledPrecisionNormalPath:
    """Toy MVN path: N(0, I/prec(beta)) with prec(beta) linear from
    ``precision0`` to ``precision1`` (Syed et al. 2021 section I.4.1), with
    closed-form barrier and normalization oracles."""

    precision0: float
    precision1: float
    dim: int

    def precision(self, beta):
        # (1 - beta) p0 + beta p1 as XLA evaluates it: one fused multiply-add
        return f32math.fma(beta, self.precision1, (1.0 - beta) * self.precision0)

    def coord_factor(self, beta):
        """``a(beta)`` with coordinate term ``f(v) = (a v) v``: the density is
        ``sum_c f(x_c)``, which is what the banded slice kernel needs."""
        return self.precision(beta) * -0.5

    def coord_log_density(self, v, c, beta):
        """Contribution of coordinate ``c`` holding value ``v`` at ``beta``
        (isotropic: the same for every ``c``)."""
        del c
        return (self.coord_factor(beta) * v) * v

    def log_density(self, x, beta):
        return self.coord_factor(beta) * torch.sum(x * x, dim=-1)

    def sweep_term(self, x):
        """The ``m_i`` of the sum of squares, for every coordinate: the step
        of :meth:`sweep_log_density` that the slice kernel shares out over a
        group of threads."""
        return x * 1.0

    def sweep_finish(self, terms, beta):
        return self.coord_factor(beta) * sum_squares(terms)

    def sweep_log_density(self, x, beta):
        """The density as the general slice kernel evaluates it: the same
        value as :meth:`log_density` with the squares summed in coordinate
        order (last bits may differ from ``torch.sum``)."""
        return self.sweep_finish(self.sweep_term(x), beta)

    def device_density(self) -> DeviceDensity:
        return DeviceDensity(TOY_MVN, (float(self.precision0), float(self.precision1)))

    def sample_at(self, keys, beta):
        """iid draws at ``beta`` for keys ``[..., 2]``: ``[..., dim]``."""
        beta = torch.as_tensor(beta, dtype=torch.float32, device=keys.device)
        sd = torch.rsqrt(self.precision(beta))
        return sd[..., None] * rng.normal(keys, (self.dim,))

    def sample_reference(self, keys):
        return self.sample_at(keys, 0.0)

    has_iid_reference = True

    # ---- analytic oracles (host-side, float64) ----

    def analytic_cumulative_barrier(self, beta):
        """Predescu et al. 2003 closed form."""
        import numpy as np

        beta = np.asarray(beta, dtype=np.float64)
        log_b = math.lgamma(self.dim / 2.0) * 2.0 - math.lgamma(self.dim)
        b = math.exp(log_b)
        sigma0 = 1.0 / math.sqrt(self.precision0)
        sigmab = 1.0 / np.sqrt((1.0 - beta) * self.precision0 + beta * self.precision1)
        return 2.0 ** (2.0 - self.dim) / b * np.log(sigma0 / sigmab)

    def analytic_lognormalization(self):
        """log(Z_target / Z_ref); Z propto prec^{-d/2}."""
        return 0.5 * self.dim * (math.log(self.precision0) - math.log(self.precision1))


def toy_mvn_path(dim: int) -> ScaledPrecisionNormalPath:
    """Reference ``ScaledPrecisionNormalPath(dim) = (1.0, 10.0, dim)``."""
    return ScaledPrecisionNormalPath(1.0, 10.0, dim)
