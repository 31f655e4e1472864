"""Annealing paths: continuums of distributions indexed by beta in [0, 1].

Counterpart of ``pigeons_tpu/paths.py``. A path's ``log_density(x, beta)``
takes a batch of states ``x [..., d]`` and betas that broadcast against
``x[..., 0]``, and returns ``[...]``: the batch dimension the JAX package
gets from ``vmap`` is written out.
"""

from __future__ import annotations

import math
from dataclasses import KW_ONLY, dataclass
from typing import Callable, NamedTuple, Optional

import torch

from . import f32math, rng


# density kinds of csrc/densities.cuh (enum Density); USER is a density the
# user supplies as CUDA source (device_source.py), compiled apart
(TOY_MVN, FUNNEL, BANANA, MVN, HIERARCHICAL_NORMAL, EIGHT_SCHOOLS, UNID,
 LOGISTIC_REGRESSION, BERNOULLI, EIGHT_SCHOOLS_CENTERED, MRNA, USER) = range(12)


class DeviceDensity(NamedTuple):
    """How a path describes itself to the general-density slice kernel: a
    density kind of ``csrc/densities.cuh`` and its float32 parameters. For the
    interpolating kinds ``params[0]`` is the normal reference's ``1 / sigma``
    and the rest are the target's constants. A ``BayesianModel`` path also
    has ``arrays``, the likelihood's data as float32 tensors on the run's
    device (the kernel reads them in place), and ``prior``, the rows
    ``(offset, size, distribution kind, bijector kind, p0, p1, p2)`` of its
    prior table: the reference is then the prior when ``params[0]`` is 0,
    else the normal of ``params[0] = 1 / sigma``. Kind ``USER`` has
    ``source``, the :class:`~.device_source.DeviceSource` whose library the
    kernel runs, with ``params[1:]`` and ``arrays`` the source's."""

    kind: int
    params: tuple
    arrays: tuple = ()
    prior: tuple = ()
    source: object = None


def sum_squares(m):
    """``sum(m * m)`` over the last axis, summed in coordinate order with one
    fused multiply-add per term. This is how the slice kernel and XLA's CPU
    code accumulate it, so that densities agree bit for bit."""
    cols = m.unbind(-1)  # one autograd node for all the columns
    acc = cols[0] * cols[0]
    for c in cols[1:]:
        acc = f32math.fma(c, c, acc)
    return acc


def _guarded_mul(w, v):
    """``w * v`` with the convention ``0 * (-inf) = 0`` (the reference
    interpolator's endpoint short-circuit)."""
    return torch.where(w == 0.0, torch.zeros_like(v), w * v)


@dataclass(frozen=True)
class InterpolatingPath:
    """Linear path ``(1 - beta) ref(x) + beta target(x)`` between two batched
    log densities ``x [..., d] -> [...]``; ``sample_reference(keys) -> x``
    draws iid reference states for keys ``[..., 2]``.

    ``ref_coord_log_density`` / ``target_coord_log_density``: optional
    coordinate-wise decompositions ``(v, c) -> [...]``, batched over ``v``
    (``c`` a coordinate index, or indices that broadcast against ``v``), with
    ``log_density(x) == sum_c coord(x[..., c], c)``. The JAX package's
    Pallas sampler answers single-coordinate queries from them; here the
    runtime and the torch explorers evaluate the path through
    ``log_density`` and ignore them, as the JAX XLA ``SliceSampler`` does,
    and ``SliceSamplerCUDA`` takes such a path where it has a device density
    (kernel K2) or a ``coord_source``, the two terms as a user's CUDA source
    (:class:`~.device_source.DeviceSource`, hook ``"coord"``), which kernel
    K1 runs. The fields after them are the port's own, keyword only, so that
    a positional call means what it means to the JAX class."""

    ref_log_density: Callable
    target_log_density: Callable
    sample_reference: Optional[Callable] = None
    ref_coord_log_density: Optional[Callable] = None
    target_coord_log_density: Optional[Callable] = None
    _: KW_ONLY
    # set when the slice kernel can evaluate both endpoints on the device
    device: Optional[DeviceDensity] = None
    # x -> (ref_log_density(x), target_log_density(x)) where the two share work
    endpoints: Optional[Callable] = None
    # the same as the general slice kernel evaluates them, where that differs
    sweep_endpoints: Optional[Callable] = None
    # the coordinate terms as CUDA source for kernel K1 (a DeviceSource)
    coord_source: Optional[object] = None

    def log_density(self, x, beta):
        if self.endpoints is not None:
            lref, ltgt = self.endpoints(x)
        else:
            lref = self.ref_log_density(x)
            ltgt = self.target_log_density(x)
        return _guarded_mul(1.0 - beta, lref) + _guarded_mul(beta, ltgt)

    def sweep_log_density(self, x, beta):
        """The density as the general slice kernel evaluates it: from
        ``sweep_endpoints`` where the path has them, else
        :meth:`log_density`."""
        if self.sweep_endpoints is None:
            return self.log_density(x, beta)
        lref, ltgt = self.sweep_endpoints(x)
        return _guarded_mul(1.0 - beta, lref) + _guarded_mul(beta, ltgt)

    def device_density(self) -> Optional[DeviceDensity]:
        return self.device

    @property
    def has_iid_reference(self) -> bool:
        return self.sample_reference is not None

    @property
    def has_coordwise(self) -> bool:
        return self.ref_coord_log_density is not None and self.target_coord_log_density is not None

    def coord_log_density(self, v, c, beta):
        """Contribution of coordinate ``c`` holding ``v`` at ``beta``."""
        lref = self.ref_coord_log_density(v, c)
        ltgt = self.target_coord_log_density(v, c)
        return _guarded_mul(1.0 - beta, lref) + _guarded_mul(beta, ltgt)


@dataclass(frozen=True)
class ScaledPrecisionNormalPath:
    """Toy MVN path: N(0, I/prec(beta)) with prec(beta) linear from
    ``precision0`` to ``precision1`` (Syed et al. 2021 section I.4.1), with
    closed-form barrier and normalization oracles."""

    precision0: float
    precision1: float
    dim: int

    has_coordwise = True

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
        """iid draws at ``beta`` for keys ``[..., 2]``: ``[..., dim]``, in the
        betas' dtype (a Python number: the default float dtype). In float64
        XLA's ``rsqrt`` is the CPU's 14-bit estimate refined by two Newton
        steps, which ``torch.rsqrt`` can differ from in the last bits."""
        dtype = beta.dtype if torch.is_tensor(beta) else rng.float_dtype()
        beta = torch.as_tensor(beta, dtype=dtype, device=keys.device)
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


@dataclass(frozen=True)
class VariationalPath:
    """A path whose variational chains anneal from a fitted reference.

    The blend of ``pigeons_tpu/pt.py:646-658``: a lane with ``isvar > 0``,
    once ``ref_params["active"] > 0``, follows ``(1 - beta) q(x) + beta
    target(x)`` with ``q`` the variational reference's density under
    ``ref_params``; every other lane follows the fixed path. The runtime and
    the explorers evaluate a run's density through this one object
    (:func:`lane_log_density`), with ``isvar`` broadcasting against
    ``beta``."""

    fixed: object
    variational: object

    def use_variational(self, isvar, ref_params):
        return (isvar > 0) & (ref_params["active"] > 0)

    def log_density(self, x, beta, isvar, ref_params, sweep: bool = False):
        """``sweep``: the sums in the general slice kernel's order (the
        ``sweep_log_density`` of the fixed path and of the reference, where
        they have one)."""
        fixed, variational = self.fixed.log_density, self.variational.log_density
        if sweep:
            fixed = getattr(self.fixed, "sweep_log_density", fixed)
            variational = getattr(self.variational, "sweep_log_density", variational)
        l_fixed = fixed(x, beta)
        l_var_ref = variational(x, ref_params)
        l_target = fixed(x, torch.ones_like(beta))
        l_var = _guarded_mul(1.0 - beta, l_var_ref) + _guarded_mul(beta, l_target)
        return torch.where(self.use_variational(isvar, ref_params), l_var, l_fixed)

    def device_density(self) -> Optional[DeviceDensity]:
        """The fixed path's: the kernel takes the reference's parameters as
        arrays with every launch. ``None`` unless the reference is mean-field
        (``coord_param_arrays``)."""
        describe = getattr(self.fixed, "device_density", None)
        if describe is None or not hasattr(self.variational, "coord_param_arrays"):
            return None
        return describe()


def lane_log_density(path, x, beta, isvar=None, ref_params=None, sweep: bool = False):
    """The run's density of ``x [..., d]`` at ``beta``, NaN read as -inf (the
    guard for out-of-support evaluations): the one function through which the
    runtime and the explorers evaluate a path. ``isvar`` and ``ref_params``
    are read by a :class:`VariationalPath` only. With ``sweep`` a path that
    has a ``sweep_log_density`` answers with it: the same value with its sums
    in the order in which the general slice kernel adds them."""
    if isinstance(path, VariationalPath):
        lp = path.log_density(x, beta, isvar, ref_params, sweep)
    elif sweep:
        lp = getattr(path, "sweep_log_density", path.log_density)(x, beta)
    else:
        lp = path.log_density(x, beta)
    return torch.where(torch.isnan(lp), torch.full_like(lp, -float("inf")), lp)


def value_and_grad(path, x, beta, isvar=None, ref_params=None):
    """``(lp [B], grad [B, d])``: :func:`lane_log_density` of ``x [B, d]``
    and its gradient in ``x``, what the JAX package's explorers take from
    ``jax.value_and_grad`` of the lane's density. Lanes are independent, so
    the gradient of the sum of the lanes' densities is each lane's own."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        lp = lane_log_density(path, xg, beta, isvar, ref_params)
        (grad,) = torch.autograd.grad(lp.sum(), xg, allow_unused=True)
    if grad is None:  # a density that does not read x
        grad = torch.zeros_like(x)
    return lp.detach(), grad


def toy_mvn_path(dim: int) -> ScaledPrecisionNormalPath:
    """Reference ``ScaledPrecisionNormalPath(dim) = (1.0, 10.0, dim)``."""
    return ScaledPrecisionNormalPath(1.0, 10.0, dim)
