"""Hamiltonian dynamics over the batch: preconditioned leapfrog in velocity
space, and the preconditioners.

Counterpart of ``pigeons_tpu/ops/hamiltonian.py`` (reference
``src/explorers/hamiltonian_dynamics.jl``, ``Preconditioner.jl``). The mass
matrix M approximates the inverse target covariance; the integrator works
with the velocity y = M^{-1/2} p ~ N(0, I):

    y* = y + (eps/2) M^{-1/2} grad(log pi)(x)
    x' = x + eps M^{-1/2} y*
    y' = y* + (eps/2) M^{-1/2} grad(log pi)(x')

with the preconditioner ``precond`` = M^{1/2} stored as a vector per lane.
The JAX package writes these for one lane and vmaps them; here every
function takes the batch: states ``[B, d]``, step sizes ``[B]`` (or a
float), and a ``vg(x) -> (lp [B], grad [B, d])``, the lanes' densities and
their gradients (:class:`LaneGradient`). A divergence (a non-finite
joint) flags the lane's move invalid.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import rng
from ..paths import value_and_grad


def _squared_norm(v):
    return torch.sum(v * v, dim=-1)


def lane_dot(a, b):
    """``a . b`` of each lane: ``[B, d]`` x ``[B, d]`` -> ``[B]``."""
    return torch.sum(a * b, dim=-1)


def adapted_std_devs(std_devs, reduced):
    """The target's std deviations from the online variance recorder (the
    reference's ``_transformed_online``; its last entry is the log density),
    one row per chain of ``std_devs [n_chains, d]``: what an adapting
    preconditioner is built from between rounds."""
    std = np.sqrt(np.maximum(reduced.online_var[:-1], 0.0)).astype(np.float32)
    return torch.tensor(std, device=std_devs.device).expand(std_devs.shape[0], -1).clone()


def log_joint(lp, v):
    """``lp - |v|^2 / 2`` of each lane: ``lp [B]``, ``v [B, d]``."""
    return lp - 0.5 * _squared_norm(v)


def _per_lane(step):
    """A step size ``[B]`` (or a float) as a column against ``[B, d]``."""
    return step[:, None] if torch.is_tensor(step) and step.dim() == 1 else step


class LaneGradient:
    """``value_and_grad`` of each lane's density at its own ``beta`` (and
    ``isvar``), as the runtime gives them to an explorer; :meth:`at` is the
    same for a subset of the lanes, in the order of ``idx``."""

    def __init__(self, path, betas, isvar=None, ref_params=None):
        self.path, self.betas, self.isvar, self.ref_params = path, betas, isvar, ref_params

    def __call__(self, x):
        return value_and_grad(self.path, x, self.betas, self.isvar, self.ref_params)

    def at(self, idx) -> "LaneGradient":
        isvar = None if self.isvar is None else self.isvar[idx]
        return LaneGradient(self.path, self.betas[idx], isvar, self.ref_params)


def value_and_cond_grad(vg, x, precond):
    """``(log pi(x), M^{-1/2} grad log pi(x))`` of every lane, from ``vg(x)
    -> (lp, grad)``."""
    lp, grad = vg(x)
    return lp, grad / precond


def leapfrog1_cached(vg, precond, x, v, step_size, cgrad0):
    """One leapfrog step from ``(x, v)`` with the start point's conditioned
    gradient ``cgrad0 = grad(log pi)(x) / precond`` supplied by the caller:
    within AutoMALA's search the start point is fixed across every trial, so
    its gradient is computed once per refresh. Returns ``(x', v', lp',
    cgrad', ok)``, ``ok [B]`` False where the lane diverged."""
    e = _per_lane(step_size)
    v1 = v + (0.5 * e) * cgrad0
    x1 = x + e * (v1 / precond)
    lp1, cgrad1 = value_and_cond_grad(vg, x1, precond)
    v2 = v1 + (0.5 * e) * cgrad1
    ok = torch.isfinite(log_joint(lp1, v1)) & torch.isfinite(_squared_norm(v2))
    return x1, v2, lp1, cgrad1, ok


def leapfrog(vg, precond, x, v, step_size, n_steps: int = 1):
    """``n_steps`` leapfrog steps with Neal's merged half-steps. Returns
    ``(x', v', lp', ok)``, ``ok`` False on divergence (reference
    ``hamiltonian_dynamics.jl:39-77`` returns false)."""
    e = _per_lane(step_size)
    lp, grad = value_and_cond_grad(vg, x, precond)
    v = v + (0.5 * e) * grad
    ok = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for i in range(n_steps):
        x = x + e * (v / precond)
        lp, grad = value_and_cond_grad(vg, x, precond)
        ok = ok & torch.isfinite(log_joint(lp, v))
        if i < n_steps - 1:  # the merged full step on the velocity
            v = v + e * grad
    v = v + (0.5 * e) * grad
    return x, v, lp, ok & torch.isfinite(_squared_norm(v))


# ---------------------------------------------------------------------------
# preconditioners: build(keys [B, 2], std_devs [B, d]) -> M^{1/2} [B, d]
# ---------------------------------------------------------------------------


def _inverse_std(std_devs):
    return torch.where(std_devs == 0.0, torch.ones_like(std_devs), 1.0 / std_devs)


@dataclass(frozen=True)
class IdentityPreconditioner:
    adapts = False

    def build(self, keys, std_devs):
        return torch.ones_like(std_devs)


@dataclass(frozen=True)
class DiagonalPreconditioner:
    adapts = True

    def build(self, keys, std_devs):
        return _inverse_std(std_devs)


@dataclass(frozen=True)
class MixDiagonalPreconditioner:
    """The zero-one-inflated random mixture ``mix + (1 - mix) / std`` with
    ``P(mix = 0) = p0``, ``P(mix = 1) = p1``, else ``mix ~ U(0, 1)``
    (reference ``Preconditioner.jl:53-76``); defaults p0 = p1 = 1/3."""

    p0: float = 1.0 / 3.0
    p1: float = 1.0 / 3.0
    adapts = True

    def __post_init__(self):
        if not 0.0 <= self.p0 + self.p1 <= 1.0:
            raise ValueError("p0 + p1 must lie in [0, 1]")

    def build(self, keys, std_devs):
        u, mix = rng.uniform(rng.split(keys)).unbind(-1)  # from the two children
        u, mix = u[:, None], mix[:, None]
        inv = _inverse_std(std_devs)
        one = torch.ones_like(inv)
        blended = torch.where(std_devs == 0.0, one, mix + (1.0 - mix) * inv)
        return torch.where(u <= self.p0, inv, torch.where(u <= self.p0 + self.p1, one, blended))
