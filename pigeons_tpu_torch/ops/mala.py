"""MALA: Metropolis-adjusted Langevin with a fixed step size, over the batch.

Counterpart of ``pigeons_tpu/ops/mala.py`` (reference
``src/explorers/MALA.jl``): per exploration, ``base_n_refresh *
ceil(dim^exponent_n_refresh)`` momentum refreshments, each one
preconditioned leapfrog step followed by an MH correction with momentum
flip; the preconditioner (default the zero-one-inflated mixture) is rebuilt
from the estimated target std deviations at each refreshment, and the std
deviations are re-estimated between rounds. The step size is not adapted
(AutoMALA adapts it).

Streams as the JAX explorer derives them from a lane's key: refreshment
``i`` splits ``fold_in(key, i)`` three ways into the momentum's, the
preconditioner's and the MH uniform's keys.
"""

from __future__ import annotations

import math

import torch

from .. import f32math, rng
from .base import Explorer, StepOut, refuse_float64
from .hamiltonian import (LaneGradient, MixDiagonalPreconditioner, adapted_std_devs,
                          leapfrog1_cached, log_joint)


def select(mask, new, old):
    """``new`` where the lane's ``mask [B]`` is set, else ``old``."""
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


class GradientExplorer(Explorer):
    """What MALA and AutoMALA share: the number of refreshments, the adapted
    state ``{"step_size": [n_chains], "std_devs": [n_chains, d]}`` and its
    std deviations' re-estimation from the online moments."""

    def __init__(self, step_size: float = 1.0, base_n_refresh: int = 3,
                 exponent_n_refresh: float = 0.35, preconditioner=None):
        self.step_size = float(step_size)
        self.base_n_refresh = int(base_n_refresh)
        self.exponent_n_refresh = float(exponent_n_refresh)
        self.preconditioner = (
            preconditioner if preconditioner is not None else MixDiagonalPreconditioner()
        )

    def n_refresh(self, dim: int) -> int:
        return self.base_n_refresh * math.ceil(dim**self.exponent_n_refresh)

    def init_state(self, n_chains: int, dim: int, device=None):
        return {
            "step_size": torch.full((n_chains,), self.step_size, dtype=torch.float32,
                                    device=device),
            "std_devs": torch.ones((n_chains, dim), dtype=torch.float32, device=device),
        }

    def needs_online_moments(self) -> bool:
        return self.preconditioner.adapts

    def _std_devs(self, state, reduced):
        """The std deviations the preconditioner is built from next round."""
        if not self.preconditioner.adapts:
            return state["std_devs"]
        return adapted_std_devs(state["std_devs"], reduced)

    def _start(self, xs, betas, path, isvar, ref_params, lp, chain_params):
        """The lanes' gradient function, their density and raw gradient at
        ``xs`` (one evaluation seeds the whole step), and the chain params."""
        refuse_float64(self, xs)
        vg = LaneGradient(path, betas, isvar, ref_params)
        lp_start, raw_grad = vg(xs)
        if chain_params is None:
            chain_params = self.init_state(xs.shape[0], xs.shape[1], xs.device)
        return vg, (lp_start if lp is None else lp), raw_grad, chain_params


class MALA(GradientExplorer):
    def adapt(self, state, reduced, round_idx: int):
        return {"step_size": state["step_size"], "std_devs": self._std_devs(state, reduced)}

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        """``n_refresh`` MALA moves of every lane. The raw gradient at the
        current state rides the loop, so each move costs one density and
        gradient evaluation, at its proposal."""
        vg, lp, raw_grad, chain_params = self._start(xs, betas, path, isvar, ref_params, lp,
                                                     chain_params)
        step_size, std_devs = chain_params["step_size"], chain_params["std_devs"]
        B, d = xs.shape
        x = xs
        a_s = torch.zeros(B, dtype=torch.float32, device=xs.device)
        for i in range(self.n_refresh(d)):
            k_mom, k_prec, k_mh = rng.split(rng.fold_in(keys, i), 3).unbind(-2)
            precond = self.preconditioner.build(k_prec, std_devs)
            v = rng.normal(k_mom, (d,))
            h0 = log_joint(lp, v)
            x_new, v_new, lp_new, cgrad_new, ok = leapfrog1_cached(
                vg, precond, x, v, step_size, raw_grad / precond)
            h1 = log_joint(lp_new, v_new)  # the momentum flip leaves |v|^2 as it is
            pr = torch.where(ok, torch.clamp_max(f32math.exp(h1 - h0), 1.0), 0.0)
            accept = rng.uniform(k_mh) < pr
            x = select(accept, x_new, x)
            lp = torch.where(accept, lp_new, lp)
            raw_grad = select(accept, cgrad_new * precond, raw_grad)
            a_s = a_s + pr
        n = torch.full_like(a_s, float(self.n_refresh(d)))
        # n_steps counts leapfrogs, as the reference records them (MALA.jl:96)
        return StepOut(x, lp, a_s, n, n)

