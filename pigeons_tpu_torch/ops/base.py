"""Explorer interface: within-chain MCMC moves over the whole replica batch.

Counterpart of ``pigeons_tpu/ops/base.py``. The JAX package writes an
explorer's ``step`` for one replica and vmaps it; here an explorer takes the
batch ``[B, d]`` at once through ``step_batched(keys, xs, betas, path,
isvar=None, ref_params=None, lp=None, chain_params=None, scan_idx=None)``,
with ``keys [B, 2]`` the lanes' keys, ``betas [B]`` their annealing
parameters and, for a run with a variational reference (``path`` is then a
:class:`~..paths.VariationalPath`), the lanes' ``isvar [B]`` and the
reference's parameters; ``lp [B]`` is the density of ``xs`` that the runtime
carries from scan to scan. ``chain_params`` is the explorer's adapted state
(``init_state``, every tensor ``[n_chains, ...]``) gathered at each lane's
chain, and ``scan_idx`` the scan's index in its round, from 1. It returns a
:class:`StepOut` whose statistics are ``[B]`` tensors, and for an explorer
with ``extra_names`` ``[B, K]`` sums and counts of its own statistics. The
runtime computes the density of the moved states itself, fused with the
swap's partner-beta evaluation, so ``StepOut.lp`` may be ``None``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class StepOut(NamedTuple):
    x: torch.Tensor
    lp: Optional[torch.Tensor]  # log density at the lane's beta, when computed
    accept_sum: torch.Tensor  # contribution to explorer_acceptance_pr
    accept_n: torch.Tensor
    n_steps: torch.Tensor  # contribution to explorer_n_steps (density evals)
    extras_sum: Optional[torch.Tensor] = None  # [B, K], K = len(extra_names)
    extras_n: Optional[torch.Tensor] = None


def _zero_stats(B: int, device):
    z = torch.zeros(B, dtype=torch.float32, device=device)
    return z, z, z


def refuse_float64(explorer, xs) -> None:
    """Raise the ``TypeError`` that the JAX package raises for this explorer
    in a float64 run: its loop carries a float32 statistic (MALA's and
    AutoMALA's summed acceptance, NUTS's tree statistics) to which a float64
    acceptance is added, and ``jax.lax`` refuses a carry whose dtype
    changes. ROADMAP §3 records this fault of the reference."""
    if xs.dtype == torch.float64:
        raise TypeError(
            f"{type(explorer).__name__} does not run in float64: the JAX package's loop "
            "carries a float32 statistic that a float64 acceptance promotes (scan body "
            "function carry input and carry output must have equal types); use "
            "SliceSampler() or AAPS() in a float64 run")


class Explorer:
    extra_names: tuple = ()

    def check_target(self, target) -> None:
        """Raise if this explorer cannot move ``target``'s states."""

    def check_path(self, path) -> None:
        """Raise if this explorer cannot move along ``path``."""

    def check_dtype(self, dtype) -> None:
        """Raise if this explorer cannot run in ``dtype`` (``Inputs.dtype``)."""

    def init_state(self, n_chains: int, dim: int, device=None):
        """The per-chain adapted state: a dict of tensors ``[n_chains, ...]``
        on ``device``, or ``()`` for an explorer that adapts nothing."""
        return ()

    def needs_online_moments(self) -> bool:
        """Whether ``adapt`` reads ``reduced.online_var``: the runtime then
        records the online moments whatever ``Inputs.record`` says."""
        return False

    def supports_ref_params(self, ref_params) -> bool:
        """Whether this explorer moves lanes whose density reads a
        variational reference's ``ref_params``."""
        return True

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        raise NotImplementedError

    def adapt(self, state, reduced, round_idx: int):
        return state


class ToyExplorer(Explorer):
    """iid regeneration at every chain, for paths that are iid-sampleable at
    every beta (reference ``src/explorers/ToyExplorer.jl``)."""

    def __init__(self, path=None):
        self.path = path  # provides sample_at(keys, betas); the run's path if None

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        x_new = (self.path or getattr(path, "fixed", path)).sample_at(keys, betas)
        return StepOut(x_new, None, *_zero_stats(xs.shape[0], xs.device))


class NoOpExplorer(Explorer):
    """Identity move (the TestSwapper toy target's explorer)."""

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        return StepOut(xs, None, *_zero_stats(xs.shape[0], xs.device))
