"""Constant-acceptance toy swapper isolating communication from exploration.

Counterpart of ``pigeons_tpu/models/test_swapper.py`` (reference
``src/swap/pair_swapper.jl:100-149``): every swap is accepted with a fixed
probability, there is no state to speak of and no swap statistic is recorded;
used for the exact round-trip counts and for timing communication alone.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .target import Reference, Target


def _zeros(x):
    return torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)


@dataclass(frozen=True)
class TestSwapper(Target):
    constant_swap_accept_pr: float

    dim: int = 1

    __test__ = False  # not a test class, whatever its name says to pytest

    def log_density(self, x):
        return _zeros(x)

    def default_reference(self) -> Reference:
        return Reference(log_density=_zeros, sample_iid=None)

    def default_explorer(self):
        from ..ops import NoOpExplorer

        return NoOpExplorer()

    def swap_accept_fn(self):
        """Consumed by the runtime in place of the Metropolis acceptance."""
        pr = self.constant_swap_accept_pr
        return lambda stat_sum: torch.full_like(stat_sum, pr)
