"""2-D Ising model: the discrete-state example.

Counterpart of ``pigeons_tpu/models/ising.py`` (reference
``examples/ising.jl``): ``p(state)`` proportional to ``exp(beta_ising
sum_<ij> s_i s_j)`` over the neighbour pairs of an ``L x L`` torus, spins
``s = 2 x - 1`` for a float state ``x`` in {0, 1}^(L^2); the annealing
reference is iid Bernoulli(1/2), explored with exact binary Gibbs updates
(``ops.BinaryGibbs``). The pair sum adds integers, so it is exact in float32
and bitwise the JAX package's whatever the order.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from .. import rng
from .target import Reference, Target


@dataclass(frozen=True)
class IsingTarget(Target):
    beta_ising: float = 1.0
    base_length: int = 5

    @property
    def dim(self):
        return self.base_length * self.base_length

    def _pair_sum(self, x):
        L = self.base_length
        s = (2.0 * x - 1.0).reshape(x.shape[:-1] + (L, L))
        # periodic torus: each undirected neighbour pair counted once
        rows = (s * torch.roll(s, 1, dims=-2)).sum(dim=(-2, -1))
        return rows + (s * torch.roll(s, 1, dims=-1)).sum(dim=(-2, -1))

    def log_density(self, x):
        return self.beta_ising * self._pair_sum(x)

    def default_reference(self) -> Reference:
        d = self.dim
        return Reference(
            log_density=lambda x: torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device),
            sample_iid=lambda keys: (rng.uniform(keys, (d,)) < 0.5).to(torch.float32),
        )

    def default_explorer(self):
        from ..ops.binary_gibbs import BinaryGibbs

        return BinaryGibbs()

    def initialization(self, keys):
        return self.default_reference().sample_iid(keys)

    def enumerate_oracle(self):
        """Exact log Z (relative to the Bernoulli(1/2) reference) and mean
        ``|M|`` by enumerating all ``2^(L^2)`` states (``L <= 4``)."""
        n = self.dim
        if n > 16:
            raise ValueError("enumeration only for tiny lattices")
        states = np.array(list(itertools.product([0.0, 1.0], repeat=n)), np.float32)
        lps = self.log_density(torch.from_numpy(states)).numpy()  # float32, as the JAX oracle
        lz = np.logaddexp.reduce(lps) - n * np.log(2.0)
        w = np.exp(lps - lps.max())
        w /= w.sum()
        mag = np.abs((2.0 * states - 1.0).mean(axis=1))
        return float(lz), float((w * mag).sum())


def ising_target(beta_ising: float = 1.0, base_length: int = 5) -> IsingTarget:
    return IsingTarget(beta_ising, base_length)
