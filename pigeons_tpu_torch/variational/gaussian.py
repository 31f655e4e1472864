"""Mean-field Gaussian variational reference.

Counterpart of ``pigeons_tpu/variational/gaussian.py`` (reference
``src/variational/GaussianReference.jl``): a diagonal Gaussian fit by moment
matching to the online statistics of the target-chain samples, active from
round ``first_tuning_round`` on. Its parameters are a dict of tensors on the
run's device (``mean [d]``, ``std [d]``, ``active []``), replaced between
rounds; the ``active`` flag blends the fixed and the variational reference
inside the path (:class:`~..paths.VariationalPath`), so nothing is rebuilt
when the fit changes.

The densities take batches, ``x [..., d]``. The coordinate term is written as
XLA's CPU backend evaluates the JAX one: ``log((2 pi std) std)`` with the
Cephes polynomial, a true division by ``std``, and no fused multiply-add (the
two products by 0.5 are exact either way).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import f32math, rng

TWO_PI = float(np.float32(2.0 * np.pi))


@dataclass(frozen=True)
class GaussianReference:
    first_tuning_round: int = 6

    def init_params(self, dim: int, device=None) -> dict:
        return {
            "mean": torch.zeros(dim, dtype=torch.float32, device=device),
            "std": torch.ones(dim, dtype=torch.float32, device=device),
            "active": torch.zeros((), dtype=torch.float32, device=device),
        }

    def active(self, round_idx: int) -> bool:
        return round_idx >= self.first_tuning_round

    def fit(self, params: dict, reduced, round_idx: int) -> dict:
        """Moment-matching update from the online recorder of target-chain
        samples (numpy, on the host); the variance is floored at 1e-12."""
        if not self.active(round_idx):
            return params
        device = params["mean"].device
        mean = np.asarray(reduced.online_mean[:-1], dtype=np.float32)
        std = np.sqrt(np.maximum(np.asarray(reduced.online_var[:-1]), 1e-12)).astype(np.float32)
        return {
            "mean": torch.tensor(mean, device=device),
            "std": torch.tensor(std, device=device),
            "active": torch.ones((), dtype=torch.float32, device=device),
        }

    @staticmethod
    def coord_param_arrays(params: dict) -> tuple:
        """Per-coordinate parameter vectors consumed by ``coord_log_density``."""
        return (params["mean"], params["std"])

    @staticmethod
    def coord_log_norm(std_c):
        """``-0.5 log(2 pi std_c^2)``: the summand of a coordinate's term that
        does not depend on the value."""
        return -0.5 * f32math.log((TWO_PI * std_c) * std_c)

    @staticmethod
    def coord_log_density(v, mean_c, std_c, log_norm=None):
        """Coordinate ``c``'s contribution, given its own mean and std (and
        its ``coord_log_norm``, where the caller keeps it between calls)."""
        if log_norm is None:
            log_norm = GaussianReference.coord_log_norm(std_c)
        q = (v - mean_c) / std_c
        return log_norm - 0.5 * (q * q)

    @staticmethod
    def log_density(x, params: dict):
        terms = GaussianReference.coord_log_density(x, params["mean"], params["std"])
        return torch.sum(terms, dim=-1)

    @staticmethod
    def sweep_log_density(x, params: dict):
        """:meth:`log_density` with the coordinates added in order, as the
        general slice kernel and XLA's CPU code add them."""
        terms = GaussianReference.coord_log_density(x, params["mean"], params["std"])
        acc = terms[..., 0]
        for i in range(1, terms.shape[-1]):
            acc = acc + terms[..., i]
        return acc

    @staticmethod
    def sample(keys, params: dict):
        """One draw for every key of ``keys [..., 2]``: ``[..., d]``."""
        mean, std = params["mean"], params["std"]
        return mean + std * rng.normal(keys, tuple(mean.shape))
