"""Target interface: what a model must provide to be tempered.

Counterpart of ``pigeons_tpu/models/target.py``, for batched torch tensors:
``log_density(x [..., d]) -> [...]``, ``initialization(keys [..., 2]) ->
[..., d]``, a :class:`Reference` with a batched log density and iid sampler,
and ``create_path(reference)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..paths import InterpolatingPath


@dataclass(frozen=True)
class Reference:
    """A reference distribution: unnormalized log density + iid sampler."""

    log_density: Callable  # x [..., d] -> [...]
    sample_iid: Optional[Callable] = None  # keys [..., 2] -> x [..., d]


class Target:
    dim: int

    def log_density(self, x):
        raise NotImplementedError

    def default_reference(self) -> Reference:
        raise NotImplementedError

    def default_explorer(self):
        raise NotImplementedError(
            f"{type(self).__name__} has no default explorer in the port; pass "
            "Inputs.explorer (the XLA SliceSampler is ROADMAP queue 1, item 8b)"
        )

    def create_path(self, reference: Reference):
        return InterpolatingPath(
            ref_log_density=reference.log_density,
            target_log_density=self.log_density,
            sample_reference=reference.sample_iid,
        )

    def initialization(self, keys):
        ref = self.default_reference()
        if ref.sample_iid is None:
            return torch.zeros(keys.shape[:-1] + (self.dim,), dtype=torch.float32,
                               device=keys.device)
        return ref.sample_iid(keys)
