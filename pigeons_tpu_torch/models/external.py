"""External targets: a batched host function as the density, and lazy
construction.

Counterpart of ``pigeons_tpu/models/external.py`` (reference
``src/targets/StreamTarget.jl``, ``src/targets/LazyTarget.jl``).
``ExternalTarget`` calls the user's numpy function once on the whole block
of lanes ``[B, dim]``: the lanes are copied to the host and the float32
result back to their device, as the JAX package's ``jax.pure_callback``
with ``vmap_method="expand_dims"`` hands the callback the vmapped batch. It
is the slow compatibility path: every evaluation crosses to the host. torch
runs eagerly, so no data dependency has to order the host calls (the JAX
runtime's ``lp_guard``).

``LazyTarget`` defers building the target to each process, for targets that
hold what cannot be pickled: a checkpoint or a ``ChildProcess`` stores only
the flag, and each process builds the target on first use
(``register_lazy_target``) and caches it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .target import Reference, StandardNormalReference, Target


class ExternalTarget(Target):
    host_evaluated = True

    def __init__(self, batch_log_density: Callable[[np.ndarray], np.ndarray], dim: int,
                 reference: Optional[Reference] = None):
        """``batch_log_density``: host function ``[batch, dim] -> [batch]``
        float32."""
        self._host_fn = batch_log_density
        self.dim = dim
        self._reference = reference

    def log_density(self, x):
        """One call of the host function on the block ``x [..., dim]``: one
        copy to the host and one back."""
        lead = x.shape[:-1]
        xb = x.detach().reshape(-1, self.dim).cpu().numpy()
        out = np.asarray(self._host_fn(xb), dtype=np.float32).reshape(lead)
        return torch.from_numpy(out).to(x.device)

    def default_reference(self) -> Reference:
        if self._reference is not None:
            return self._reference
        return StandardNormalReference(self.dim).as_reference()


_lazy_cache: dict = {}
_lazy_constructors: dict = {}


def instantiate_target(flag) -> Target:
    """Override/register per flag (reference ``instantiate_target``)."""
    raise NotImplementedError("register a constructor with register_lazy_target(flag, fn)")


def register_lazy_target(flag: Any, constructor: Callable[[], Target]) -> None:
    _lazy_constructors[flag] = constructor


@dataclass(frozen=True)
class LazyTarget(Target):
    """Wraps a picklable flag; the target itself is built lazily in each
    process (reference ``LazyTarget.jl:17-47``)."""

    flag: Any

    def _resolved(self) -> Target:
        if self.flag not in _lazy_cache:
            build = _lazy_constructors.get(self.flag)
            _lazy_cache[self.flag] = build() if build is not None else instantiate_target(self.flag)
        return _lazy_cache[self.flag]

    def to(self, device) -> "LazyTarget":
        """The built target moved to ``device`` in this process's cache."""
        _lazy_cache[self.flag] = self._resolved().to(device)
        return self

    @property
    def dim(self):
        return self._resolved().dim

    @property
    def host_evaluated(self):
        return getattr(self._resolved(), "host_evaluated", False)

    def log_density(self, x):
        return self._resolved().log_density(x)

    def default_reference(self):
        return self._resolved().default_reference()

    def default_explorer(self):
        return self._resolved().default_explorer()

    def create_path(self, reference):
        return self._resolved().create_path(reference)

    def initialization(self, keys):
        return self._resolved().initialization(keys)

    def __getstate__(self):
        return {"flag": self.flag}

    def __setstate__(self, state):
        object.__setattr__(self, "flag", state["flag"])
