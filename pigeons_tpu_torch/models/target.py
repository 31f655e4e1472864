"""Target interface: what a model must provide to be tempered.

Counterpart of ``pigeons_tpu/models/target.py``, for batched torch tensors:
``log_density(x [..., d]) -> [...]``, ``initialization(keys [..., 2]) ->
[..., d]``, a :class:`Reference` with a batched log density and iid sampler,
and ``create_path(reference)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import KW_ONLY, dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import rng
from ..paths import USER, DeviceDensity, InterpolatingPath, sum_squares


@dataclass(frozen=True)
class Reference:
    """A reference distribution: unnormalized log density + iid sampler."""

    log_density: Callable  # x [..., d] -> [...]
    sample_iid: Optional[Callable] = None  # keys [..., 2] -> x [..., d]
    # set when the reference is N(0, sigma^2 I), the one reference the
    # general-density slice kernel evaluates on the device
    normal_sigma: Optional[float] = None
    # set when the reference is the prior of this BayesianModel, the other
    # reference the kernel evaluates (from the model's prior table)
    prior_of: Optional[object] = None


class Target:
    dim: int
    # a DeviceSource of hook "target": the target's log density as CUDA
    # source, which kernel K2 runs under a normal reference
    source = None

    @property
    def device_source(self):
        """The ``DeviceSource`` that kernel K2 runs: ``source`` (a target
        that keeps something else there, a Stan program's text, sets its
        own)."""
        return self.source

    def log_density(self, x):
        raise NotImplementedError

    def default_reference(self) -> Reference:
        raise NotImplementedError

    def to(self, device) -> "Target":
        """The target with any tensors it holds on ``device``."""
        del device
        return self

    def default_explorer(self):
        """The slice sampler, with a target's ``integer_mask`` /
        ``binary_mask`` handed on."""
        from ..ops import SliceSampler

        masks = {name: getattr(self, name) for name in ("integer_mask", "binary_mask")
                 if getattr(self, name, None) is not None}
        return SliceSampler(**masks)

    def device_target(self) -> Optional[tuple]:
        """``(kind, params)`` of ``csrc/densities.cuh`` when the slice kernel
        can evaluate this target on the device, else ``None``."""
        return None

    def create_path(self, reference: Reference):
        """The linear path from ``reference``. Under ``N(0, sigma^2 I)`` the
        slice kernel K2 evaluates it from a library kind (``device_target``)
        or from the target's ``device_source``; the kernel's twin then
        evaluates the source's torch form beside the reference as the kernel
        does, unnormalized (``sweep_endpoints``)."""
        device = sweep = None
        target, source = self.device_target(), self.device_source
        if reference.normal_sigma is not None and (target is not None or source is not None):
            inv_sigma = float(np.float32(1.0) / np.float32(reference.normal_sigma))
            if target is not None:
                kind, params = target
                device = DeviceDensity(kind, (inv_sigma, *params))
            else:
                device = DeviceDensity(USER, (inv_sigma, *source.params), source.arrays, (), source)
                kernel_ref = StandardNormalReference(self.dim, reference.normal_sigma).as_reference()

                def sweep(x):
                    return kernel_ref.log_density(x), source.target(x)
        return InterpolatingPath(
            ref_log_density=reference.log_density,
            target_log_density=self.log_density,
            sample_reference=reference.sample_iid,
            device=device,
            sweep_endpoints=sweep,
        )

    def initialization(self, keys):
        ref = self.default_reference()
        if ref.sample_iid is None:
            return torch.zeros(keys.shape[:-1] + (self.dim,), dtype=torch.float32,
                               device=keys.device)
        return ref.sample_iid(keys)


@dataclass(frozen=True)
class CustomPath:
    """Any annealing path ``(x [..., d], beta) -> [...]``, not only the
    linear interpolation of two endpoints: the reference's ``path`` /
    ``interpolate`` interface implemented directly, e.g. the JuliaBUGS
    extension's ``logprior + beta * loglikelihood`` tempering.

    ``sample_reference``: optional ``keys [..., 2] -> x [..., d]``, iid draws
    at beta = 0 (reference-chain regeneration); ``sample_at``: optional
    ``(keys, betas) -> x``, iid draws at every beta (the ``ToyExplorer``).
    The torch explorers take it as it is; the CUDA slice kernel K2 takes it
    where it has ``source``, the path's density as CUDA source (a
    ``DeviceSource`` of hook ``"path"``), whose torch form the kernel's twin
    evaluates (``SliceSamplerCUDA.check_path`` raises without one)."""

    log_density_fn: Callable  # (x [..., d], beta) -> [...]
    sample_reference: Optional[Callable] = None
    sample_at: Optional[Callable] = None
    _: KW_ONLY
    source: Optional[object] = None

    def log_density(self, x, beta):
        return self.log_density_fn(x, beta)

    def sweep_log_density(self, x, beta):
        """The density as kernel K2 evaluates it: the source's torch form."""
        return self.log_density(x, beta) if self.source is None else self.source.path(x, beta)

    def device_density(self) -> Optional[DeviceDensity]:
        src = self.source
        return None if src is None else DeviceDensity(USER, (0.0, *src.params), src.arrays, (), src)

    @property
    def has_iid_reference(self) -> bool:
        return self.sample_reference is not None


class CustomPathTarget(Target):
    """A target defined by its annealing path (reference targets whose
    ``create_path`` does not return an interpolating path)."""

    def __init__(self, path: CustomPath, dim: int):
        self.path = path
        self.dim = dim

    def to(self, device) -> "CustomPathTarget":
        """The target with its path's source arrays on ``device`` (a
        ``log_density_fn`` that is the source's own torch form follows it)."""
        src = self.path.source
        if src is None:
            return self
        moved = src.to(device)
        fn = moved.path if self.path.log_density_fn == src.path else self.path.log_density_fn
        return CustomPathTarget(
            dataclasses.replace(self.path, log_density_fn=fn, source=moved), self.dim)

    def log_density(self, x):
        return self.path.log_density(x, 1.0)

    def default_reference(self) -> Reference:
        return Reference(log_density=lambda x: self.path.log_density(x, 0.0),
                         sample_iid=self.path.sample_reference)

    def create_path(self, reference):
        del reference
        return self.path

    def initialization(self, keys):
        if self.path.sample_reference is not None:
            return self.path.sample_reference(keys)
        return torch.zeros(keys.shape[:-1] + (self.dim,), dtype=torch.float32, device=keys.device)


@dataclass(frozen=True)
class StandardNormalReference:
    """N(0, sigma^2 I) reference, the generic default."""

    dim: int
    sigma: float = 1.0

    def as_reference(self) -> Reference:
        sigma, dim = self.sigma, self.dim
        inv_sigma = float(np.float32(1.0) / np.float32(sigma))

        def log_density(x):
            # -0.5 sum((x / sigma)^2) as XLA evaluates it: the division by a
            # constant is a multiplication by its reciprocal in the run's dtype
            inv = 1.0 / sigma if x.dtype == torch.float64 else inv_sigma
            return sum_squares(x * inv) * -0.5

        def sample_iid(keys):
            if rng.float_dtype() == torch.float64:
                # a float64 run's XLA folds sigma into the normal's sqrt(2)
                return rng.normal(keys, (dim,), scale=sigma)
            return float(np.float32(sigma)) * rng.normal(keys, (dim,))

        return Reference(log_density=log_density, sample_iid=sample_iid, normal_sigma=sigma)
