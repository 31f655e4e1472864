"""Densities a user supplies as CUDA source for the slice kernels.

The port's counterpart of the JAX package's Pallas kernels taking any traced
density (``SliceSamplerPallas.step_batched`` hoists a ``jnp`` density's
constants into kernel inputs). A :class:`DeviceSource` is a ``__device__``
function in CUDA C++ text, its float32 ``params`` and float32 ``arrays``,
beside the torch form of the same function. ``SliceSamplerCUDA`` compiles the
text into a library of its own at first use (``_build.build_user``; keyed by
a hash of the text, the headers and the flags) and runs it inside kernel K2 or
K1; on CPU tensors the kernels' twins evaluate the torch form, and the kernel
is held bit for bit to it on the card. ``csrc/user_density.cuh`` states each
hook's signature and what a source may call.

The hooks and their torch forms (``params`` a tuple of floats, ``arrays`` a
tuple of 1-D float32 tensors on the run's device):

* ``"target"``: ``pigeons_user_target(x, d, params, arrays)``; torch
  ``fn(x [..., d], params, arrays) -> [...]``. :class:`SourceTarget` is a
  target under ``N(0, sigma^2 I)`` (kernel K2).
* ``"path"``: ``pigeons_user_path(x, d, beta, params, arrays)``; torch
  ``fn(x, beta, params, arrays)``, for a ``CustomPath(..., source=...)``.
* ``"likelihood"``: ``pigeons_user_log_likelihood(theta, u, d, params,
  arrays)`` on the constrained values ``theta`` (and the unconstrained ``u``);
  torch ``fn(q, params, arrays)`` on ``BayesianModel``'s dict of constrained
  values (``q["log_name"]`` is ``u`` of a positive parameter). The model's
  likelihood is ``SourceLikelihood(source)``; its prior reaches K2 as the
  table of blocks.
* ``"coord"``: ``pigeons_user_ref_coord(v, c, params, arrays)`` and
  ``pigeons_user_target_coord(...)``; torch ``ref_fn(v, c, params, arrays)``
  (``torch_ref_fn``) and ``fn(v, c, params, arrays)``, ``c`` broadcasting
  against ``v``. :class:`SourceCoordTarget` is the separable target, whose
  path kernel K1 runs.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .models.target import Reference, StandardNormalReference, Target
from .paths import InterpolatingPath

# csrc/user_density.cuh: PIGEONS_USER_HOOK, and the function each hook defines
HOOKS = {"target": 0, "path": 1, "likelihood": 2, "coord": 3}
FUNCTIONS = {"target": ("pigeons_user_target",), "path": ("pigeons_user_path",),
             "likelihood": ("pigeons_user_log_likelihood",),
             "coord": ("pigeons_user_ref_coord", "pigeons_user_target_coord")}
MAX_PARAMS = 7  # csrc/densities.cuh: DensityParams less the reference's slot
MAX_ARRAYS = 4  # csrc/densities.cuh: DensityArrays


@dataclass(frozen=True, eq=False)
class DeviceSource:
    """A user's density as CUDA source and its torch form; see the module
    docstring for the hooks. ``code`` defines the hook's function(s) at
    global scope; ``params`` (at most 7) are rounded to float32; ``arrays``
    (at most 4) are 1-D float32 tensors, read by the kernel in place."""

    code: str
    hook: str
    torch_fn: Callable
    params: tuple = ()
    arrays: tuple = ()
    torch_ref_fn: Optional[Callable] = None  # the "coord" hook's reference term

    def __post_init__(self):
        if self.hook not in HOOKS:
            raise ValueError(f"DeviceSource: hook {self.hook!r} is not one of {sorted(HOOKS)}")
        if not isinstance(self.code, str):
            raise TypeError("DeviceSource: code is CUDA C++ text")
        for name in FUNCTIONS[self.hook]:
            if name not in self.code:
                raise ValueError(f"DeviceSource: a {self.hook!r} source defines __device__ float "
                                 f"{name}(...) (csrc/user_density.cuh)")
        if (self.torch_ref_fn is not None) != (self.hook == "coord"):
            raise ValueError("DeviceSource: torch_ref_fn is the reference's coordinate term, "
                             "given with the 'coord' hook and only with it")
        params = tuple(float(np.float32(v)) for v in self.params)
        if len(params) > MAX_PARAMS:
            raise ValueError(f"DeviceSource: {len(params)} params, the kernels take at most "
                             f"{MAX_PARAMS}: pass more as an array")
        arrays = tuple(self.arrays)
        if len(arrays) > MAX_ARRAYS:
            raise ValueError(f"DeviceSource: {len(arrays)} arrays, the kernels take at most "
                             f"{MAX_ARRAYS}")
        for i, a in enumerate(arrays):
            if not isinstance(a, torch.Tensor) or a.dtype != torch.float32 or a.dim() != 1:
                raise ValueError(f"DeviceSource: array {i} must be a 1-D float32 tensor")
        object.__setattr__(self, "params", params)
        object.__setattr__(self, "arrays", tuple(a.contiguous() for a in arrays))

    @property
    def key(self) -> str:
        """A hash of the text and the hook: part of the library's build key."""
        return hashlib.sha256(f"{self.hook}\0{self.code}".encode()).hexdigest()[:16]

    def to(self, device) -> "DeviceSource":
        """The source with its arrays on ``device``."""
        return dataclasses.replace(self, arrays=tuple(a.to(device) for a in self.arrays))

    # -- the torch forms, with the source's params and arrays --------------

    def target(self, x):
        return self.torch_fn(x, self.params, self.arrays)

    def path(self, x, beta):
        return self.torch_fn(x, beta, self.params, self.arrays)

    def log_likelihood(self, q):
        return self.torch_fn(q, self.params, self.arrays)

    def ref_coord(self, v, c):
        return self.torch_ref_fn(v, c, self.params, self.arrays)

    def target_coord(self, v, c):
        return self.torch_fn(v, c, self.params, self.arrays)


@dataclass(frozen=True)
class SourceLikelihood:
    """A ``BayesianModel`` likelihood from a ``"likelihood"`` source: its
    torch form on the dict of constrained values, and the source that kernel
    K2 runs (``BayesianModel.device_target``)."""

    source: DeviceSource

    def __post_init__(self):
        if self.source.hook != "likelihood":
            raise ValueError(f"SourceLikelihood takes a 'likelihood' source, not "
                             f"{self.source.hook!r}")

    def __call__(self, q):
        return self.source.log_likelihood(q)

    def to(self, device) -> "SourceLikelihood":
        return SourceLikelihood(self.source.to(device))


class SourceTarget(Target):
    """A target whose log density is a ``"target"`` source, under the
    reference ``N(0, sigma^2 I)`` (what kernel K2 blends it with)."""

    def __init__(self, source: DeviceSource, dim: int, sigma: float = 1.0):
        if source.hook != "target":
            raise ValueError(f"SourceTarget takes a 'target' source, not {source.hook!r}")
        self.source, self.dim, self.sigma = source, int(dim), float(sigma)

    def log_density(self, x):
        return self.source.target(x)

    def default_reference(self) -> Reference:
        return StandardNormalReference(self.dim, self.sigma).as_reference()

    def to(self, device) -> "SourceTarget":
        return SourceTarget(self.source.to(device), self.dim, self.sigma)


class SourceCoordTarget(Target):
    """A separable target from a ``"coord"`` source over ``dim``
    coordinates: its log density is the sum of the source's target terms,
    its reference's the sum of the reference terms, with iid draws from
    ``sample_reference(keys) -> x`` (``None``: no tempered restarts). From
    that reference the path has the coordinate-wise densities of the torch
    forms and ``coord_source``, which sends it to kernel K1's user term."""

    def __init__(self, source: DeviceSource, dim: int,
                 sample_reference: Optional[Callable] = None):
        if source.hook != "coord":
            raise ValueError(f"SourceCoordTarget takes a 'coord' source, not {source.hook!r}")
        self.source, self.dim, self.sample_reference = source, int(dim), sample_reference

    def _coords(self, x):
        return torch.arange(self.dim, device=x.device)

    def log_density(self, x):
        return torch.sum(self.source.target_coord(x, self._coords(x)), dim=-1)

    def ref_log_density(self, x):
        return torch.sum(self.source.ref_coord(x, self._coords(x)), dim=-1)

    def default_reference(self) -> Reference:
        return Reference(log_density=self.ref_log_density, sample_iid=self.sample_reference)

    def create_path(self, reference: Reference):
        own = reference.log_density == self.ref_log_density
        return InterpolatingPath(
            ref_log_density=reference.log_density,
            target_log_density=self.log_density,
            sample_reference=reference.sample_iid,
            ref_coord_log_density=self.source.ref_coord if own else None,
            target_coord_log_density=self.source.target_coord if own else None,
            coord_source=self.source if own else None,
        )

    def to(self, device) -> "SourceCoordTarget":
        return SourceCoordTarget(self.source.to(device), self.dim, self.sample_reference)
