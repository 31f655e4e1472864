"""BayesianModel: named, constrained parameters with priors plus a
likelihood, compiled to an unconstrained flat-vector target.

Counterpart of ``pigeons_tpu/models/bayesian.py`` on batched tensors: every
method takes ``x [..., dim]`` and returns ``[...]``. The conventions are the
JAX package's: the default reference is the prior (iid-sampleable, so that
tempered restarts work), the annealed density is ``prior + beta likelihood``,
initialization draws from the prior and maps to unconstrained space, and
``sample_names`` / ``constrained_samples`` speak of constrained values.

The likelihood is a batched function of the dict of constrained tensors. One
that can also run inside the general slice kernel (``csrc/densities.cuh``) is
an object with ``device() -> (kind, params, arrays)`` and ``to(device)``; the
library's models are such (``models/library.py``). A user's likelihood
reaches the kernel as CUDA source: an object with ``source``, a
``DeviceSource`` of hook ``"likelihood"`` (``device_source.SourceLikelihood``).
The prior reaches the kernel as a table of blocks, one per prior, so a new
prior needs no kernel code as long as its distribution has a ``device_block``
(all seven have one). The kernel evaluates the path from the model's own
prior or from ``N(0, sigma^2 I)`` (a ``Reference`` with ``normal_sigma``).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .. import rng
from ..paths import USER, DeviceDensity, InterpolatingPath
from .distributions import IDENTITY, INTERVAL, POSITIVE, Interval
from .target import Reference, Target

MAX_PRIOR_BLOCKS = 8  # csrc/densities.cuh: PriorTable


class BayesianModel(Target):
    def __init__(self, priors: Dict[str, "Distribution"], log_likelihood: Callable):
        """``priors``: ordered name -> Distribution (with shape/bijector);
        ``log_likelihood(q) -> [...]``: batched function of the dict of
        constrained parameter tensors ``[..., *shape]``."""
        self.priors = dict(priors)
        self.log_likelihood_fn = log_likelihood
        self._slices = {}
        off = 0
        for name, dist in self.priors.items():
            self._slices[name] = (off, dist.size, dist.shape)
            off += dist.size
        self.dim = off
        if getattr(log_likelihood, "source", None) is not None and self.prior_table() is None:
            raise ValueError(
                f"BayesianModel: a likelihood with a CUDA source runs inside kernel K2, whose "
                f"prior table takes at most {MAX_PRIOR_BLOCKS} priors; this model has "
                f"{len(self.priors)}")

    def to(self, device) -> "BayesianModel":
        """The model with its likelihood's data on ``device``."""
        move = getattr(self.log_likelihood_fn, "to", None)
        return self if move is None else BayesianModel(self.priors, move(device))

    # -- parameter vector <-> constrained dict -----------------------------

    def constrain(self, x):
        """Unconstrained ``x [..., dim]`` -> (dict of constrained values
        ``[..., *shape]``, log-Jacobian ``[...]``). The log-Jacobian adds one
        summand per prior in dict order; an identity's zero is not added.
        For a prior ``name`` on the positive reals the dict also has
        ``log_name``, the unconstrained coordinates themselves: XLA folds
        ``log(exp(u))`` to ``u``, and a likelihood that needs the log reads it
        there."""
        q = {}
        logjac = None
        for name, dist in self.priors.items():
            off, size, shape = self._slices[name]
            u = x[..., off: off + size].reshape(x.shape[:-1] + shape)
            val, lj = dist.bijector.forward(u, shape)
            q[name] = val
            if dist.bijector.kind == POSITIVE:
                q[f"log_{name}"] = u
            if dist.bijector.kind != IDENTITY:
                logjac = lj if logjac is None else logjac + lj
        if logjac is None:
            logjac = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        return q, logjac

    def unconstrain(self, q, fused: bool = True) -> torch.Tensor:
        """Constrained values back to the flat unconstrained vector; with
        ``fused`` false, as the JAX package's op-by-op evaluation gives it
        (``Interval.inverse``)."""
        parts = []
        for name, dist in self.priors.items():
            _, size, shape = self._slices[name]
            bijector = dist.bijector
            v = bijector.inverse(q[name]) if fused or not isinstance(bijector, Interval) else \
                bijector.inverse(q[name], False)
            parts.append(v.reshape(v.shape[: v.dim() - len(shape)] + (size,)))
        return torch.cat(parts, dim=-1)

    def sample_names(self):
        """Flat constrained-variable names, then ``log_density``."""
        names = []
        for name, dist in self.priors.items():
            if dist.shape == ():
                names.append(name)
            else:
                names.extend(f"{name}[{i}]" for i in range(dist.size))
        return names + ["log_density"]

    # -- densities in unconstrained space ----------------------------------

    def log_prior(self, x):
        return self._prior_of(*self.constrain(x))

    def _prior_of(self, q, logjac):
        """The log-Jacobian, then each prior's log density in dict order; the
        priors whose log density is a constant (``Uniform``) are added last,
        as one constant: XLA folds their float32 sum (in dict order) and adds
        it once (read off the slice kernel's densities of ``mrna_target``,
        five uniform priors); a constant 0 is not added."""
        lp = logjac
        constant = None
        for name, dist in self.priors.items():
            total = getattr(dist, "total", None)
            if total is None:
                lp = lp + dist.log_prob(q[name])
            elif total != 0.0:
                constant = np.float32(total) if constant is None else np.float32(constant + np.float32(total))
        return lp if constant is None else lp + float(constant)

    def log_likelihood(self, x):
        q, _ = self.constrain(x)
        return self.log_likelihood_fn(q)

    def log_density(self, x):
        return self.log_prior(x) + self.log_likelihood(x)

    def prior_and_posterior(self, x):
        """``(log_prior(x), log_density(x))`` from one ``constrain`` and one
        evaluation of the prior, where the two methods take three and two:
        the two ends of the annealing path, with the bits of the two methods.
        The runtime's density pass is eager torch operations: with this a
        scan of the hierarchical normal (32 chains x 256 ladders) is 11,425
        device operations, without it 14,705 (``chip_smoke.py --profile``)."""
        q, logjac = self.constrain(x)
        lp = self._prior_of(q, logjac)
        return lp, lp + self.log_likelihood_fn(q)

    def sweep_prior_and_posterior(self, x):
        """:meth:`prior_and_posterior` with the likelihood as the general
        slice kernel evaluates it: its ``sweep`` where it has one (the
        logistic regression's column form, which its call may not take)."""
        q, logjac = self.constrain(x)
        lp = self._prior_of(q, logjac)
        return lp, lp + getattr(self.log_likelihood_fn, "sweep", self.log_likelihood_fn)(q)

    # -- target interface ---------------------------------------------------

    def _prior_draws(self, keys, fused: bool):
        # jax.random.split(key, n): child i is fold_in(key, i)
        q = {name: dist.sample(rng.fold_in(keys, i), fused)
             for i, (name, dist) in enumerate(self.priors.items())}
        return self.unconstrain(q, fused)

    def default_reference(self) -> Reference:
        return Reference(log_density=self.log_prior,
                         sample_iid=lambda keys: self._prior_draws(keys, True), prior_of=self)

    def initialization(self, keys):
        """The prior's draws as the JAX package makes its initial states: op
        by op (an eager ``vmap``, ``pigeons_tpu/pt.py:756``), where the
        reference chain's later draws run inside its compiled scan. The two
        differ for a ``Uniform`` prior other than on (0, 1): there XLA fuses
        the draw's scaling into a multiply-add and divides by the interval's
        width through its reciprocal (``Uniform.sample``,
        ``Interval.inverse``), and for a ``Beta`` prior, whose compiled draw
        folds the functions of its parameters (``rng.beta``)."""
        return self._prior_draws(keys, False)

    def prior_table(self):
        """The prior as the slice kernel reads it: one row ``(offset, size,
        distribution kind, bijector kind, p0, p1, p2, p3)`` per prior, with
        ``p0..p2`` the distribution's ``device_block`` parameters and ``p3``
        the log width of an interval bijector; ``None`` where a distribution
        has no ``device_block`` or there are more than ``MAX_PRIOR_BLOCKS``
        priors."""
        rows = []
        for name, dist in self.priors.items():
            block = dist.device_block
            if block is None:
                return None
            off, size, _ = self._slices[name]
            bijector = dist.bijector
            log_width = bijector.log_width if bijector.kind == INTERVAL else 0.0
            rows.append((off, size, block[0], bijector.kind, *block[1], log_width))
        return tuple(rows) if len(rows) <= MAX_PRIOR_BLOCKS else None

    def device_target(self):
        """``(kind, params, arrays, prior table)`` when the slice kernel has
        this model's likelihood (a library kind, or ``USER`` for a likelihood
        with a CUDA source) and every prior, else ``None``."""
        describe = getattr(self.log_likelihood_fn, "device", None)
        source = getattr(self.log_likelihood_fn, "source", None)
        table = self.prior_table()
        if table is None:
            return None
        if describe is not None:
            kind, params, arrays = describe()
            return kind, tuple(params), tuple(arrays), table
        if source is not None:
            return USER, source.params, source.arrays, table
        return None

    def _is_own_prior(self, reference: Reference) -> bool:
        """Whether ``reference`` is the ``default_reference()`` of this model
        or of a copy of it with its data elsewhere (:meth:`to`): the same
        distributions under the same names, in the same order."""
        other = reference.prior_of
        return (isinstance(other, BayesianModel)
                and list(other.priors) == list(self.priors)
                and all(other.priors[name] is dist for name, dist in self.priors.items()))

    def create_path(self, reference: Reference):
        """Prior to posterior. The kernel evaluates the path from this
        model's own prior (``params[0] = 0``) or from ``N(0, sigma^2 I)``
        (``params[0] = 1 / sigma``); with any other reference ``device``
        stays ``None``."""
        device = sweep = None
        target = self.device_target()
        own_prior = self._is_own_prior(reference)
        if target is not None and (own_prior or reference.normal_sigma is not None):
            kind, params, arrays, table = target
            ref0 = 0.0 if own_prior else float(np.float32(1.0) / np.float32(reference.normal_sigma))
            device = DeviceDensity(kind, (ref0, *params), arrays, table,
                                   getattr(self.log_likelihood_fn, "source", None))
            if own_prior:
                sweep = self.sweep_prior_and_posterior
            else:
                def sweep(x):
                    return reference.log_density(x), self.sweep_prior_and_posterior(x)[1]
        return InterpolatingPath(
            ref_log_density=reference.log_density,
            target_log_density=self.log_density,
            sample_reference=reference.sample_iid,
            device=device,
            endpoints=self.prior_and_posterior if own_prior else None,
            sweep_endpoints=sweep,
        )

    def constrained_samples(self, pt) -> Dict[str, np.ndarray]:
        """Map a PT's unconstrained trace back to constrained space."""
        xs = torch.as_tensor(pt.sample_array()[:, :-1], dtype=torch.float32)
        q = self.constrain(xs)[0]
        return {name: q[name].numpy() for name in self.priors}
