"""Exact invariance test (modified Geweke): does one explorer step leave the
target invariant?

Counterpart of ``pigeons_tpu/invariance_test.py`` (reference
``src/explorers/invariance_test.jl``): draw N iid samples of the target by
forward simulation, draw N more and move each by ONE explorer step, and
compare the marginals of the two batches with two-sample KS tests at a
Bonferroni-corrected threshold (default 0.005 over the dimensions). An
invariant kernel passes; a broken one fails.

The keys are the JAX package's: ``split(master_key(seed), 3)``, a key per
sample from ``replica_keys``, the step's key ``fold_in(sample key, 1)``. The
step is ONE ``step_batched`` of all N samples at beta = 1 (the JAX test's),
or at another beta where the draws at that beta can be made iid: on the
card, for ``SliceSamplerCUDA``, one launch of its kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import rng
from .checks import check_device
from .paths import VariationalPath, lane_log_density


class InvarianceTestResult(NamedTuple):
    passed: bool
    pvalues: np.ndarray
    failed_dims: np.ndarray


def invariance_test(target, explorer, seed: int = 1, n_iid_samples: int = 10_000,
                    marginal_pvalue_threshold: float = 0.005, device: str = "cuda",
                    beta: float = 1.0, variational=None,
                    ref_params: Optional[dict] = None) -> InvarianceTestResult:
    """The target must sample itself iid: ``sample_iid_target(keys)``, or a
    ``path`` iid-sampleable at beta = 1 (the toy MVN). The explorer moves
    along the target's path under its default reference; with
    ``variational`` (a reference such as ``GaussianReference``) and its
    ``ref_params``, along the blend :class:`~.paths.VariationalPath` with
    every lane variational. Draws and step are at ``beta``: 1 unless the
    draws at ``beta`` can be made iid, which is the toy MVN's path, alone or
    blended with a mean-field Gaussian reference (at beta = 1 the blend is
    the target, and the reference's term weighs nothing)."""
    dev = check_device(device)
    target = target.to(dev) if hasattr(target, "to") else target
    path = target.create_path(target.default_reference())
    isvar = None
    if variational is not None:
        path = VariationalPath(path, variational)
        isvar = torch.ones(n_iid_samples, dtype=torch.float32, device=dev)
        ref_params = {k: v.to(dev) for k, v in ref_params.items()}
    initial, xs, step_keys = iid_draws(target, seed, n_iid_samples, dev, beta, variational,
                                       ref_params)
    betas = torch.full((n_iid_samples,), beta, dtype=torch.float32, device=dev)
    state = explorer.init_state(1, target.dim, dev)
    chain_params = None
    if state:
        chain_params = {k: v.expand(n_iid_samples, *v.shape[1:]) for k, v in state.items()}
    lp = lane_log_density(path, xs, betas, isvar, ref_params)
    out = explorer.step_batched(step_keys, xs, betas, path, isvar=isvar,
                                ref_params=ref_params, lp=lp, chain_params=chain_params,
                                scan_idx=2)
    return ks_verdict(initial.cpu().numpy(), out.x.cpu().numpy(), marginal_pvalue_threshold)


def iid_draws(target, seed: int, n: int, device, beta: float = 1.0, variational=None,
              ref_params: Optional[dict] = None):
    """The two batches of ``n`` iid draws at ``beta``, ``[n, d]`` each, and
    the keys of the second batch's step, as the JAX package draws them (at
    beta = 1 its draws)."""
    sampler = _sampler(target, beta, variational, ref_params)
    k_init, k_final, _ = rng.split(rng.master_key(seed, device), 3).unbind(-2)
    final_keys = rng.replica_keys(k_final, n)
    return (sampler(rng.replica_keys(k_init, n)), sampler(final_keys),
            rng.fold_in(final_keys, 1))


def ks_verdict(initial: np.ndarray, final: np.ndarray, threshold: float = 0.005):
    """Two-sample KS test of each coordinate's marginal, Bonferroni over the
    coordinates."""
    from scipy.stats import ks_2samp

    d = initial.shape[1]
    pvalues = np.array([ks_2samp(initial[:, j], final[:, j]).pvalue for j in range(d)])
    failed = np.where(pvalues < threshold / d)[0]
    return InvarianceTestResult(bool(len(failed) == 0), pvalues, failed)


def _sampler(target, beta, variational, ref_params):
    if beta == 1.0:
        return _target_sampler(target)
    path = getattr(target, "path", None)
    if variational is None and hasattr(path, "sample_at"):
        return lambda keys: path.sample_at(keys, beta)
    if hasattr(path, "precision") and hasattr(variational, "coord_param_arrays"):
        # (1 - beta) log q + beta log N(0, I / precision(1)) with q a
        # mean-field Gaussian is the log density of a Gaussian up to a constant
        mean, std = (v.double() for v in variational.coord_param_arrays(ref_params))
        prec_q = 1.0 / (std * std)
        prec = (1.0 - beta) * prec_q + beta * float(path.precision(torch.tensor(1.0)))
        loc, sd = ((1.0 - beta) * prec_q * mean / prec).float(), torch.rsqrt(prec).float()
        return lambda keys: loc + sd * rng.normal(keys, (target.dim,))
    raise ValueError(
        f"invariance_test at beta = {beta} needs iid draws at that beta: the toy MVN's path, "
        "alone or blended with a mean-field Gaussian reference"
    )


def _target_sampler(target):
    if hasattr(target, "sample_iid_target"):
        return target.sample_iid_target
    path = getattr(target, "path", None)
    if getattr(path, "has_iid_reference", False) and hasattr(path, "sample_at"):
        return lambda keys: path.sample_at(keys, 1.0)
    raise ValueError(
        "invariance_test needs a target with sample_iid_target(keys) or an "
        "iid-sampleable toy path"
    )
