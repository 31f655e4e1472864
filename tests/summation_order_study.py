"""In which order XLA's CPU code adds up the many-term likelihoods, read off
the JAX package's slice kernel.

    JAX_PLATFORMS=cpu python tests/summation_order_study.py [--lanes 128]

For the hierarchical normal at several shapes (rows x columns of its
observations) and the logistic regression at several numbers of
observations, one sweep of ``SliceSamplerPallas(interpret=True, n_passes=1)``
at beta = 1 returns, for every lane, the density of its final state: the
prior plus the likelihood's sum as ``_sweep_kernel`` forms it. For each
candidate order the script counts the lanes whose returned density equals the
port's prior (``BayesianModel.log_prior``, bitwise the JAX one) plus the
port's terms (``terms``) added in that order. Candidates: every term in
order; ``V`` partial sums over the rows (row ``r`` in partial ``r mod V``)
combined by halving, then the rows past the last full ``V`` in order;
``library.row_partials`` (the rule the port follows); windows of ``W`` terms
(``library.sum_by_windows``). A candidate that matches every lane is XLA's
order at that shape, or indistinguishable from it there. For the mRNA
model's 150 terms it counts the kernel's lanes and, separately, the lanes of
the runtime's pass (``jit(vmap(log_likelihood))``) that each order gives.

Not a test: a study (about two minutes); ``tests/test_torch_sweep_bayesian.py``
holds the port's rule at the shapes it covers.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pigeons_tpu as J  # noqa: E402
from pigeons_tpu import SliceSamplerPallas  # noqa: E402
from pigeons_tpu import rng as jrng  # noqa: E402
from pigeons_tpu_torch import convert  # noqa: E402
from pigeons_tpu_torch.models import library  # noqa: E402

HIERARCHICAL_SHAPES = ((3, 2), (4, 10), (5, 3), (7, 10), (8, 4), (8, 10), (9, 10), (12, 10),
                       (15, 10), (16, 10), (17, 10), (19, 10), (20, 4), (20, 10), (20, 16),
                       (21, 10), (23, 10), (24, 10), (27, 10), (28, 10), (30, 10), (32, 10),
                       (36, 10), (48, 4))
LOGISTIC_SIZES = ((16, 10), (31, 10), (33, 10), (64, 10), (100, 10), (200, 10), (256, 10),
                  (500, 10), (200, 3), (64, 1))


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _final_states(jm, lanes):
    """The returned states and densities of one sweep of the JAX kernel at
    beta = 1."""
    import jax
    import jax.numpy as jnp

    path = jm.create_path(jm.default_reference())
    xs = (np.random.RandomState(1).normal(size=(lanes, jm.dim)) * 0.5).astype(np.float32)

    def ld(x, beta, isvar, rp):
        lp = path.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    keys = jrng.keys_for(jax.random.key(7), jnp.arange(lanes))
    out = SliceSamplerPallas(interpret=True, n_passes=1).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(lanes), ld, jnp.ones(lanes), jnp.zeros(lanes), (), (), 1,
        ld_coord=None)
    return torch.from_numpy(np.asarray(out.x)), np.asarray(out.lp)


def _in_order(terms):
    acc = terms[:, 0].copy()
    for i in range(1, terms.shape[1]):
        acc = (acc + terms[:, i]).astype(np.float32)
    return acc


def _by_rows(rows, V):
    """V partial sums over the rows, halved, then the rest in order."""
    lanes, R, n = rows.shape
    n_main = R // V * V
    s = np.zeros((lanes, V), np.float32)
    for r in range(n_main):
        for j in range(n):
            t = rows[:, r, j]
            s[:, r % V] = t if (r < V and j == 0) else (s[:, r % V] + t).astype(np.float32)
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s = (s[:, :half] + s[:, half:]).astype(np.float32)
    acc = s[:, 0]
    for i in range(n_main * n, R * n):
        acc = (acc + rows.reshape(lanes, -1)[:, i]).astype(np.float32)
    return acc


def hierarchical(shape, lanes):
    jm = J.hierarchical_normal(*shape, seed=2)
    tm = convert.bayesian_model_from_numpy("hierarchical_normal",
                                           data=_closure(jm.log_likelihood_fn, "data"))
    x, lp = _final_states(jm, lanes)
    prior = tm.log_prior(x).numpy()
    terms = tm.log_likelihood_fn.terms(tm.constrain(x)[0]).numpy()
    rows = terms.reshape(lanes, *shape)
    sums = {"in order": _in_order(terms)}
    sums.update({f"{V} partials": _by_rows(rows, V) for V in (2, 4, 8, 16) if V <= shape[0]})
    sums["row_partials"] = library.sum_by_rows(torch.from_numpy(terms), shape[1]).numpy()
    return {k: int(((prior + v).astype(np.float32) == lp).sum()) for k, v in sums.items()}


def logistic(n, d, lanes):
    jm = J.logistic_regression(n, d, seed=1)
    fn = jm.log_likelihood_fn
    tm = convert.bayesian_model_from_numpy("logistic_regression", X=_closure(fn, "X"),
                                           y=_closure(fn, "y"))
    x, lp = _final_states(jm, lanes)
    prior = tm.log_prior(x).numpy()
    terms = tm.log_likelihood_fn.terms(tm.constrain(x)[0])
    sums = {"in order": _in_order(terms.numpy())}
    sums.update({f"windows of {W}": library.sum_by_windows(terms, W).numpy()
                 for W in (8, 16, 32, 64)})
    return {k: int(((prior + v).astype(np.float32) == lp).sum()) for k, v in sums.items()}


def mrna(lanes):
    """The mRNA model's 150 terms: the kernel's order (its returned densities
    at beta = 1, against the port's prior plus each candidate sum; the prior
    also with its five uniform constants added one by one instead of folded
    into one, ``BayesianModel._prior_of``) and the runtime pass's
    (``jit(vmap(log_likelihood))`` of the JAX model at the same states)."""
    import jax

    from pigeons_tpu.models.library import _load_mrna_data

    jm = J.mrna_target()
    ts, ys = _load_mrna_data()
    tm = convert.bayesian_model_from_numpy("mrna_target", ts=ts, ys=ys)
    x, lp = _final_states(jm, lanes)
    q, logjac = tm.constrain(x)
    prior = tm.log_prior(x).numpy()
    one_by_one = logjac.numpy()
    for dist in tm.priors.values():
        one_by_one = (one_by_one + np.float32(dist.total)).astype(np.float32)
    terms = tm.log_likelihood_fn.terms(q)
    sums = {"in order": _in_order(terms.numpy())}
    sums.update({f"windows of {W}": library.sum_by_windows(terms, W).numpy() for W in (8, 16, 32, 64)})
    kernel = {k: int(((prior + v).astype(np.float32) == lp).sum()) for k, v in sums.items()}
    kernel["windows of 32, constants one by one"] = int(
        ((one_by_one + sums["windows of 32"]).astype(np.float32) == lp).sum())
    lik = np.asarray(jax.jit(jax.vmap(jm.log_likelihood))(x.numpy()))
    runtime = {k: int((v == lik).sum()) for k, v in sums.items()}
    return kernel, runtime


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=128)
    args = ap.parse_args()
    print(f"lanes whose returned density each order gives, of {args.lanes}")
    for shape in HIERARCHICAL_SHAPES:
        print(f"hierarchical normal {shape[0]} x {shape[1]} (row_partials "
              f"{library.row_partials(shape[0])}): {hierarchical(shape, args.lanes)}", flush=True)
    for n, d in LOGISTIC_SIZES:
        print(f"logistic regression n={n}, d={d}: {logistic(n, d, args.lanes)}", flush=True)
    kernel, runtime = mrna(args.lanes)
    print(f"mRNA, 150 observations: the kernel {kernel}; the runtime pass {runtime}", flush=True)


if __name__ == "__main__":
    main()
