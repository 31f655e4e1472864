"""Kernel K2's ``BayesianModel`` densities, compiled for the host and run
against the twin: the rest of ``tests/test_torch_csrc_host.py``, which has the
helpers and says how the sources are built and what is compared (everything
bitwise). Here: each model's density for 1, 8, 16 and 32 threads per lane
(the hierarchical normal also at shapes whose rows do not fill the four
partial sums of its likelihood; the Bernoulli model with its Beta prior
block, centred eight schools and mRNA with ``expm1`` and glibc's ``powf``
of base 10), and the launcher's own choice of group.
"""

import functools

import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch.ops import cuda_slice
from test_torch_csrc_host import (  # noqa: F401  (host_libraries is a fixture)
    BAYESIAN,
    SHORT,
    _assert_bitwise,
    _bayesian_inputs,
    _k2,
    host_libraries,
)


@functools.lru_cache(maxsize=None)
def _twin_case(name, B, seed, n_passes=1):
    """A model's path, inputs and the twin's sweep of them (shared by the
    tests of each group)."""
    model = {**BAYESIAN, **MANY_TERMS}[name]()
    path = model.create_path(model.default_reference())
    x, betas, seeds = _bayesian_inputs(model, B, seed)
    counts = torch.zeros(6, dtype=torch.int64)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=n_passes,
                                      max_iter=SHORT, phase_counts=counts)
    return path, x, betas, seeds, want, counts


@pytest.mark.parametrize("group", [1, 8, 16, 32])
@pytest.mark.parametrize("name", sorted(BAYESIAN))
def test_k2_bayesian_host_build_matches_twin(host_libraries, name, group):
    """A ``BayesianModel`` density: the prior from its table, the likelihood
    from the model's data arrays, whatever the number of threads per lane."""
    path, x, betas, seeds, want, _ = _twin_case(name, 6, len(name))
    if name == "unid" and group > 1:  # one term: built for one thread per lane only
        with pytest.raises(AssertionError, match="returned -1"):
            _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
                max_iter=SHORT)
        return
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
              max_iter=SHORT)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    assert not torch.equal(got[0][0], x[0])


@pytest.mark.parametrize("name", ["hierarchical_normal", "eight_schools",
                                  "logistic_regression_40x3", "bernoulli",
                                  "eight_schools_centered", "mrna"])
def test_k2_launchers_group_matches_twin(host_libraries, name):
    """The launcher's own choice of threads per lane (group 0)."""
    model = BAYESIAN[name]()
    path = model.create_path(model.default_reference())
    x, betas, seeds = _bayesian_inputs(model, 5, 11)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, max_iter=SHORT)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, 0, max_iter=SHORT)
    _assert_bitwise(got, want, ("x", "lp", "stats"))




# the shapes of the shared reduction (row_partials): 8 partial sums of one row
# each; 8 with 3 rows past them; 4 with 1 row past them; the logistic
# regression's 7 windows of 32 (the library's 200 x 10); mRNA's 5 windows of
# its 150 terms; centred eight schools' three sums of 8
MANY_TERMS = {
    "hierarchical_normal_8x4": lambda: T.hierarchical_normal(8, 4, seed=4),
    "hierarchical_normal_19x3": lambda: T.hierarchical_normal(19, 3, seed=5),
    "hierarchical_normal_21x2": lambda: T.hierarchical_normal(21, 2, seed=6),
    "logistic_regression_200x10": lambda: T.logistic_regression(),
    "mrna_target": lambda: T.mrna_target(),
    "eight_schools_centered": lambda: T.eight_schools(centered=True),
}
# the coordinates from which on prepare reads them (the second kind); mRNA's
# every coordinate is of it, and each has its own query form (which of its
# kept shapes and levels a query reads)
SECOND_KIND = {"eight_schools_centered": -2, "mrna_target": 0}


@pytest.mark.parametrize("group", [8, 32])
@pytest.mark.parametrize("name", sorted(MANY_TERMS))
def test_k2_many_terms_keep_their_terms(host_libraries, name, group):
    """The shared reduction of the many-term likelihoods: a lane keeps its
    terms, partial sums and prior blocks from query to query and takes a
    candidate's over when the machine accepts it, for both kinds of
    coordinate (theta_trans and mu, log tau, log sigma; the weights and the
    bias; centred eight schools' theta and mu, log tau; any of mRNA's five,
    each of which recomputes one of its parameters). Bitwise the twin, which
    recomputes everything for every query; the sweep accepts and rejects
    candidates on both kinds."""
    path, x, betas, seeds, want, counts = _twin_case(name, 3, 1)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
              max_iter=SHORT)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    moved = want[0] != x
    split = SECOND_KIND.get(name, -3)
    assert moved[:, split:].any() and (split == 0 or moved[:, :split].any())
    if name == "mrna_target":
        assert moved.any(0).all()
    assert float(want[2][0].sum()) < float(counts[3])  # fewer accepted than shrink candidates
