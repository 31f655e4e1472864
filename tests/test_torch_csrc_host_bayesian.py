"""Kernel K2's ``BayesianModel`` densities, compiled for the host and run
against the twin: the rest of ``tests/test_torch_csrc_host.py``, which has the
helpers and says how the sources are built and what is compared (everything
bitwise). Here: each model's density for 1, 8, 16 and 32 threads per lane
(the hierarchical normal also at shapes whose rows do not fill the four
partial sums of its likelihood; the Bernoulli model with its Beta prior
block, centred eight schools and mRNA with ``expm1`` and glibc's ``powf``
of base 10; eight schools, unid and Bernoulli, whose groups speculate the
machine's next queries, also at sampler settings that end its runs inside a
round, as does delta mode's machine of one thread on the toy MVN, which
takes a run's iterations in rounds too), and the launcher's own choice of
group.
"""

import functools

import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch.ops import cuda_slice
from pigeons_tpu_torch.paths import toy_mvn_path
from test_torch_csrc_host import (  # noqa: F401  (host_libraries is a fixture)
    BAYESIAN,
    SHORT,
    _assert_bitwise,
    _bayesian_inputs,
    _inputs,
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
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
              max_iter=SHORT)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    assert not torch.equal(got[0][0], x[0])


@pytest.mark.parametrize("name", ["hierarchical_normal", "eight_schools", "unid",
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


# Sampler settings (w, p, max_iter) under which the speculated machine's runs
# end inside a round of 8, 16 or 32 slots, each by one of the machine's
# conditions; the far-out lanes and the NaN lane of _bayesian_inputs are in
# every case. A witness (twin_end) shows that the case's condition ends some run.
ENDS = {
    # a bracket 0.05 wide still doubles where p = 3 stops it: 5 steps a run
    "doublings run out": (0.05, 3, SHORT),
    # the NaN lane's third rejected candidate ends its coordinate
    "bail at max_iter": (10.0, 20, 3),
    # a bracket that closes in on old before max_iter (eight schools: a far-out
    # lane's queries are all -inf)
    "degenerate bracket": (10.0, 20, 200),
    # no doubling (p = 0): every candidate in the slice is accepted without CHECK
    "narrow accept": (10.0, 0, SHORT),
    # doublings, then CHECK halvings that accept and reject
    "checks": (0.3, 20, SHORT),
}


# delta mode on the toy MVN path (d = 4)
DELTA = "toy_mvn_delta"


@functools.lru_cache(maxsize=None)
def _ends_case(name, case):
    """The path, inputs and the twin's sweep under ``ENDS[case]``, and its
    phase counts; shared by the tests of each group. ``DELTA``: the toy
    MVN's states with the same far-out and NaN lanes, in delta mode."""
    w, p, max_iter = ENDS[case]
    if name == DELTA:
        path = toy_mvn_path(4)
        x, betas, seeds = _inputs(6, 4, 3)
        x[1, 3], x[2, 3], x[3, 0] = 95.0, -95.0, float("nan")
    else:
        model = BAYESIAN[name]()
        path = model.create_path(model.default_reference())
        x, betas, seeds = _bayesian_inputs(model, 6, 3)
    counts = torch.zeros(6, dtype=torch.int64)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, name == DELTA, w=w, p=p,
                                      n_passes=1, max_iter=max_iter, phase_counts=counts)
    return path, x, betas, seeds, want, counts


def _twin_end(name, case, want, counts):
    """Whether ``case``'s condition ended some run of the twin's sweep."""
    path, x, betas, seeds, *_ = _ends_case(name, case)
    w, p, max_iter = ENDS[case]
    d = x.shape[1]
    if case == "doublings run out":  # one doubling more moves some lane
        more = cuda_slice.sweep_reference(x, betas, seeds, path, name == DELTA, w=w, p=p + 1,
                                          n_passes=1, max_iter=max_iter)
        return not torch.equal(more[2], want[2])
    if case == "bail at max_iter":  # the NaN lane: d coordinates of ENTER, INIT_R, 3 shrinks
        return float(want[2][2][3]) == d * (2 + max_iter)
    if case == "degenerate bracket":  # a lane gave up more coordinates than max_iter explains
        given_up = d - want[2][0]  # each after at least ENTER, INIT_R, max_iter rejections
        return bool((want[2][2] < given_up * (2 + max_iter)).any())
    if case == "narrow accept":
        return int(counts[4]) == 0 and float(want[2][0].sum()) > 0
    return int(counts[4]) > 0  # checks


@pytest.mark.parametrize("group", [8, 16, 32])
@pytest.mark.parametrize("case", sorted(ENDS))
@pytest.mark.parametrize("name", ["eight_schools", "unid", "bernoulli"])
def test_k2_speculated_runs_end_inside_a_round(host_libraries, name, case, group):
    """The speculated machine (eight schools, unid, Bernoulli) takes the first
    slot of a round whose iteration ends the run, by each of the machine's
    conditions: the doublings' count p, max_iter rejections, a degenerate
    bracket, a candidate accepted in a narrow interval, a CHECK that accepts
    or rejects; and the far-out and NaN lanes. States, densities and the
    three stats rows bitwise the twin's. Every case ends some run on every
    model, Bernoulli's one coordinate included."""
    path, x, betas, seeds, want, counts = _ends_case(name, case)
    w, p, max_iter = ENDS[case]
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
              max_iter=max_iter, sampler=(w, p))
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    assert _twin_end(name, case, want, counts), f"{case}: no run of the sweep ended so"


@pytest.mark.parametrize("case", sorted(ENDS))
def test_k2_delta_rounds_end_inside_a_round(host_libraries, case):
    """Delta mode's machine of one thread, which hashes the draws of a run's
    next iterations at once and takes them in turn, takes them up to the
    first that ends the run, by each of the machine's conditions, with the
    far-out and NaN lanes: states, densities and stats bitwise the twin's."""
    path, x, betas, seeds, want, counts = _ends_case(DELTA, case)
    w, p, max_iter = ENDS[case]
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, True, 1, 1,
              max_iter=max_iter, sampler=(w, p))
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    assert _twin_end(DELTA, case, want, counts), f"{case}: no run of the sweep ended so"
