"""The port's densities in the three steps in which the slice kernel K2
evaluates them: ``prepare`` (what all terms need, from coordinate 0),
``term`` (one coordinate's term) and ``finish`` (the in-order sums).

Same inputs from a numpy seed, d = 3 and d = 10, with NaN, +-inf and far-out
rows and beta in {0, 1} among them, for the funnel, banana and flat-prior MVN
paths and the toy MVN path.

The ``BayesianModel`` densities have the same three steps with terms that
are observations, not coordinates (``terms`` and ``finish`` of the library's
likelihood objects): the hierarchical normal's 200, eight schools' 8, unid's
one; held the same way, on the JAX models' default data.

Tolerance: everything bitwise (a NaN equals a NaN). The three steps in a row
are held against ``jit(vmap(log_density))`` of the JAX package's path, and
against the densities written in one pass, as they were before they were
split; a term computed for one coordinate alone is the term computed with all
of them, which is what lets a thread of the kernel compute only its own.
"""

import jax
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu.paths import toy_mvn_path as jax_toy_mvn_path
from pigeons_tpu_torch import f32math
from pigeons_tpu_torch.models import library
from pigeons_tpu_torch.models.distributions import normal_logpdf
from pigeons_tpu_torch.paths import sum_squares, toy_mvn_path

N = 257
MAKE = {"funnel": lambda m, d: m.funnel(d - 1, 2.0), "banana": lambda m, d: m.banana(d - 1, 1.5),
        "mvn": lambda m, d: m.mvn_target(d, 2.5)}


def _inputs(d):
    rs = np.random.RandomState(d)
    x = (rs.normal(size=(N, d)) * 2.0).astype(np.float32)
    beta = rs.uniform(size=N).astype(np.float32)
    beta[:4] = [0.0, 1.0, 0.0, 1.0]
    x[0, 0], x[1, d - 1], x[2, 0], x[5, d - 1] = np.nan, np.inf, -np.inf, np.nan
    x[3, 0], x[4, 0] = 95.0, -95.0
    return x, beta


def _assert_same_bits(have, want):
    have, want = np.asarray(have), np.asarray(want)
    same = (have.view(np.int32) == want.view(np.int32)) | (np.isnan(have) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} of {same.size} differ in their bits"


@pytest.mark.parametrize("d", [3, 10])
@pytest.mark.parametrize("name", ["funnel", "banana", "mvn", "toy"])
def test_three_steps_match_the_jax_density(name, d):
    x, beta = _inputs(d)
    tx, tbeta = torch.from_numpy(x), torch.from_numpy(beta)
    if name == "toy":
        jpath, tpath = jax_toy_mvn_path(d), toy_mvn_path(d)
        have = tpath.sweep_finish(tpath.sweep_term(tx), tbeta)
        assert torch.equal(have.view(torch.int32), tpath.sweep_log_density(tx, tbeta).view(torch.int32))
    else:
        jt, tt = MAKE[name](J, d), MAKE[name](T, d)
        jpath = jt.create_path(jt.default_reference())
        tpath = tt.create_path(tt.default_reference())
        have = tpath.log_density(tx, tbeta)
        first = 0 if name == "mvn" else 1
        prep = tt.prepare(tx[:, 0])
        _assert_same_bits(tt.finish(prep, tt.term(tx[:, first:], prep)), tt.log_density(tx))
    want = jax.jit(jax.vmap(jpath.log_density))(x, beta)
    _assert_same_bits(have.numpy(), want)


def _funnel_in_one_pass(target, s):
    y, x = s[..., 0], s[..., 1:]
    m = y * library._INV_3
    lp_y = f32math.fma(-(m * m), 0.5, library._FUNNEL_Y_CONST)
    u = y * target._inv_scale
    q = x / f32math.exp(u)[..., None]
    terms = f32math.fma(q * q, -0.5, -u[..., None]) + library._NEG_HALF_LOG_2PI
    lp_x = terms[..., 0]
    for i in range(1, target.n_x):
        lp_x = lp_x + terms[..., i]
    return lp_y + lp_x


def _banana_in_one_pass(target, s):
    x, y = s[..., :1], s[..., 1:]
    return (normal_logpdf(x, 0.0, library._S_A)
            + normal_logpdf(y, x * x, target.scale * library._S_B))


def _mvn_in_one_pass(target, x):
    return sum_squares(x) * target._factor


@pytest.mark.parametrize("d", [3, 10])
@pytest.mark.parametrize("name", ["funnel", "banana", "mvn"])
def test_three_steps_match_the_density_in_one_pass(name, d):
    one_pass = {"funnel": _funnel_in_one_pass, "banana": _banana_in_one_pass,
                "mvn": _mvn_in_one_pass}[name]
    target = MAKE[name](T, d)
    x = torch.from_numpy(_inputs(d)[0])
    _assert_same_bits(target.log_density(x).numpy(), one_pass(target, x).numpy())


@pytest.mark.parametrize("name", ["funnel", "banana", "mvn"])
def test_a_term_needs_no_other_coordinate(name):
    target = MAKE[name](T, 10)
    x = torch.from_numpy(_inputs(10)[0])
    prep = target.prepare(x[:, 0])
    terms = target.term(x, prep)
    for i in (1, 4, 9):
        _assert_same_bits(target.term(x[:, i:i + 1], prep).numpy(), terms[:, i:i + 1].numpy())


def test_funnel_without_x_coordinates():
    """d = 1: no term, the density is y's own (the kernel's in-order sum of
    nothing is 0)."""
    target = T.funnel(0)
    y = torch.from_numpy(_inputs(3)[0][:, :1])
    want = jax.jit(jax.vmap(J.funnel(0).log_density))(y.numpy())
    _assert_same_bits(target.log_density(y).numpy(), want)


def _bayesian(name):
    jm = {"hierarchical_normal": J.hierarchical_normal, "eight_schools": J.eight_schools,
          "unid_target": J.unid_target, "logistic_regression": J.logistic_regression}[name]()
    tm = {"hierarchical_normal": T.hierarchical_normal, "eight_schools": T.eight_schools,
          "unid_target": T.unid_target, "logistic_regression": T.logistic_regression}[name]()
    if name == "hierarchical_normal":  # on the JAX model's observations (its own are within 2 ulp)
        fn = jm.log_likelihood_fn
        data = np.asarray(fn.__closure__[fn.__code__.co_freevars.index("data")].cell_contents)
        tm = T.hierarchical_normal(data=torch.from_numpy(data))
    return jm, tm


def _states(d):
    """Unconstrained states, with far-out and non-finite rows among them."""
    x, _ = _inputs(d)
    return np.clip(x, -30.0, 30.0)


@pytest.mark.parametrize("name", ["hierarchical_normal", "unid_target"])
def test_likelihood_steps_match_the_jax_likelihood(name):
    jm, tm = _bayesian(name)
    x = _states(jm.dim)
    q, _ = tm.constrain(torch.from_numpy(x))
    like = tm.log_likelihood_fn
    have = like.finish(like.terms(q))
    _assert_same_bits(have.numpy(), tm.log_likelihood(torch.from_numpy(x)).numpy())
    _assert_same_bits(have.numpy(), jax.jit(jax.vmap(jm.log_likelihood))(x))


@pytest.mark.parametrize("name", ["hierarchical_normal", "eight_schools", "logistic_regression"])
def test_an_observation_term_needs_no_other(name):
    """What lets a thread of the kernel compute only its own observations."""
    _, tm = _bayesian(name)
    q, _ = tm.constrain(torch.from_numpy(_states(tm.dim)))
    like = tm.log_likelihood_fn
    terms = like.terms(q)
    n_terms = {"hierarchical_normal": 200, "eight_schools": 8, "logistic_regression": 200}[name]
    assert terms.shape == (N, n_terms)
    for lane in (6, 100):  # one lane alone gives its row of terms
        alone = like.terms({k: v[lane:lane + 1] for k, v in q.items()})
        _assert_same_bits(alone.numpy(), terms[lane:lane + 1].numpy())
    _assert_same_bits(like.finish(terms[:, :n_terms]).numpy(), like(q).numpy())


@pytest.mark.parametrize("n_rows,n_per_row", [(20, 10), (6, 3), (3, 2), (4, 1), (9, 4),
                                               (8, 4), (19, 10), (21, 3)])
def test_row_quads_sum_adds_every_term_once(n_rows, n_per_row):
    """One, four or eight partial sums over the rows, then the rows past the
    last full group: against float64, and exact on integers whatever the
    order."""
    rs = np.random.RandomState(n_rows)
    t = torch.from_numpy(rs.normal(size=(5, n_rows * n_per_row)).astype(np.float32))
    have = library.sum_by_rows(t, n_per_row)
    np.testing.assert_allclose(have.numpy(), t.double().sum(-1).numpy(), rtol=1e-5, atol=1e-5)
    ints = torch.arange(n_rows * n_per_row, dtype=torch.float32).repeat(2, 1)
    assert torch.equal(library.sum_by_rows(ints, n_per_row), ints.sum(-1))
    if library.row_partials(n_rows) == 1:  # no vectorised loop: in order
        acc = t[:, 0]
        for i in range(1, t.shape[1]):
            acc = acc + t[:, i]
        assert torch.equal(have, acc)


@pytest.mark.parametrize("n", [200, 32, 33, 7, 64, 95])
def test_window_sum_adds_every_term_once(n):
    """Windows of 32 with the padding split in front and behind: against
    float64, exact on integers, and at n = 200 the windows 0..19, 20..51, ..."""
    rs = np.random.RandomState(n)
    t = torch.from_numpy(rs.normal(size=(5, n)).astype(np.float32))
    have = library.sum_by_windows(t)
    np.testing.assert_allclose(have.numpy(), t.double().sum(-1).numpy(), rtol=1e-5, atol=1e-5)
    ints = torch.arange(n, dtype=torch.float32).repeat(2, 1)
    assert torch.equal(library.sum_by_windows(ints), ints.sum(-1))
    if n == 200:
        bounds = [0, 20, 52, 84, 116, 148, 180, 200]
        total = torch.zeros(5)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            acc = torch.zeros(5)
            for i in range(lo, hi):
                acc = acc + t[:, i]
            total = total + acc
        assert torch.equal(have, total)
