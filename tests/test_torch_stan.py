"""A Stan model end to end in the port, held to the JAX package: the
counterparts of the four inline cases of ``tests/test_stan.py`` (``:197``,
``:227``, ``:232``, ``:262``; its other cases read the reference's
``examples/stan`` checkout, absent here, and skip as the JAX ones do), the
extraction (``sample_names``, ``constrained_samples``: the generated
quantities' numpy draws bit for bit), a three-round run of the inline model
with ``SliceSampler(n_passes=1)`` in both packages, and the three faults of
the JAX package's ``models/stan.py`` that the port reproduces.

Tolerances: log densities within 1e-5 relative (1e-4 absolute), gradients
within 1e-5 of ``max(1, |g|)``; the run at those of ``ROADMAP.md`` section 3
"Settled" (barrier within 1e-4, logZ within 1e-3, swap decisions and round
trips equal, states within 1e-5 relative, flips counted).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu.models import stan as JS
from pigeons_tpu_torch import convert
from pigeons_tpu_torch.models import stan as TS
from test_stan import REF_STAN, needs_ref  # the JAX tests' reference checkout, and its skip
from test_torch_stan_lang import hold


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_INLINE = """
functions {
    real half_sq(real z) {
        if (z < 0) {
            return 0.0;
        }
        return 0.5 * square(z);
    }
}
data {
    int<lower=1> K;
    array[K] real obs;
    real<lower=0> s;
}
transformed data {
    real s2 = square(s);
}
parameters {
    real mu;
    vector[K] eta;
    real<lower=0, upper=1> w;
}
transformed parameters {
    vector[K] lam = eta * w + mu;
}
model {
    mu ~ normal(0, 3);
    w ~ beta(2, 2);
    eta ~ normal(0, 1);
    for (k in 1:K) {
        obs[k] ~ normal(lam[k], s);
        target += -half_sq(lam[k] - obs[k]) / s2 * 0.0; // exercise target+=
    }
}
generated quantities {
    real obs_rep = normal_rng(lam[1], s);
}
"""
_INLINE_DATA = {"K": 3, "obs": [0.3, -0.1, 0.8], "s": 0.5}


def test_inline_model_all_constructs():
    """Functions with a conditional return, transformed data and
    parameters, generated quantities, loops, vectorized ``~`` and bounds:
    both packages, and the JAX test's hand-computed oracle."""
    jt, t = hold(_INLINE, _INLINE_DATA, n=8)
    assert t.dim == 1 + 3 + 1
    x = np.array([0.2, -0.3, 0.1, 0.4, 0.3], np.float32)
    lp = float(t.log_density(torch.from_numpy(x)))
    mu, eta, w_u = x[0], x[1:4], x[4]
    w = 1 / (1 + math.exp(-w_u))
    lam = eta * w + mu
    H = 0.5 * math.log(2 * math.pi)
    want = (-0.5 * (mu / 3) ** 2 - math.log(3.0) - H
            + float(np.sum(-0.5 * eta**2)) - 3 * H
            + (math.log(w) + math.log(1 - w) - (2 * math.lgamma(2) - math.lgamma(4)))
            + sum(-0.5 * ((o - v) / 0.5) ** 2 - math.log(0.5) - H
                  for o, v in zip(_INLINE_DATA["obs"], lam))
            + math.log(w) + math.log(1 - w))
    np.testing.assert_allclose(lp, want, rtol=1e-4)
    names = t.sample_names()
    assert names == jt.sample_names()
    assert names[0] == "mu" and "lam[0]" in names and "obs_rep" in names
    assert t.unconstrained_sample_names() == jt.unconstrained_sample_names()
    from pigeons_tpu_torch.ops import AutoMALA

    assert isinstance(t.default_explorer(), AutoMALA)


def test_files_and_json_data(tmp_path):
    """``stan_target(file=..., data=<a JSON path>)`` as the JAX package reads
    them (``load_stan_data``), the name from the file; one of ``file`` and
    ``source`` exactly."""
    import json

    (tmp_path / "inline.stan").write_text(_INLINE)
    (tmp_path / "inline.data.json").write_text(json.dumps(_INLINE_DATA))
    assert T.models.load_stan_data(str(tmp_path / "inline.data.json")) == \
        J.models.load_stan_data(str(tmp_path / "inline.data.json"))
    t = T.stan_target(file=str(tmp_path / "inline.stan"), data=str(tmp_path / "inline.data.json"))
    jt = J.stan_target(file=str(tmp_path / "inline.stan"), data=str(tmp_path / "inline.data.json"))
    assert t.name == jt.name == "inline" and t.dim == jt.dim
    with pytest.raises(ValueError, match="exactly one"):
        T.stan_target(source=_INLINE, file=str(tmp_path / "inline.stan"))


def test_missing_data_raises():
    with pytest.raises(ValueError, match="missing data"):
        T.stan_target(source="data { int<lower=1> K; } parameters { real x; } "
                             "model { x ~ normal(0, 1); }")


def test_extended_distribution_library():
    from scipy import stats

    src = """
    data { int<lower=0> k; real<lower=0> yv; }
    parameters { real<lower=0> s; }
    model {
        s ~ gamma(2.5, 1.5);
        yv ~ inv_gamma(3.0, 2.0);
        k ~ poisson(s);
        target += double_exponential_lpdf(yv | 0.5, 2.0);
        target += logistic_lpdf(yv | 0.0, 1.5);
    }
    """
    _, t = hold(src, {"k": 4, "yv": 1.3})
    u = 0.2
    s = math.exp(u)
    want = (stats.gamma.logpdf(s, 2.5, scale=1 / 1.5) + stats.invgamma.logpdf(1.3, 3.0, scale=2.0)
            + stats.poisson.logpmf(4, s) + stats.laplace.logpdf(1.3, 0.5, 2.0)
            + stats.logistic.logpdf(1.3, 0.0, 1.5) + u)
    np.testing.assert_allclose(float(t.log_density(torch.tensor([u]))), want, rtol=2e-5)


def test_row_vector_decl_in_transformed_block_and_minmax_reduction():
    src = """
    data { int<lower=1> K; }
    parameters { vector[K] y; }
    transformed parameters {
        row_vector[K] z;
        z = y' * 2.0;
    }
    model {
        real top = max(y);
        real bottom = min(y);
        real clipped = fmax(top, 0.5) + min(bottom, -0.5);
        target += -0.5 * dot_self(y) - square(top - bottom) * 0.0 + clipped * 0.0;
        target += sum(z) * 0.0;
    }
    """
    jt, t = hold(src, {"K": 3})
    x = torch.tensor([0.5, -1.0, 2.0])
    np.testing.assert_allclose(float(t.log_density(x)), -0.5 * float(torch.sum(x * x)), rtol=1e-6)
    assert "z[0]" in t.sample_names() and t.sample_names() == jt.sample_names()


class _Samples:
    """What ``constrained_samples`` reads of a run: ``sample_array()``."""

    def __init__(self, array):
        self.array = array

    def sample_array(self):
        return self.array


_GQ_MODEL = """
data { int<lower=1> N; real s; }
parameters { real mu; real<lower=0, upper=1> theta; real<lower=0> rate; }
model { mu ~ normal(0, 1); rate ~ exponential(1); }
generated quantities {
  real y_rep = normal_rng(mu, s);
  real b = bernoulli_rng(theta);
  real e = exponential_rng(rate);
  real g = gamma_rng(2.0, rate);
  real c = cauchy_rng(mu, s);
  real k = binomial_rng(N, theta);
}
"""


@pytest.mark.parametrize("model", ["inline", "draws"])
def test_constrained_samples_and_generated_quantities(model):
    """The same unconstrained samples through both packages' extraction:
    constrained and transformed parameters within float32 tolerance, and the
    generated quantities drawn from ``numpy.random.default_rng(seed)`` call
    for call as the JAX package draws them. Where their inputs are the same
    bits (parameters whose transforms are XLA's bit for bit) the draws are
    equal bit for bit; the inline model's ``lam = eta * w + mu`` is one
    fused multiply-add in XLA, so its draws are within float32 tolerance."""
    src, data = {"inline": (_INLINE, _INLINE_DATA),
                 "draws": (_GQ_MODEL, {"N": 12, "s": 0.3})}[model]
    jt, t = JS.StanTarget(src, data), TS.StanTarget(src, data)
    sa = np.concatenate([np.random.default_rng(5).normal(size=(40, jt.dim)), np.zeros((40, 1))],
                        axis=1).astype(np.float32)
    qj, qt = jt.constrained_samples(_Samples(sa), seed=3), t.constrained_samples(_Samples(sa), seed=3)
    assert sorted(qj) == sorted(qt)
    gq = [st[1] for st in jt._blocks["generated quantities"] if st[0] == "decl"]
    for k in qj:
        assert qt[k].shape == qj[k].shape and qt[k].dtype == qj[k].dtype, k
        if model == "draws":
            assert np.array_equal(qt[k], qj[k]), k
        else:
            np.testing.assert_allclose(qt[k], qj[k], rtol=1e-6, atol=1e-6)
    assert t.sample_names() == jt.sample_names()
    assert all(k in qt for k in gq)


def test_three_round_run_of_the_inline_model_matches_jax():
    """The JAX package runs round 1 from the seed, its state is carried into
    the port (``convert.state_from_numpy``) and both run rounds 2 and 3 with
    the slice sampler: swap decisions, restarts and round trips equal,
    barrier within 1e-4, logZ within 1e-3, states within 1e-5 relative, the
    lanes whose slice decisions differ (near ties of float32 sums taken in
    another order) counted, at most 1 in 16."""
    kw = dict(seed=3, n_rounds=3, show_report=False, n_chains=4, n_replicates=2)
    ja = J.PT(J.Inputs(target=J.stan_target(source=_INLINE, data=_INLINE_DATA),
                       explorer=J.SliceSampler(n_passes=1), **kw))
    ta = T.PT(T.Inputs(target=T.stan_target(source=_INLINE, data=_INLINE_DATA),
                       explorer=T.SliceSampler(n_passes=1), device="cpu", **kw))
    ja.run_round()
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": np.asarray(ja.schedule.grids)}, round_idx=1)
    for _ in range(2):
        ja.run_round()
        ta.run_round()
        rj, rt = ja.reports[-1], ta.reports[-1]
        assert (rj.n_scans, rj.n_tempered_restarts, rj.n_round_trips) == \
            (rt.n_scans, rt.n_tempered_restarts, rt.n_round_trips)
        assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-4
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3 * max(1.0, abs(rj.log_z_estimate))
    sj, st = np.asarray(ja.states), ta.states.numpy()
    lanes = (np.abs(st - sj) > 1e-5 * np.maximum(np.abs(sj), 1.0)).any(-1)
    print(f"{int(lanes.sum())} of {lanes.size} lanes flipped, {int((sj != st).sum())} of "
          f"{sj.size} state elements not bitwise equal")
    assert lanes.sum() <= lanes.size // 16


# ---------------------------------------------------------------------------
# the JAX package's faults, which the port reproduces
# ---------------------------------------------------------------------------


def test_vectorizer_guard_checks_shapes_only_in_both_packages():
    """``_vectorized_for`` takes a loop of 32 or more sampling statements as
    vectorizable when every operand is a scalar or has the loop's length. A
    parameter vector used whole (``mu``, not ``mu[n]``) passes that guard,
    so both packages pair ``y[n]`` with ``mu[n]``, where Stan (and the
    unrolled loop) would add every ``mu[j]`` for each ``y[n]``."""
    N = 32
    src = """
data { int<lower=1> N; vector[N] y; }
parameters { vector[N] mu; }
model { for (n in 1:N) y[n] ~ normal(mu, 1); }
"""
    y = np.random.default_rng(8).normal(size=N)
    _, t = hold(src, {"N": N, "y": y}, n=3)
    mu = np.random.default_rng(9).normal(size=N).astype(np.float32) * 0.5
    got = float(t.log_density(torch.from_numpy(mu)))
    H = 0.5 * math.log(2 * math.pi)
    paired = float(np.sum(-0.5 * (y - mu) ** 2 - H))
    stan = float(np.sum(-0.5 * (y[:, None] - mu[None, :]) ** 2 - H))
    np.testing.assert_allclose(got, paired, rtol=1e-5)
    assert abs(got - stan) > 100.0


def test_rep_matrix_tiles_a_row_vector_as_columns_in_both_packages():
    """``rep_matrix(v, m)`` of a 1-D value tiles it as the columns of an
    ``[n, m]`` matrix whether ``v`` is a vector or a row_vector; Stan makes
    ``[m, n]`` rows of a row_vector."""
    v = np.array([1.0, 2.0], np.float32)
    got = TS._MATH_FNS["rep_matrix"](torch.from_numpy(v), 3)
    want = np.asarray(JS._MATH_FNS["rep_matrix"](jnp.asarray(v), 3))
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    src = """
parameters { row_vector[2] r; }
model {
  matrix[2, 3] M = rep_matrix(r, 3);
  target += -0.5 * sum(M .* M) + M[2, 1];
}
"""
    _, t = hold(src, n=4)
    np.testing.assert_allclose(float(t.log_density(torch.tensor([1.0, 2.0]))), -0.5 * 15 + 2.0,
                               rtol=1e-6)


def test_uniform_lcdf_floor_is_flushed_in_both_packages():
    """``_lcdf_uniform`` clips the probability to ``[1e-38, 1]``, and 1e-38
    is a float32 subnormal that XLA flushes to 0: below the lower bound the
    log CDF is -inf (not log(1e-38)), and ``jax.grad`` of it is NaN (0 times
    the infinite derivative of the log), where Stan's gradient is 0. The
    port gives both."""
    src = """
data { real y; }
parameters { real<lower=0> a; }
model { a ~ exponential(1); target += uniform_lcdf(y | a, a + 1); }
"""
    jt, t = hold(src, {"y": -1.0}, n=4, grad=False)
    assert float(TS._LCDFS["uniform"](torch.tensor(-1.0), 0.0, 1.0)) == -np.inf
    assert float(JS._LCDFS["uniform"](jnp.asarray(-1.0), 0.0, 1.0)) == -np.inf
    x = torch.tensor([[0.3], [-0.2]], requires_grad=True)
    (g,) = torch.autograd.grad(t.log_density(x).sum(), x)
    jg = jax.vmap(jax.grad(jt.log_density))(jnp.asarray(x.detach().numpy()))
    assert np.isnan(g.numpy()).all() and np.isnan(np.asarray(jg)).all()
    _, inside = hold(src, {"y": 2.0}, n=4)  # inside the support both are finite
    assert np.isfinite(float(inside.log_density(torch.tensor([0.3]))))


@needs_ref
def test_reference_bernoulli_end_to_end():
    """The reference's ``bernoulli.stan`` through the port's ``stan_target``
    (``file=``, ``data=`` a JSON path), sampled with its default
    ``AutoMALA``: the JAX test's gates."""
    t = T.stan_target(file=f"{REF_STAN}/bernoulli.stan", data=f"{REF_STAN}/bernoulli.data.json")
    pt = T.pigeons(target=t, n_chains=6, n_rounds=9, seed=1, show_report=False, device="cpu")
    q = t.constrained_samples(pt)
    assert abs(q["theta"].mean() - 0.25) < 0.04
    want = math.lgamma(3) + math.lgamma(9) - math.lgamma(12)
    assert abs(pt.reports[-1].log_z_estimate - want) < 0.2
