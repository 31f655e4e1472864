"""The port's ``BayesianModel`` frontend against the JAX package, on the CPU.

Inputs come from a numpy seed and go through the JAX function under
``jit(vmap(...))`` and through the port's batched counterpart.

(a) Bijectors ``Identity``, ``Positive``, ``Interval``: ``forward`` (value and
    log-Jacobian) and ``inverse``. Tolerance 2e-6 relative (atol 1e-6), with
    the number of elements that are not bitwise equal printed: the port
    writes them as XLA evaluates them *inside the slice kernel*, where they
    are bitwise (``tests/test_torch_sweep_bayesian.py``); a plain
    ``jit(vmap)`` vectorises and fuses some of them differently.
(b) The seven distributions: ``log_prob`` at event shapes ``()`` and ``(5,)``,
    same tolerance (``Beta`` 1e-5 absolute: its constant is three lgammas).
    ``sample``, in units of float32's epsilon times the larger of the draw
    and the distribution's scale: ``Normal``, ``Uniform`` and ``Exponential``
    within 2 (the erfinv tail, as everywhere in the port; XLA fuses the
    affine map), ``LogNormal`` within 8 (the exp of such a normal), ``Cauchy``
    and ``HalfCauchy`` within 4 of ``jax.random.cauchy`` (the tangent; the
    share of draws that differ is printed). ``Beta.sample`` draws the law of ``jax.random.beta``, not its
    stream (a gamma rejection loop): held with a two-sample Kolmogorov-Smirnov
    test at level 1e-3 against the JAX draws, seeds fixed.
(c) ``bernoulli_logpmf``, ``binomial_logpmf``, ``f32math.lgamma``: 2e-6
    relative against ``jax.scipy.special.gammaln`` and the JAX helpers.
(d) The library models ``hierarchical_normal``, ``eight_schools``,
    ``unid_target`` and ``logistic_regression``: the port's own synthetic data against the JAX package's
    (within 2 ulp), and on the JAX model's data, carried over with
    ``convert.bayesian_model_from_numpy``: ``constrain``, ``log_prior``,
    ``log_likelihood``, ``log_density`` within 2e-6 relative (bitwise counts
    printed; the 20 x 10 hierarchical normal and unid are bitwise),
    ``unconstrain``, ``sample_names``, the prior's ``sample_iid``, the path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu.models import distributions as JD
from pigeons_tpu_torch import convert, f32math
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.models import distributions as TD
from pigeons_tpu_torch.models import library as TL

N = 512
RTOL, ATOL = 2e-6, 1e-6


def _close(have, want, name="", rtol=RTOL, atol=ATOL):
    have, want = np.asarray(have), np.asarray(want)
    assert have.shape == want.shape, (name, have.shape, want.shape)
    n_diff = int(((have.view(np.int32) != want.view(np.int32)) & ~(np.isnan(have) & np.isnan(want))).sum())
    print(f"{name}: {n_diff} of {want.size} not bitwise equal")
    np.testing.assert_allclose(have, want, rtol=rtol, atol=atol, err_msg=name)
    return n_diff


def _ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _u(shape, seed, scale=2.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(np.float32)


BIJECTORS = {
    "identity": (JD.Identity(), TD.Identity()),
    "positive": (JD.Positive(), TD.Positive()),
    "unit interval": (JD.Interval(0.0, 1.0), TD.Interval(0.0, 1.0)),
    "interval": (JD.Interval(-2.0, 5.0), TD.Interval(-2.0, 5.0)),
}


@pytest.mark.parametrize("shape", [(), (5,)])
@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_matches_jax(name, shape):
    jb, tb = BIJECTORS[name]
    u = _u((N,) + shape, len(name))
    jx, jlj = jax.jit(jax.vmap(jb.forward))(u)
    tx, tlj = tb.forward(torch.from_numpy(u), shape)
    _close(tx.numpy(), jx, f"{name} forward")
    _close(tlj.numpy(), jlj, f"{name} log-Jacobian", atol=2e-6)
    x = np.asarray(jx)
    _close(tb.inverse(torch.from_numpy(x)).numpy(), jax.jit(jax.vmap(jb.inverse))(x), f"{name} inverse",
           rtol=1e-5, atol=1e-5)


def _support(name, shape, seed):
    u = _u((N,) + shape, seed, 1.0)
    if name in ("Normal", "Cauchy"):
        return u * 3.0
    if name in ("Uniform", "Beta"):
        return (1.0 / (1.0 + np.exp(-u))).astype(np.float32)
    return np.exp(u).astype(np.float32)


DISTRIBUTIONS = {
    "Normal": dict(loc=0.5, scale=2.0),
    "Uniform": dict(lo=-2.0, hi=1.0),
    "Beta": dict(a=2.0, b=3.5),
    "Cauchy": dict(loc=-1.0, scale=2.5),
    "HalfCauchy": dict(scale=2.5),
    "Exponential": dict(rate=1.5),
    "LogNormal": dict(loc=0.3, scale=0.7),
}


def _pair(name, shape, **override):
    kw = {**DISTRIBUTIONS[name], **override}
    return getattr(JD, name)(shape=shape, **kw), getattr(TD, name)(shape=shape, **kw)


@pytest.mark.parametrize("shape", [(), (5,)])
@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_log_prob_matches_jax(name, shape):
    jd, td = _pair(name, shape)
    assert td.shape == jd.shape and td.size == jd.size
    x = _support(name, shape, len(name))
    if name == "Uniform":
        x = x * 3.0 - 2.0
    want = jax.jit(jax.vmap(jd.log_prob))(x)
    # Beta's constant is three float32 lgammas (each up to 4 ulp off XLA's), once per element
    _close(td.log_prob(torch.from_numpy(x)).numpy(), want, f"{name}{shape} log_prob",
           atol=1e-5 if name == "Beta" else 2e-6)
    assert type(td.bijector).__name__ == type(jd.bijector).__name__


def test_standard_normal_log_prob_is_bitwise():
    """The form the models' ``theta_trans`` priors take: scale 1, so the
    halving feeds the sum."""
    jd, td = _pair("Normal", (20,), loc=0.0, scale=1.0)
    x = _u((N, 20), 3)
    assert _close(td.log_prob(torch.from_numpy(x)).numpy(), jax.jit(jax.vmap(jd.log_prob))(x),
                  "standard normal") <= N // 8


# in units of float32's epsilon times max(|draw|, the distribution's scale): a
# location added to a draw cancels near 0, where ulps of the result say nothing
SAMPLE_EPS = {"Normal": 2, "LogNormal": 8, "Uniform": 2, "Exponential": 2, "Cauchy": 4,
              "HalfCauchy": 4}
SCALE = {"Normal": 2.0, "LogNormal": 1.0, "Uniform": 3.0, "Exponential": 1.0, "Cauchy": 2.5,
         "HalfCauchy": 2.5}


@pytest.mark.parametrize("shape", [(), (5,)])
@pytest.mark.parametrize("name", sorted(SAMPLE_EPS))
def test_sample_matches_jax(name, shape):
    jd, td = _pair(name, shape)
    want = np.asarray(jax.vmap(jd.sample)(jrng.keys_for(jax.random.key(3), jnp.arange(4096))))
    have = td.sample(trng.keys_for(trng.key(3), torch.arange(4096))).numpy()
    assert have.shape == want.shape == (4096,) + shape
    off = np.abs(have - want) / (np.finfo(np.float32).eps * np.maximum(np.abs(want), SCALE[name]))
    print(f"{name}{shape}: {float((off > 0).mean()):.5f} of draws differ, by at most {off.max():.3f} eps")
    assert off.max() <= SAMPLE_EPS[name]


def test_beta_sample_has_the_law_of_jax():
    jd, td = _pair("Beta", ())
    want = np.asarray(jax.vmap(jd.sample)(jrng.keys_for(jax.random.key(5), jnp.arange(4096))))
    have = td.sample(trng.keys_for(trng.key(6), torch.arange(4096))).numpy()
    assert np.isfinite(have).all() and (have > 0).all() and (have < 1).all()
    res = sps.ks_2samp(have, want)
    print(f"KS p-value against jax.random.beta {res.pvalue:.4f}; against Beta(2, 3.5) "
          f"{sps.kstest(have, sps.beta(2.0, 3.5).cdf).pvalue:.4f}")
    assert res.pvalue > 1e-3
    low = TD.Beta(a=0.5, b=0.7).sample(trng.keys_for(trng.key(7), torch.arange(4096))).numpy()
    assert sps.kstest(low, sps.beta(0.5, 0.7).cdf).pvalue > 1e-3  # the boosted branch, a < 1


def test_likelihood_helpers_match_jax():
    rs = np.random.RandomState(0)
    p = rs.uniform(0.01, 0.99, size=(N, 10)).astype(np.float32)
    y = (rs.uniform(size=10) < 0.4).astype(np.float32)
    want = jax.jit(jax.vmap(lambda pp: JD.bernoulli_logpmf(jnp.asarray(y), pp)))(p)
    _close(TD.bernoulli_logpmf(torch.from_numpy(y), torch.from_numpy(p)).numpy(), want, "bernoulli",
           rtol=1e-5)
    want = jax.jit(jax.vmap(lambda pp: JD.binomial_logpmf(50.0, 100.0, pp)))(p[:, 0])
    assert _close(TD.binomial_logpmf(50.0, 100.0, torch.from_numpy(p[:, 0])).numpy(), want,
                  "binomial") == 0
    want = jax.jit(jax.vmap(lambda yy, mm: JD.normal_logpdf(yy, mm, 2.0)))(p, p[:, ::-1])
    _close(TD.normal_logpdf(torch.from_numpy(p), torch.from_numpy(p[:, ::-1].copy()), 2.0).numpy(),
           want, "normal_logpdf", rtol=1e-5)


def test_lgamma_matches_jax():
    x = np.concatenate([np.linspace(0.5, 5.0, 200), np.linspace(5.0, 300.0, 200),
                        [1.0, 2.0, 51.0, 101.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.scipy.special.gammaln)(x))
    have = f32math.lgamma(torch.from_numpy(x)).numpy()
    off = _ulp(have, want)
    print(f"lgamma: {int((off > 0).sum())} of {x.size} differ, by at most {off.max()} ulp")
    np.testing.assert_allclose(have, want, rtol=2e-6, atol=2e-6)
    assert np.isnan(f32math.lgamma(torch.tensor([0.25])).numpy()).all()


# ---------------------------------------------------------------------------
# models


def _closure(fn, name):
    """What the JAX model's likelihood closes over under ``name``."""
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _models(name):
    """The JAX model and the port's on the JAX model's own data."""
    if name == "hierarchical_normal":
        jm = J.hierarchical_normal()
        data = _closure(jm.log_likelihood_fn, "data")
        return jm, convert.bayesian_model_from_numpy(name, data=data)
    if name == "eight_schools":
        jm = J.eight_schools()
        fn = jm.log_likelihood_fn
        return jm, convert.bayesian_model_from_numpy(name, y=_closure(fn, "y"),
                                                     sigma=_closure(fn, "sigma"))
    if name == "logistic_regression":
        jm = J.logistic_regression()
        fn = jm.log_likelihood_fn
        return jm, convert.bayesian_model_from_numpy(name, X=_closure(fn, "X"), y=_closure(fn, "y"))
    return J.unid_target(), convert.bayesian_model_from_numpy("unid_target", n_trials=100,
                                                              n_successes=50)


MODELS = ["hierarchical_normal", "eight_schools", "unid_target", "logistic_regression"]
BITWISE = {"hierarchical_normal", "unid_target"}


def test_hierarchical_normal_data_matches_jax():
    want = _closure(J.hierarchical_normal(7, 4, seed=3).log_likelihood_fn, "data")
    have = TL.hierarchical_normal_data(7, 4, seed=3).numpy()
    assert have.shape == want.shape == (7, 4)
    assert _ulp(have, want).max() <= 2
    default = _closure(J.hierarchical_normal().log_likelihood_fn, "data")
    off = _ulp(TL.hierarchical_normal_data().numpy(), default)
    print(f"default data: {int((off > 0).sum())} of 200 observations differ, by at most {off.max()} ulp")
    assert off.max() <= 2


def test_logistic_regression_data_matches_jax():
    """The design matrix within 2 ulp; a label is a comparison of a uniform
    with a sigmoid, so labels are equal unless that falls on the last bit."""
    fn = J.logistic_regression(50, 4, seed=5).log_likelihood_fn
    X, y = TL.logistic_regression_data(50, 4, seed=5)
    assert _ulp(X.numpy(), _closure(fn, "X")).max() <= 2
    assert np.array_equal(y.numpy(), _closure(fn, "y"))
    fn = J.logistic_regression().log_likelihood_fn
    X, y = TL.logistic_regression_data()
    flips = int((y.numpy() != _closure(fn, "y")).sum())
    print(f"default data: X off by at most {_ulp(X.numpy(), _closure(fn, 'X')).max()} ulp, {flips} of 200 labels differ")
    assert _ulp(X.numpy(), _closure(fn, "X")).max() <= 2 and flips == 0


def test_converter_refuses_unported_models():
    """A name that the JAX package's library does not have (its models are
    all ported; ``tests/test_torch_library_models.py`` converts the last
    three)."""
    assert not hasattr(J, "poisson_regression")
    with pytest.raises(ValueError, match="no such BayesianModel"):
        convert.bayesian_model_from_numpy("poisson_regression", data=np.zeros(3))


@pytest.mark.parametrize("name", MODELS)
def test_model_densities_match_jax(name):
    jm, tm = _models(name)
    assert tm.dim == jm.dim and tm.sample_names() == jm.sample_names()
    x = _u((N, jm.dim), 1, 1.5)
    tx = torch.from_numpy(x)
    for fn in ("log_prior", "log_likelihood", "log_density"):
        want = jax.jit(jax.vmap(getattr(jm, fn)))(x)
        n_diff = _close(getattr(tm, fn)(tx).numpy(), want, f"{name} {fn}", rtol=1e-6, atol=1e-5)
        assert n_diff == 0 or name not in BITWISE
    lp, post = tm.prior_and_posterior(tx)
    assert torch.equal(lp, tm.log_prior(tx)) and torch.equal(post, tm.log_density(tx))


@pytest.mark.parametrize("name", MODELS)
def test_constrain_matches_jax(name):
    jm, tm = _models(name)
    x = _u((N, jm.dim), 2, 1.5)
    jq, jlj = jax.jit(jax.vmap(jm.constrain))(x)
    tq, tlj = tm.constrain(torch.from_numpy(x))
    for key, want in jq.items():
        _close(tq[key].numpy(), want, f"{name} {key}")
    _close(tlj.numpy(), jlj, f"{name} log-Jacobian", atol=2e-6)
    back = tm.unconstrain({k: tq[k] for k in jq})
    _close(back.numpy(), jax.jit(jax.vmap(jm.unconstrain))(jq), f"{name} unconstrain", rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("name", MODELS)
def test_prior_draws_match_jax(name):
    """``default_reference().sample_iid`` and ``initialization``: one child
    key per prior; the half-Cauchy blocks within 4 ulp of the JAX draw before
    the logarithm of ``unconstrain``, so within 1e-5 after it."""
    jm, tm = _models(name)
    want = np.asarray(jax.vmap(jm.initialization)(jrng.keys_for(jax.random.key(2), jnp.arange(256))))
    keys = trng.keys_for(trng.key(2), torch.arange(256))
    have = tm.initialization(keys)
    assert torch.equal(have, tm.default_reference().sample_iid(keys))
    off = _ulp(have.numpy(), want)
    print(f"{name}: {float((off > 0).mean()):.5f} of coordinates differ, by at most {off.max()} ulp")
    np.testing.assert_allclose(have.numpy(), want, rtol=1e-5, atol=1e-5)
    ref_j = jax.jit(jax.vmap(jm.default_reference().log_density))(want)
    _close(tm.default_reference().log_density(torch.from_numpy(want)).numpy(), ref_j, f"{name} reference",
           rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_path_describes_itself_to_the_kernel(name):
    _, tm = _models(name)
    path = tm.create_path(tm.default_reference())
    density = path.device_density()
    assert density is not None and path.has_iid_reference
    assert len(density.prior) == len(tm.priors) and all(len(row) == 8 for row in density.prior)
    assert sum(row[1] for row in density.prior) == tm.dim
    assert all(a.dtype == torch.float32 and a.dim() == 1 and a.is_contiguous() for a in density.arrays)
    T.SliceSamplerCUDA().check_path(path)
    # from any other reference the kernel cannot evaluate the path
    other = T.StandardNormalReference(tm.dim, 3.0).as_reference()
    assert tm.create_path(other).device_density() is None
    with pytest.raises(NotImplementedError, match="11b"):
        T.SliceSamplerCUDA().check_path(tm.create_path(other))
    # nor from the prior of another instance of the model
    assert tm.create_path(_models(name)[1].default_reference()).device_density() is None
    x = torch.from_numpy(_u((8, tm.dim), 4))
    beta = torch.linspace(0.0, 1.0, 8)
    lp = path.log_density(x, beta)
    assert torch.equal(lp[0], tm.log_prior(x)[0]) and torch.equal(lp[-1], tm.log_density(x)[-1])


@pytest.mark.parametrize("name", MODELS)
def test_reference_passed_explicitly_keeps_the_kernel_path(name):
    """The model's own prior handed to the run as ``reference``: the run moves
    the model to its device, which makes a new ``BayesianModel`` for a model
    with data, and the path must still describe itself to the kernel."""
    _, tm = _models(name)
    moved = tm.to("cpu")
    density = moved.create_path(tm.default_reference()).device_density()
    assert density is not None and density.kind == tm.create_path(tm.default_reference()).device.kind
    assert tm.create_path(moved.default_reference()).device_density() is not None
    pt = T.PT(T.Inputs(target=tm, reference=tm.default_reference(), n_chains=3, n_rounds=1,
                       explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu", show_report=False))
    assert pt.path.device_density() is not None
    T.SliceSamplerCUDA().check_path(pt.path)
    # a prior with another distribution under one of the names is not the model's own
    changed = T.BayesianModel({**tm.priors, next(iter(tm.priors)): TD.Normal(
        shape=next(iter(tm.priors.values())).shape)}, tm.log_likelihood_fn)
    assert tm.create_path(changed.default_reference()).device_density() is None


def test_a_model_without_device_blocks_runs_with_the_torch_sampler():
    """A user's model: torch likelihood, a prior the kernel has no block for."""
    model = T.BayesianModel({"rate": TD.Exponential(2.0), "w": TD.Normal(shape=(2,))},
                            lambda q: -(q["w"] ** 2).sum(-1) * q["rate"])
    assert model.dim == 3 and model.sample_names() == ["rate", "w[0]", "w[1]", "log_density"]
    assert model.prior_table() is None and model.device_target() is None
    path = model.create_path(model.default_reference())
    assert path.device_density() is None
    with pytest.raises(NotImplementedError, match="11b"):
        T.SliceSamplerCUDA().check_path(path)
    pt = T.pigeons(target=model, n_chains=3, n_rounds=2, seed=1, device="cpu", show_report=False)
    assert np.isfinite(pt.sample_array()).all() and pt.sample_names()[0] == "rate"
    q = model.constrained_samples(pt)
    assert q["rate"].shape == (4,) and (q["rate"] > 0).all() and q["w"].shape == (4, 2)


def test_unid_with_other_counts_matches_jax():
    """The binomial coefficient is three float32 lgammas of about 300, each
    within 1 ulp (3e-5) of XLA's: 1e-4 absolute."""
    jm = J.unid_target(80, 30)
    tm = convert.bayesian_model_from_numpy("unid_target", n_trials=80, n_successes=30)
    x = _u((N, 2), 5, 1.5)
    want = jax.jit(jax.vmap(jm.log_density))(x)
    _close(tm.log_density(torch.from_numpy(x)).numpy(), want, "unid(80, 30)", rtol=1e-5, atol=1e-4)


def test_unid_analytic_log_z_matches_jax():
    assert TL.unid_analytic_log_z(20, 7) == pytest.approx(J.models.unid_analytic_log_z(20, 7), abs=1e-12)
