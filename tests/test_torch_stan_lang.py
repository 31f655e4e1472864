"""The Stan front end of the port (``pigeons_tpu_torch/models/stan.py``)
held to the JAX package's: the counterparts of ``tests/test_stan_lang.py``.

Every model of that file, and each of its transforms and densities, goes
through both packages on the same numpy-seeded unconstrained states: the
log density within 1e-5 relative (1e-4 absolute), the gradient (autograd
through ``f32math`` against ``jax.grad``) within 1e-5 of ``max(1, |g|)``,
and both packages parse the source into equal ASTs. The JAX file's own
oracles (slogdet of the transform's jacobian, quadrature normalization,
scipy) are kept for the port where they are cheap. The JAX file's runs
(``pigeons`` with ``AutoMALA``) become a short run of the port, checked for
the invariants the JAX test checks (a simplex sums to 1, shapes of the
extracted draws). ``betainc``, which torch lacks, is held to
``jax.scipy.special.betainc`` on a grid with both tails.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu.models import stan as JS
from pigeons_tpu_torch.models import stan as TS

jax.config.update("jax_enable_x64", False)

LP_RTOL, LP_ATOL, GRAD_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(dim, n=6, scale=0.5, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, dim)) * scale).astype(np.float32)


def _port_value_and_grad(t, x):
    xt = torch.from_numpy(x).requires_grad_(True)
    lp = t.log_density(xt)
    (g,) = torch.autograd.grad(lp.sum(), xt)
    return lp.detach().numpy(), g.numpy()


def hold(src, data=None, n=6, scale=0.5, seed=0, grad=True):
    """Both packages' targets of ``src``: equal ASTs, the port's log
    density and gradient at ``n`` seeded states against the JAX ones."""
    jt, tt = JS.StanTarget(src, data), TS.StanTarget(src, data)
    assert JS._Parser(JS._tokenize(src)).parse_program() == \
        TS._Parser(TS._tokenize(src)).parse_program()
    assert jt.dim == tt.dim
    x = _states(jt.dim, n, scale, seed)
    if grad:
        jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jt.log_density)))(jnp.asarray(x))
        tl, tg = _port_value_and_grad(tt, x)
        jg = np.asarray(jg)
        assert np.all(np.abs(tg - jg) <= GRAD_TOL * np.maximum(1.0, np.abs(jg))), (tg, jg)
    else:
        jl = jax.jit(jax.vmap(jt.log_density))(jnp.asarray(x))
        tl = tt.log_density(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=LP_RTOL, atol=LP_ATOL)
    return jt, tt


# ---------------------------------------------------------------------------
# transforms: the JAX package's values and log-jacobians, and the autodiff
# slogdet oracle
# ---------------------------------------------------------------------------

K = 4
_IL = np.tril_indices(K, -1)
_ILL = np.tril_indices(K)
_M, _N = 5, 3
_rows, _cols = np.tril_indices(_M, -1)
_keep = _cols < _N
_rows, _cols = _rows[_keep], _cols[_keep]

TRANSFORMS = {
    "simplex": ("_constrain_simplex", (), lambda x: x[: K - 1], K - 1),
    "ordered": ("_constrain_ordered", (), lambda x: x, K),
    "positive_ordered": ("_constrain_positive_ordered", (), lambda x: x, K),
    "cholesky_factor_corr": ("_constrain_cholesky_factor_corr", (K,), lambda L: L[_IL],
                             K * (K - 1) // 2),
    "corr_matrix": ("_constrain_corr_matrix", (K,), lambda R: R[_IL], K * (K - 1) // 2),
    "cov_matrix": ("_constrain_cov_matrix", (K,), lambda S: S[_ILL], K * (K + 1) // 2),
    "cholesky_factor_cov": ("_constrain_cholesky_factor_cov", (_M, _N),
                            lambda L: (torch.cat([torch.diagonal(L)[:_N], L[_rows, _cols]])
                                       if isinstance(L, torch.Tensor) else
                                       jnp.concatenate([jnp.diagonal(L)[:_N], L[_rows, _cols]])),
                            _N + len(_rows)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_logjac_matches_jax_and_autodiff(name):
    """Each transform's value and log|J| equal the JAX package's within
    float32 tolerance (1e-5 for the log-jacobians), and log|J| is slogdet of
    the jacobian onto the free coordinates, by ``torch.func.jacrev``."""
    fname, extra, coords, n_unc = TRANSFORMS[name]
    jfn, tfn = getattr(JS, fname), getattr(TS, fname)
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(3):
        u = (rng.normal(size=n_unc) * 0.8).astype(np.float32)
        jv, jlj = jfn(jnp.asarray(u), *extra)
        tv, tlj = tfn(torch.from_numpy(u), *extra)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tlj), float(jlj), rtol=1e-5, atol=1e-5)
        J = torch.func.jacrev(lambda uu: coords(tfn(uu, *extra)[0]))(torch.from_numpy(u))
        _, ld = torch.linalg.slogdet(J.double())
        np.testing.assert_allclose(float(tlj), float(ld), atol=2e-4)


def test_transform_shapes_and_invariants():
    rng = np.random.default_rng(0)

    def u(n):
        return torch.from_numpy(rng.normal(size=n).astype(np.float32))

    x, _ = TS._constrain_simplex(u(K - 1))
    np.testing.assert_allclose(float(torch.sum(x)), 1.0, atol=1e-6)
    assert (x.numpy() > 0).all()
    x, _ = TS._constrain_ordered(u(K))
    assert (np.diff(x.numpy()) > 0).all()
    x, _ = TS._constrain_positive_ordered(u(K))
    assert (x.numpy() > 0).all() and (np.diff(x.numpy()) > 0).all()
    x, _ = TS._constrain_unit_vector(u(K))
    np.testing.assert_allclose(float(torch.sum(x * x)), 1.0, atol=1e-6)
    R, _ = TS._constrain_corr_matrix(u(K * (K - 1) // 2), K)
    np.testing.assert_allclose(np.diagonal(R.numpy()), 1.0, atol=1e-6)
    np.testing.assert_allclose(R.numpy(), R.numpy().T, atol=1e-7)
    assert (np.linalg.eigvalsh(R.numpy()) > 0).all()
    S, _ = TS._constrain_cov_matrix(u(K * (K + 1) // 2), K)
    assert (np.linalg.eigvalsh(S.numpy()) > 0).all()


# ---------------------------------------------------------------------------
# density constants: normalization, scipy, the JAX package
# ---------------------------------------------------------------------------

# the grids' points held pointwise to the JAX package: |u| <= INNER, where
# float32 tanh and sigmoid have not saturated (the normalizations use the
# whole grid, as the JAX tests do)
INNER = 4.0


@pytest.mark.parametrize("eta", [0.7, 1.0, 2.5])
def test_lkj_cholesky_normalizes_k2(eta):
    """For K=2 the Cholesky-LKJ density integrates to 1 over the
    unconstrained line through the transform and its jacobian (the JAX
    test's grid), and equals the JAX package's pointwise."""
    us = np.linspace(-7, 7, 4001).astype(np.float32)

    def f(mod, xp, u):
        L, lj = getattr(mod, "_constrain_cholesky_factor_corr")(u, 2)
        return mod._lpdf_lkj_corr_cholesky(L, eta) + lj

    tv = torch.func.vmap(lambda u: f(TS, torch, u[None]))(torch.from_numpy(us))
    jv = jax.jit(jax.vmap(lambda u: f(JS, jnp, u[None])))(jnp.asarray(us))
    inner = np.abs(us) <= INNER  # past it tanh saturates and both forms are ill-conditioned
    np.testing.assert_allclose(tv.numpy()[inner], np.asarray(jv)[inner], rtol=1e-5, atol=1e-4)
    total = float(torch.nan_to_num(torch.exp(tv.double())).sum()) * (us[1] - us[0])
    np.testing.assert_allclose(total, 1.0, atol=2e-3)


@pytest.mark.parametrize("which", ["lkj_corr_cholesky", "lkj_corr"])
def test_lkj_normalizes_k3(which):
    """The K=3 normalization of the JAX file's slow test, on the port (a
    grid of 49^3 points batched by ``vmap``), and a few points against the
    JAX package's."""
    lpdf, tf, inner = {
        "lkj_corr_cholesky": ("_lpdf_lkj_corr_cholesky", "_cpc_cholesky", INNER),
        # slogdet of a correlation matrix near singular differs from LAPACK's
        # in float32 by more than 1e-5 past |u| = 2 (condition number ~100)
        "lkj_corr": ("_lpdf_lkj_corr", "_constrain_corr_matrix", 2.0)}[which]
    g = np.linspace(-7, 7, 49)
    U = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)

    def f(mod, u):
        V, lj = getattr(mod, tf)(u, 3)
        return getattr(mod, lpdf)(V, 1.5) + lj

    tv = torch.func.vmap(lambda u: f(TS, u))(torch.from_numpy(U))
    total = float(torch.exp(tv.double()).sum()) * (g[1] - g[0]) ** 3
    np.testing.assert_allclose(total, 1.0, atol=5e-3)
    pick = np.random.default_rng(3).choice(np.flatnonzero(np.abs(U).max(1) <= inner), 64,
                                           replace=False)
    jv = jax.jit(jax.vmap(lambda u: f(JS, u)))(jnp.asarray(U[pick]))
    np.testing.assert_allclose(tv.numpy()[pick], np.asarray(jv), rtol=1e-5, atol=1e-4)


def test_dirichlet_normalizes_k3():
    alpha = [2.0, 0.8, 1.5]
    g = np.linspace(-10, 10, 201)
    U = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2).astype(np.float32)

    def f(mod, a, u):
        x, lj = mod._constrain_simplex(u)
        return mod._lpdf_dirichlet(x, a) + lj

    tv = torch.func.vmap(lambda u: f(TS, torch.tensor(alpha), u))(torch.from_numpy(U))
    total = float(torch.exp(tv.double()).sum()) * (g[1] - g[0]) ** 2
    np.testing.assert_allclose(total, 1.0, atol=5e-3)
    pick = np.random.default_rng(4).choice(np.flatnonzero(np.abs(U).max(1) <= INNER), 64,
                                           replace=False)
    jv = jax.jit(jax.vmap(lambda u: f(JS, jnp.asarray(alpha), u)))(jnp.asarray(U[pick]))
    np.testing.assert_allclose(tv.numpy()[pick], np.asarray(jv), rtol=1e-5, atol=1e-4)


def _both(fname, *args):
    """``fname`` of the two packages on the same (float32) arguments."""
    ja = [jnp.asarray(np.float32(a)) if isinstance(a, (float, np.ndarray)) else a for a in args]
    ta = [torch.from_numpy(np.asarray(a, np.float32)) if isinstance(a, np.ndarray) else a
          for a in args]
    return float(getattr(TS, fname)(*ta)), float(getattr(JS, fname)(*ja))


def test_multi_normal_matches_scipy_and_jax():
    from scipy.stats import multivariate_normal

    rng = np.random.default_rng(1)
    A = rng.normal(size=(3, 3))
    S = A @ A.T + 3 * np.eye(3)
    mu, y = rng.normal(size=3), rng.normal(size=3)
    want = multivariate_normal.logpdf(y, mu, S)
    L = np.linalg.cholesky(S)
    Y = rng.normal(size=(4, 3))
    for fname, args, w, rtol in [
        ("_lpdf_multi_normal", (y, mu, S), want, 1e-5),
        ("_lpdf_multi_normal_cholesky", (y, mu, L), want, 1e-5),
        ("_lpdf_multi_normal_prec", (y, mu, np.linalg.inv(S)), want, 1e-4),
        ("_lpdf_multi_normal", (Y, mu, S), sum(multivariate_normal.logpdf(yy, mu, S) for yy in Y),
         1e-5),
    ]:
        got, ref = _both(fname, *args)
        np.testing.assert_allclose(got, w, rtol=rtol)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_wishart_matches_scipy_and_jax():
    from scipy.stats import invwishart, wishart

    rng = np.random.default_rng(2)
    A = rng.normal(size=(3, 3))
    S = A @ A.T + 3 * np.eye(3)
    B = rng.normal(size=(3, 3))
    W = B @ B.T + 3 * np.eye(3)
    for fname, want in [("_lpdf_wishart", wishart.logpdf(W, 5, S)),
                        ("_lpdf_inv_wishart", invwishart.logpdf(W, 5, S))]:
        got, ref = _both(fname, W, 5.0, S)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# full models through both compilers
# ---------------------------------------------------------------------------

_LKJ_REGRESSION = """
data {
  int<lower=0> N;
  int<lower=1> J;
  int<lower=1> P;
  array[N] int<lower=1, upper=J> g;
  matrix[N, P] x;
  vector[N] y;
}
parameters {
  matrix[P, J] z;
  cholesky_factor_corr[P] L_Omega;
  vector<lower=0>[P] tau;
  real<lower=0> sigma;
}
transformed parameters {
  matrix[J, P] beta = (diag_pre_multiply(tau, L_Omega) * z)';
}
model {
  to_vector(z) ~ std_normal();
  L_Omega ~ lkj_corr_cholesky(2);
  tau ~ cauchy(0, 2.5);
  sigma ~ exponential(1);
  y ~ normal(rows_dot_product(beta[g], x), sigma);
}
"""


def _lkj_regression_data(seed=0, N=48, J=4, P=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, P))
    g = rng.integers(1, J + 1, size=N)
    beta_true = rng.normal(size=(J, P))
    y = np.sum(beta_true[g - 1] * x, axis=1) + 0.3 * rng.normal(size=N)
    return {"N": N, "J": J, "P": P, "g": g, "x": x, "y": y}


def test_lkj_varying_slopes_compiles_and_differentiates():
    _, t = hold(_LKJ_REGRESSION, _lkj_regression_data(), n=8, scale=0.3)
    assert t.dim == 2 * 4 + 1 + 2 + 1
    assert t.device_source is None and "2-D data 'x' (line 7)" in t.device_refusal


def test_lkj_varying_slopes_short_run():
    """The JAX file's end-to-end run, cut to two rounds of the port's
    ``AutoMALA`` on three chains: the extraction's shapes and a
    unit-diagonal correlation."""
    data = _lkj_regression_data(seed=3, N=120, J=3, P=2)
    t = T.stan_target(source=_LKJ_REGRESSION, data=data)
    pt = T.pigeons(target=t, n_rounds=2, n_chains=3, seed=1, show_report=False, device="cpu")
    cs = t.constrained_samples(pt)
    assert cs["beta"].shape[1:] == (3, 2)
    assert cs["L_Omega"].shape[1:] == (2, 2)
    corr = cs["L_Omega"] @ np.swapaxes(cs["L_Omega"], 1, 2)
    np.testing.assert_allclose(np.diagonal(corr, axis1=1, axis2=2), 1.0, atol=1e-5)


_MV_MODEL = """
data {
  int<lower=1> N;
  int<lower=1> K;
  array[N] vector[K] y;
}
parameters {
  vector[K] mu;
  cov_matrix[K] Sigma;
}
model {
  mu ~ normal(0, 5);
  Sigma ~ inv_wishart(K + 2, identity_matrix(K));
  for (n in 1:N)
    y[n] ~ multi_normal(mu, Sigma);
}
"""


def test_cov_matrix_multi_normal_model():
    rng = np.random.default_rng(4)
    N, Kd = 20, 3
    jt, t = hold(_MV_MODEL, {"N": N, "K": Kd, "y": rng.normal(size=(N, Kd))})
    assert t.dim == Kd + Kd * (Kd + 1) // 2
    assert t.sample_names(include_tp=False, include_gq=False) == \
        jt.sample_names(include_tp=False, include_gq=False)
    assert t.unconstrained_sample_names() == jt.unconstrained_sample_names()
    assert t.unconstrained_sample_names()[3].startswith("Sigma_unc")


_SIMPLEX_MODEL = """
data {
  int<lower=1> K;
  array[K] int<lower=0> counts;
}
parameters {
  simplex[K] theta;
}
model {
  theta ~ dirichlet(rep_vector(2.0, K));
  counts ~ multinomial(theta);
}
"""


def test_simplex_multinomial_model_and_run():
    counts = np.array([12, 30, 18])
    _, t = hold(_SIMPLEX_MODEL, {"K": 3, "counts": counts})
    assert t.dim == 2
    pt = T.pigeons(target=t, n_rounds=2, n_chains=3, seed=2, show_report=False, device="cpu")
    theta = t.constrained_samples(pt)["theta"]
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, atol=1e-5)


_ORDERED_MODEL = """
data { int<lower=1> N; vector[N] y; }
parameters {
  ordered[2] mu;
  real<lower=0> sigma;
}
model {
  mu ~ normal(0, 5);
  sigma ~ exponential(1);
  for (n in 1:N)
    target += log_sum_exp(
      log(0.5) + normal_lpdf(y[n] | mu[1], sigma),
      log(0.5) + normal_lpdf(y[n] | mu[2], sigma));
}
"""


def test_ordered_mixture_model():
    rng = np.random.default_rng(7)
    y = np.concatenate([rng.normal(-2, 0.5, 25), rng.normal(2, 0.5, 25)])
    hold(_ORDERED_MODEL, {"N": 50, "y": y})


_WHILE_MODEL = """
data { int<lower=1> N; }
transformed data {
  int s = 0;
  int i = 1;
  while (i <= N) {
    if (i == 4) { i += 1; continue; }
    if (i > 6) break;
    s += i;
    i += 1;
  }
  // s = 1+2+3+5+6 = 17
  int q = -7 / 2;   // Stan truncates toward zero: -3
  int r = -7 % 3;   // C semantics, sign of dividend: -1
}
parameters { real x; }
model { x ~ normal(s + q + r, 1); }
"""


def test_while_break_continue_and_int_division():
    _, t = hold(_WHILE_MODEL, {"N": 100})
    assert (t._data_env["s"], t._data_env["q"], t._data_env["r"]) == (17, -3, -1)
    lp = t.log_density(torch.tensor([[13.0], [0.0]]))
    np.testing.assert_allclose(float(lp[0] - lp[1]), 0.5 * 13.0**2, atol=1e-3)


def test_traced_while_condition_fails_loudly():
    src = """
parameters { real x; }
model {
  real y = x;
  while (y > 0) { y -= 1; }
  x ~ normal(0, 1);
}
"""
    t = T.stan_target(source=src)
    with pytest.raises(SyntaxError, match="while"):
        t.log_density(torch.zeros(1))
    with pytest.raises(SyntaxError, match="while"):
        t.log_density(torch.zeros(3, 1))


_SLICE_MODEL = """
data { int<lower=1> N; matrix[N, 3] X; }
parameters { vector[3] b; }
model {
  vector[3] c = X[1]';         // first row of a matrix
  b[1:2] ~ normal(0, 1);       // range index
  target += normal_lpdf(X[1:2, 1] | b[1], 2);  // sliced column
  b[3] ~ normal(dot_product(c, b), 10);
}
"""


def test_range_indexing_and_matrix_rows():
    hold(_SLICE_MODEL, {"N": 5, "X": np.random.default_rng(9).normal(size=(5, 3))})


_BUILTIN_MODEL = """
data { int<lower=1> K; matrix[K, K] A; vector[K] v; }
parameters { vector[K] w; }
model {
  matrix[K, K] S = quad_form_diag(A, exp(v));
  matrix[K, K] L = cholesky_decompose(S + diag_matrix(rep_vector(3.0, K)));
  vector[K] u = mdivide_left_tri_low(L, w);
  target += -0.5 * dot_self(u) - sum(log(diagonal(L)));
  target += trace(crossprod(L)) * 1e-6;
  w ~ normal(0, 10);
}
"""


def test_matrix_builtins_differentiate():
    rng = np.random.default_rng(11)
    B = rng.normal(size=(3, 3))
    hold(_BUILTIN_MODEL, {"K": 3, "A": B @ B.T + np.eye(3), "v": rng.normal(size=3) * 0.3})


def test_stan_mul_semantics():
    src = """
data { matrix[2, 3] A; vector[3] v; vector[2] u; }
parameters { real s; }
transformed parameters {
  vector[2] mv = A * v;        // matrix * vector
  real d = u' * mv;            // row * col -> dot
  matrix[2, 2] o = u * u';     // col * row -> outer
  matrix[3, 2] At = A';
}
model { s ~ normal(d + o[1, 2] + At[2, 1], 1); }
"""
    A = np.arange(6.0).reshape(2, 3)
    v = np.array([1.0, 2.0, 3.0])
    u = np.array([0.5, -1.0])
    _, t = hold(src, {"A": A, "v": v, "u": u})
    want = float(u @ (A @ v) + u[0] * u[1] + A.T[1, 0])
    lp = t.log_density(torch.tensor([[want], [want + 1.0]]))
    np.testing.assert_allclose(float(lp[0] - lp[1]), 0.5, atol=1e-4)


def test_array_of_simplexes():
    src = """
data { int<lower=1> J; int<lower=1> K; }
parameters { array[J] simplex[K] theta; }
model {
  for (j in 1:J)
    theta[j] ~ dirichlet(rep_vector(1.5, K));
}
"""
    _, t = hold(src, {"J": 3, "K": 4})
    assert t.dim == 3 * 3
    env, _ = t._constrain_env(torch.zeros(t.dim))
    np.testing.assert_allclose(env["theta"].numpy().sum(axis=1), 1.0, atol=1e-6)


_ORDINAL_MODEL = """
data {
  int<lower=0> N;
  int<lower=2> K;
  vector[N] x;
  array[N] int<lower=1, upper=K> y;
}
parameters {
  real beta;
  ordered[K - 1] c;
}
model {
  beta ~ normal(0, 5);
  c ~ normal(0, 5);
  y ~ ordered_logistic(beta * x, c);
}
"""


def test_ordered_logistic_regression():
    """The JAX file's direct numpy oracle at its point, and both packages on
    seeded states."""
    rng = np.random.default_rng(21)
    N, Kc = 60, 4
    x = rng.normal(size=N)
    y = rng.integers(1, Kc + 1, size=N)
    _, t = hold(_ORDINAL_MODEL, {"N": N, "K": Kc, "x": x, "y": y})
    th = np.array([0.8, -0.5, 0.1, 0.6])
    cc = np.concatenate(([th[1]], th[1] + np.cumsum(np.exp(th[2:]))))
    sig = lambda z: 1 / (1 + np.exp(-z))  # noqa: E731
    ce = np.concatenate(([-np.inf], cc, [np.inf]))
    lik = np.log(sig(th[0] * x - ce[y - 1]) - sig(th[0] * x - ce[y])).sum()
    prior = (-0.5 * (th[0] / 5) ** 2 - np.log(5) - 0.5 * np.log(2 * np.pi)
             + np.sum(-0.5 * (cc / 5) ** 2 - np.log(5) - 0.5 * np.log(2 * np.pi)))
    np.testing.assert_allclose(float(t.log_density(torch.tensor(th, dtype=torch.float32))),
                               lik + prior + th[2:].sum(), rtol=1e-5)


def test_glm_log_densities_match_scipy_and_jax():
    from scipy.stats import binom, nbinom, poisson

    mu, phi = np.exp(0.9), 3.0
    for fname, args, want in [
        ("_lpmf_poisson_log", (3.0, 1.2), poisson.logpmf(3, np.exp(1.2))),
        ("_lpmf_binomial_logit", (4.0, 10.0, 0.3), binom.logpmf(4, 10, 1 / (1 + np.exp(-0.3)))),
        ("_lpmf_neg_binomial_2_log", (5.0, 0.9, phi), nbinom.logpmf(5, phi, phi / (phi + mu))),
    ]:
        got, ref = _both(fname, *args)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_special_functions_match_scipy_and_jax():
    import scipy.special as sp
    from scipy.stats import norm

    x = 0.37
    for name, args, want, rtol in [
        ("Phi", (x,), norm.cdf(x), 1e-5),
        ("inv_Phi", (np.float32(0.84),), norm.ppf(0.84), 1e-4),
        ("erf", (x,), sp.erf(x), 1e-5),
        ("digamma", (2.5,), sp.digamma(2.5), 1e-5),
        ("trigamma", (2.5,), sp.polygamma(1, 2.5), 1e-4),
        ("log_mix", (0.3, -1.0, -2.0), np.log(0.3 * np.exp(-1.0) + 0.7 * np.exp(-2.0)), 1e-5),
        ("log_diff_exp", (-1.0, -3.0), np.log(np.exp(-1.0) - np.exp(-3.0)), 1e-5),
        ("lbeta", (2.0, 3.5), sp.betaln(2.0, 3.5), 1e-5),
    ]:
        got = float(TS._MATH_FNS[name](*args))
        np.testing.assert_allclose(got, want, rtol=rtol)
        np.testing.assert_allclose(got, float(JS._MATH_FNS[name](*args)), rtol=1e-5)


def test_log_mix_model_differentiates():
    src = """
data { int<lower=1> N; vector[N] y; }
parameters {
  real<lower=0, upper=1> theta;
  ordered[2] mu;
}
model {
  mu ~ normal(0, 5);
  for (n in 1:N)
    target += log_mix(theta,
                      normal_lpdf(y[n] | mu[1], 1),
                      normal_lpdf(y[n] | mu[2], 1));
}
"""
    rng = np.random.default_rng(23)
    hold(src, {"N": 40, "y": np.concatenate([rng.normal(-2, 1, 15), rng.normal(2, 1, 25)])})


def test_truncation_matches_analytic_and_jax():
    from scipy.stats import norm

    src = """
data { real y; }
parameters { real mu; }
model {
  mu ~ normal(0, 10);
  y ~ normal(mu, 2) T[-1, 3];
}
"""
    _, t = hold(src, {"y": 1.5})
    mu = 0.7
    want = (norm.logpdf(mu, 0, 10) + norm.logpdf(1.5, mu, 2)
            - np.log(norm.cdf(3, mu, 2) - norm.cdf(-1, mu, 2)))
    np.testing.assert_allclose(float(t.log_density(torch.tensor([mu]))), want, rtol=1e-5)
    assert float(T.stan_target(source=src, data={"y": 5.0}).log_density(torch.zeros(1))) == -np.inf
    _, t3 = hold(src.replace("T[-1, 3]", "T[0, ]"), {"y": 1.5})
    want_l = norm.logpdf(mu, 0, 10) + norm.logpdf(1.5, mu, 2) - np.log(1 - norm.cdf(0, mu, 2))
    np.testing.assert_allclose(float(t3.log_density(torch.tensor([mu]))), want_l, rtol=1e-5)


def test_lcdf_functions_match_scipy_and_jax():
    from scipy.stats import cauchy, expon, gamma, norm, t as student, weibull_min

    y = 1.3
    for name, args, want, rtol in [
        ("normal", (0.5, 2.0), norm.logcdf(1.3, 0.5, 2.0), 1e-5),
        ("exponential", (0.7,), expon.logcdf(1.3, scale=1 / 0.7), 1e-5),
        ("cauchy", (0.2, 1.5), cauchy.logcdf(1.3, 0.2, 1.5), 1e-5),
        ("gamma", (2.0, 1.5), gamma.logcdf(1.3, 2.0, scale=1 / 1.5), 1e-4),
        ("student_t", (5.0, 0.0, 1.0), student.logcdf(1.3, 5), 1e-4),
        ("weibull", (2.0, 1.5), weibull_min.logcdf(1.3, 2.0, scale=1.5), 1e-4),
    ]:
        got = float(TS._LCDFS[name](torch.tensor(y), *args))
        np.testing.assert_allclose(got, want, rtol=rtol)
        np.testing.assert_allclose(got, float(JS._LCDFS[name](jnp.asarray(y), *args)), rtol=1e-5)
    src = """
data { real y; }
parameters { real mu; }
model { target += normal_lcdf(y | mu, 1) + normal_lccdf(y | mu, 1); }
"""
    _, t = hold(src, {"y": 0.3})
    want = norm.logcdf(0.3, 0.1, 1) + norm.logsf(0.3, 0.1, 1)
    np.testing.assert_allclose(float(t.log_density(torch.tensor([0.1]))), want, rtol=1e-4)


def test_betainc_matches_jax_on_a_grid_with_both_tails():
    """The port's float32 ``betainc`` against ``jax.scipy.special.betainc``
    on shapes from 0.1 to 50 and x from 1e-6 to 1 - 1e-6: within 2e-6
    absolute and 2e-4 relative (XLA's own float32 continued fraction is
    within ~1e-6 of the float64 value that the port rounds once); the gradient
    in x is the beta density."""
    a = np.array([0.1, 0.5, 1.0, 2.5, 10.0, 50.0], np.float32)
    x = np.array([1e-6, 1e-4, 0.01, 0.2, 0.5, 0.8, 0.99, 0.9999, 1 - 1e-6], np.float32)
    A, B, X = (v.reshape(-1).astype(np.float32) for v in np.meshgrid(a, a, x, indexing="ij"))
    got = TS.betainc(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(X)).numpy()
    want = np.asarray(jax.scipy.special.betainc(A, B, X))
    assert np.all(np.abs(got - want) <= 2e-6 + 2e-4 * np.abs(want)), \
        np.max(np.abs(got - want) - 2e-4 * np.abs(want))
    xt = torch.tensor([0.3, 0.7], requires_grad=True)
    (g,) = torch.autograd.grad(TS.betainc(torch.tensor(2.0), torch.tensor(3.0), xt).sum(), xt)
    jg = jax.grad(lambda v: jnp.sum(jax.scipy.special.betainc(2.0, 3.0, v)))(
        jnp.asarray([0.3, 0.7], jnp.float32))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5)


def test_reject_statement_zeroes_density():
    src = """
parameters { real x; }
model {
  if (x > 1) reject("x too big");
  x ~ normal(0, 1);
}
"""
    _, t = hold(src, n=4, scale=2.0, grad=False)
    lp = t.log_density(torch.tensor([[0.5], [2.0]]))
    assert np.isfinite(float(lp[0])) and float(lp[1]) == -np.inf


def test_unsupported_constructs_fail_loudly():
    with pytest.raises(SyntaxError):
        T.stan_target(source="parameters { foo_bar_type[3] x; } model { }")
    t_tr = T.stan_target(source="parameters { real x; } model { x ~ von_mises(0, 1) T[0, ]; }")
    with pytest.raises(SyntaxError, match="truncation"):
        t_tr.log_density(torch.zeros(1))
    t = T.stan_target(source="parameters { real x; } model { x ~ no_such_dist(1); }")
    with pytest.raises(SyntaxError, match="unsupported density"):
        t.log_density(torch.zeros(1))


# ---------------------------------------------------------------------------
# the vectorized data loop
# ---------------------------------------------------------------------------

_BIG_LOOP = """
data { int<lower=1> N; vector[N] x; vector[N] y; }
parameters { real a; real b; real<lower=0> sigma; }
model {
  a ~ normal(0, 5);
  b ~ normal(0, 5);
  sigma ~ exponential(1);
  for (n in 1:N)
    y[n] ~ normal(a + b * x[n], sigma);
}
"""


def _big_loop_want(x, y, th):
    a, b, sigma = th[0], th[1], float(np.exp(th[2]))
    resid = y - (a + b * x)
    return (-0.5 * (a / 5) ** 2 - np.log(5) - 0.5 * np.log(2 * np.pi)
            - 0.5 * (b / 5) ** 2 - np.log(5) - 0.5 * np.log(2 * np.pi) - sigma + th[2]
            + np.sum(-0.5 * (resid / sigma) ** 2 - np.log(sigma) - 0.5 * np.log(2 * np.pi)))


def test_data_loop_vectorizes_and_evaluates_fast():
    """A 10^4-iteration data likelihood loop is evaluated once, vectorized,
    on 64 states at once."""
    rng = np.random.default_rng(13)
    N = 10_000
    x = rng.normal(size=N)
    y = 1.0 + 2.0 * x + 0.1 * rng.normal(size=N)
    t0 = time.time()
    t = T.stan_target(source=_BIG_LOOP, data={"N": N, "x": x, "y": y})
    lp = t.log_density(torch.zeros(64, t.dim))
    assert np.isfinite(lp.numpy()).all()
    th = [0.5, -0.3, 0.2]
    got = float(t.log_density(torch.tensor(th)))
    assert time.time() - t0 < 30.0
    np.testing.assert_allclose(got, _big_loop_want(x, y, np.array(th)), rtol=1e-5)


def test_vectorized_loop_matches_unrolled_and_jax():
    rng = np.random.default_rng(17)
    N = 40
    x = rng.normal(size=N)
    y = 0.5 + x + 0.2 * rng.normal(size=N)
    _, t = hold(_BIG_LOOP, {"N": N, "x": x, "y": y})
    th = [0.4, 0.9, -0.1]
    np.testing.assert_allclose(float(t.log_density(torch.tensor(th))),
                               _big_loop_want(x, y, np.array(th)), rtol=1e-5)
