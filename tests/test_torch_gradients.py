"""The port's gradients against ``jax.grad`` of the JAX package, on the CPU.

(a) ``f32math``'s differentiable entry points ``fma``, ``exp``, ``log``,
    ``log1p``, ``lgamma``: with an input that requires a gradient the forward
    gives the plain function's bits, and the gradient matches ``jax.grad`` of
    the same ``jnp`` function within 1e-6 relative (``lgamma``: 1e-5 relative
    or 1e-6 absolute, torch's ``digamma`` against XLA's, near its root).
    Without one, the call is the plain function (no autograd node).
    ``softplus`` and ``sigmoid`` follow JAX's own rules (``logaddexp``'s
    custom JVP, ``logistic``'s ``s (1 - s)``) at 0, in the tails and at
    infinities. ``fma`` is correctly rounded: bitwise its earlier, longer
    form on random, cancelling and midpoint triples and on every special
    value. ``sum_in_order``, one autograd node, gives the chain of adds'
    value and gradients bit for bit.
(b) ``paths.value_and_grad`` against ``jit(vmap(value_and_grad(ld)))`` of the
    JAX path, ``ld`` the runtime's density with NaN read as -inf, on the same
    numpy-seeded states and betas (some at 0 and 1, some far out), for the
    toy MVN path, funnel, banana, MVN, logistic regression, hierarchical
    normal, eight schools, unid, and the funnel under a fitted
    ``GaussianReference`` (``VariationalPath``, both legs). The models run on
    the JAX models' own data (``convert.bayesian_model_from_numpy``). Values
    are bitwise the port's ``lane_log_density`` (the forward is unchanged)
    and within 1e-6 relative of JAX's (its gradient program may fuse the
    forward differently); gradients within 1e-5 of the lane's largest |g|
    (float32 sums of d or n terms in another order); the lanes whose value
    or gradient is not finite are the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu_torch import convert, f32math, paths
from pigeons_tpu_torch.models import distributions as TD

B = 256
RS = np.random.RandomState

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which the thread pool slows when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _x(shape, seed, scale=1.0):
    return (RS(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) f32math


UNARY = {
    "exp": (f32math.exp, f32math._exp, jnp.exp, lambda r: r.normal(size=512) * 10.0),
    "log": (f32math.log, f32math._log, jnp.log, lambda r: np.exp(r.normal(size=512) * 5.0)),
    "log1p": (f32math.log1p, f32math._log1p, jnp.log1p,
              lambda r: np.expm1(r.normal(size=512) * 2.0)),
    "lgamma": (f32math.lgamma, f32math._lgamma, jax.scipy.special.gammaln,
               lambda r: 0.5 + np.exp(r.normal(size=512) * 2.0)),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_function_forward_bitwise_and_gradient(name):
    fn, plain, jfn, draw = UNARY[name]
    x = draw(RS(1)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    assert y.grad_fn is not None
    assert torch.equal(y.detach(), plain(torch.tensor(x)))
    (g,) = torch.autograd.grad(y.sum(), xt)
    jg = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v)))(x))
    # digamma, torch's against XLA's: 1e-5 relative, 1e-6 absolute near its root at 1.46
    rtol, atol = (1e-5, 1e-6) if name == "lgamma" else (1e-6, 0.0)
    np.testing.assert_allclose(g.numpy(), jg, rtol=rtol, atol=atol)
    with torch.no_grad():
        assert fn(xt).grad_fn is None
    assert fn(torch.tensor(x)).grad_fn is None


def test_fma_forward_bitwise_and_gradient():
    r = RS(2)
    a, b, c = (r.normal(size=(4, 64)).astype(np.float32) for _ in range(3))
    b = b[:1]  # broadcast: the gradient is summed back to b's shape
    ta, tb, tc = (torch.tensor(v, requires_grad=True) for v in (a, b, c))
    y = f32math.fma(ta, tb, tc)
    assert torch.equal(y.detach(), f32math._fma(torch.tensor(a), torch.tensor(b), torch.tensor(c)))
    got = torch.autograd.grad(y.sum(), (ta, tb, tc))
    want = jax.grad(lambda a, b, c: jnp.sum(a * b + c), argnums=(0, 1, 2))(a, b, c)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    # a constant operand: only the tensors get a gradient
    (gx,) = torch.autograd.grad(f32math.fma(ta, 3.0, 0.5).sum(), (ta,))
    assert torch.equal(gx, torch.full_like(gx, 3.0))


def _fma_reference(a, b, c):
    """The float32 fused multiply-add by TwoSum and a step to the odd
    neighbour, written out case by case (the form ``f32math._fma`` had
    before its round to odd was folded into fewer operations)."""
    a, b, c = a.double(), b.double(), c.double()
    prod = a * b
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    inexact = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(inexact, (bits + step).view(torch.float64), s).float()


@pytest.mark.parametrize("kind", ["scaled normals", "bit patterns", "cancellation", "midpoints"])
def test_fma_is_correctly_rounded(kind):
    """Bitwise the reference form on 10^5 triples of each kind, among them
    sums that cancel and sums a tiny addend puts on a rounding midpoint,
    and on every triple of special values."""
    r = RS(3)
    n = 100_000
    if kind == "scaled normals":
        a = r.normal(size=n) * 10.0 ** r.uniform(-5, 5, n)
        b, c = r.normal(size=n), r.normal(size=n)
    elif kind == "bit patterns":
        a, b, c = (r.randint(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
                   for _ in range(3))
    else:
        a, b = r.normal(size=n).astype(np.float32), r.normal(size=n).astype(np.float32)
        ab = a.astype(np.float64) * b
        c = -ab * (1 + r.normal(size=n) * 1e-7) if kind == "cancellation" else \
            ab * 2.0 ** -r.randint(24, 80, n) * r.choice([-1, 1], n)
    a, b, c = (torch.tensor(np.asarray(v, np.float32)) for v in (a, b, c))
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1e-45, -1e-45,
                            3.4e38, -3.4e38, 1.0, -1.0])
    grid = [g.reshape(-1) for g in torch.meshgrid(special, special, special, indexing="ij")]
    for x, y, z in ((a, b, c), grid):
        have, want = f32math._fma(x, y, z), _fma_reference(x, y, z)
        same = (have.view(torch.int32) == want.view(torch.int32)) | (
            torch.isnan(have) & torch.isnan(want))
        assert bool(same.all())


@pytest.mark.parametrize("name", ["softplus", "sigmoid"])
def test_softplus_and_sigmoid_follow_jax_rules(name):
    x = np.array([0.0, -0.0, 1e-3, -2.0, 5.0, 30.0, -30.0, 100.0, -100.0, 90.0, -90.0],
                 np.float32)
    fn = {"softplus": TD.softplus, "sigmoid": TD.sigmoid}[name]
    jfn = {"softplus": jax.nn.softplus, "sigmoid": jax.nn.sigmoid}[name]
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    with torch.no_grad():
        assert torch.equal(y, fn(torch.tensor(x)))
    (g,) = torch.autograd.grad(y.sum(), xt)
    jg = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(jfn(v))))(x))
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("n", [1, 2, 11, 256])
def test_sum_in_order_is_the_chain_of_adds(n):
    """``sum_in_order`` with a gradient is one autograd node: its forward and
    the gradient it hands each term are the chain of adds', bit for bit,
    downstream of a float32 step and at infinities and NaN."""
    x = np.random.RandomState(n).normal(size=(64, n)).astype(np.float32) * 3.0
    x[0, 0], x[1, -1], x[2, n // 2] = np.inf, np.nan, -np.inf
    out = []
    for chain in (True, False):
        xt = torch.tensor(x, requires_grad=True)
        terms = f32math.fma(xt, xt, 0.5)
        if chain:
            cols = terms.unbind(-1)
            acc = cols[0]
            for c in cols[1:]:
                acc = acc + c
        else:
            acc = TD.sum_in_order(terms)
        (g,) = torch.autograd.grad((acc * torch.linspace(-1.0, 2.0, 64)).sum(), xt)
        out.append((acc.detach(), g))
    (a, ga), (b, gb) = out
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(ga.view(torch.int32), gb.view(torch.int32))


# ---------------------------------------------------------------------------
# (b) value_and_grad of the paths


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _bayesian(name):
    """The JAX model and the port's on the JAX model's own data."""
    jm = getattr(J, name)()
    fn = jm.log_likelihood_fn
    if name == "hierarchical_normal":
        return jm, convert.bayesian_model_from_numpy(name, data=_closure(fn, "data"))
    if name == "eight_schools":
        return jm, convert.bayesian_model_from_numpy(name, y=_closure(fn, "y"),
                                                     sigma=_closure(fn, "sigma"))
    if name == "logistic_regression":
        return jm, convert.bayesian_model_from_numpy(name, X=_closure(fn, "X"), y=_closure(fn, "y"))
    return jm, convert.bayesian_model_from_numpy(name, n_trials=100, n_successes=50)


def _paths(name):
    """``(jax ld(x, beta, isvar, ref_params), port path, dim, scale of the
    states, jax ref_params, port ref_params)``."""
    if name == "toy_mvn":
        jt, tt = J.toy_mvn_target(4), T.toy_mvn_target(4)
        jp, tp, scale = jt.create_path(None), tt.create_path(None), 1.0
    elif name in ("funnel", "banana", "mvn"):
        jt, tt = {"funnel": (J.funnel(4), T.funnel(4)), "banana": (J.banana(4), T.banana(4)),
                  "mvn": (J.mvn_target(5), T.mvn_target(5))}[name]
        jp = jt.create_path(jt.default_reference())
        tp, scale = tt.create_path(tt.default_reference()), 2.0
    elif name == "funnel_variational":
        jt, tt = J.funnel(4), T.funnel(4)
        jfixed = jt.create_path(jt.default_reference())
        tfixed = tt.create_path(tt.default_reference())
        mean, std = _x(5, 7, 0.5), np.abs(_x(5, 8)) + 0.5
        jref = {"mean": jnp.asarray(mean), "std": jnp.asarray(std), "active": jnp.float32(1.0)}
        tref = {"mean": torch.tensor(mean), "std": torch.tensor(std), "active": torch.tensor(1.0)}

        def jld(x, beta, isvar, ref_params):  # pigeons_tpu/pt.py:646-658
            from pigeons_tpu.paths import _guarded_mul

            l_fixed = jfixed.log_density(x, beta)
            l_var = _guarded_mul(1.0 - beta, J.GaussianReference.log_density(x, ref_params)) + \
                _guarded_mul(beta, jfixed.log_density(x, jnp.ones_like(beta)))
            lp = jnp.where((isvar > 0) & (ref_params["active"] > 0), l_var, l_fixed)
            return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

        return jld, T.VariationalPath(tfixed, T.GaussianReference()), 5, 2.0, jref, tref
    else:
        jm, tm = _bayesian(name)
        jp, tp, scale = jm.create_path(jm.default_reference()), \
            tm.create_path(tm.default_reference()), 1.5

    def jld(x, beta, isvar, ref_params):
        lp = jp.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    dim = 4 if name == "toy_mvn" else (tt.dim if name in ("funnel", "banana", "mvn") else tm.dim)
    return jld, tp, dim, scale, (), None


PATHS = ["toy_mvn", "funnel", "banana", "mvn", "logistic_regression", "hierarchical_normal",
         "eight_schools", "unid_target", "funnel_variational"]


@pytest.mark.parametrize("name", PATHS)
def test_value_and_grad_matches_jax(name):
    jld, tpath, d, scale, jref, tref = _paths(name)
    x = _x((B, d), 11, scale)
    x[:4] *= 30.0  # far out: overflows, underflows, out of support
    x[4] = 0.0
    beta = RS(12).uniform(size=B).astype(np.float32)
    beta[8:16], beta[16:24] = 0.0, 1.0
    isvar = (np.arange(B) % 2).astype(np.float32)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(jld), in_axes=(0, 0, 0, None)))(
        x, beta, isvar, jref)
    jl, jg = np.asarray(jl), np.asarray(jg)
    xt, bt, it = torch.tensor(x), torch.tensor(beta), torch.tensor(isvar)
    tl, tg = paths.value_and_grad(tpath, xt, bt, it, tref)
    tl, tg = tl.numpy(), tg.numpy()
    # the forward is the runtime's density, bit for bit
    assert np.array_equal(tl, paths.lane_log_density(tpath, xt, bt, it, tref).numpy())
    fin_j = np.isfinite(jl) & np.isfinite(jg).all(1)
    fin_t = np.isfinite(tl) & np.isfinite(tg).all(1)
    assert np.array_equal(np.isfinite(tl), np.isfinite(jl))
    assert np.array_equal(fin_t, fin_j)
    assert np.array_equal(tl[~np.isfinite(jl)], jl[~np.isfinite(jl)])
    lane_scale = np.maximum(np.abs(jg).max(1), np.finfo(np.float32).tiny)[fin_j]
    gerr = (np.abs(tg - jg).max(1)[fin_j] / lane_scale).max()
    lerr = (np.abs(tl - jl) / np.maximum(np.abs(jl), np.finfo(np.float32).tiny))[fin_j].max()
    print(f"{name}: {int(fin_j.sum())} finite lanes of {B}; values {int((tl != jl).sum())} "
          f"not bitwise JAX's, max rel {lerr:.3g}; gradients max err / lane max|g| {gerr:.3g}")
    assert lerr <= 1e-6
    assert gerr <= 1e-5
