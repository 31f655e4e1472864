"""The logistic regression's dense form (``LogisticRegressionLikelihood.dense``,
bench config 2b's ``n = 4,096, d = 256``) against the JAX package, on the CPU.

* The dense form's density and gradient against ``jit(vmap(value_and_grad(
  log_density)))`` of the JAX model on its own ``X`` and ``y``, at 2b's shape
  and at the fewest observations where the rule takes it (1,025): values
  within 1e-6 relative, gradients within 1e-5 of the lane's largest
  component. Its terms keep the JAX terms' values (``logaddexp(z, 0)``) and
  gradients at +-inf, NaN and around 20, where ``F.softplus`` switches.
* The rule: the column form (bitwise the slice kernel's) up to 1,024
  observations, at 200 x 10 and 1,024 x 32 among them; the dense form above.
  The kernel's route (``sweep_log_density``, the twin) keeps the column form
  at every shape.
* A round of the queued search above 1,024 observations creates no float64
  tensor of a row's size and no ``[lanes, n, d]`` tensor.
* ``logistic_regression_data(4096, 256, 0)`` draws JAX's labels, and its
  ``X`` within 2 ulp of JAX's.
* One queued ``AutoMALA(queue_width=64, window=2)`` explore of 128 lanes at
  2b's shape against the JAX explorer's ``step_batched``: at most 1 % of the
  lanes end elsewhere; the others within 1e-4 relative.
* Three rounds of both packages from one state at 2b's shape (the JAX
  package runs round 1, ``convert.state_from_numpy`` carries it across):
  permutations, restarts, round trips and evaluation counts exact; schedule
  within 1e-6, barrier within 1e-3, logZ within 1e-6 relative, states within
  1e-5 relative.

``tests/logistic_form_study.py`` is the study behind the rule; the card's
side is in ``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu_torch import convert, paths
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.models import library
from pigeons_tpu_torch.ops import cuda_slice

N_2B, D_2B = 4096, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which the thread pool slows when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


@functools.lru_cache(maxsize=None)
def _models(n, d):
    """The JAX model and the port's on the JAX model's ``X`` and ``y``."""
    jm = J.logistic_regression(n, d, seed=0)
    fn = jm.log_likelihood_fn
    return jm, convert.bayesian_model_from_numpy("logistic_regression", X=_closure(fn, "X"),
                                                 y=_closure(fn, "y"))


def _assert_close(lp, grad, want_lp, want_grad):
    np.testing.assert_allclose(lp, want_lp, rtol=1e-6)
    scale = np.abs(want_grad).max(1)
    assert (np.abs(grad - want_grad).max(1) / scale).max() <= 1e-5


@pytest.mark.parametrize("n,d", [(N_2B, D_2B), (1025, 10)])
def test_dense_form_matches_jax_value_and_grad(n, d):
    jm, tm = _models(n, d)
    assert tm.log_likelihood_fn.uses_dense
    x = (np.random.RandomState(2).normal(size=(64, jm.dim)) * 0.3).astype(np.float32)
    jv, jg = jax.jit(jax.vmap(jax.value_and_grad(jm.log_density)))(x)
    path = tm.create_path(tm.default_reference())
    lp, grad = paths.value_and_grad(path, torch.from_numpy(x), torch.ones(64))
    _assert_close(lp.numpy(), grad.numpy(), np.asarray(jv), np.asarray(jg))


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_dense_terms_keep_jax_values_at_the_edges(label):
    """One observation with ``X = [[1]]``: the dense form is ``y z -
    softplus(z)`` with ``z = w``, held to the JAX model's ``y z -
    jax.nn.softplus(z)`` (``logaddexp(z, 0)``) and to its gradient, at the
    infinities, NaN and on both sides of 20, where ``F.softplus`` switches
    to ``z``. XLA flushes ``softplus(-100)``, a subnormal, to zero."""
    z = np.array([-np.inf, -100.0, -30.0, -1.0, 0.0, 1e-8, 1.0, 17.0, 19.9, 20.0, 20.1, 30.0,
                  100.0, np.inf, np.nan], np.float32)
    like = library.LogisticRegressionLikelihood(torch.ones(1, 1), torch.full((1,), label))
    w = torch.from_numpy(z[:, None]).requires_grad_(True)
    val = like.dense({"w": w, "b": torch.zeros(len(z))})
    (g,) = torch.autograd.grad(val.sum(), w)

    def jterm(zz):
        return label * zz - jax.nn.softplus(zz)

    want = np.asarray(jax.vmap(jterm)(z))
    want_g = np.asarray(jax.vmap(jax.grad(jterm))(z))
    # NaN where JAX has NaN, infinities equal
    np.testing.assert_allclose(val.detach().numpy(), want, rtol=1e-6, atol=1e-37)
    np.testing.assert_allclose(g[:, 0].numpy(), want_g, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,d,dense", [(200, 10, False), (1024, 32, False), (1024, 1, False),
                                       (1025, 10, True), (N_2B, D_2B, True)])
def test_rule_picks_the_form(n, d, dense):
    X = torch.from_numpy(np.random.RandomState(n).normal(size=(n, d)).astype(np.float32))
    like = library.LogisticRegressionLikelihood(X, (X[:, 0] > 0).float())
    assert like.uses_dense is dense
    q = {"w": torch.from_numpy(np.random.RandomState(1).normal(size=(8, d)).astype(np.float32)),
         "b": torch.linspace(-1.0, 1.0, 8)}
    want = (like.dense if dense else like.sweep)(q)
    assert torch.equal(like(q).view(torch.int32), want.view(torch.int32))


def test_column_form_keeps_config_2a_bits():
    """At 200 x 10 the call is the column form, which is the slice kernel's
    sum: its density is the JAX model's bit for bit in most lanes, as
    before."""
    jm, tm = _models(200, 10)
    x = (np.random.RandomState(1).normal(size=(64, jm.dim)) * 0.1).astype(np.float32)
    have = tm.log_density(torch.from_numpy(x)).numpy()
    assert (have == np.asarray(jax.jit(jax.vmap(jm.log_density))(x))).sum() >= 48


@pytest.mark.parametrize("n", [1100, N_2B])
def test_kernel_route_keeps_the_column_form(n):
    """The slice kernel computes the column form at every shape: so do its
    twin's density (``sweep_log_density``) and ``device()``; the runtime's
    density is the dense form, within float32 rounding of it."""
    d = 4
    X = torch.from_numpy(np.random.RandomState(0).normal(size=(n, d)).astype(np.float32))
    model = T.logistic_regression(X=X, y=(X[:, 1] > 0).float())
    path = model.create_path(model.default_reference())
    x = model.initialization(trng.keys_for(trng.key(3), torch.arange(16)))
    beta = torch.linspace(0.0, 1.0, 16)
    like = model.log_likelihood_fn
    q = model.constrain(x)[0]
    prior = model.log_prior(x)
    column = paths._guarded_mul(1.0 - beta, prior) + paths._guarded_mul(beta, prior + like.sweep(q))
    twin = cuda_slice.sweep_density(path)(x, beta)
    assert torch.equal(twin.view(torch.int32), column.view(torch.int32))
    assert torch.equal(path.sweep_log_density(x, beta).view(torch.int32), column.view(torch.int32))
    runtime = paths.lane_log_density(path, x, beta)
    np.testing.assert_allclose(runtime.numpy(), column.numpy(), rtol=1e-6)
    kind, params, arrays = like.device()
    assert kind == paths.LOGISTIC_REGRESSION and params == (float(n),)
    assert torch.equal(arrays[0], X.reshape(-1))


class _LargestOutputs(TorchDispatchMode):
    """The most elements of any tensor an operation returns, and of any
    float64 one."""

    def __init__(self):
        super().__init__()
        self.largest = self.largest_float64 = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
                if t.dtype == torch.float64:
                    self.largest_float64 = max(self.largest_float64, t.numel())
        return out


def test_dense_runs_hold_no_float64_row_and_no_lane_row_column_tensor():
    """A round of the queued AutoMALA above 1,024 observations (the runtime's
    density passes, the gradients, the queued search): no operation returns
    a float64 tensor with as many elements as the observations, nor any
    tensor of two design matrices' size (a ``[lanes, n, d]`` one). With at
    most 8 lanes a trial and ``d = 16``, ``[lanes, n]`` float32 logits are
    below that."""
    n, d = 1100, 16
    X = torch.from_numpy(np.random.RandomState(0).normal(size=(n, d)).astype(np.float32))
    model = T.logistic_regression(X=X, y=(X[:, 0] > 0).float())
    pt = T.PT(T.Inputs(target=model, n_chains=3, n_replicates=2, seed=1, show_report=False,
                       explorer=T.AutoMALA(queued=True, queue_width=4, window=2), device="cpu"))
    with _LargestOutputs() as sizes:
        pt.run_round(n_scans=2)
    print(f"largest output {sizes.largest} elements, largest float64 {sizes.largest_float64}")
    assert sizes.largest_float64 < n
    assert sizes.largest < 2 * n * d


def test_synthetic_data_matches_jax_at_config_2b():
    jm, _ = _models(N_2B, D_2B)
    X, y = library.logistic_regression_data(N_2B, D_2B, 0)
    jX, jy = _closure(jm.log_likelihood_fn, "X"), _closure(jm.log_likelihood_fn, "y")
    assert int((y.numpy() != jy).sum()) == 0
    ulps = np.abs(X.numpy().view(np.int32).astype(np.int64) - jX.view(np.int32).astype(np.int64))
    print(f"X: {int((ulps > 0).sum())} of {ulps.size} draws differ, by at most {ulps.max()} ulp")
    assert ulps.max() <= 2


def _near_map_lanes(jm, n_lanes, seed):
    """States around the float64 MAP (Newton's method) with Laplace standard
    deviations, betas in [0, 1] (a quarter of them 1), step sizes and
    preconditioner scales near what adaptation gives."""
    fn = jm.log_likelihood_fn
    X, y = _closure(fn, "X").astype(np.float64), _closure(fn, "y").astype(np.float64)
    Xa = np.hstack([X, np.ones((X.shape[0], 1))])
    theta = np.zeros(Xa.shape[1])
    for _ in range(50):
        p = 1.0 / (1.0 + np.exp(-(Xa @ theta)))
        hess = -(Xa.T * (p * (1.0 - p))) @ Xa - np.eye(Xa.shape[1]) / 4.0  # N(0, 2^2) priors
        step = np.linalg.solve(hess, Xa.T @ (y - p) - theta / 4.0)
        theta = theta - step
        if np.abs(step).max() < 1e-10:
            break
    sd = np.sqrt(np.diag(np.linalg.inv(-hess)))
    r = np.random.RandomState(seed)
    x = (theta + sd * r.normal(size=(n_lanes, len(theta)))).astype(np.float32)
    beta = r.uniform(size=n_lanes).astype(np.float32)
    beta[::4] = 1.0
    std = (sd * np.abs(1.0 + 0.2 * r.normal(size=x.shape))).astype(np.float32)
    step = np.exp(r.normal(size=n_lanes) * 0.5).astype(np.float32)
    return x, beta, std, step


def test_queued_explore_matches_jax_at_config_2b():
    """Config 2b's explorer (the queue narrowed to 64 for 128 lanes), one
    whole explore (21 refreshments at d = 257) from the same keys and
    states. A lane whose decisions all agree ends within 1e-4 relative; a
    lane with a differing decision (a near tie read the other way: the
    forms' sums differ in the last bits) ends elsewhere, at most 1 %."""
    jm, tm = _models(N_2B, D_2B)
    L = 128
    x, beta, std, step = _near_map_lanes(jm, L, 0)
    kw = dict(queued=True, queue_width=64, window=2)
    jp = jm.create_path(jm.default_reference())

    def ld(xx, b, iv, rp):
        lp = jp.log_density(xx, b)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    jk = jrng.keys_for(jax.random.key(8), jnp.arange(L))
    lp0 = jax.vmap(lambda xx, b: ld(xx, b, 0.0, ()))(x, beta)
    jo = jax.jit(lambda k, xs, lp, b, st, s: J.AutoMALA(**kw).step_batched(
        k, xs, lp, ld, b, jnp.zeros(L), (), {"step_size": s, "std_devs": st}, 2))(
        jk, x, lp0, beta, std, step)
    to = T.AutoMALA(**kw).step_batched(
        trng.keys_for(trng.key(8), torch.arange(L)), torch.from_numpy(x), torch.from_numpy(beta),
        tm.create_path(tm.default_reference()),
        chain_params={"step_size": torch.from_numpy(step), "std_devs": torch.from_numpy(std)},
        scan_idx=2)
    jx, tx = np.asarray(jo.x), to.x.numpy()
    same = np.abs(jx - tx).max(1) <= 1e-4 * np.maximum(np.abs(jx).max(1), 1.0)
    same &= np.asarray(jo.n_steps) == to.n_steps.numpy()
    same &= (np.asarray(jo.extras_sum) == to.extras_sum.numpy()).all(1)
    print(f"{int((~same).sum())} of {L} lanes end elsewhere; "
          f"{float(np.asarray(jo.n_steps).mean()):.1f} evaluations per lane")
    assert (~same).sum() <= 0.01 * L
    assert np.array_equal(np.asarray(jo.extras_n), to.extras_n.numpy())
    assert np.array_equal(np.asarray(jo.accept_n), to.accept_n.numpy())
    np.testing.assert_allclose(to.lp.numpy()[same], np.asarray(jo.lp)[same], rtol=1e-6)


def test_three_round_run_matches_jax_at_config_2b():
    jm, tm = _models(N_2B, D_2B)
    kw = dict(seed=3, n_chains=3, n_replicates=2, show_report=False)
    ex = dict(queued=True, queue_width=4, window=2)
    ja = J.PT(J.Inputs(target=jm, explorer=J.AutoMALA(**ex), **kw))
    ta = T.PT(T.Inputs(target=tm, explorer=T.AutoMALA(**ex), device="cpu", **kw))
    ja.run_round(n_scans=2)
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states),
                                  "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": np.asarray(ja.schedule.grids)}, round_idx=1)
    convert.explorer_state_from_numpy(ta, {k: np.asarray(v) for k, v in ja.exp_state.items()})
    for _ in range(2):
        ja.run_round(n_scans=2)
        ta.run_round(n_scans=2)
        rj, rt = ja.reports[-1], ta.reports[-1]
        assert rj.n_tempered_restarts == rt.n_tempered_restarts
        assert rj.n_round_trips == rt.n_round_trips
        assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
        assert np.array_equal(np.asarray(ja.replica_of), ta.replica_of.numpy())
        assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
        assert np.array_equal(ja.reduced.accept_n, ta.reduced.accept_n)
        np.testing.assert_allclose(ta.schedule.grids, ja.schedule.grids, atol=1e-6)
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.log_z_estimate - rt.log_z_estimate) <= 1e-6 * abs(rj.log_z_estimate)
        np.testing.assert_allclose(ta.exp_state["step_size"].numpy(),
                                   np.asarray(ja.exp_state["step_size"]), rtol=1e-6)
    sj, st = np.asarray(ja.states), ta.states.numpy()
    assert (np.abs(st - sj) / np.maximum(np.abs(sj), 1.0)).max() <= 1e-5
