"""Kernel K2's twin with array inputs against the JAX package's general Pallas
slice kernel, and ``BayesianModel`` runs in both packages, on the CPU.

The JAX side runs ``SliceSamplerPallas(interpret=True, n_passes=1)
.step_batched`` (``_sweep_kernel`` in the Pallas interpreter, which receives
the model's data and the reference's ``mean`` / ``std`` / ``active`` as
hoisted array inputs) with the runtime's ``ld`` closure; the port runs
``SliceSamplerCUDA(n_passes=1).step_batched``, which on CPU tensors goes to
``sweep_reference``. The port's models are built on the JAX models' own data
(``convert.bayesian_model_from_numpy``).

(a) One sweep of ``hierarchical_normal()`` (d = 23, 200 observations),
    ``eight_schools()`` (d = 10), ``unid_target()`` (d = 2) and
    ``logistic_regression()`` (d = 11, 200 observations), 8 lanes from
    a numpy seed, betas including 0 and 1: states, returned densities and
    the stats rows accept_sum, accept_n and n_evals **bitwise**; no lane may
    diverge.
    The same, bitwise, at other shapes: the hierarchical normal at 5 x 3,
    8 x 4, 20 x 16 and 7 x 10, the logistic regression at 64, 100 and 256
    observations (the summation orders of ``library.row_partials`` and
    ``library.sum_by_windows``). At 36 x 10, past the rows whose order is
    known, within 1e-5 relative, decisions exact.
(b) The same for the funnel (not separable, so K1 cannot take it) and eight
    schools under a ``GaussianReference``, lanes of both legs, the reference
    active and not: bitwise; before activation the sweep is the fixed
    path's.
(c) Three-round runs of each model in both packages from one state: the JAX
    package runs round 1 from the seed, ``convert.state_from_numpy`` carries
    its state into the port (the two packages' own initial states differ in
    the last bits of the prior's half-Cauchy draws), and both run rounds 2
    and 3. Exact: permutations, restarts, round trips and the explorer's
    step counts (``exp_steps``). Within 1e-6: the schedule. Within 1e-3
    absolute: barrier and logZ of each round (sums of densities that differ
    in last bits outside the kernel). States within 1e-5 relative with flips
    counted (none allowed).

The kernel itself runs only on a card (``tests/test_torch_cuda.py``) and,
compiled for the host, in ``tests/test_torch_csrc_host*.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import SliceSamplerPallas
from pigeons_tpu import rng as jrng
from pigeons_tpu_torch import convert
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice

B = 8


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _models(name):
    """The JAX model and the port's on the same data."""
    if name == "hierarchical_normal":
        jm = J.hierarchical_normal()
        return jm, convert.bayesian_model_from_numpy(name, data=_closure(jm.log_likelihood_fn, "data"))
    if name == "eight_schools":
        jm = J.eight_schools()
        fn = jm.log_likelihood_fn
        return jm, convert.bayesian_model_from_numpy(name, y=_closure(fn, "y"), sigma=_closure(fn, "sigma"))
    if name == "unid_target":
        return J.unid_target(), convert.bayesian_model_from_numpy(name, n_trials=100, n_successes=50)
    if name == "logistic_regression":
        jm = J.logistic_regression()
        fn = jm.log_likelihood_fn
        return jm, convert.bayesian_model_from_numpy(name, X=_closure(fn, "X"), y=_closure(fn, "y"))
    d = int(name.split()[1])
    return J.funnel(d - 1), T.funnel(d - 1)


MODELS = ["hierarchical_normal", "eight_schools", "unid_target", "logistic_regression"]


def _inputs(d, seed):
    rs = np.random.RandomState(seed)
    xs = rs.normal(size=(B, d)).astype(np.float32)
    betas = rs.uniform(0.0, 1.0, B).astype(np.float32)
    betas[[0, 1, -2, -1]] = 0.0, 1.0, 0.0, 1.0  # both ends, on both legs where there are two
    return xs, betas


def _guard(lp):
    return jnp.where(jnp.isnan(lp), -jnp.inf, lp)


def _jax_sweep(ld, xs, betas, isvar, ref_params, key_seed, n_passes):
    keys = jrng.keys_for(jax.random.key(key_seed), jnp.arange(len(xs)))
    out = SliceSamplerPallas(interpret=True, n_passes=n_passes).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(len(xs)), ld, jnp.asarray(betas), jnp.asarray(isvar),
        ref_params, (), 1, ld_coord=None)
    return {k: np.asarray(getattr(out, k)) for k in ("x", "lp", "accept_sum", "accept_n", "n_steps")}


def _assert_bitwise(ref, out):
    got = {"x": out.x, "lp": out.lp, "accept_sum": out.accept_sum, "accept_n": out.accept_n,
           "n_steps": out.n_steps}
    for name, want in ref.items():
        have = got[name].numpy()
        n_diff = int((have.view(np.int32) != want.view(np.int32)).sum())
        assert n_diff == 0, f"{name}: {n_diff} of {want.size} elements differ in their bits"


@pytest.mark.parametrize("name,n_passes", [("hierarchical_normal", 1), ("eight_schools", 1),
                                           ("eight_schools", 2), ("unid_target", 1),
                                           ("unid_target", 2), ("logistic_regression", 1)])
def test_twin_matches_pallas_kernel(name, n_passes):
    jm, tm = _models(name)
    jpath = jm.create_path(jm.default_reference())
    tpath = tm.create_path(tm.default_reference())
    xs, betas = _inputs(jm.dim, n_passes)
    ref = _jax_sweep(lambda x, beta, isvar, rp: _guard(jpath.log_density(x, beta)), xs, betas,
                     np.zeros(B, np.float32), (), 7, n_passes)
    keys = trng.keys_for(trng.key(7), torch.arange(B))
    before = dict(SliceSamplerCUDA.launches)
    out = SliceSamplerCUDA(n_passes=n_passes).step_batched(
        keys, torch.from_numpy(xs), torch.from_numpy(betas), tpath)
    assert SliceSamplerCUDA.launches == before  # CPU tensors: the twin
    _assert_bitwise(ref, out)
    assert not np.array_equal(out.x.numpy(), xs)  # the sweep moved
    fresh = cuda_slice.sweep_density(tpath)(out.x, torch.from_numpy(betas))
    assert torch.equal(out.lp, fresh)  # full mode: the density of the returned state


def _shape_case(kind, shape):
    """The JAX model and the port's on its data at another shape: a
    hierarchical normal of ``shape = (n_groups, n_per_group)``, a logistic
    regression of ``shape = n`` observations of 10 covariates."""
    if kind == "hierarchical_normal":
        jm = J.hierarchical_normal(*shape, seed=2)
        data = _closure(jm.log_likelihood_fn, "data")
        return jm, convert.bayesian_model_from_numpy(kind, data=data)
    jm = J.logistic_regression(shape, 10, seed=1)
    fn = jm.log_likelihood_fn
    return jm, convert.bayesian_model_from_numpy(kind, X=_closure(fn, "X"), y=_closure(fn, "y"))


def _shape_sweep(kind, shape):
    jm, tm = _shape_case(kind, shape)
    jpath, tpath = jm.create_path(jm.default_reference()), tm.create_path(tm.default_reference())
    xs, betas = _inputs(jm.dim, 0)
    ref = _jax_sweep(lambda x, beta, isvar, rp: _guard(jpath.log_density(x, beta)), xs, betas,
                     np.zeros(B, np.float32), (), 7, 1)
    out = SliceSamplerCUDA(n_passes=1).step_batched(
        trng.keys_for(trng.key(7), torch.arange(B)), torch.from_numpy(xs), torch.from_numpy(betas), tpath)
    assert not np.array_equal(out.x.numpy(), xs)  # the sweep moved
    return ref, out


def test_twin_on_another_shape_of_the_hierarchical_normal():
    """5 groups x 3 observations: fewer than 16 rows, which XLA adds in order
    (``library.row_partials``): bitwise."""
    ref, out = _shape_sweep("hierarchical_normal", (5, 3))
    _assert_bitwise(ref, out)


# the likelihoods' summation orders away from the library's shapes
# (library.row_partials, library.sum_by_windows): 8 rows, which XLA adds as
# 8 partial sums; 20 rows of 16 (4 partials); 7 rows (in order); 64, 100 and
# 256 observations (windows of 32, padded in front by 0, 14 and 0)
@pytest.mark.parametrize("kind,shape", [("hierarchical_normal", (8, 4)),
                                        ("hierarchical_normal", (20, 16)),
                                        ("hierarchical_normal", (7, 10)),
                                        ("logistic_regression", 64),
                                        ("logistic_regression", 100),
                                        ("logistic_regression", 256)])
def test_twin_matches_pallas_kernel_at_other_shapes(kind, shape):
    """Bitwise: states, returned densities and stats."""
    ref, out = _shape_sweep(kind, shape)
    _assert_bitwise(ref, out)


def test_twin_past_the_rows_whose_order_is_known():
    """36 rows: from 28 rows on XLA adds the rows in yet another order than
    ``library.row_partials`` gives (``tests/summation_order_study.py``), so
    the returned densities differ in their last bits. Held within 1e-5
    relative, the elements that differ counted; no lane may take another
    decision (the stats are exact)."""
    ref, out = _shape_sweep("hierarchical_normal", (36, 10))
    for name, have in (("x", out.x), ("lp", out.lp)):
        n_diff = int((have.numpy().view(np.int32) != ref[name].view(np.int32)).sum())
        print(f"{name}: {n_diff} of {ref[name].size} not bitwise equal")
        np.testing.assert_allclose(have.numpy(), ref[name], rtol=1e-5, atol=1e-5)
    for name in ("accept_sum", "accept_n", "n_steps"):
        assert np.array_equal(getattr(out, name).numpy(), ref[name]), name


def _reference_params(d, seed, active):
    rs = np.random.RandomState(seed)
    mean = (rs.normal(size=d) * 0.3).astype(np.float32)
    std = np.exp(rs.normal(size=d) * 0.4).astype(np.float32)
    jp = {"mean": jnp.asarray(mean), "std": jnp.asarray(std), "active": jnp.asarray(active, jnp.float32)}
    tp = {"mean": torch.from_numpy(mean), "std": torch.from_numpy(std), "active": torch.tensor(active)}
    return jp, tp


@pytest.mark.parametrize("active", [0.0, 1.0])
@pytest.mark.parametrize("name", ["funnel 4", "funnel 10", "eight_schools"])
def test_variational_twin_matches_pallas_kernel(name, active):
    """K2 under a mean-field reference: the blend of ``pigeons_tpu/pt.py:646-658``
    inside ``_sweep_kernel``."""
    jm, tm = _models(name)
    d = jm.dim
    # the JAX runtime's own closure for a two-leg run of this target
    jpt = J.PT(J.Inputs(target=jm, n_chains=3, n_chains_variational=3,
                        explorer=SliceSamplerPallas(interpret=True, n_passes=1), show_report=False))
    tpath = T.VariationalPath(tm.create_path(tm.default_reference()), T.GaussianReference())
    xs, betas = _inputs(d, 3)
    isvar = (np.arange(B) < B // 2).astype(np.float32)
    jp, tp = _reference_params(d, d, active)
    ref = _jax_sweep(lambda x, beta, iv, rp: _guard(jpt._path_log_density(x, beta, iv, rp)),
                     xs, betas, isvar, jp, 9, 1)
    keys = trng.keys_for(trng.key(9), torch.arange(B))
    explorer = SliceSamplerCUDA(n_passes=1)
    explorer.check_path(tpath)
    out = explorer.step_batched(keys, torch.from_numpy(xs), torch.from_numpy(betas), tpath,
                                isvar=torch.from_numpy(isvar), ref_params=tp)
    _assert_bitwise(ref, out)
    fixed = explorer.step_batched(keys, torch.from_numpy(xs), torch.from_numpy(betas), tpath.fixed)
    assert (active == 0.0) == torch.equal(out.x, fixed.x)
    assert (active == 0.0) == torch.equal(out.lp, fixed.lp)
    if active:  # the fixed leg's lanes are untouched by the reference
        assert torch.equal(out.x[B // 2:], fixed.x[B // 2:])


def test_variational_sweep_density_is_the_runtime_density():
    """The twin's density (sums in the kernel's order) against the runtime's
    ``lane_log_density`` (``torch.sum``): the same value within 1e-5."""
    from pigeons_tpu_torch.paths import lane_log_density

    tm = T.funnel(9)
    path = T.VariationalPath(tm.create_path(tm.default_reference()), T.GaussianReference())
    xs, betas = (torch.from_numpy(a) for a in _inputs(10, 0))
    isvar = (torch.arange(B) % 2).float()
    _, tp = _reference_params(10, 1, 1.0)
    sweep = cuda_slice.sweep_density(path, isvar, tp)(xs, betas)
    np.testing.assert_allclose(sweep.numpy(), lane_log_density(path, xs, betas, isvar, tp).numpy(),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# runs

RUN = {"hierarchical_normal": dict(n_chains=3, n_replicates=1),
       "eight_schools": dict(n_chains=4, n_replicates=2),
       "unid_target": dict(n_chains=4, n_replicates=2),
       "logistic_regression": dict(n_chains=3, n_replicates=1)}


@pytest.mark.parametrize("name", MODELS)
def test_three_round_run_matches_jax(name):
    jm, tm = _models(name)
    kw = dict(seed=3, n_rounds=3, show_report=False, **RUN[name])
    ja = J.PT(J.Inputs(target=jm, explorer=SliceSamplerPallas(interpret=True, n_passes=1), **kw))
    ta = T.PT(T.Inputs(target=tm, explorer=SliceSamplerCUDA(n_passes=1), device="cpu", **kw))
    # the packages' own initial states: the same draws up to the tangent's last bits
    np.testing.assert_allclose(ta.states.numpy(), np.asarray(ja.states), rtol=1e-5, atol=1e-5)
    ja.run_round()
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": np.asarray(ja.schedule.grids)}, round_idx=1)
    assert np.array_equal(ta.states.numpy(), np.asarray(ja.states))
    for _ in range(2):
        ja.run_round()
        ta.run_round()
        rj, rt = ja.reports[-1], ta.reports[-1]
        assert rj.n_scans == rt.n_scans
        assert rj.n_tempered_restarts == rt.n_tempered_restarts
        assert rj.n_round_trips == rt.n_round_trips
        assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
        assert np.array_equal(np.asarray(ja.replica_of), ta.replica_of.numpy())
        assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
        assert np.array_equal(ja.reduced.accept_n, ta.reduced.accept_n)
        np.testing.assert_allclose(ta.schedule.grids, ja.schedule.grids, atol=1e-6)
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3 * max(1.0, abs(rj.log_z_estimate))
    sj, st = np.asarray(ja.states), ta.states.numpy()
    flipped = int((np.abs(st - sj) > 1e-5 * np.maximum(np.abs(sj), 1.0)).sum())
    print(f"{flipped} flipped of {sj.size} state elements, {int((sj != st).sum())} not bitwise equal")
    assert flipped == 0
    assert ta.sample_names() == jm.sample_names() == tm.sample_names()
    np.testing.assert_allclose(ta.sample_array(), np.asarray(ja.sample_array()), rtol=1e-4, atol=1e-4)
    jq, tq = jm.constrained_samples(ja), tm.constrained_samples(ta)
    for key in jq:
        np.testing.assert_allclose(tq[key], jq[key], rtol=1e-4, atol=1e-4)


def test_variational_funnel_run_matches_jax():
    """Two legs on the funnel, the reference fitted after round 2 and used
    by K2's twin in round 3, against the JAX package's run from the seed."""
    kw = dict(n_chains=3, n_chains_variational=3, seed=2, n_rounds=3, show_report=False)
    ja = J.PT(J.Inputs(target=J.funnel(2), variational=J.GaussianReference(2),
                       explorer=SliceSamplerPallas(interpret=True, n_passes=1), **kw)).run()
    ta = T.PT(T.Inputs(target=T.funnel(2), variational=T.GaussianReference(2),
                       explorer=SliceSamplerCUDA(n_passes=1), device="cpu", **kw)).run()
    assert float(ja._ref_params["active"]) == float(ta._ref_params["active"]) == 1.0
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        assert rj.n_tempered_restarts == rt.n_tempered_restarts
        assert rj.n_round_trips == rt.n_round_trips
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.global_barrier_variational - rt.global_barrier_variational) < 1e-3
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
    np.testing.assert_allclose(ta._ref_params["std"].numpy(), np.asarray(ja._ref_params["std"]), atol=1e-5)
    np.testing.assert_allclose(ta.states.numpy(), np.asarray(ja.states), rtol=1e-5, atol=1e-5)
