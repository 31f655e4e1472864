"""The port's torch ``SliceSampler`` against the JAX package's, on the CPU.

The JAX sampler's ``step`` is written for one lane and vmapped; the port's
``step_batched`` writes the batch out. Same states, betas and keys from a
numpy seed, B = 32 lanes, d = 4.

Tolerance: the draws (exponential, window offset, side and candidate uniforms
of an iteration) bitwise; ``n_steps``, ``accept_sum`` and ``accept_n`` equal on
every lane (they count the machine's phases, so equal counts mean the same
phases were walked); states within 2 ulp, with the count of elements that are
not bitwise equal printed (none expected on the funnel, whose density the port
evaluates operation for operation as XLA does; the toy path's ``sum(x * x)``
may round differently). Runs through ``PT`` hold permutations, restarts,
round trips and explorer step counts exact, barrier and logZ within 1e-3 and
states within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.ops import slice_sampler

B, D = 32, 4


def _targets(name):
    if name == "toy":
        return J.toy_mvn_target(D), T.toy_mvn_target(D)
    return J.funnel(D - 1), T.funnel(D - 1)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    xs = rs.normal(size=(B, D)).astype(np.float32)
    betas = rs.uniform(size=B).astype(np.float32)
    betas[0], betas[-1] = 0.0, 1.0
    return xs, betas


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _guard(lp):
    return jnp.where(jnp.isnan(lp), -jnp.inf, lp)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["toy", "funnel"])
def test_step_matches_vmapped_jax_step(name, seed):
    jt, tt = _targets(name)
    jpath, tpath = jt.create_path(jt.default_reference()), tt.create_path(tt.default_reference())
    xs, betas = _inputs(seed)
    sampler = J.SliceSampler(n_passes=2)

    def one(key, x, beta):
        def ld(xx):
            return _guard(jpath.log_density(xx, beta))

        return sampler.step(key, x, ld(x), ld, beta, (), 1)

    oj = jax.jit(jax.vmap(one))(jrng.keys_for(jax.random.key(seed + 3), jnp.arange(B)), xs, betas)
    ot = T.SliceSampler(n_passes=2).step_batched(
        trng.keys_for(trng.key(seed + 3), torch.arange(B)), torch.from_numpy(xs),
        torch.from_numpy(betas), tpath)
    for field in ("n_steps", "accept_sum", "accept_n"):
        assert np.array_equal(np.asarray(getattr(oj, field)), getattr(ot, field).numpy()), field
    ulp = _ulp(np.asarray(oj.x), ot.x.numpy())
    print(f"{name}: {int((ulp > 0).sum())} of {ulp.size} state elements not bitwise equal")
    assert ulp.max() <= 2
    np.testing.assert_allclose(ot.lp.numpy(), np.asarray(oj.lp), rtol=1e-6)
    assert not np.array_equal(ot.x.numpy(), xs)


def test_step_under_a_variational_reference_matches_jax():
    """Lanes of both legs through the blended density of a two-leg run."""
    jt, tt = _targets("toy")
    ja = J.PT(J.Inputs(target=jt, n_chains=3, n_chains_variational=3, show_report=False))
    rs = np.random.RandomState(9)
    xs, betas = _inputs(9)
    isvar = (np.arange(B) % 2).astype(np.float32)
    mean = (rs.normal(size=D) * 0.2).astype(np.float32)
    std = np.exp(rs.normal(size=D) * 0.3 - 1.0).astype(np.float32)
    jrp = {"mean": jnp.asarray(mean), "std": jnp.asarray(std), "active": jnp.ones(())}
    trp = {"mean": torch.from_numpy(mean), "std": torch.from_numpy(std), "active": torch.ones(())}
    sampler = J.SliceSampler(n_passes=1)

    def one(key, x, beta, iv, rp):
        def ld(xx):
            return _guard(ja._path_log_density(xx, beta, iv, rp))

        return sampler.step(key, x, ld(x), ld, beta, (), 1)

    oj = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))(
        jrng.keys_for(jax.random.key(5), jnp.arange(B)), xs, betas, isvar, jrp)
    ot = T.SliceSampler(n_passes=1).step_batched(
        trng.keys_for(trng.key(5), torch.arange(B)), torch.from_numpy(xs), torch.from_numpy(betas),
        T.VariationalPath(tt.create_path(tt.default_reference()), T.GaussianReference()),
        isvar=torch.from_numpy(isvar), ref_params=trp)
    # the summed reference density rounds differently in the last bits
    # (torch.sum against XLA's reduction), so a slice test can fall the other
    # way: lanes whose phases agree must agree in state too
    same = np.asarray(oj.n_steps) == ot.n_steps.numpy()
    print(f"{int((~same).sum())} of {B} lanes walked other phases")
    assert same.sum() >= B - 1
    np.testing.assert_allclose(ot.x.numpy()[same], np.asarray(oj.x)[same], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("i", [0, 3, 11])
def test_coordinate_draws_bitwise(i):
    jkeys = jrng.keys_for(jax.random.key(8), jnp.arange(B))

    def draws(key):
        k_c = jax.random.fold_in(key, i)
        return (jax.random.key_data(k_c), jax.random.exponential(jax.random.fold_in(k_c, 0)),
                jax.random.uniform(jax.random.fold_in(k_c, 1)))

    jk, je, ju = (np.asarray(a) for a in jax.jit(jax.vmap(draws))(jkeys))
    tk, te, tu = slice_sampler.coordinate_draws(trng.keys_for(trng.key(8), torch.arange(B)), i)
    assert np.array_equal(jk.astype(np.int64), tk.numpy())
    assert np.array_equal(je.view(np.int32), te.numpy().view(np.int32))
    assert np.array_equal(ju.view(np.int32), tu.numpy().view(np.int32))


@pytest.mark.parametrize("it", [0, 1, 40])
def test_iteration_draws_bitwise(it):
    jkeys = jrng.keys_for(jax.random.key(2), jnp.arange(B))

    def draws(k_c):
        k_it = jax.random.fold_in(k_c, 2 + it)
        return (jax.random.uniform(jax.random.fold_in(k_it, 0)),
                jax.random.uniform(jax.random.fold_in(k_it, 1)))

    ja, jb = (np.asarray(a) for a in jax.jit(jax.vmap(draws))(jkeys))
    ta, tb = slice_sampler.iteration_draws(trng.keys_for(trng.key(2), torch.arange(B)), it)
    assert np.array_equal(ja.view(np.int32), ta.numpy().view(np.int32))
    assert np.array_equal(jb.view(np.int32), tb.numpy().view(np.int32))


def test_lanes_at_stop_change_nothing():
    """A lane's result does not depend on which lanes share its batch: the
    slowest lane keeps the loop running while the others sit at STOP."""
    _, tt = _targets("funnel")
    path = tt.create_path(tt.default_reference())
    xs, betas = (torch.from_numpy(a) for a in _inputs(4))
    keys = trng.keys_for(trng.key(6), torch.arange(B))
    whole = T.SliceSampler(n_passes=1).step_batched(keys, xs, betas, path)
    for lanes in (slice(0, 1), slice(5, 9)):
        part = T.SliceSampler(n_passes=1).step_batched(keys[lanes], xs[lanes], betas[lanes], path)
        assert torch.equal(part.x, whole.x[lanes]) and torch.equal(part.n_steps, whole.n_steps[lanes])


def _run_pair(jt, tt, **kw):
    ja = J.PT(J.Inputs(target=jt, explorer=J.SliceSampler(n_passes=1), show_report=False, **kw)).run()
    ta = T.PT(T.Inputs(target=tt, explorer=T.SliceSampler(n_passes=1), show_report=False,
                       device="cpu", **kw)).run()
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        assert (rj.n_tempered_restarts, rj.n_round_trips) == (rt.n_tempered_restarts, rt.n_round_trips)
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
    return ja, ta


def test_funnel_run_with_the_torch_sampler_matches_jax():
    ja, ta = _run_pair(J.funnel(2), T.funnel(2), n_chains=4, n_replicates=2, n_rounds=3, seed=3)
    # the reference chains' normal draws may be 2 ulp off (the tail branch),
    # and a sweep that starts from such a state keeps a few ulp of it in its
    # bracket: no element may be off by more than 1e-5 relative (a slice test
    # that fell the other way would be)
    sj, st = np.asarray(ja.states), ta.states.numpy()
    print(f"max {_ulp(sj, st).max()} ulp")
    assert (np.abs(st - sj) <= 1e-5 * np.maximum(np.abs(sj), 1e-30)).all()


def test_two_leg_run_with_the_torch_sampler_matches_jax():
    """The torch sampler on a two-leg run of the funnel path. The general
    CUDA kernel takes this path too now (no raise when the run is set up; the
    sweep itself is held in ``tests/test_torch_sweep_bayesian.py``)."""
    T.PT(T.Inputs(target=T.funnel(2), n_chains=3, n_chains_variational=3,
                  explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu"))
    kw = dict(n_chains=3, n_chains_variational=3, n_rounds=3, seed=2)
    ja, ta = _run_pair(J.funnel(2), T.funnel(2), variational=None, **kw)
    assert abs(ja.global_barrier_variational - ta.global_barrier_variational) < 1e-3


def test_defaults_match_jax():
    j, t = J.SliceSampler(), T.SliceSampler()
    assert (j.w, j.p, j.n_passes, j.max_iter) == (t.w, t.p, t.n_passes, t.max_iter)
    # and it is a target's default explorer in both packages
    assert isinstance(J.funnel(2).default_explorer(), J.SliceSampler)
    assert isinstance(T.funnel(2).default_explorer(), T.SliceSampler)
    assert isinstance(T.pigeons(target=T.funnel(2), n_chains=3, n_rounds=1, device="cpu",
                                show_report=False).explorer, T.SliceSampler)
