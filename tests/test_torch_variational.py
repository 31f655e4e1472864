"""Stabilized variational PT in the port against the JAX package, on the CPU.

(d) ``GaussianReference``: parameters, densities, draws and the fit against
    the JAX class on inputs from a numpy seed. Tolerance: the coordinate term
    bitwise (it is what kernel K1 evaluates); the summed density within 1e-6
    relative (``torch.sum`` and XLA's reduction order differ in the last
    bits); draws within 2 ulp (the normal's tail branch, as everywhere in the
    port); the fit exact (numpy on both sides).
(e) A two-leg run from the seed, 5 + 5 chains on the d=3 toy MVN, 5 rounds
    with ``first_tuning_round=4`` (cut from the default 6 and 7 rounds to keep
    the interpreted JAX kernel's 62 scans short), so that the reference fitted
    after round 4 is used in round 5: the JAX side
    runs ``SliceSamplerPallas(interpret=True)``, the port ``SliceSamplerCUDA``
    on its twin (kernel K1's variational term). Exact: permutations, restarts
    and round trips of every round, the ``active`` flag, explorer step counts.
    Within 1e-6: both legs' schedules and the reference's mean and std (they
    come from acceptance rates and moments of densities that differ in the
    last bits). Within 1e-3: both barriers and logZ of every round. States
    within 1e-5 with flips counted (none expected).
(f) The same for a single variational leg (``n_chains=0``), fitted after
    round 3 of 4.
(g) ``TestSwapper(0.5)``, one leg and two: restarts and round trips equal.
(i) ``convert.state_from_numpy`` carries the JAX run of (e) after round 4
    (state, both schedules, the fitted reference) into the port; round 5 then
    agrees as in (e).
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
from pigeons_tpu_torch.convert import state_from_numpy

D = 5


def _params(seed, active=1.0):
    rs = np.random.RandomState(seed)
    mean = (rs.normal(size=D) * 0.3).astype(np.float32)
    std = np.exp(rs.normal(size=D) * 0.5 - 1.0).astype(np.float32)
    jp = {"mean": jnp.asarray(mean), "std": jnp.asarray(std), "active": jnp.asarray(active, jnp.float32)}
    tp = {"mean": torch.from_numpy(mean), "std": torch.from_numpy(std), "active": torch.tensor(active)}
    return jp, tp


def test_init_params_and_activation_match_jax():
    jp, tp = J.GaussianReference().init_params(D), T.GaussianReference().init_params(D)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert np.array_equal(np.asarray(jp[k]), tp[k].numpy()) and tp[k].dtype == torch.float32
    for first in (1, 6):
        j, t = J.GaussianReference(first), T.GaussianReference(first)
        assert [j.active(r) for r in range(9)] == [t.active(r) for r in range(9)]


@pytest.mark.parametrize("seed", [0, 1])
def test_coord_log_density_bitwise(seed):
    jp, tp = _params(seed)
    v = (np.random.RandomState(seed + 10).normal(size=(64, D)) * 2).astype(np.float32)
    # mean and std as arguments: closed over, XLA folds log(2 pi std^2) at
    # compile time with another log than the one it emits
    j = np.asarray(jax.jit(jax.vmap(J.GaussianReference.coord_log_density, in_axes=(0, None, None)))(
        v, jp["mean"], jp["std"]))
    t = T.GaussianReference.coord_log_density(torch.from_numpy(v), tp["mean"], tp["std"]).numpy()
    assert np.array_equal(j.view(np.int32), t.view(np.int32))
    arrays = T.GaussianReference.coord_param_arrays(tp)
    assert arrays[0] is tp["mean"] and arrays[1] is tp["std"]


@pytest.mark.parametrize("seed", [0, 1])
def test_log_density_matches_jax(seed):
    jp, tp = _params(seed)
    x = (np.random.RandomState(seed + 20).normal(size=(64, D)) * 2).astype(np.float32)
    j = np.asarray(jax.jit(jax.vmap(lambda row: J.GaussianReference.log_density(row, jp)))(x))
    t = T.GaussianReference.log_density(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6)
    # batches of any rank, as the runtime's fused pass has them
    t2 = T.GaussianReference.log_density(torch.from_numpy(x).reshape(2, 32, D), tp)
    assert torch.equal(t2.reshape(-1), torch.from_numpy(t))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_matches_jax(seed):
    jp, tp = _params(seed)
    jkeys = jrng.keys_for(jax.random.key(seed), jnp.arange(256))
    j = np.asarray(jax.vmap(lambda k: J.GaussianReference.sample(k, jp))(jkeys))
    t = T.GaussianReference.sample(trng.keys_for(trng.key(seed), torch.arange(256)), tp).numpy()
    ulp = np.abs(j.view(np.int32).astype(np.int64) - t.view(np.int32).astype(np.int64))
    print(f"{int((ulp > 0).sum())} of {j.size} draws not bitwise equal, max {ulp.max()} ulp")
    assert ulp.max() <= 2


class _Reduced:
    def __init__(self, mean, var):
        self.online_mean, self.online_var = mean, var


@pytest.mark.parametrize("round_idx", [5, 6])
def test_fit_matches_jax(round_idx):
    rs = np.random.RandomState(3)
    reduced = _Reduced(rs.normal(size=D + 1), np.abs(rs.normal(size=D + 1)))
    reduced.online_var[1] = 0.0  # floored at 1e-12: std 1e-6
    jp, tp = _params(4, active=0.0)
    jf = J.GaussianReference().fit(jp, reduced, round_idx)
    tf = T.GaussianReference().fit(tp, reduced, round_idx)
    for k in jf:
        assert np.array_equal(np.asarray(jf[k]), tf[k].numpy()), k
    assert float(tf["active"]) == float(round_idx >= 6)
    assert (round_idx < 6) == (tf is tp)
    if round_idx >= 6:
        assert float(tf["std"][1]) == np.float32(1e-6)


# ---------------------------------------------------------------------------
# runs


def _arrays(ja):
    """What ``pigeons_tpu/checkpoint.py:write_checkpoint`` stores of a run."""
    arrays = {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
              "replica_of": np.asarray(ja.replica_of), "schedule": np.asarray(ja.schedule.grids)}
    if ja.schedule_var is not None:
        arrays["schedule_var"] = np.asarray(ja.schedule_var.grids)
    for k, v in ja._ref_params.items():
        arrays[f"ref_params_{k}"] = np.asarray(v)
    return arrays


def _assert_round_matches(rj, rt):
    assert rj.n_scans == rt.n_scans
    assert rj.n_tempered_restarts == rt.n_tempered_restarts
    assert rj.n_round_trips == rt.n_round_trips
    assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
    if np.isfinite(rj.global_barrier_variational):
        assert abs(rj.global_barrier_variational - rt.global_barrier_variational) < 1e-3
    else:
        assert not np.isfinite(rt.global_barrier_variational)
    assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3


def _assert_state_matches(ja, ta):
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    assert np.array_equal(np.asarray(ja.replica_of), ta.replica_of.numpy())
    np.testing.assert_allclose(ta.betas.numpy(), np.asarray(ja.betas), atol=1e-6)
    np.testing.assert_allclose(ta.schedule.grids, ja.schedule.grids, atol=1e-6)
    if ja.schedule_var is not None:
        np.testing.assert_allclose(ta.schedule_var.grids, ja.schedule_var.grids, atol=1e-6)
    assert float(ja._ref_params["active"]) == float(ta._ref_params["active"])
    for k in ("mean", "std"):
        np.testing.assert_allclose(ta._ref_params[k].numpy(), np.asarray(ja._ref_params[k]), atol=1e-6)
    sj, st = np.asarray(ja.states), ta.states.numpy()
    flipped = int((np.abs(st - sj) > 1e-5).sum())
    print(f"{flipped} flipped of {sj.size} state elements, {int((sj != st).sum())} not bitwise equal")
    assert flipped == 0
    assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
    assert np.array_equal(ja.reduced.accept_n, ta.reduced.accept_n)


TWO_LEG = dict(n_chains=5, n_chains_variational=5, seed=1, n_rounds=5, show_report=False)
FIT_ROUND = 4


@pytest.fixture(scope="module")
def jax_two_leg():
    """The JAX run of (e), with its state after the fit for (i)."""
    ja = J.PT(J.Inputs(target=J.toy_mvn_target(3), variational=J.GaussianReference(FIT_ROUND),
                       explorer=J.SliceSamplerPallas(interpret=True, n_passes=1), **TWO_LEG))
    for _ in range(FIT_ROUND):
        ja.run_round()
    after_fit = _arrays(ja)
    ja.run_round()
    return ja, after_fit


def _port_two_leg():
    return T.PT(T.Inputs(target=T.toy_mvn_target(3), variational=T.GaussianReference(FIT_ROUND),
                         explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu", **TWO_LEG))


def test_two_leg_run_matches_jax(jax_two_leg):
    ja, _ = jax_two_leg
    ta = _port_two_leg().run()
    assert ta.two_leg and ta.target_positions == (4, 5) and ta.ref_positions == (0, 9)
    assert float(ja._ref_params["active"]) == 1.0  # fitted after round 4, used in round 5
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        _assert_round_matches(rj, rt)
    _assert_state_matches(ja, ta)
    assert ta.global_barrier_variational < ta.global_barrier
    np.testing.assert_allclose(ta.sample_array(), ja.sample_array(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta.mean(), ja.mean(), atol=1e-6)


def test_two_leg_run_carried_over_from_jax(jax_two_leg):
    ja, after_fit = jax_two_leg
    assert float(after_fit["ref_params_active"]) == 1.0
    ta = state_from_numpy(_port_two_leg(), after_fit, round_idx=FIT_ROUND)
    assert np.array_equal(ta._ref_params["std"].numpy(), after_fit["ref_params_std"])
    ta.run_round()
    _assert_round_matches(ja.reports[-1], ta.reports[-1])
    _assert_state_matches(ja, ta)


def test_single_leg_variational_matches_jax():
    kw = dict(n_chains=0, n_chains_variational=5, seed=2, n_rounds=4, show_report=False)
    ja = J.PT(J.Inputs(target=J.toy_mvn_target(2), variational=J.GaussianReference(3),
                       explorer=J.SliceSamplerPallas(interpret=True, n_passes=1), **kw)).run()
    ta = T.PT(T.Inputs(target=T.toy_mvn_target(2), variational=T.GaussianReference(3),
                       explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu", **kw)).run()
    assert ta.single_leg_variational and not ta.two_leg and ta.n_chains == 5
    assert ta.schedule_var is None and ta.barriers_var is None
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        _assert_round_matches(rj, rt)
    _assert_state_matches(ja, ta)
    with pytest.raises(ValueError, match="no variational leg"):
        ta.global_barrier_variational


@pytest.mark.parametrize("n_fixed,n_var", [(5, 0), (5, 5), (3, 4), (1, 3)])
def test_test_swapper_counts_match_jax(n_fixed, n_var):
    kw = dict(n_chains=n_fixed, n_chains_variational=n_var, n_rounds=7, seed=1, show_report=False)
    ja = J.pigeons(target=J.TestSwapper(0.5), **kw)
    ta = T.pigeons(target=T.TestSwapper(0.5), device="cpu", **kw)
    assert isinstance(ta.explorer, T.NoOpExplorer)
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        assert (rj.n_tempered_restarts, rj.n_round_trips) == (rt.n_tempered_restarts, rt.n_round_trips)
        assert np.isnan(rt.log_z_estimate)  # a constant swapper records no swap statistic
    assert ta.n_tempered_restarts > 0
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    np.testing.assert_allclose(ta.reduced.accept_mean, ja.reduced.accept_mean, atol=1e-7)


def test_two_leg_replicates_match_jax():
    """Several ladders of a two-leg run as one flat batch, fitted after round 2."""
    kw = dict(n_chains=3, n_chains_variational=3, n_replicates=3, seed=4, n_rounds=3,
              show_report=False)
    ja = J.PT(J.Inputs(target=J.toy_mvn_target(2), variational=J.GaussianReference(2),
                       explorer=J.SliceSamplerPallas(interpret=True, n_passes=1), **kw)).run()
    ta = T.PT(T.Inputs(target=T.toy_mvn_target(2), variational=T.GaussianReference(2),
                       explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu", **kw)).run()
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        _assert_round_matches(rj, rt)
    _assert_state_matches(ja, ta)


def test_variational_forces_the_online_recorder():
    ta = T.PT(T.Inputs(target=T.toy_mvn_target(2), n_chains=2, n_chains_variational=2,
                       record=("traces",), device="cpu", show_report=False))
    assert ta._record_online
    ta.run_round()
    assert np.isfinite(ta.mean()).all()


def test_report_has_the_variational_column(capsys):
    T.pigeons(target=T.toy_mvn_target(2), n_chains=2, n_chains_variational=2, n_rounds=1,
              device="cpu")
    assert "Λ_var" in capsys.readouterr().out
    T.pigeons(target=T.toy_mvn_target(2), n_chains=2, n_rounds=1, device="cpu")
    assert "Λ_var" not in capsys.readouterr().out
