"""The port's PT runtime against the JAX package's, end to end on the CPU.

(a) Continuation: a JAX run's state after round 2 (the checkpoint arrays)
    is carried into the port with ``convert.state_from_numpy``, and both
    packages run round 3 with the banded slice sampler.
(b) From seed: both ``pigeons()`` entry points, ToyExplorer, 3 rounds.
(c) The runtime options ``swap_graph`` (a shifted DEO graph), ``extractor``
    and ``reference`` (an override of the target's default) against the same
    options of the JAX runtime, and the diagnostics tables of a run.

Tolerances and why: swap decisions, permutations, round trips and restarts
must be exact. Log densities sum ``x * x`` in another order than XLA's fused
reduction, so log-ratios differ in the last bits: the barrier is held to
1e-4 and logZ to 1e-3 (they sum rejection rates and log-ratios over rounds).
States of (a) within 1e-5, with flipped elements counted (none expected: the
sweep's draws do not depend on the densities); states of (b) come from
``rsqrt(precision)`` times normals, where XLA's ``rsqrt`` may be 2 ulp off
torch's, so 1e-6 relative.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu_torch.convert import state_from_numpy


def _assert_reports_close(ja, ta, barrier_tol, logz_tol):
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        assert rj.n_scans == rt.n_scans
        assert rj.n_tempered_restarts == rt.n_tempered_restarts
        assert rj.n_round_trips == rt.n_round_trips
        assert abs(rj.global_barrier - rt.global_barrier) < barrier_tol
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < logz_tol
        assert abs(rj.mean_swap_accept - rt.mean_swap_accept) < barrier_tol


def _same_permutations(ja, ta):
    return (np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
            and np.array_equal(np.asarray(ja.replica_of), ta.replica_of.numpy()))


@pytest.mark.parametrize("R", [1, 4])
def test_continuation_round_matches_jax(R):
    common = dict(n_chains=4, seed=3, n_replicates=R, n_rounds=3, show_report=False)
    ja = J.PT(J.Inputs(target=J.toy_mvn_target(4),
                       explorer=J.SliceSamplerPallas(interpret=True, n_passes=1), **common))
    ja.run_round()
    ja.run_round()
    arrays = {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
              "replica_of": np.asarray(ja.replica_of), "schedule": np.asarray(ja.schedule.grids)}
    ta = T.PT(T.Inputs(target=T.toy_mvn_target(4), explorer=T.SliceSamplerCUDA(n_passes=1),
                       device="cpu", **common))
    state_from_numpy(ta, arrays, round_idx=2)
    ja.run_round()
    ta.run_round()

    assert _same_permutations(ja, ta)
    _assert_reports_close(_Last(ja), _Last(ta), 1e-4, 1e-3)
    sj, st = np.asarray(ja.states), ta.states.numpy()
    flipped = np.abs(st - sj) > 1e-5
    print(f"R={R}: {int(flipped.sum())} flipped of {sj.size} state elements")
    assert flipped.sum() <= 1e-3 * sj.size
    assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
    assert np.array_equal(ja.reduced.accept_n, ta.reduced.accept_n)


class _Last:
    """The last round's report only (round 3 is the one both packages ran)."""

    def __init__(self, pt):
        self.reports = pt.reports[-1:]


@pytest.mark.parametrize("R", [1, 4])
def test_pigeons_from_seed_matches_jax(R):
    kw = dict(n_chains=4, n_rounds=3, seed=1, n_replicates=R, show_report=False)
    ja = J.pigeons(target=J.toy_mvn_target(5), **kw)
    ta = T.pigeons(target=T.toy_mvn_target(5), device="cpu", **kw)
    assert isinstance(ta.explorer, T.ToyExplorer)
    _assert_reports_close(ja, ta, 1e-4, 1e-3)
    assert _same_permutations(ja, ta)
    np.testing.assert_allclose(ta.states.numpy(), np.asarray(ja.states), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ta.sample_array(), ja.sample_array(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.mean(), ja.mean(), atol=1e-6)
    np.testing.assert_allclose(ta.var(), ja.var(), rtol=1e-5)


def _state_flips(sj, st):
    rel = np.abs(st - sj) / np.maximum(np.abs(sj), 1e-30)
    return int((rel > 1e-5).sum())


def test_funnel_run_matches_jax():
    common = dict(n_chains=4, seed=5, n_replicates=2, n_rounds=3, show_report=False)
    ja = J.PT(J.Inputs(target=J.funnel(3),
                       explorer=J.SliceSamplerPallas(interpret=True, n_passes=1), **common))

    def port():
        return T.PT(T.Inputs(target=T.funnel(3), explorer=T.SliceSamplerCUDA(n_passes=1),
                             device="cpu", **common))

    ta = port()
    assert ta.path.device_density().kind == T.paths.FUNNEL
    for _ in range(2):
        ja.run_round()
        ta.run_round()
    arrays = {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
              "replica_of": np.asarray(ja.replica_of), "schedule": np.asarray(ja.schedule.grids)}
    carried = state_from_numpy(port(), arrays, round_idx=2)
    ja.run_round()
    ta.run_round()
    carried.run_round()

    _assert_reports_close(ja, ta, 1e-3, 1e-3)
    _assert_reports_close(_Last(ja), _Last(carried), 1e-3, 1e-3)
    sj = np.asarray(ja.states)
    for name, run in (("from seed", ta), ("carried over", carried)):
        assert _same_permutations(ja, run), name
        n_flip = _state_flips(sj, run.states.numpy())
        print(f"{name}: {n_flip} flipped of {sj.size} state elements, "
              f"{int((sj != run.states.numpy()).sum())} not bitwise equal")
        assert n_flip == 0, name
        assert np.array_equal(ja.reduced.exp_steps, run.reduced.exp_steps), name
        assert np.array_equal(ja.reduced.accept_n, run.reduced.accept_n), name
    np.testing.assert_allclose(ta.sample_array(), ja.sample_array(), rtol=1e-5, atol=1e-5)
    assert math.isfinite(ta.reports[-1].log_z_estimate)


def test_same_seed_same_run_on_cpu():
    def run():
        return T.pigeons(target=T.toy_mvn_target(3), n_chains=4, n_rounds=3, seed=7,
                         n_replicates=2, explorer=T.SliceSamplerCUDA(), device="cpu",
                         show_report=False)

    a, b = run(), run()
    assert torch.equal(a.states, b.states) and torch.equal(a.chain_of, b.chain_of)
    assert np.array_equal(a.sample_array(), b.sample_array())


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.PT(T.Inputs(target=T.toy_mvn_target(3), device="cuda"))


def test_cuda_slice_sampler_on_non_separable_path_raises():
    class Quartic(T.models.Target):
        dim = 3

        def log_density(self, x):
            return -(x**4).sum(-1)

        def default_reference(self):
            return T.models.Reference(log_density=lambda x: -0.5 * (x**2).sum(-1))

    with pytest.raises(NotImplementedError, match="K2"):
        T.PT(T.Inputs(target=Quartic(), explorer=T.SliceSamplerCUDA(), device="cpu"))


@pytest.mark.parametrize("option", [{"dtype": "float64"}])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.PT(T.Inputs(target=T.toy_mvn_target(3), device="cpu", **option))


def _checkpointed(pt):
    from pigeons_tpu_torch.checkpoint import latest_checkpoint_round

    return latest_checkpoint_round(pt.exec_folder) == pt.round_idx


PORTED_OPTIONS = {
    "checkpoint": ({"checkpoint": True}, _checkpointed),
    "checked_round": ({"checked_round": 1, "checkpoint": True},
                      lambda pt: pt.serial_check is not None),
    "checkpoint_folder": ({"checkpoint": True, "checkpoint_folder": "run"},
                          lambda pt: pt.exec_folder == "run" and _checkpointed(pt)),
    "extended_traces": ({"extended_traces": True},
                        lambda pt: pt.extended_sample_array().shape == (2, 3, 4)),
    "index_process": ({"record": ("traces", "index_process")},
                      lambda pt: pt.index_process.shape == (2, 3)),
    "profile_round": ({"checkpoint": True, "profile_round": 1},
                      lambda pt: (Path(pt.exec_folder) / "profile/round=1/trace.json").is_file()),
}


@pytest.mark.parametrize("name", list(PORTED_OPTIONS))
def test_ported_options_work(name, tmp_path, monkeypatch):
    """The six options that raised until checkpointing was ported."""
    monkeypatch.chdir(tmp_path)
    option, works = PORTED_OPTIONS[name]
    pt = T.pigeons(target=T.toy_mvn_target(3), n_chains=3, n_rounds=1, device="cpu",
                   show_report=False, **option)
    assert works(pt)


def test_import_pulls_no_jax():
    code = ("import sys, pigeons_tpu_torch, pigeons_tpu_torch.parallel, "
            "pigeons_tpu_torch.submission.host_main; print('jax' in sys.modules, any(m == "
            "'pigeons_tpu' or m.startswith('pigeons_tpu.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.split() == ["False", "False"]


def test_shifted_swap_graph_matches_jax():
    """``Inputs.swap_graph`` (the shifted DEO graph of ``tests/test_swaps.py``)
    drives the swaps and the fused partner-beta pass: exact counts."""
    from pigeons_tpu.swaps import deo_partner_map as jax_deo
    from pigeons_tpu_torch.swaps import deo_partner_map as port_deo

    kw = dict(n_chains=4, n_rounds=5, seed=1, show_report=False)
    ja = J.pigeons(target=J.TestSwapper(1.0), swap_graph=lambda n, s: jax_deo(n, s + 1), **kw)
    ta = T.pigeons(target=T.TestSwapper(1.0), swap_graph=lambda n, s: port_deo(n, s + 1),
                   device="cpu", **kw)
    plain = T.pigeons(target=T.TestSwapper(1.0), device="cpu", **kw)
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        assert (rj.n_tempered_restarts, rj.n_round_trips) == (rt.n_tempered_restarts, rt.n_round_trips)
    assert _same_permutations(ja, ta)
    assert not torch.equal(plain.chain_of, ta.chain_of)  # the graph was used


def test_swap_graph_with_densities_matches_jax():
    """A graph given as a list, on a path whose swaps depend on densities."""
    import jax.numpy as jnp

    def idle_ends(n, scan_idx):  # only the middle pair ever interacts
        return [0, 2, 1, 3]

    kw = dict(n_chains=4, n_rounds=3, seed=2, show_report=False)
    ja = J.pigeons(target=J.toy_mvn_target(3), swap_graph=lambda n, s: jnp.asarray(idle_ends(n, s)),
                   **kw)
    ta = T.pigeons(target=T.toy_mvn_target(3), swap_graph=idle_ends, device="cpu", **kw)
    assert _same_permutations(ja, ta)
    assert np.array_equal(ja.reduced.accept_n, ta.reduced.accept_n)
    assert ta.reduced.accept_n.tolist() == [0.0, 8.0, 0.0]


def test_extractor_matches_jax():
    import jax.numpy as jnp

    kw = dict(n_chains=4, n_rounds=4, seed=1, show_report=False)
    ja = J.pigeons(target=J.toy_mvn_target(3),
                   extractor=lambda x, lp: jnp.array([jnp.sum(x**2), lp]), **kw)
    ta = T.pigeons(target=T.toy_mvn_target(3), device="cpu",
                   extractor=lambda x, lp: torch.stack([(x**2).sum(-1), lp], dim=-1), **kw)
    assert ta.sample_array().shape == ja.sample_array().shape == (16, 2)
    np.testing.assert_allclose(ta.sample_array(), ja.sample_array(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.reduced.online_mean, ja.reduced.online_mean, rtol=1e-5)
    assert ta.sample_names() == ja.sample_names() == ["x[0]", "log_density"]
    assert _same_permutations(ja, ta)


def test_sample_names_match_jax():
    kw = dict(n_chains=3, n_rounds=2, seed=1, show_report=False)
    ja = J.pigeons(target=J.toy_mvn_target(3), **kw)
    ta = T.pigeons(target=T.toy_mvn_target(3), device="cpu", **kw)
    assert ta.sample_names() == ja.sample_names() == ["x[0]", "x[1]", "x[2]", "log_density"]


def test_reference_override_matches_jax():
    """``Inputs.reference`` replaces the funnel's N(0, 9 I) by N(0, 4 I): the
    path, the iid draws of the reference chain and the kernel's description of
    the density follow it."""
    from pigeons_tpu.models.target import StandardNormalReference as JaxNormal

    kw = dict(n_chains=4, n_replicates=2, n_rounds=3, seed=6, show_report=False)
    ja = J.PT(J.Inputs(target=J.funnel(2), reference=JaxNormal(3, sigma=2.0).as_reference(),
                       explorer=J.SliceSamplerPallas(interpret=True, n_passes=1), **kw)).run()
    ta = T.PT(T.Inputs(target=T.funnel(2),
                       reference=T.StandardNormalReference(3, sigma=2.0).as_reference(),
                       explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu", **kw)).run()
    default = T.PT(T.Inputs(target=T.funnel(2), explorer=T.SliceSamplerCUDA(n_passes=1),
                            device="cpu", **kw))
    assert ta.path.device_density().params[0] == 0.5 != default.path.device_density().params[0]
    _assert_reports_close(ja, ta, 1e-3, 1e-3)
    assert _same_permutations(ja, ta)
    assert _state_flips(np.asarray(ja.states), ta.states.numpy()) == 0
    assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)


def test_float64_still_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="6c"):
        T.PT(T.Inputs(target=T.toy_mvn_target(3), device="cpu", dtype="float64"))


def test_unknown_recorder_raises_at_construction():
    with pytest.raises(ValueError, match="unknown recorder"):
        T.PT(T.Inputs(target=T.toy_mvn_target(3), device="cpu", record=("trace",)))


def test_diagnostics_match_jax():
    pd = pytest.importorskip("pandas")
    kw = dict(n_chains=4, n_rounds=5, seed=1, show_report=False)
    ja = J.pigeons(target=J.toy_mvn_target(2), **kw)
    ta = T.pigeons(target=T.toy_mvn_target(2), device="cpu", **kw)
    sj, st = J.summary(ja), T.summary(ta)
    assert list(st["variable"]) == list(sj["variable"]) == ["x[0]", "x[1]", "log_density"]
    np.testing.assert_allclose(st.drop(columns="variable").to_numpy(float),
                               sj.drop(columns="variable").to_numpy(float), rtol=1e-4, atol=1e-5)
    rj, rt = J.reports_dataframe(ja), T.reports_dataframe(ta)
    assert isinstance(rt, pd.DataFrame) and len(rt) == 5
    assert set(rj.columns) == set(rt.columns)
    assert list(rt["n_tempered_restarts"]) == list(rj["n_tempered_restarts"])
    wj, wt = J.swap_prs_dataframe(ja), T.swap_prs_dataframe(ta)
    np.testing.assert_allclose(wt.to_numpy(float), wj.to_numpy(float), atol=1e-6)
    x = np.random.default_rng(0).normal(size=(4, 500))
    assert T.ess(x[0]) == J.ess(x[0]) and T.split_rhat(x) == J.split_rhat(x)
    assert T.diagnostics.ess is T.ess


def test_plots_draw_both_legs():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    ta = T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_chains_variational=3, n_rounds=3,
                   seed=1, show_report=False, device="cpu")
    for plot in (T.plots.plot_local_barrier, T.plots.plot_cumulative_barrier):
        ax = plot(ta)
        assert [line.get_label() for line in ax.get_lines()][:2] == ["fixed leg", "variational leg"]
    with pytest.raises(RuntimeError, match="index_process"):
        T.plots.plot_index_process(ta)


def test_evidence_functions_use_the_variational_leg():
    ta = T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_chains_variational=3, n_rounds=3,
                   seed=1, show_report=False, device="cpu")
    assert ta._stepping_stone_pair_mask().tolist() == [True, True, False, False, False]
    assert T.stepping_stone(ta) == ta.reports[-1].log_z_estimate
    fwd, bwd = T.stepping_stone_pair(ta)
    assert abs(0.5 * (fwd + bwd) - T.stepping_stone(ta)) < 1e-12
