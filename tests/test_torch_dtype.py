"""float64 runs of the port (``Inputs.dtype=float64``) against the JAX
package's under x64, on the CPU.

JAX's x64 mode is process-global, so the JAX side runs once, in a subprocess
(``tests/torch_x64_reference.py``), and hands back numpy arrays. Held to it:

* the float64 draws (uniform, normal, exponential, Gumbel) and the float64
  forms of ``f32math`` / ``f64math`` (``fma``, ``exp``, ``log``, ``log1p``,
  ``expm1``, ``erfinv``, ``lgamma``, ``logaddexp``, ``sqrt``) on sweeps:
  bitwise;
* ``tests/test_dtype.py``'s runs: the funnel's state at ``y = -100`` (finite
  in float64, -inf in float32), the deep funnel (4 chains x 5 rounds,
  ``SliceSampler(n_passes=1)``) and the toy MVN (4 chains, the default
  explorer, 4 rounds here against the JAX file's 9: each round of the JAX
  side compiles anew, and the port's eager scans take about 0.03 s each on
  the CPU; the 9-round law runs on the card, ``chip_smoke.py`` phase 13a).
  Permutations, round trips and restarts equal; the deep funnel's states
  bitwise, the toy's within 2e-15 relative (XLA's float64 ``rsqrt`` in
  ``ToyExplorer``'s draws is the CPU's estimate refined by Newton steps);
  the samples' state columns within 1e-13 relative (a few transient values
  of the funnel's y differ in the last bits) and their log density column
  within 1e-12 (XLA fuses the density into other kernels inside the round
  and rounds some of them differently in the last bit); logZ and barriers
  within 1e-9;
* a ``SliceSampler`` run continued from the JAX run's state after round 2
  (``convert.state_from_numpy``), round 3 bitwise; the same with ``AAPS``,
  held as the float32 AAPS file holds it (at most 1 % of lanes elsewhere);
  ``BinaryGibbs`` (Ising) and ``Compose`` (slice sampler and AAPS) runs from
  the seed, the first bitwise, the second's states within 1e-13 relative
  and 1e-14 absolute (AAPS's leapfrogs carry the gradient's last bits);
* ``MALA``, ``AutoMALA`` and ``NUTS`` raise the ``TypeError`` that the JAX
  runtime raises in a float64 run (a fault of the reference, ROADMAP §3);
* the dtype of every leaf after a round;
* a float64 checkpoint resumed bit for bit, the dtype's three spellings, and
  ``SliceSamplerCUDA``'s refusal naming ``SliceSampler(...)``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch import f32math, f64math, rng
from pigeons_tpu_torch.convert import explorer_state_from_numpy, state_from_numpy
from pigeons_tpu_torch.models import funnel, ising_target

ROOT = Path(__file__).resolve().parent.parent
F64 = torch.float64


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("x64") / "ref.npz"
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_x64_reference.py"),
                           str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(target, **kw):
    return T.PT(T.Inputs(target=target, dtype=F64, show_report=False, device="cpu", **kw))


def _assert_run_is_jax(pt, ref, prefix, state_rtol=0.0, state_atol=1e-300):
    assert pt.states.dtype == F64
    if state_rtol:
        np.testing.assert_allclose(pt.states.numpy(), ref[prefix + "states"], rtol=state_rtol,
                                   atol=state_atol)
    else:
        assert np.array_equal(pt.states.numpy(), ref[prefix + "states"])
    assert np.array_equal(pt.chain_of.numpy(), ref[prefix + "chain_of"])
    assert np.array_equal(pt.replica_of.numpy(), ref[prefix + "replica_of"])
    assert [r.n_round_trips for r in pt.reports] == list(ref[prefix + "trips"])
    assert [r.n_tempered_restarts for r in pt.reports] == list(ref[prefix + "restarts"])
    np.testing.assert_allclose(pt.schedule.grids, ref[prefix + "schedule"], rtol=1e-9, atol=0)
    sa, ra = pt.sample_array(), ref[prefix + "samples"]
    np.testing.assert_allclose(sa[:, :-1], ra[:, :-1], rtol=1e-13, atol=state_atol)
    np.testing.assert_allclose(sa[:, -1], ra[:, -1], rtol=1e-12, atol=0)
    np.testing.assert_allclose([r.log_z_estimate for r in pt.reports], ref[prefix + "logz"],
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose([r.global_barrier for r in pt.reports], ref[prefix + "barrier"],
                               rtol=1e-9, atol=1e-9)


def test_float64_draws_are_jax_random_bitwise(ref):
    keys = torch.from_numpy(ref["draw_keys"])
    for name, fn in (("uniform", rng.uniform), ("normal", rng.normal),
                     ("exponential", rng.exponential), ("gumbel", rng.gumbel)):
        got = fn(keys, (8,), dtype=F64).numpy()
        assert got.dtype == np.float64
        assert np.array_equal(got, ref["draw_" + name]), name
    # the default float dtype is the run's: float64 inside a float64 run's scope
    with rng.default_float(F64):
        assert np.array_equal(rng.uniform(keys, (8,)).numpy(), ref["draw_uniform"])
    assert rng.uniform(keys, (8,)).dtype == torch.float32


@pytest.mark.parametrize("name", ["fma", "fma_exact", "exp", "log", "log1p", "expm1", "erfinv",
                                  "lgamma", "logaddexp", "sqrt"])
def test_float64_math_is_xla_bitwise(ref, name):
    # fma_exact: the emulation that f64math.fma falls back to where
    # torch.addcmul is not fused
    key = "fma" if name == "fma_exact" else name
    args = [torch.from_numpy(ref[f"math_{key}_in{i}"]) for i in range(3)
            if f"math_{key}_in{i}" in ref]
    fn = {"sqrt": f64math.sqrt, "fma_exact": f64math._fma_exact}.get(name) or getattr(f32math, name)
    got = fn(*args).numpy()
    want = ref[f"math_{key}_out"]
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{name}: {int((~same).sum())} of {same.size} differ"


def test_float32_density_saturates_where_float64_does_not(ref):
    s = torch.tensor([[-100.0, 1.0, 1.0]])
    assert not torch.isfinite(funnel(2).log_density(s)).any()
    lp = funnel(2).log_density(s.to(F64))
    assert lp.dtype == F64 and torch.isfinite(lp).all()
    np.testing.assert_allclose(lp.numpy()[0], ref["funnel_lp"], rtol=1e-15)


def test_deep_funnel_run_is_the_jax_run(ref):
    pt = _run(funnel(2), n_chains=4, n_rounds=5, seed=1, explorer=T.SliceSampler(n_passes=1))
    pt.run()
    sa = pt.sample_array()
    assert sa.dtype == np.float64 and np.isfinite(sa).all()
    assert np.isfinite(pt.mean()).all() and np.isfinite(pt.reports[-1].log_z_estimate)
    _assert_run_is_jax(pt, ref, "deep_")
    np.testing.assert_allclose(pt.mean(), ref["deep_mean"], rtol=1e-12)


def test_toy_mvn_run_is_the_jax_run(ref):
    pt = _run(T.toy_mvn_target(2), n_chains=4, n_rounds=4, seed=1)
    pt.run()
    # ToyExplorer's draws scale by rsqrt(precision): XLA's float64 rsqrt is
    # the CPU's 14-bit estimate and two Newton steps, torch's may differ in
    # the last bit
    _assert_run_is_jax(pt, ref, "toy_", state_rtol=2e-15)
    np.testing.assert_allclose(pt.var(), ref["toy_var"], rtol=1e-12)


def _carried(ref, name, explorer):
    pt = _run(T.toy_mvn_target(3), n_chains=4, n_replicates=2, seed=4, n_rounds=3,
              explorer=explorer)
    state_from_numpy(pt, {k: ref[f"{name}2_{k}"] for k in
                          ("states", "chain_of", "replica_of", "schedule")}, 2)
    if f"{name}2_std_devs" in ref:
        explorer_state_from_numpy(pt, {"std_devs": ref[f"{name}2_std_devs"]})
    pt.run_round()
    return pt


def test_slice_sampler_round_carried_over_is_the_jax_round(ref):
    pt = _carried(ref, "slice", T.SliceSampler(n_passes=2))
    assert np.array_equal(pt.states.numpy(), ref["slice3_states"])
    assert np.array_equal(pt.chain_of.numpy(), ref["slice3_chain_of"])
    assert pt.reports[-1].n_round_trips == ref["slice3_trips"][-1]


def test_aaps_round_carried_over_follows_the_jax_round(ref):
    pt = _carried(ref, "aaps", T.AAPS(step_size=0.3))
    moved = np.abs(pt.states.numpy() - ref["aaps3_states"]).max(-1) > 1e-12
    assert moved.sum() <= 0.01 * moved.size + 1


@pytest.mark.parametrize("name", ["ising", "compose"])
def test_discrete_and_combinator_runs_are_the_jax_runs(ref, name):
    if name == "ising":
        pt = _run(ising_target(0.4, 3), n_chains=4, n_rounds=2, seed=2)
    else:
        pt = _run(T.toy_mvn_target(2), n_chains=4, n_rounds=2, seed=3,
                  explorer=T.Compose(T.SliceSampler(n_passes=1), T.AAPS(step_size=0.3)))
    pt.run()
    if name == "ising":
        _assert_run_is_jax(pt, ref, name + "_")
    else:
        # AAPS's trajectories carry the gradient's last-bit differences (autograd
        # against jax.grad) through their leapfrogs: 1e-13 relative, 1e-14 absolute
        _assert_run_is_jax(pt, ref, name + "_", state_rtol=1e-13, state_atol=1e-14)


@pytest.mark.parametrize("name,explorer", [("mala", T.MALA), ("automala", T.AutoMALA),
                                           ("nuts", T.NUTS)])
def test_gradient_explorers_fail_as_the_jax_ones_do(ref, name, explorer):
    kind, message = ref["fails_" + name]
    assert kind == "TypeError", message
    pt = _run(T.toy_mvn_target(2), n_chains=4, n_rounds=1, seed=1, explorer=explorer())
    with pytest.raises(TypeError, match="carry input and carry output must have equal types"):
        pt.run()


@pytest.mark.parametrize("name", ["slice", "aaps"])
def test_leaf_dtypes_are_the_jax_runs(ref, name):
    explorer = T.SliceSampler(n_passes=2) if name == "slice" else T.AAPS(step_size=0.3)
    pt = _run(T.toy_mvn_target(3), n_chains=4, n_replicates=2, seed=4, n_rounds=1,
              explorer=explorer)
    pt.run_round()
    leaves = {"states": pt.states, "chain_of": pt.chain_of, "replica_of": pt.replica_of,
              "betas": pt.betas, "schedule": pt.schedule.grids, "traces": pt.traces}
    leaves.update({"exp_state." + k: v for k, v in (pt.exp_state or {}).items()})
    leaves.update({"reduced." + k: v for k, v in pt.reduced._asdict().items()})
    prefix = f"dtypes_{name}_"
    want = {k[len(prefix):]: str(v) for k, v in ref.items() if k.startswith(prefix)}
    got = {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)).dtype.name
           for k, v in leaves.items()}
    # the port keeps its permutations in int64 (torch's index type), the JAX
    # runtime in int32
    for k in ("chain_of", "replica_of"):
        assert (got.pop(k), want.pop(k)) == ("int64", "int32")
    assert got == want


def test_float64_checkpoint_resumes_bit_for_bit(tmp_path):
    kw = dict(target=T.toy_mvn_target(3), n_chains=4, seed=2, dtype=F64,
              explorer=T.SliceSampler(n_passes=1), show_report=False, device="cpu")
    whole = T.pigeons(n_rounds=3, **kw)
    folder = str(tmp_path / "run")
    T.pigeons(n_rounds=2, checkpoint=True, checkpoint_folder=folder, **kw)
    resumed = T.load_pt(T.increment_n_rounds(folder, 1), device="cpu").run()
    assert resumed.states.dtype == F64
    assert np.array_equal(resumed.states.numpy(), whole.states.numpy())
    assert np.array_equal(resumed.sample_array(), whole.sample_array())


@pytest.mark.parametrize("dtype", [torch.float64, np.float64, "float64"])
def test_float64_is_spelled_three_ways(dtype):
    pt = T.PT(T.Inputs(target=T.toy_mvn_target(2), n_chains=3, n_rounds=1, dtype=dtype,
                       show_report=False, device="cpu"))
    assert pt.run().states.dtype == F64


def test_cuda_sampler_refuses_float64_naming_the_torch_sampler():
    with pytest.raises(ValueError, match=r"SliceSampler\(w=10.0, p=20, n_passes=1, "
                                         r"max_iter=1024\)"):
        _run(funnel(2), n_chains=4, explorer=T.SliceSamplerCUDA(n_passes=1))
