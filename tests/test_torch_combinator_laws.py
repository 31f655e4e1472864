"""The laws of the port's combinators: the seven cases of
``tests/test_combinators.py`` (reference ``Mix.jl``, ``Compose.jl``) with the
JAX tests' own bounds, on the CPU.

The JAX tests run 7 rounds of one ladder of 4 chains, whose last round
gives 128 target-chain samples; here 4 rounds of 8 ladders give as many, in
a eighth of the scans (a scan on the CPU costs about as much for 32 lanes as
for 4). The determinism pairs run 3 rounds of 2 ladders.
"""

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(explorer, seed=1, n_rounds=4, n_replicates=8):
    pt = T.PT(T.Inputs(target=T.toy_mvn_target(2), n_chains=4, n_rounds=n_rounds,
                       n_replicates=n_replicates, seed=seed, explorer=explorer,
                       show_report=False, device="cpu")).run()
    assert n_replicates < 8 or pt.traces.shape[0] >= 128  # the JAX tests' samples
    print(f"{type(explorer).__name__}: mean {pt.mean()}, var {pt.var()}")
    return pt


def test_compose_moments():
    pt = _run(T.Compose(T.SliceSampler(n_passes=1), T.MALA(step_size=0.3)))
    assert np.abs(pt.mean()).max() < 0.1
    assert np.abs(pt.var() - 0.1).max() < 0.06


def test_compose_recurses_adaptation():
    # AutoMALA inside a Compose still receives its extras (step-size
    # exponents) and adapts: its step size moves from the 1.0 it starts at
    pt = _run(T.Compose(T.SliceSampler(n_passes=1), T.AutoMALA()))
    step = pt.exp_state[1]["step_size"].numpy()
    assert not np.allclose(step, 1.0)
    assert np.abs(pt.mean()).max() < 0.1


def test_mix_moments():
    pt = _run(T.Mix(T.SliceSampler(n_passes=1), T.MALA(step_size=0.3)))
    assert np.abs(pt.mean()).max() < 0.1
    assert np.abs(pt.var() - 0.1).max() < 0.06


def test_mix_supports_extras():
    # components with statistics get fixed slots; the selected component's
    # counts are masked by the selection, so AutoMALA's factor adaptation
    # still sees its own per-chain means and moves its step size
    pt = _run(T.Mix(T.SliceSampler(n_passes=1), T.AutoMALA()))
    step = pt.exp_state[1]["step_size"].numpy()
    assert not np.allclose(step, 1.0)
    assert np.abs(pt.mean()).max() < 0.12
    extra_n = pt.reduced.extra_n
    assert extra_n.shape[1] == len(pt.explorer.extra_names)
    assert (extra_n.sum(0) > 0).all()


def test_mix_deterministic():
    a = _run(T.Mix(T.SliceSampler(n_passes=1), T.MALA(step_size=0.3)), seed=3, n_rounds=3,
             n_replicates=2)
    b = _run(T.Mix(T.SliceSampler(n_passes=1), T.MALA(step_size=0.3)), seed=3, n_rounds=3,
             n_replicates=2)
    assert np.array_equal(a.sample_array(), b.sample_array())


def test_scanmix_moments_and_adaptation():
    pt = _run(T.ScanMix(T.SliceSampler(n_passes=1), T.AutoMALA()))
    assert np.abs(pt.mean()).max() < 0.12
    assert np.abs(pt.var() - 0.1).max() < 0.06
    step = pt.exp_state[1]["step_size"].numpy()
    assert not np.allclose(step, 1.0)
    assert (pt.reduced.extra_n.sum(0) > 0).all()


def test_scanmix_deterministic():
    a = _run(T.ScanMix(T.SliceSampler(n_passes=1), T.MALA(step_size=0.3)), seed=3,
             n_rounds=3, n_replicates=2)
    b = _run(T.ScanMix(T.SliceSampler(n_passes=1), T.MALA(step_size=0.3)), seed=3,
             n_rounds=3, n_replicates=2)
    assert np.array_equal(a.sample_array(), b.sample_array())
