"""The laws of the port's gradient explorers: ``tests/test_gradient_explorers.py``
(reference ``test/test_auto_mala.jl``, ``test_mala.jl``) with the JAX tests'
own thresholds, on the CPU.

Each run is shorter than its JAX twin by two to four rounds and runs
``n_replicates`` ladders instead of one, so that the last round pools as
many target-chain samples or more (the port's CPU scan costs about as much
for 128 lanes as for 4): the JAX tests' 9 rounds of one ladder give 512
samples, the port's 6 rounds of 16 ladders 1,024. The tests of adaptation
are in ``tests/test_torch_gradient_adaptation.py``.
"""

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which the thread pool slows when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def run(target, explorer, n_rounds, n_chains=4, n_replicates=16, seed=1):
    return T.PT(T.Inputs(target=target, n_chains=n_chains, n_rounds=n_rounds,
                         n_replicates=n_replicates, seed=seed, explorer=explorer,
                         show_report=False, device="cpu")).run()


@pytest.mark.parametrize("name", ["MALA", "AutoMALA"])
def test_moments(name):
    explorer = T.MALA(step_size=0.5) if name == "MALA" else T.AutoMALA()
    pt = run(T.toy_mvn_target(2), explorer, n_rounds=6)
    print(f"{name}: mean {pt.mean()}, var {pt.var()}, explorer acceptance "
          f"{np.nanmean(pt.reduced.exp_accept):.4f}")
    np.testing.assert_allclose(pt.mean(), 0.0, atol=0.05)
    np.testing.assert_allclose(pt.var(), 0.1, atol=0.05)
    if name == "AutoMALA":
        # reference test_auto_mala.jl:44-48: mean MH acceptance > 0.4
        assert np.nanmean(pt.reduced.exp_accept) > 0.4


def test_automala_reversibility_rate_recorded():
    pt = run(T.toy_mvn_target(3), T.AutoMALA(), n_rounds=5, n_replicates=4)
    i = T.AutoMALA.extra_names.index("reversibility_rate")
    rates = pt.reduced.extra_mean[:, i]
    print(f"reversibility rate by chain {rates}")
    assert np.all(pt.reduced.extra_n[:, i] > 0)  # recorded at every chain
    assert np.nanmean(rates) > 0.6  # mostly reversible on a Gaussian


def test_identity_preconditioner_no_adaptation():
    explorer = T.MALA(step_size=0.5, preconditioner=T.IdentityPreconditioner())
    pt = run(T.toy_mvn_target(2), explorer, n_rounds=4, n_replicates=4)
    assert torch.equal(pt.exp_state["std_devs"], torch.ones_like(pt.exp_state["std_devs"]))
    assert not explorer.needs_online_moments()


def test_adapting_explorer_records_online_moments():
    """An adapting preconditioner reads the online variance, so the runtime
    records it even when ``Inputs.record`` leaves it out (JAX ``pt.py:851-855``)."""
    pt = T.PT(T.Inputs(target=T.toy_mvn_target(2), n_chains=3, n_rounds=2, record=("traces",),
                       explorer=T.AutoMALA(), show_report=False, device="cpu")).run()
    assert np.isfinite(pt.reduced.online_var).all()
    assert not torch.equal(pt.exp_state["std_devs"], torch.ones_like(pt.exp_state["std_devs"]))
