"""The adaptation laws of the port's gradient explorers:
``tests/test_gradient_explorers.py`` (reference ``test/test_auto_mala.jl``)
with the JAX tests' own thresholds, on the CPU: acceptance across
dimensions, the step size's scaling with dimension, the mass matrix. Runs
are cut in rounds and widened in ladders as ``tests/test_torch_gradient_laws.py``
says.
"""

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch.models.target import Reference, StandardNormalReference, Target

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which the thread pool slows when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



class HetPrecisionNormal(Target):
    """Independent Gaussian with per-coordinate precisions (the reference's
    HetPrecisionNormalLogPotential fixture)."""

    def __init__(self, precisions):
        self.precisions = torch.tensor(precisions, dtype=torch.float32)
        self.dim = len(precisions)

    def log_density(self, x):
        return -0.5 * torch.sum(self.precisions * x * x, dim=-1)

    def default_reference(self) -> Reference:
        return StandardNormalReference(self.dim).as_reference()


def run(target, explorer, n_rounds, n_chains=4, n_replicates=16, seed=1):
    return T.PT(T.Inputs(target=target, n_chains=n_chains, n_rounds=n_rounds,
                         n_replicates=n_replicates, seed=seed, explorer=explorer,
                         show_report=False, device="cpu")).run()


@pytest.mark.parametrize("dim", [1, 10, 100])
def test_automala_acceptance_across_dims(dim):
    pt = run(T.toy_mvn_target(dim), T.AutoMALA(), n_rounds=4, n_chains=3, n_replicates=8)
    acc = np.nanmean(pt.reduced.exp_accept)
    print(f"d={dim}: explorer acceptance {acc:.4f}")
    assert acc > 0.4


def test_automala_step_size_dimensional_scaling():
    """Step size shrinks with dimension, but by less than d^(1/3)
    (reference test_auto_mala.jl:27-34)."""

    def adapted_step(dim):
        pt = run(T.toy_mvn_target(dim), T.AutoMALA(), n_rounds=5, n_chains=3, n_replicates=4)
        return float(pt.exp_state["step_size"][0])

    s1, s64 = adapted_step(1), adapted_step(64)
    print(f"adapted step sizes: {s1} at d=1, {s64} at d=64")
    assert s64 < s1
    assert s1 / s64 < 64.0 ** (1.0 / 3.0) * 2.0


def test_mass_matrix_adaptation():
    """DiagonalPreconditioner recovers the target std devs (reference
    test_auto_mala.jl:36-41: precisions [500, 1])."""
    pt = run(HetPrecisionNormal([500.0, 1.0]),
             T.AutoMALA(preconditioner=T.DiagonalPreconditioner()), n_rounds=6, n_replicates=32)
    stds = pt.exp_state["std_devs"][0].numpy()
    print(f"adapted std devs {stds} (target {1 / np.sqrt(500.0):.4f}, 1)")
    assert abs(stds[0] - 1.0 / np.sqrt(500.0)) < 0.01
    assert abs(stds[1] - 1.0) < 0.2
