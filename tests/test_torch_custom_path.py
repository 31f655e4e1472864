"""The port's ``CustomPath`` / ``CustomPathTarget`` on the cases of
``tests/test_custom_path.py`` (the JuliaBUGS-style tempering ``logprior +
beta * loglikelihood``), on the CPU, with the JAX tests' thresholds.

The run is cut from 9 rounds of one ladder to 4 rounds of 32 ladders with
the torch ``SliceSampler`` (the last round pools 512 target-chain samples,
as the JAX run's does; a scan of that sampler costs half a second on a CPU)
and to 6 rounds of 32 ladders with ``AutoMALA``. The torch
``SliceSampler`` and the gradient explorers take the path as it is;
``SliceSamplerCUDA`` has no device density for it and raises, naming the
route of a ``CustomPath`` with a CUDA source (``tests/test_torch_user_density.py``).
"""

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch import rng
from pigeons_tpu_torch.models import CustomPath, CustomPathTarget

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which the thread pool slows when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _bugs_style_target(dim=2):
    # prior N(0, 1) and a likelihood that pulls the variance to 1/10
    def lp(x, beta):
        log_prior = -0.5 * torch.sum(x * x, dim=-1)
        log_like = -0.5 * 9.0 * torch.sum(x * x, dim=-1)
        return log_prior + beta * log_like

    path = CustomPath(log_density_fn=lp, sample_reference=lambda keys: rng.normal(keys, (dim,)))
    return CustomPathTarget(path, dim=dim)


@pytest.mark.parametrize("explorer,n_rounds,n_replicates",
                         [("SliceSampler", 4, 32), ("AutoMALA", 6, 32)])
def test_custom_path_run_matches_oracle(explorer, n_rounds, n_replicates):
    # the same annealed family as toy_mvn_target: precision 1 -> 10
    pt = T.pigeons(target=_bugs_style_target(2), explorer=getattr(T, explorer)(), n_chains=4,
                   n_rounds=n_rounds, n_replicates=n_replicates, show_report=False,
                   device="cpu")
    print(f"{explorer}: mean {pt.mean()}, var {pt.var()}, round trips {pt.n_round_trips}")
    assert np.all(np.abs(pt.mean()) < 0.05)
    assert np.all(np.abs(pt.var() - 0.1) < 0.05)
    assert pt.n_round_trips > 0


def test_custom_path_beta_zero_is_prior():
    t = _bugs_style_target(3)
    x = torch.ones(3)
    ref = t.default_reference()
    assert float(ref.log_density(x)) == float(-0.5 * 3)
    assert np.isclose(float(t.log_density(x)), -0.5 * 30.0)
    # batched: a state per key, the reference's draws of a key are its normals
    keys = rng.keys_for(rng.key(0), torch.arange(5))
    assert torch.equal(t.initialization(keys), rng.normal(keys, (3,)))
    assert t.create_path(ref) is t.path and t.path.has_iid_reference


def test_custom_path_without_sampler_starts_at_zero():
    t = CustomPathTarget(CustomPath(lambda x, beta: -0.5 * torch.sum(x * x, dim=-1)), dim=2)
    keys = rng.keys_for(rng.key(0), torch.arange(3))
    assert torch.equal(t.initialization(keys), torch.zeros(3, 2))
    assert not t.path.has_iid_reference


def test_slice_sampler_cuda_refuses_a_custom_path():
    t = _bugs_style_target(2)
    with pytest.raises(NotImplementedError, match="DeviceSource"):
        T.SliceSamplerCUDA().check_path(t.create_path(t.default_reference()))
