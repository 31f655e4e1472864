"""The port on an NVIDIA card: kernel K1 against its twin, and a run on the
card against the same run on the CPU. Every test here is marked ``cuda`` and
skips without a CUDA device. The file imports no JAX, so that it runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch import rng
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice
from pigeons_tpu_torch.paths import toy_mvn_path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_passes", [1, 3])
def test_kernel_matches_twin_on_card(cuda_device, n_passes):
    """Bitwise: the twin follows the kernel's fused multiply-adds and log."""
    rs = np.random.RandomState(n_passes)
    n, d = 4096, 100
    x = torch.tensor(rs.normal(size=(n, d)).astype(np.float32), device=cuda_device)
    betas = torch.tensor(rs.uniform(size=n).astype(np.float32), device=cuda_device)
    a = toy_mvn_path(d).coord_factor(betas)
    keys = rng.keys_for(rng.key(1, cuda_device), torch.arange(n, device=cuda_device))
    seeds = cuda_slice.lane_seeds(keys)
    before = SliceSamplerCUDA.n_kernel_launches
    xk, sk = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes)
    assert SliceSamplerCUDA.n_kernel_launches == before + 1
    xt, st = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes)
    assert torch.equal(xk, xt) and torch.equal(sk, st)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros(4, 3, device=cuda_device)
    seeds = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_slice.banded_sweep_cuda(x, torch.zeros(4, dtype=torch.float64, device=cuda_device), seeds)
    with pytest.raises(ValueError):
        cuda_slice.banded_sweep_cuda(x.t(), torch.zeros(3, device=cuda_device), seeds[:3])


@pytest.mark.cuda
def test_card_run_matches_cpu_run(cuda_device):
    runs = [T.pigeons(target=T.toy_mvn_target(6), n_chains=5, n_replicates=8, seed=4,
                      n_rounds=4, explorer=T.SliceSamplerCUDA(), device=dev, show_report=False)
            for dev in ("cuda", "cpu")]
    g, c = runs
    assert torch.equal(g.chain_of.cpu(), c.chain_of)
    assert torch.equal(g.states.cpu(), c.states)
