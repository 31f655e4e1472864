"""The port on an NVIDIA card: kernels K1 and K2 against their twins, and runs
on the card against the same runs on the CPU. Every test here is marked ``cuda`` and
skips without a CUDA device. The file imports no JAX, so that it runs on a
machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import functools

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
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
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
    before = SliceSamplerCUDA.launches["banded_slice_sweep"]
    xk, sk = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes)
    assert SliceSamplerCUDA.launches["banded_slice_sweep"] == before + 1
    xt, st = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes)
    assert torch.equal(xk, xt) and torch.equal(sk, st)


def _lane_inputs(n, d, seed, device):
    rs = np.random.RandomState(seed)
    x = torch.tensor((rs.normal(size=(n, d)) * 2.0).astype(np.float32), device=device)
    betas = torch.tensor(rs.uniform(size=n).astype(np.float32), device=device)
    betas[0], betas[-1] = 0.0, 1.0
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(2, device), torch.arange(n, device=device)))
    return x, betas, seeds


# B * d below a warp, a prime, config 1's; no pass at all, one, the default
@pytest.mark.cuda
@pytest.mark.parametrize("n_passes", [0, 1, 3])
@pytest.mark.parametrize("n,d", [(1, 5), (1, 4099), (20480, 100)])
def test_kernel_matches_twin_at_the_edges(cuda_device, n, d, n_passes):
    """Bitwise, and the same bits from a second launch on the same inputs
    (the per-lane sums are integer-valued, so their order does not show)."""
    x, betas, seeds = _lane_inputs(n, d, n_passes, cuda_device)
    a = toy_mvn_path(d).coord_factor(betas)
    first = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes)
    again = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes)
    for name, f, g, w in zip(("x", "stats"), first, again, want, strict=True):
        assert torch.equal(f.view(torch.int32), w.view(torch.int32)), name
        assert torch.equal(f.view(torch.int32), g.view(torch.int32)), name


@functools.lru_cache(maxsize=None)
def _k2_full_case(name, d, n):
    """A path, inputs on the card and the twin's result for them, made once
    for all group sizes."""
    device = torch.device("cuda")
    target = {"funnel": lambda: T.funnel(d - 1), "banana": lambda: T.banana(d - 1, 1.5),
              "mvn": lambda: T.mvn_target(d, 2.5)}[name]()
    path = target.create_path(target.default_reference())
    x, betas, seeds = _lane_inputs(n, d, d, device)
    return path, x, betas, seeds, cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1)


# d = 1, below, just above and far above a group of 8; one lane, a last block
# that is not full, the funnel cell's batch
@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 8, 16, 32])
@pytest.mark.parametrize("n", [1, 33, 3072])
@pytest.mark.parametrize("d", [1, 7, 10, 40])
@pytest.mark.parametrize("name", ["funnel", "banana", "mvn"])
def test_general_kernel_matches_twin_for_each_group(cuda_device, name, d, n, group):
    """Full mode with 1, 8, 16 and 32 threads per lane: bitwise the twin, and
    the same bits from a second launch."""
    path, x, betas, seeds, want = _k2_full_case(name, d, n)
    first = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, group=group)
    again = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, group=group)
    for tensor_name, f, g, w in zip(("x", "lp", "stats"), first, again, want, strict=True):
        assert torch.equal(f.view(torch.int32), w.view(torch.int32)), tensor_name
        assert torch.equal(f.view(torch.int32), g.view(torch.int32)), tensor_name


def _k2_cases():
    def interpolating(target):
        return target.create_path(target.default_reference())

    return {
        "funnel": (interpolating(T.funnel(9)), False, 3072, 10),
        "funnel-scaled": (interpolating(T.funnel(4, 0.5)), False, 1000, 5),
        "banana": (interpolating(T.banana(9, 1.5)), False, 1000, 10),
        "mvn": (interpolating(T.mvn_target(10, 2.5)), False, 1000, 10),
        "toy-full": (toy_mvn_path(20), False, 1000, 20),
        "toy-delta": (toy_mvn_path(100), True, 4096, 100),
        "toy-delta-wide": (toy_mvn_path(600), True, 100, 600),  # 64 lanes per block
    }


@pytest.mark.cuda
@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("case", ["funnel", "funnel-scaled", "banana", "mvn", "toy-full",
                                  "toy-delta", "toy-delta-wide"])
def test_general_kernel_matches_twin_on_card(cuda_device, case, n_passes):
    """Bitwise in both modes: states, returned densities and stats. The
    funnel cases include states far out in the tails and a NaN."""
    path, coord_deltas, n, d = _k2_cases()[case]
    rs = np.random.RandomState(n_passes)
    x = torch.tensor((rs.normal(size=(n, d)) * 2.0).astype(np.float32), device=cuda_device)
    if case.startswith("funnel"):
        x[3, 0], x[4, 0], x[5, 1] = 95.0, -95.0, float("nan")
    betas = torch.tensor(rs.uniform(size=n).astype(np.float32), device=cuda_device)
    betas[0], betas[-1] = 0.0, 1.0
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(2, cuda_device), torch.arange(n, device=cuda_device)))
    before = SliceSamplerCUDA.launches["slice_sweep"]
    got = cuda_slice.sweep(x, betas, seeds, path, coord_deltas, n_passes=n_passes)
    assert SliceSamplerCUDA.launches["slice_sweep"] == before + 1
    want = cuda_slice.sweep_reference(x, betas, seeds, path, coord_deltas, n_passes=n_passes)
    for name, g, w in zip(("x", "lp", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.cuda
def test_general_kernel_keeps_the_funnel_law_on_card(cuda_device):
    """4,096 lanes of exact funnel(9) draws, 300 sweeps of K2 at beta = 1 with
    fresh lane seeds each: the y marginal stays N(0, 3), held with a
    Kolmogorov-Smirnov test at level 1e-3 before, during and after (the seeds
    are fixed, so the test is deterministic)."""
    from scipy import stats as sps

    target = T.funnel(9)
    path = target.create_path(target.default_reference())
    lanes = torch.arange(4096, device=cuda_device)
    x = target.sample_iid_target(rng.keys_for(rng.key(31, cuda_device), lanes)).contiguous()
    betas = torch.ones(4096, device=cuda_device)
    for sweep in range(301):
        if sweep in (0, 10, 100, 300):
            y = x[:, 0].cpu().numpy()
            res = sps.kstest(y, sps.norm(0.0, 3.0).cdf)
            print(f"after {sweep} sweeps: y mean {y.mean():.4f}, variance {y.var():.4f}, "
                  f"KS p-value {res.pvalue:.4f}")
            assert res.pvalue > 1e-3, sweep
        seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(1000 + sweep, cuda_device), lanes))
        x = cuda_slice.sweep(x, betas, seeds, path, n_passes=1)[0]


@pytest.mark.cuda
def test_general_kernel_rejects_bad_inputs(cuda_device):
    x = torch.zeros(4, 3, device=cuda_device)
    betas = torch.zeros(4, device=cuda_device)
    seeds = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        cuda_slice.sweep_cuda(x, betas.double(), seeds, toy_mvn_path(3))
    with pytest.raises(RuntimeError, match="does not take"):  # no coordinate term for the funnel
        target = T.funnel(2)
        cuda_slice.sweep_cuda(x, betas, seeds, target.create_path(target.default_reference()), True)
    with pytest.raises(RuntimeError, match="does not take"):  # a state too wide for shared memory
        cuda_slice.sweep_cuda(torch.zeros(4, 2000, device=cuda_device), betas, seeds, toy_mvn_path(2000))
    with pytest.raises(RuntimeError, match="does not take"):  # and for groups of 8: d above 1,816
        cuda_slice.sweep_cuda(torch.zeros(4, 2000, device=cuda_device), betas, seeds,
                              toy_mvn_path(2000), group=8)
    with pytest.raises(RuntimeError, match="does not take"):  # no such group size
        cuda_slice.sweep_cuda(x, betas, seeds, toy_mvn_path(3), group=3)


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


@pytest.mark.cuda
def test_funnel_card_run_matches_cpu_run(cuda_device):
    g, c = (T.pigeons(target=T.funnel(3), n_chains=5, n_replicates=8, seed=4, n_rounds=4,
                      explorer=T.SliceSamplerCUDA(n_passes=1), device=dev, show_report=False)
            for dev in ("cuda", "cpu"))
    assert torch.equal(g.chain_of.cpu(), c.chain_of)
    assert torch.equal(g.states.cpu(), c.states)
    assert g.reports[-1].log_z_estimate == c.reports[-1].log_z_estimate
