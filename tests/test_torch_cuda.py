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


def _variational_term(betas, d, active):
    """Lanes of both legs in turn and a reference that differs by coordinate,
    one std the smallest a fit can give."""
    rs = np.random.RandomState(d)
    dev = betas.device
    isvar = (torch.arange(len(betas), device=dev) % 3 != 1).float()
    mean = torch.tensor((rs.normal(size=d) * 0.3).astype(np.float32), device=dev)
    std = torch.tensor(np.exp(rs.normal(size=d) * 0.5 - 1.0).astype(np.float32), device=dev)
    std[d // 2] = 1e-6
    a_target = float(toy_mvn_path(d).coord_factor(torch.ones(())))
    return cuda_slice.VariationalTerm(betas, isvar, torch.tensor([active], device=dev), a_target,
                                      mean, std)


# B * d below a warp, a d above the tile (the coordinate table then goes by
# element), config 4's shape; one pass and the default
@pytest.mark.cuda
@pytest.mark.parametrize("n_passes", [1, 3])
@pytest.mark.parametrize("n,d", [(1, 5), (2, 4099), (5120, 100)])
def test_variational_kernel_matches_twin(cuda_device, n, d, n_passes):
    """K1 with its variational term: bitwise against the twin, the same bits
    from a second launch, and with the reference not active the toy term's."""
    x, betas, seeds = _lane_inputs(n, d, n_passes, cuda_device)
    a = toy_mvn_path(d).coord_factor(betas)
    term = _variational_term(betas, d, 1.0)
    before = dict(SliceSamplerCUDA.launches)
    first = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes, variational=term)
    assert SliceSamplerCUDA.launches["banded_slice_sweep_variational"] == (
        before["banded_slice_sweep_variational"] + 1)
    assert SliceSamplerCUDA.launches["banded_slice_sweep"] == before["banded_slice_sweep"]
    again = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes, variational=term)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes, variational=term)
    for name, f, g, w in zip(("x", "stats"), first, again, want, strict=True):
        assert torch.equal(f.view(torch.int32), w.view(torch.int32)), name
        assert torch.equal(f.view(torch.int32), g.view(torch.int32)), name
    idle = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes,
                                   variational=_variational_term(betas, d, 0.0))
    toy = cuda_slice.banded_sweep(x, a, seeds, n_passes=n_passes)
    for name, f, w in zip(("x", "stats"), idle, toy, strict=True):
        assert torch.equal(f.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.cuda
def test_two_leg_run_on_card_matches_cpu(cuda_device):
    """A two-leg run whose last round uses the fitted reference: the card's
    kernel against the twin-driven run on the CPU."""
    def run(device):
        return T.pigeons(target=T.toy_mvn_target(5), n_chains=4, n_chains_variational=4,
                         n_replicates=4, n_rounds=4, seed=3, explorer=T.SliceSamplerCUDA(),
                         variational=T.GaussianReference(3), show_report=False, device=device)

    g, c = run("cuda"), run("cpu")
    assert float(g._ref_params["active"]) == 1.0
    assert torch.equal(g.chain_of.cpu(), c.chain_of) and torch.equal(g.states.cpu(), c.states)
    assert g.n_tempered_restarts == c.n_tempered_restarts


@pytest.mark.cuda
def test_torch_slice_sampler_on_card_matches_cpu(cuda_device):
    """The torch ``SliceSampler`` launches no kernel of the port and gives the
    CPU's bits on the card."""
    def run(device):
        return T.pigeons(target=T.funnel(3), n_chains=4, n_replicates=4, n_rounds=2, seed=3,
                         explorer=T.SliceSampler(n_passes=1), show_report=False, device=device)

    before = dict(SliceSamplerCUDA.launches)
    g, c = run("cuda"), run("cpu")
    assert SliceSamplerCUDA.launches == before
    assert torch.equal(g.chain_of.cpu(), c.chain_of) and torch.equal(g.states.cpu(), c.states)


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


def _k2_card_inputs(case, n_passes, device):
    """The path, mode and card inputs of a ``_k2_cases`` case; the funnel
    cases with states far out in the tails and a NaN."""
    path, coord_deltas, n, d = _k2_cases()[case]
    rs = np.random.RandomState(n_passes)
    x = torch.tensor((rs.normal(size=(n, d)) * 2.0).astype(np.float32), device=device)
    if case.startswith("funnel"):
        x[3, 0], x[4, 0], x[5, 1] = 95.0, -95.0, float("nan")
    betas = torch.tensor(rs.uniform(size=n).astype(np.float32), device=device)
    betas[0], betas[-1] = 0.0, 1.0
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(2, device), torch.arange(n, device=device)))
    return path, coord_deltas, x, betas, seeds


@functools.lru_cache(maxsize=None)
def _k2_delta_case(case, n_passes):
    """A delta-mode case's inputs on the card and the twin's sweep of them,
    made once for all group sizes."""
    path, _, x, betas, seeds = _k2_card_inputs(case, n_passes, torch.device("cuda"))
    want = cuda_slice.sweep_reference(x, betas, seeds, path, True, n_passes=n_passes)
    return path, x, betas, seeds, want


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("case", ["toy-delta", "toy-delta-wide"])
def test_delta_kernel_matches_twin_for_each_group(cuda_device, case, n_passes, group):
    """Delta mode with the launcher's choice and one thread a lane (at d =
    600 too): bitwise the twin. A group of more threads is refused."""
    path, x, betas, seeds, want = _k2_delta_case(case, n_passes)
    if group > 1:
        with pytest.raises(RuntimeError, match="error -1"):
            cuda_slice.sweep_cuda(x, betas, seeds, path, True, n_passes=n_passes, group=group)
        return
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, True, n_passes=n_passes, group=group)
    for name, g, w in zip(("x", "lp", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("case", ["funnel", "funnel-scaled", "banana", "mvn", "toy-full",
                                  "toy-delta", "toy-delta-wide"])
def test_general_kernel_matches_twin_on_card(cuda_device, case, n_passes):
    """Bitwise in both modes: states, returned densities and stats. The
    funnel cases include states far out in the tails and a NaN."""
    path, coord_deltas, x, betas, seeds = _k2_card_inputs(case, n_passes, cuda_device)
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


BAYESIAN = {"hierarchical_normal": T.hierarchical_normal, "eight_schools": T.eight_schools,
            "unid": T.unid_target, "logistic_regression": T.logistic_regression,
            "bernoulli": T.bernoulli_target, "mrna": T.mrna_target,
            "eight_schools_centered": lambda: T.eight_schools(centered=True)}


@functools.lru_cache(maxsize=None)
def _bayesian_case(name, n, variational):
    """A ``BayesianModel`` path on the card, states drawn from its prior (some
    far out, one NaN), and the twin's sweep of them; with ``variational`` under
    an active mean-field reference, lanes of both legs."""
    device = torch.device("cuda")
    model = BAYESIAN[name]().to(device)
    path = model.create_path(model.default_reference())
    lanes = torch.arange(n, device=device)
    x = model.initialization(rng.keys_for(rng.key(5, device), lanes)).contiguous()
    if n > 3:
        x[1, -1], x[2, -1], x[3, 0] = 95.0, -95.0, float("nan")
    _, betas, seeds = _lane_inputs(n, model.dim, 3, device)
    extra = {}
    if variational:
        path = T.VariationalPath(path, T.GaussianReference())
        extra = _reference(model.dim, n, 1.0, device)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1, max_iter=64, **extra)
    return path, x, betas, seeds, extra, want


def _reference(d, n, active, device):
    rs = np.random.RandomState(d)
    return {"isvar": torch.tensor((np.arange(n) % 3 != 1).astype(np.float32), device=device),
            "ref_params": {
                "mean": torch.tensor((rs.normal(size=d) * 0.3).astype(np.float32), device=device),
                "std": torch.tensor(np.exp(rs.normal(size=d) * 0.5).astype(np.float32), device=device),
                "active": torch.tensor(active, device=device)}}


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("variational", [False, True])
@pytest.mark.parametrize("n", [5, 1000])
@pytest.mark.parametrize("name", sorted(BAYESIAN))
def test_bayesian_kernel_matches_twin_for_each_group(cuda_device, name, n, variational, group):
    """The prior from its table and the likelihood from the model's data
    arrays, for every number of threads per lane and the launcher's own
    choice: bitwise the twin."""
    path, x, betas, seeds, extra, want = _bayesian_case(name, n, variational)
    before = SliceSamplerCUDA.launches["slice_sweep"]
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, max_iter=64, group=group,
                                **extra)
    assert SliceSamplerCUDA.launches["slice_sweep"] == before + 1
    for tensor_name, g, w in zip(("x", "lp", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), tensor_name


# the many-term likelihoods at their paths' batches (chip_smoke.py: the
# hierarchical cell's and mRNA's 8,192 lanes, the logistic regression's
# 10,240, centred eight schools' 640), at the smaller paths' 640, and under a
# variational reference with active 0 and 1
MANY_TERM_CASES = [("hierarchical_normal", 640, None), ("hierarchical_normal", 8192, None),
                   ("hierarchical_normal", 8192, 0.0), ("hierarchical_normal", 8192, 1.0),
                   ("logistic_regression", 640, None), ("logistic_regression", 8192, None),
                   ("logistic_regression", 10240, None), ("logistic_regression", 10240, 0.0),
                   ("logistic_regression", 10240, 1.0), ("mrna", 8192, None), ("mrna", 8192, 1.0),
                   ("eight_schools_centered", 640, None), ("eight_schools_centered", 640, 1.0)]


@functools.lru_cache(maxsize=None)
def _many_term_case(name, n, active):
    device = torch.device("cuda")
    model = BAYESIAN[name]().to(device)
    path = model.create_path(model.default_reference())
    x = model.initialization(rng.keys_for(rng.key(6, device), torch.arange(n, device=device)))
    x = x.contiguous()
    x[1, -1], x[2, -1], x[3, 0] = 95.0, -95.0, float("nan")
    _, betas, seeds = _lane_inputs(n, model.dim, 4, device)
    extra = {}
    if active is not None:
        path = T.VariationalPath(path, T.GaussianReference())
        extra = _reference(model.dim, n, active, device)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1, max_iter=64, **extra)
    return path, x, betas, seeds, extra, want


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 8, 16, 32])
@pytest.mark.parametrize("name,n,active", MANY_TERM_CASES)
def test_many_term_kernel_matches_twin_at_the_paths_batches(cuda_device, name, n, active, group):
    """The shared reduction and the cached terms of the hierarchical normal,
    the logistic regression, mRNA and centred eight schools, for the
    launcher's choice and every group it can pick: bitwise the twin."""
    path, x, betas, seeds, extra, want = _many_term_case(name, n, active)
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, max_iter=64, group=group,
                                **extra)
    for tensor_name, g, w in zip(("x", "lp", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), tensor_name


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 32])
def test_bayesian_kernel_reads_arrays_larger_than_shared_memory(cuda_device, group):
    """A design matrix of 60,000 floats (240 KB; a block may use 227 KB of
    shared memory): the kernel reads the data where it lies, whatever its
    size, and gives the twin's bits. What must fit is a block's term buffers,
    6,000 floats for each of its 128 / group lanes: with groups of 8 or 16
    they do not, and the launcher says so."""
    model = T.logistic_regression(n=6000, d=10, seed=2).to(cuda_device)
    path = model.create_path(model.default_reference())
    assert path.device_density().arrays[0].numel() * 4 > 227 * 1024
    lanes = torch.arange(4, device=cuda_device)
    x = model.initialization(rng.keys_for(rng.key(7, cuda_device), lanes)).contiguous()
    _, betas, seeds = _lane_inputs(4, model.dim, 3, cuda_device)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1, max_iter=64)
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, max_iter=64, group=group)
    for tensor_name, g, w in zip(("x", "lp", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), tensor_name
    with pytest.raises(RuntimeError, match="does not take"):
        cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, max_iter=64, group=8)


@functools.lru_cache(maxsize=None)
def _config2b_kernel_case():
    """Four lanes of bench config 2b's target (4,096 observations, d = 257)
    and the twin's sweep of them: a lane's term buffers are 2 n + 16 floats,
    32 KB."""
    device = torch.device("cuda")
    model = T.logistic_regression(4096, 256).to(device)
    path = model.create_path(model.default_reference())
    x = model.initialization(rng.keys_for(rng.key(8, device), torch.arange(4, device=device)))
    _, betas, seeds = _lane_inputs(4, model.dim, 5, device)
    want = cuda_slice.sweep_reference(x.contiguous(), betas, seeds, path, n_passes=1, max_iter=64)
    return path, x.contiguous(), betas, seeds, want


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
def test_bayesian_kernel_at_config_2b_fits_or_refuses(cuda_device, group):
    """K2 on config 2b's target: with one thread per lane, or groups of 32
    (four lanes to a block, 135 KB) and the launcher's choice, bitwise the
    twin (the column form, whatever the runtime's); groups of 8 or 16 would
    need 541 KB or 271 KB of shared memory, and the launcher refuses them
    without a launch."""
    path, x, betas, seeds, want = _config2b_kernel_case()
    before = SliceSamplerCUDA.launches["slice_sweep"]
    if group in (8, 16):
        with pytest.raises(RuntimeError, match="does not take.*227 KB of shared memory"):
            cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, max_iter=64, group=group)
        assert SliceSamplerCUDA.launches["slice_sweep"] == before
        return
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, max_iter=64, group=group)
    for tensor_name, g, w in zip(("x", "lp", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), tensor_name


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("active", [0.0, 1.0])
@pytest.mark.parametrize("name", ["funnel", "banana", "mvn", "toy"])
def test_general_kernel_under_a_variational_reference(cuda_device, name, active, group):
    """K2 with ``isvar``, ``mean``, ``std`` and ``active`` as device arrays:
    bitwise the twin; before activation bitwise the fixed path's launch."""
    d, n = 10, 3072
    fixed = toy_mvn_path(d) if name == "toy" else _k2_full_case(name, d, n)[0]
    path = T.VariationalPath(fixed, T.GaussianReference())
    x, betas, seeds = _lane_inputs(n, d, d, cuda_device)
    extra = _reference(d, n, active, cuda_device)
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, group=group, **extra)
    if active:
        want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1, **extra)
    else:
        want = cuda_slice.sweep_cuda(x, betas, seeds, fixed, n_passes=1, group=group)
    for tensor_name, g, w in zip(("x", "lp", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), tensor_name


def _two_leg_funnel_row(n, device):
    """``chip_smoke.py`` phase 2e's inputs at ``n`` lanes: the funnel d = 10,
    each ladder's 2 x 6 chains (768 lanes: 64 ladders; 6,144: 12 + 12 chains
    x 256 ladders, bench config 3's width with an equal variational leg), its
    first half variational, a reference whose mean and std differ by
    coordinate, active."""
    d, half = 10, 6 if n == 768 else 12
    fixed = _k2_full_case("funnel", d, n)[0]
    path = T.VariationalPath(fixed, T.GaussianReference())
    rs = np.random.RandomState(4)
    extra = {"isvar": ((torch.arange(n, device=device) % (2 * half)) < half).float(),
             "ref_params": {"mean": torch.tensor((rs.normal(size=d) * 0.3).astype(np.float32),
                                                 device=device),
                            "std": torch.tensor((2.0 * np.exp(rs.normal(size=d) * 0.3))
                                                .astype(np.float32), device=device),
                            "active": torch.tensor(1.0, device=device)}}
    return path, _lane_inputs(n, d, 11, device), extra


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("n", [768, 6144])
def test_k2_variational_row_matches_twin_on_card(cuda_device, n, group):
    """K2 under a variational reference at the two-leg funnel's 768 lanes and
    at 6,144: 0 differing bits against the twin at every group and the
    launcher's choice (the lane keeps its reference's and the funnel's terms
    from query to query; the twin recomputes them)."""
    path, (x, betas, seeds), extra = _two_leg_funnel_row(n, cuda_device)
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, group=group, **extra)
    for tensor_name, g, w in zip(("x", "lp", "stats"), got, _row_twin(n), strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), tensor_name


@functools.lru_cache(maxsize=None)
def _row_twin(n):
    """The twin's sweep of a row's inputs, once for all group sizes."""
    path, (x, betas, seeds), extra = _two_leg_funnel_row(n, torch.device("cuda"))
    return cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5120, 20480])
def test_k1_variational_row_matches_twin_on_card(cuda_device, n):
    """K1's variational term at config 4's 5,120 lanes and config 1's width:
    ``chip_smoke.py`` phase 2c's inputs (each ladder's first 10 lanes
    variational, the reference active), 0 differing bits against the twin."""
    d = 100
    rs0 = np.random.RandomState(0)
    x = torch.tensor((rs0.normal(size=(n, d)) * 0.5).astype(np.float32), device=cuda_device)
    betas = torch.tensor(rs0.uniform(0.0, 1.0, n).astype(np.float32), device=cuda_device)
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(13, cuda_device),
                                               torch.arange(n, device=cuda_device)))
    path = toy_mvn_path(d)
    rs = np.random.RandomState(4)
    term = cuda_slice.VariationalTerm(
        betas, ((torch.arange(n, device=cuda_device) % 20) < 10).float(),
        torch.tensor([1.0], device=cuda_device), float(path.coord_factor(torch.ones(()))),
        torch.tensor((rs.normal(size=d) * 0.05).astype(np.float32), device=cuda_device),
        torch.tensor((np.sqrt(0.1) * np.exp(rs.normal(size=d) * 0.2)).astype(np.float32),
                     device=cuda_device))
    a = path.coord_factor(betas)
    got = cuda_slice.banded_sweep(x, a, seeds, n_passes=3, variational=term)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=3, variational=term)
    for tensor_name, g, w in zip(("x", "stats"), got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), tensor_name


@pytest.mark.cuda
def test_general_kernel_rejects_bad_arrays(cuda_device):
    model = T.hierarchical_normal().to(cuda_device)
    path = model.create_path(model.default_reference())
    x, betas, seeds = _lane_inputs(4, 23, 0, cuda_device)
    density = path.device_density()
    short = path.__class__(path.ref_log_density, path.target_log_density, path.sample_reference,
                           device=density._replace(arrays=(density.arrays[0][:-1].contiguous(),)))
    with pytest.raises(RuntimeError, match="does not take"):
        cuda_slice.sweep_cuda(x, betas, seeds, short)
    on_cpu = path.__class__(path.ref_log_density, path.target_log_density, path.sample_reference,
                            device=density._replace(arrays=(density.arrays[0].cpu(),)))
    with pytest.raises(ValueError, match="density array"):
        cuda_slice.sweep_cuda(x, betas, seeds, on_cpu)
    vpath = T.VariationalPath(path, T.GaussianReference())
    extra = _reference(23, 4, 1.0, cuda_device)
    extra["ref_params"]["std"] = extra["ref_params"]["std"].double()
    with pytest.raises(ValueError, match="std"):
        cuda_slice.sweep_cuda(x, betas, seeds, vpath, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BAYESIAN))
def test_bayesian_card_run_matches_cpu_run(cuda_device, name):
    g, c = (T.pigeons(target=BAYESIAN[name](), n_chains=5, n_replicates=4, seed=4, n_rounds=3,
                      explorer=T.SliceSamplerCUDA(n_passes=1), device=dev, show_report=False)
            for dev in ("cuda", "cpu"))
    assert torch.equal(g.chain_of.cpu(), c.chain_of)
    assert torch.equal(g.states.cpu(), c.states)
    assert g.reports[-1].log_z_estimate == c.reports[-1].log_z_estimate


@pytest.mark.cuda
def test_variational_funnel_card_run_matches_cpu_run(cuda_device):
    """Two legs on a path that is not separable: K2 under the reference fitted
    after round 2."""
    g, c = (T.pigeons(target=T.funnel(3), n_chains=4, n_chains_variational=4, n_replicates=4,
                      seed=4, n_rounds=4, variational=T.GaussianReference(first_tuning_round=2),
                      explorer=T.SliceSamplerCUDA(n_passes=1), device=dev, show_report=False)
            for dev in ("cuda", "cpu"))
    assert float(g._ref_params["active"]) == 1.0
    assert torch.equal(g.chain_of.cpu(), c.chain_of)
    assert torch.equal(g.states.cpu(), c.states)


@pytest.mark.cuda
def test_extractor_closing_over_a_card_tensor(cuda_device):
    """``PT`` probes the extractor's width on the run's device (the JAX
    package: ``jax.eval_shape``), so an extractor may close over a tensor on
    the card; the same run on the CPU with the weights there gives the same
    samples (the log density within 1e-6: ``torch.sum`` adds in another order
    on the card)."""
    def run(device):
        w = torch.tensor([2.0, -1.0], device=device)
        return T.pigeons(target=T.toy_mvn_target(3), n_chains=4, n_rounds=3, seed=1,
                         extractor=lambda x, lp: torch.cat([x[..., :2] * w, lp[..., None]], -1),
                         explorer=T.SliceSamplerCUDA(), device=device, show_report=False)

    g, c = run("cuda"), run("cpu")
    assert g.sample_array().shape == c.sample_array().shape == (8, 3)
    np.testing.assert_array_equal(g.sample_array()[:, :2], c.sample_array()[:, :2])
    np.testing.assert_allclose(g.sample_array()[:, 2], c.sample_array()[:, 2], rtol=1e-6)


# ---------------------------------------------------------------------------
# the gradient path (torch ops, no kernel): card against CPU


def _gradient_paths(name, device):
    """The port's path ``name`` with its data on ``device`` and the
    ``ref_params`` it reads (``None`` but under a variational reference)."""
    if name == "toy_mvn":
        return T.toy_mvn_target(4).create_path(None), None
    if name == "funnel_variational":
        fixed = T.funnel(4).create_path(T.funnel(4).default_reference())
        ref = {"mean": torch.full((5,), 0.3, device=device),
               "std": torch.linspace(0.5, 2.0, 5, device=device),
               "active": torch.tensor(1.0, device=device)}
        return T.VariationalPath(fixed, T.GaussianReference()), ref
    target = {"funnel": T.funnel(4), "banana": T.banana(4), "mvn": T.mvn_target(5),
              "logistic_regression": T.logistic_regression(),
              "hierarchical_normal": T.hierarchical_normal(), "eight_schools": T.eight_schools(),
              "unid_target": T.unid_target()}[name].to(device)
    return target.create_path(target.default_reference()), None


GRADIENT_PATHS = ["toy_mvn", "funnel", "banana", "mvn", "logistic_regression",
                  "hierarchical_normal", "eight_schools", "unid_target", "funnel_variational"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRADIENT_PATHS)
def test_value_and_grad_card_matches_cpu(cuda_device, name):
    """Values within 1e-6 relative, gradients within 1e-5 of the lane's
    largest |g| (the tolerances of the CPU tests against JAX), the same
    non-finite lanes."""
    from pigeons_tpu_torch import paths

    out = {}
    for dev in ("cpu", cuda_device):
        path, ref = _gradient_paths(name, dev)
        d = 4 if name == "toy_mvn" else (5 if name == "funnel_variational" else None)
        d = d or path.target_log_density.__self__.dim
        rs = np.random.RandomState(3)
        x = torch.tensor((rs.normal(size=(1024, d)) * 1.5).astype(np.float32), device=dev)
        x[:4] *= 30.0
        beta = torch.tensor(rs.uniform(size=1024).astype(np.float32), device=dev)
        isvar = (torch.arange(1024, device=dev) % 2).to(torch.float32)
        out[str(dev)] = [t.cpu().numpy() for t in paths.value_and_grad(path, x, beta, isvar, ref)]
    (cl, cg), (gl, gg) = out["cpu"], out[str(cuda_device)]
    fin = np.isfinite(cl) & np.isfinite(cg).all(1)
    assert np.array_equal(fin, np.isfinite(gl) & np.isfinite(gg).all(1))
    np.testing.assert_allclose(gl[fin], cl[fin], rtol=1e-6)
    scale = np.maximum(np.abs(cg).max(1), np.finfo(np.float32).tiny)[fin]
    assert (np.abs(gg - cg).max(1)[fin] / scale).max() <= 1e-5


def _logistic_float64(model, x):
    """The logistic regression's log posterior (``N(0, 2^2)`` priors) and its
    gradient in float64 numpy at states ``x [L, d + 1]``."""
    like = model.log_likelihood_fn
    X, y = like.X.double().cpu().numpy(), like.y.double().cpu().numpy()
    theta = x.double().cpu().numpy()
    z = theta[:, :-1] @ X.T + theta[:, -1:]
    resid = y - 0.5 * (1.0 + np.tanh(0.5 * z))
    lp = np.sum(y * z - np.logaddexp(0.0, z), 1) + np.sum(
        -0.5 * (np.log(2.0 * np.pi) + (theta / 2.0) ** 2) - np.log(2.0), 1)
    grad = np.concatenate([resid @ X, resid.sum(1, keepdims=True)], 1) - theta / 4.0
    return lp, grad


@pytest.mark.cuda
def test_logistic_dense_form_on_card_matches_float64(cuda_device):
    """Config 2b's shape: the dense form's density and gradient on the card
    (one float32 cuBLAS product each way, no TF32) at 256 states within 1e-5
    relative and 1e-4 of the lane's largest gradient component of float64
    numpy, as ``chip_smoke.py`` holds it."""
    from pigeons_tpu_torch import paths

    assert not torch.backends.cuda.matmul.allow_tf32
    model = T.logistic_regression(4096, 256).to(cuda_device)
    assert model.log_likelihood_fn.uses_dense
    rs = np.random.RandomState(0)
    x = torch.tensor((rs.normal(size=(256, model.dim)) * 0.3).astype(np.float32),
                     device=cuda_device)
    lp, grad = paths.value_and_grad(model.create_path(model.default_reference()), x,
                                    torch.ones(256, device=cuda_device))
    want_lp, want_grad = _logistic_float64(model, x)
    np.testing.assert_allclose(lp.double().cpu().numpy(), want_lp, rtol=1e-5)
    scale = np.abs(want_grad).max(1)
    assert (np.abs(grad.double().cpu().numpy() - want_grad).max(1) / scale).max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1025])
def test_logistic_forms_boundary_on_card(cuda_device, n):
    """The last shape of the column form and the first of the dense one, card
    against CPU: the column form (emulated float32 steps) with the CPU's
    bits, the dense form within 1e-6 relative; gradients within 1e-5 of the
    lane's largest component."""
    from pigeons_tpu_torch import paths

    out = {}
    for dev in ("cpu", cuda_device):
        model = T.logistic_regression(n, 10).to(dev)
        assert model.log_likelihood_fn.uses_dense is (n > 1024)
        rs = np.random.RandomState(n)
        x = torch.tensor((rs.normal(size=(512, model.dim)) * 0.5).astype(np.float32), device=dev)
        beta = torch.tensor(rs.uniform(size=512).astype(np.float32), device=dev)
        out[str(dev)] = [t.cpu().numpy() for t in
                         paths.value_and_grad(model.create_path(model.default_reference()), x,
                                              beta)]
    (cl, cg), (gl, gg) = out["cpu"], out[str(cuda_device)]
    if n <= 1024:
        assert np.array_equal(gl.view(np.int32), cl.view(np.int32))
    np.testing.assert_allclose(gl, cl, rtol=1e-6)
    assert (np.abs(gg - cg).max(1) / np.abs(cg).max(1)).max() <= 1e-5


def _config2a_lanes(device, n=640, seed=0):
    """640 lanes of config 2a's target: states, betas, keys and chain params."""
    target = T.logistic_regression().to(device)
    rs = np.random.RandomState(seed)
    d = target.dim
    x = torch.tensor((rs.normal(size=(n, d)) * 0.5).astype(np.float32), device=device)
    beta = torch.tensor(rs.uniform(size=n).astype(np.float32), device=device)
    params = {"step_size": torch.tensor((0.3 * np.exp(rs.normal(size=n))).astype(np.float32),
                                        device=device),
              "std_devs": torch.tensor(np.abs(rs.normal(size=(n, d)) * 0.3 + 0.5).astype(np.float32),
                                       device=device)}
    keys = rng.keys_for(rng.key(seed + 1, device), torch.arange(n, device=device))
    return target.create_path(target.default_reference()), keys, x, beta, params


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["MALA", "AutoMALA"])
def test_gradient_explore_card_matches_cpu(cuda_device, name):
    """One explore of 640 lanes from the same inputs: lanes whose step-size
    factors, evaluation counts and accept pattern agree are within 1e-4 in
    state; at most 1 % of the lanes differ."""
    explorer = T.MALA(step_size=0.3) if name == "MALA" else T.AutoMALA()
    outs = []
    for dev in ("cpu", cuda_device):
        path, keys, x, beta, params = _config2a_lanes(dev)
        outs.append((explorer.step_batched(keys, x, beta, path, chain_params=params,
                                           scan_idx=2), x.cpu()))
    (c, x0), (g, _) = outs
    agree = (g.n_steps.cpu() == c.n_steps) & ((g.x.cpu() != x0).any(1) == (c.x != x0).any(1))
    if g.extras_sum is not None:
        agree &= (g.extras_sum.cpu() == c.extras_sum).all(1)
    print(f"{name}: {int((~agree).sum())} of {len(agree)} lanes differ card against CPU")
    assert (~agree).sum() <= 0.01 * len(agree)
    assert float((g.x.cpu() - c.x)[agree].abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["NUTS", "AAPS"])
def test_nuts_aaps_step_card_matches_cpu(cuda_device, name):
    """One NUTS and one AAPS step of 640 lanes of config 2a's target from the
    same inputs: lanes whose leapfrog count, depth (NUTS) and move agree are
    within 1e-4 in state; at most 1 % of the lanes differ."""
    explorer = T.NUTS(step_size=0.3) if name == "NUTS" else T.AAPS(step_size=0.2)
    outs = []
    for dev in ("cpu", cuda_device):
        path, keys, x, beta, params = _config2a_lanes(dev, seed=6)
        outs.append((explorer.step_batched(keys, x, beta, path, chain_params=params,
                                           scan_idx=2), x.cpu()))
    (c, x0), (g, _) = outs
    agree = (g.n_steps.cpu() == c.n_steps) & ((g.x.cpu() != x0).any(1) == (c.x != x0).any(1))
    if g.extras_sum is not None:
        agree &= g.extras_sum[:, 1].cpu() == c.extras_sum[:, 1]
    print(f"{name}: {int((~agree).sum())} of {len(agree)} lanes differ card against CPU, "
          f"{float(c.n_steps.mean()):.2f} leapfrogs a lane")
    assert (~agree).sum() <= 0.01 * len(agree)
    assert float((g.x.cpu() - c.x)[agree].abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(window=3), dict(queued=True, queue_width=64),
                                dict(queued=True, queue_width=128, window=2, queue_tail_width=-1)])
def test_automala_search_variants_bitwise_on_card(cuda_device, kw):
    path, keys, x, beta, params = _config2a_lanes(cuda_device, seed=4)
    params["step_size"][::5] *= 64.0
    a = T.AutoMALA(base_n_refresh=1).step_batched(keys, x, beta, path, chain_params=params,
                                                  scan_idx=2)
    b = T.AutoMALA(base_n_refresh=1, **kw).step_batched(keys, x, beta, path,
                                                        chain_params=params, scan_idx=2)
    for f in ("x", "lp", "accept_sum", "accept_n", "extras_sum", "extras_n"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
def test_config2a_card_run_passes_the_gates(cuda_device):
    """Config 2a at 640 lanes (10 chains x 64 ladders), the rounds of
    ``chip_smoke.py``'s phase (a 32-scan round: a tempered restart takes
    more scans than a chain count) and its gates."""
    target = T.logistic_regression()
    pt = T.PT(T.Inputs(target=target, n_chains=10, n_replicates=64, seed=1,
                       explorer=T.AutoMALA(), show_report=False, device="cuda"))
    for n_scans in (4, 4, 4, 4, 32):
        pt.run_round(n_scans=n_scans)
    w_true = rng.normal(rng.fold_in(rng.key(0), 1), (10,)).numpy()
    w = target.constrained_samples(pt)["w"].mean(0)
    assert np.abs(w - w_true).max() < 1.0
    assert np.isfinite(pt.reports[-1].log_z_estimate) and pt.n_tempered_restarts > 0
    assert np.nanmean(pt.reduced.exp_accept) > 0.4
    assert (pt.reduced.extra_n[:, 1] > 0).all()


CARD_RESUMES = {
    "toy_mvn": dict(target=T.toy_mvn_target(6), n_chains=5, n_replicates=8,
                    explorer=T.SliceSamplerCUDA()),
    "two_legs": dict(target=T.toy_mvn_target(6), n_chains=4, n_chains_variational=4,
                     n_replicates=8, variational=T.GaussianReference(first_tuning_round=2),
                     explorer=T.SliceSamplerCUDA()),
    "funnel": dict(target=T.funnel(3), n_chains=5, n_replicates=8,
                   explorer=T.SliceSamplerCUDA(n_passes=1)),
    "automala": dict(target=T.logistic_regression(), n_chains=4, n_replicates=8,
                     explorer=T.AutoMALA()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_RESUMES))
def test_resume_on_card_is_bitwise(cuda_device, tmp_path, name):
    """Stopped after round 2 and resumed with ``pigeons(folder)``: the
    uninterrupted run bit for bit, the reference's fit and AutoMALA's
    adapted state included."""
    kw = dict(CARD_RESUMES[name], seed=4, show_report=False, device="cuda")
    full = T.PT(T.Inputs(n_rounds=4, **kw)).run()
    folder = str(tmp_path / "run")
    T.PT(T.Inputs(n_rounds=2, checkpoint=True, checkpoint_folder=folder, **kw)).run()
    T.increment_n_rounds(folder, 2)
    resumed = T.pigeons(folder)
    assert resumed.device.type == "cuda" and resumed.round_idx == 4
    assert torch.equal(full.states, resumed.states)
    assert torch.equal(full.chain_of, resumed.chain_of)
    assert np.array_equal(full.sample_array(), resumed.sample_array())
    assert full.reports[-1].log_z_estimate == resumed.reports[-1].log_z_estimate
    for k, v in (full._ref_params or {}).items():
        assert torch.equal(v, resumed._ref_params[k]), k
    for k, v in (full.exp_state or {}).items():
        assert torch.equal(v, resumed.exp_state[k]), k


@pytest.mark.cuda
def test_card_checkpoint_resumes_on_cpu(cuda_device, tmp_path):
    kw = dict(target=T.toy_mvn_target(6), n_chains=5, n_replicates=8, seed=4, n_rounds=4,
              explorer=T.SliceSamplerCUDA(), show_report=False, device="cuda")
    g = T.PT(T.Inputs(**kw)).run()
    part = T.PT(T.Inputs(checkpoint=True, checkpoint_folder=str(tmp_path / "run"), **kw))
    part.run_round()
    part.run_round()
    c = T.load_pt(part.exec_folder, device="cpu").run()
    assert c.device.type == "cpu"
    assert torch.equal(g.chain_of.cpu(), c.chain_of)
    assert g.n_tempered_restarts == c.n_tempered_restarts
    assert float((g.states.cpu() - c.states).abs().max()) <= 1e-6


class _Drift(T.ops.base.Explorer):
    """Deterministic drift: not invariant."""

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None):
        z = torch.zeros(xs.shape[0], device=xs.device)
        return T.ops.base.StepOut(xs + 0.2, None, z, z, z)


class _WrongReference(T.ops.base.Explorer):
    """The blend with the reference's std 1.5 times too large: a variational
    term computed wrong."""

    def __init__(self, inner):
        self.inner = inner

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, **kw):
        wrong = dict(ref_params, std=ref_params["std"] * 1.5)
        return self.inner.step_batched(keys, xs, betas, path, isvar=isvar, ref_params=wrong,
                                       **kw)


# a reference far from the target, at beta = 0.3 where it weighs 0.7 in the
# blend (at beta = 1 it weighs nothing)
_BLEND = dict(beta=0.3, variational=T.GaussianReference(),
              ref_params={"mean": torch.linspace(-1.0, 1.0, 100),
                          "std": torch.linspace(0.5, 1.5, 100), "active": torch.tensor(1.0)})
CARD_INVARIANCE = {
    "k1_toy_term": (T.toy_mvn_target(100), T.SliceSamplerCUDA(), {}, "banded_slice_sweep"),
    "k1_variational_term": (T.toy_mvn_target(100), T.SliceSamplerCUDA(), _BLEND,
                            "banded_slice_sweep_variational"),
    "k2_full_funnel": (T.funnel(9), T.SliceSamplerCUDA(n_passes=1), {}, "slice_sweep"),
    "k2_full_variational_toy_mvn": (T.toy_mvn_target(100),
                                    T.SliceSamplerCUDA(parallel_coords=False), _BLEND,
                                    "slice_sweep"),
    "k2_delta_toy_mvn": (T.toy_mvn_target(100), T.SliceSamplerCUDA(parallel_coords=False), {},
                         "slice_sweep"),
    "mala": (T.toy_mvn_target(100),
             T.MALA(step_size=0.1, preconditioner=T.IdentityPreconditioner()), {}, None),
    "automala": (T.toy_mvn_target(100), T.AutoMALA(), {}, None),
    "broken_control": (T.toy_mvn_target(100), _Drift(), {}, None),
    "wrong_reference_control": (T.toy_mvn_target(100), _WrongReference(T.SliceSamplerCUDA()),
                                _BLEND, "banded_slice_sweep_variational"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_INVARIANCE))
def test_invariance_on_card(cuda_device, name):
    """The exact invariance test at N = 10,000: each kernel mode launched
    once; the two controls must fail."""
    target, explorer, kw, kernel = CARD_INVARIANCE[name]
    SliceSamplerCUDA.reset_launches()
    res = T.invariance_test(target, explorer, n_iid_samples=10_000, device="cuda", **kw)
    assert SliceSamplerCUDA.launches == {k: int(k == kernel) for k in SliceSamplerCUDA.launches}
    assert res.passed == (not name.endswith("_control")), (res.failed_dims, res.pvalues.min())


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("draw", ["gamma 0.3", "gamma 4", "beta 1 1", "beta 3 9", "poisson 5",
                                  "poisson 40"])
def test_jax_random_draws_on_card_match_cpu(cuda_device, draw, fused):
    """``rng.gamma``, ``rng.beta`` and ``rng.poisson`` (JAX's streams,
    ``tests/test_torch_rng.py``) give the CPU's bits on the card, both forms."""
    kind, *params = draw.split()
    fn = {"gamma": rng.gamma, "beta": rng.beta, "poisson": rng.poisson}[kind]
    params = [float(p) for p in params]
    keys = rng.keys_for(rng.key(7), torch.arange(4096))
    want = fn(keys, *params, fused=fused)
    got = fn(keys.to(cuda_device), *params, fused=fused).cpu()
    assert torch.equal(got.view(torch.int32) if got.is_floating_point() else got,
                       want.view(torch.int32) if want.is_floating_point() else want)
