"""User densities as CUDA source on an NVIDIA card: each example's library
built with ``nvcc`` at first use, its kernel held bit for bit to its twin,
runs through ``PT`` launching the user kernel once a scan, and a source that
does not compile raising with ``nvcc``'s output. Every test here is marked
``cuda`` and skips without a CUDA device; the file imports no JAX:

    python -m pytest tests/test_torch_user_cuda.py -m cuda --noconftest
"""

import functools

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch import _build, rng
from pigeons_tpu_torch.device_source import DeviceSource
from pigeons_tpu_torch.models import source_examples as SE
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(B, d, seed, dev, scale=1.0):
    rs = np.random.RandomState(seed)
    x = torch.tensor((rs.normal(size=(B, d)) * scale).astype(np.float32), device=dev)
    betas = torch.tensor(rs.uniform(size=B).astype(np.float32), device=dev)
    betas[0], betas[-1] = 0.0, 1.0
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(seed, dev), torch.arange(B, device=dev)))
    return x, betas, seeds


def _bitwise(got, want):
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


EXAMPLES = {
    "model_u": lambda: SE.model_u(),
    "hierarchical_normal_source": lambda: SE.hierarchical_normal_source(),
    "funnel_source": lambda: SE.funnel_source(10),
    "custom_path_source": lambda: SE.custom_path_source(4),
}


@functools.lru_cache(maxsize=None)
def _user_case(name, B):
    """A source's path, inputs and twin on the card (shared by the groups)."""
    dev = torch.device("cuda")
    model = EXAMPLES[name]().to(dev)
    path = model.create_path(model.default_reference())
    x, betas, seeds = _inputs(B, model.dim, B, dev)
    return path, (x, betas, seeds), cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("B", [37, 2048])
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_user_instance_matches_twin_on_card(cuda_device, name, B, group):
    """Each source's K2 instance at the launcher's choice (through the
    explorer's wrapper, one launch counted), one thread a lane and 8, 16, 32
    slots of speculated queries, bit for bit the twin."""
    path, (x, betas, seeds), want = _user_case(name, B)
    before = SliceSamplerCUDA.launches["slice_sweep_user"]
    if group == 0:
        got = cuda_slice.sweep(x, betas, seeds, path, n_passes=1)
    else:
        got = cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, group=group)
    assert SliceSamplerCUDA.launches["slice_sweep_user"] == before + 1
    _bitwise(got, want)


@functools.lru_cache(maxsize=None)
def _variational_case(name, B):
    """A source's two-leg path (a ``GaussianReference``, two of three lanes
    on its leg, active), inputs and twin on the card, as the host builds'
    tests make them (shared by the groups)."""
    dev = torch.device("cuda")
    model = EXAMPLES[name]().to(dev)
    fixed = model.create_path(model.default_reference())
    path = T.VariationalPath(fixed, T.GaussianReference())
    x, betas, seeds = _inputs(B, model.dim, 3, dev)
    isvar = (torch.arange(B, device=dev) % 3 != 1).float()
    rs = np.random.RandomState(5)
    ref_params = {
        "mean": torch.tensor((rs.normal(size=model.dim) * 0.3).astype(np.float32), device=dev),
        "std": torch.tensor(np.exp(rs.normal(size=model.dim) * 0.5).astype(np.float32),
                            device=dev),
        "active": torch.tensor(1.0, device=dev)}
    want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1, isvar=isvar,
                                      ref_params=ref_params)
    assert not torch.equal(want[0], cuda_slice.sweep_reference(x, betas, seeds, fixed,
                                                               n_passes=1)[0])
    return path, (x, betas, seeds, isvar, ref_params), want


@pytest.mark.cuda
@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("name", ["model_u", "funnel_source"])
def test_user_instance_under_a_variational_reference_on_card(cuda_device, name, group):
    """The likelihood and target hooks on a two-leg run's 640 lanes at every
    group: each slot's copy of the state under the reference, bit for bit
    the twin."""
    path, (x, betas, seeds, isvar, ref_params), want = _variational_case(name, 640)
    _bitwise(cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, group=group, isvar=isvar,
                                   ref_params=ref_params), want)


@pytest.mark.cuda
def test_user_launcher_group_on_card(cuda_device):
    """The source's library picks slots of speculated queries at the paths'
    batches (8 at 8,192 lanes, 32 at 640) and one thread a lane where a
    block's copies of the state do not fit."""
    hier = SE.hierarchical_normal_source()
    path = hier.create_path(hier.default_reference())
    assert cuda_slice.launcher_group(path, 8192, hier.dim) == 8
    assert cuda_slice.launcher_group(path, 640, hier.dim) == 32
    assert cuda_slice.launcher_group(path, 8192, 214) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,d", [(37, 13), (20480, 100)])
def test_user_term_matches_twin_on_card(cuda_device, B, d):
    target = SE.normal_product_source(d).to(cuda_device)
    path = target.create_path(target.default_reference())
    x, betas, seeds = _inputs(B, d, d, cuda_device, 2.0)
    term = cuda_slice.UserTerm(betas, path.coord_source)
    before = SliceSamplerCUDA.launches["banded_slice_sweep_user"]
    got = cuda_slice.banded_sweep(x, betas, seeds, user=term)
    assert SliceSamplerCUDA.launches["banded_slice_sweep_user"] == before + 1
    _bitwise(got, cuda_slice.banded_sweep_reference(x, betas, seeds, user=term))


@pytest.mark.cuda
def test_runs_launch_the_user_kernels_on_card(cuda_device):
    """Model U and the coordinate source, 4 chains x 8 ladders, 3 rounds."""
    for target, kernel in ((SE.model_u(), "slice_sweep_user"),
                           (SE.normal_product_source(6), "banded_slice_sweep_user")):
        SliceSamplerCUDA.reset_launches()
        pt = T.pigeons(target=target, n_chains=4, n_replicates=8, n_rounds=3,
                       explorer=SliceSamplerCUDA(n_passes=1), show_report=False, device="cuda")
        scans = sum(r.n_scans for r in pt.reports)  # 2 + 4 + 8
        assert SliceSamplerCUDA.launches[kernel] == scans
        assert sum(SliceSamplerCUDA.launches.values()) == scans
        assert np.isfinite(pt.reports[-1].log_z_estimate)


@pytest.mark.cuda
def test_a_source_that_does_not_compile_raises_with_nvccs_output(cuda_device):
    broken = DeviceSource("__device__ float pigeons_user_target(const float* x, int d, "
                          "const float* params, const pigeons::DensityArrays& arrays) "
                          "{ return not_declared_anywhere(x[0]); }", "target", SE.funnel_terms)
    target = T.SourceTarget(broken, 3)
    path = target.create_path(target.default_reference())
    x, betas, seeds = _inputs(8, 3, 0, cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed(.|\n)*not_declared_anywhere"):
        cuda_slice.sweep_cuda(x, betas, seeds, path)
    assert not _build.user_library_path(broken).exists()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unid_target", "eight_schools", "hierarchical_normal"])
def test_library_kinds_under_a_normal_reference_on_card(cuda_device, name):
    """``params[0] = 1 / sigma`` on the library's K2 at every group: one
    thread, the speculated machine (unid, eight schools) and ManyTerms (the
    hierarchical normal), bit for bit the twin."""
    model = getattr(T, name)().to(cuda_device)
    path = model.create_path(T.StandardNormalReference(model.dim, 2.0).as_reference())
    assert path.device_density().params[0] == 0.5
    x, betas, seeds = _inputs(640, model.dim, 5, cuda_device)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1)
    for group in (0, 1, 8, 16, 32):
        _bitwise(cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1, group=group), want)
