"""The port's CUDA sources, compiled for the host and run against their twins.

``g++`` builds ``pigeons_tpu_torch/csrc/*.cu`` against the stand-in runtime of
``tests/cuda_stub/cuda_runtime.h`` (a block's threads are host threads, the
warp primitives are rendezvous, ``__fmaf_rn`` is ``fmaf``) with
``-ffp-contract=off``, and the tests call the libraries' C entry points, the
ones the wrappers of ``ops/cuda_slice.py`` call on the card, on CPU tensors.
This exercises what the torch twins cannot: the mapping of work to threads.
Kernel K1's warps refill finished lanes from a cursor in shared memory; kernel
K2 runs full mode with 1, 8, 16 or 32 threads per lane and delta mode with one.

Tolerance: everything bitwise (states, returned densities, stats), as on the
card: the sources' arithmetic is the twins'. A kernel whose threads disagree
about a mask deadlocks here as it would on the card, so every call runs in a
child process under a time limit. Skipped only where ``g++`` is missing.
"""

import multiprocessing
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T
from pigeons_tpu_torch import rng
from pigeons_tpu_torch.ops import cuda_slice
from pigeons_tpu_torch.paths import toy_mvn_path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pigeons_tpu_torch" / "csrc"
STUB = ROOT / "tests" / "cuda_stub"
CALL_TIMEOUT_S = 120
SAMPLER = (10.0, 20)  # w, p: the explorer's defaults
MAX_ITER = 1024

sys.path.insert(0, str(STUB))
import host_call  # noqa: E402  (tests/cuda_stub/host_call.py: the children's side)


@pytest.fixture(scope="module")
def host_libraries(tmp_path_factory):
    """Paths of the two sources' host builds."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("csrc_host")
    paths = {}
    for name in ("banded_slice", "sweep_slice"):
        paths[name] = out / f"{name}.so"
        subprocess.run(
            [gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-pthread", "-shared",
             "-fPIC", "-I", str(STUB), "-o", str(paths[name]),
             str(CSRC / f"{name}.cu")],
            check=True, capture_output=True, text=True, timeout=300)
    return paths


def _inputs(B, d, seed, scale=1.5):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy((rs.normal(size=(B, d)) * scale).astype(np.float32))
    betas = torch.from_numpy(rs.uniform(0.0, 1.0, B).astype(np.float32))
    betas[0], betas[-1] = 0.0, 1.0
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(seed + 7), torch.arange(B)))
    return x, betas, seeds


def _in_child(fn, *args):
    """``fn(*args, queue)`` in a child process under the time limit, tensors
    handed over as numpy arrays; what it put on the queue, as tensors."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    args = [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]
    child = ctx.Process(target=fn, args=(*args, out))
    child.start()
    try:
        err, *arrays = out.get(timeout=CALL_TIMEOUT_S)
    finally:
        child.join(timeout=10)
        if child.is_alive():
            child.kill()
            child.join()
    assert err == 0, f"the launcher returned {err}"
    return [torch.from_numpy(a) for a in arrays]


def _assert_bitwise(got, want, names):
    for name, g, w in zip(names, got, want, strict=True):
        n_diff = int((g.view(torch.int32) != w.view(torch.int32)).sum())
        assert n_diff == 0, f"{name}: {n_diff} of {w.numel()} elements differ in their bits"


# B * d: below a warp; tiles that end inside a lane; more than one tile a
# block (the stand-in device keeps 4 blocks resident); d = 1
@pytest.mark.parametrize("B,d,n_passes", [(1, 5, 3), (3, 7, 0), (37, 13, 1), (700, 13, 3),
                                          (300, 1, 2), (40, 100, 3)])
def test_k1_host_build_matches_twin(host_libraries, B, d, n_passes):
    x, betas, seeds = _inputs(B, d, n_passes)
    a = toy_mvn_path(d).coord_factor(betas)
    got = _in_child(host_call.banded_slice_sweep, host_libraries["banded_slice"], x, a, seeds,
                    *SAMPLER, n_passes, MAX_ITER)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes)
    _assert_bitwise(got, want, ("x", "stats"))
    assert (n_passes == 0) == torch.equal(got[0], x)


def _k2(lib_path, x, betas, seeds, path, coord_deltas, n_passes, group):
    density = path.device_density()
    return _in_child(host_call.slice_sweep, lib_path, x, betas, seeds, density.kind,
                     density.params, coord_deltas, *SAMPLER, n_passes, MAX_ITER, group)


def _full_path(name, d):
    if name == "toy":
        return toy_mvn_path(d)
    target = {"funnel": lambda: T.funnel(d - 1), "banana": lambda: T.banana(d - 1, 1.5),
              "mvn": lambda: T.mvn_target(d, 2.5)}[name]()
    return target.create_path(target.default_reference())


# d below, at and above the group's size, d = 1, a last block that is not
# full, no pass at all
@pytest.mark.parametrize("group", [1, 8, 16, 32])
@pytest.mark.parametrize("name,B,d,n_passes", [("funnel", 9, 10, 1), ("funnel", 5, 1, 1),
                                               ("banana", 7, 4, 2), ("mvn", 3, 40, 1),
                                               ("toy", 6, 17, 1), ("funnel", 4, 3, 0)])
def test_k2_full_host_build_matches_twin(host_libraries, name, B, d, n_passes, group):
    path = _full_path(name, d)
    x, betas, seeds = _inputs(B, d, d + n_passes)
    if name == "funnel" and B > 5:
        x[3, 0], x[4, 0], x[5, d - 1] = 95.0, -95.0, float("nan")
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, n_passes, group)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=n_passes)
    _assert_bitwise(got, want, ("x", "lp", "stats"))


def test_k2_chooses_its_group_from_the_shape(host_libraries):
    """group = 0, as the wrapper calls it."""
    path = _full_path("funnel", 10)
    x, betas, seeds = _inputs(33, 10, 5)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, 0)
    _assert_bitwise(got, cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1),
                    ("x", "lp", "stats"))


@pytest.mark.parametrize("B,d,n_passes", [(8, 4, 2), (5, 1, 1), (130, 6, 1), (3, 100, 0)])
def test_k2_delta_host_build_matches_twin(host_libraries, B, d, n_passes):
    path = toy_mvn_path(d)
    x, betas, seeds = _inputs(B, d, B)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, True, n_passes, 0)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, True, n_passes=n_passes)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
