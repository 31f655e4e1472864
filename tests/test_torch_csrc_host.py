"""The port's CUDA sources, compiled for the host and run against their twins.

``g++`` builds ``pigeons_tpu_torch/csrc/*.cu`` against the stand-in runtime of
``tests/cuda_stub/cuda_runtime.h`` (a block's threads are host threads, the
warp primitives are rendezvous, ``__fmaf_rn`` is ``fmaf``) with
``-ffp-contract=off``, and the tests call the libraries' C entry points, the
ones the wrappers of ``ops/cuda_slice.py`` call on the card, on CPU tensors.
This exercises what the torch twins cannot: the mapping of work to threads.
Kernel K1's warps refill finished lanes from a cursor in shared memory; kernel
K2 runs full mode with 1, 8, 16 or 32 threads per lane and delta mode with one.
A child that calls K2 imports numpy and ctypes only (``host_call``), and a
case's twin is computed once for all its groups.

Tolerance: everything bitwise (states, returned densities, stats), as on the
card: the sources' arithmetic is the twins'. A kernel whose threads disagree
about a mask deadlocks here as it would on the card, so every call runs in a
child process under a time limit. Skipped only where ``g++`` is missing.
"""

import functools
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


def _in_child(fn, *args, err_wanted=0):
    """``fn(*args, queue)`` in a child process under the time limit, tensors
    handed over as numpy arrays; what it put on the queue, as tensors, once
    the launcher returned ``err_wanted``."""
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
    assert err == err_wanted, f"the launcher returned {err}"
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
                    *SAMPLER, n_passes, MAX_ITER, None)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes)
    _assert_bitwise(got, want, ("x", "stats"))
    assert (n_passes == 0) == torch.equal(got[0], x)


def _variational_term(betas, d, seed, active):
    """Lanes of both legs in turn, a mean and std for every coordinate, one of
    them the smallest std a fit can give (the square root of its 1e-12 floor)."""
    rs = np.random.RandomState(seed)
    isvar = torch.from_numpy((np.arange(len(betas)) % 3 != 1).astype(np.float32))
    mean = torch.from_numpy((rs.normal(size=d) * 0.3).astype(np.float32))
    std = torch.from_numpy(np.exp(rs.normal(size=d) * 0.5 - 1.0).astype(np.float32))
    std[d // 2] = 1e-6
    a_target = float(toy_mvn_path(d).coord_factor(torch.ones(())))
    return cuda_slice.VariationalTerm(betas, isvar, torch.tensor([active]), a_target, mean, std)


def _k1_variational(lib_path, x, a, seeds, term, n_passes):
    return _in_child(host_call.banded_slice_sweep, lib_path, x, a, seeds, *SAMPLER, n_passes,
                     MAX_ITER, (*(t.numpy() for t in (*term[:3], *term[4:])), term.a_target))


# the same shapes with the variational term: d = 1, ragged tiles, more than one
# tile a block; and a d above the tile size (the table then goes by element)
@pytest.mark.parametrize("B,d,n_passes", [(1, 5, 3), (37, 13, 1), (700, 13, 3), (300, 1, 2),
                                          (40, 100, 3), (3, 4100, 1)])
def test_k1_variational_host_build_matches_twin(host_libraries, B, d, n_passes):
    x, betas, seeds = _inputs(B, d, n_passes)
    a = toy_mvn_path(d).coord_factor(betas)
    term = _variational_term(betas, d, B, 1.0)
    got = _k1_variational(host_libraries["banded_slice"], x, a, seeds, term, n_passes)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes, variational=term)
    _assert_bitwise(got, want, ("x", "stats"))
    toy = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=n_passes)
    assert B == 1 or not torch.equal(want[0], toy[0])  # (the one lane of B = 1 has beta = 1)


@pytest.mark.parametrize("beta", [0.0, 1.0])
@pytest.mark.parametrize("std", [1e-3, 1e3])
def test_k1_variational_at_extreme_std_and_beta(host_libraries, std, beta):
    """Every coordinate's std far from the target's, every lane at one end of
    the path: at beta = 0 a variational lane's term is its reference's alone,
    at beta = 1 the target's (the guarded products' weights are 0)."""
    B, d = 40, 13
    x, betas, seeds = _inputs(B, d, 3)
    betas = torch.full((B,), beta)
    a = toy_mvn_path(d).coord_factor(betas)
    term = _variational_term(betas, d, 4, 1.0)._replace(std=torch.full((d,), std))
    got = _k1_variational(host_libraries["banded_slice"], x, a, seeds, term, 2)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=2, variational=term)
    _assert_bitwise(got, want, ("x", "stats"))
    assert not torch.equal(want[0], x)


def test_k1_variational_before_activation_is_the_toy_term(host_libraries):
    x, betas, seeds = _inputs(37, 13, 2)
    a = toy_mvn_path(13).coord_factor(betas)
    term = _variational_term(betas, 13, 5, 0.0)
    got = _k1_variational(host_libraries["banded_slice"], x, a, seeds, term, 3)
    toy = _in_child(host_call.banded_slice_sweep, host_libraries["banded_slice"], x, a, seeds,
                    *SAMPLER, 3, MAX_ITER, None)
    _assert_bitwise(got, toy, ("x", "stats"))
    _assert_bitwise(got, cuda_slice.banded_sweep_reference(x, a, seeds, n_passes=3), ("x", "stats"))


def test_k1_rejects_the_variational_term_without_its_arrays(host_libraries):
    x, betas, seeds = _inputs(4, 3, 0)
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    a = toy_mvn_path(3).coord_factor(betas)
    args = [t.numpy() for t in (x, a, seeds)]
    child = ctx.Process(target=_unknown_term, args=(host_libraries["banded_slice"], *args, out))
    child.start()
    assert out.get(timeout=CALL_TIMEOUT_S) != 0
    child.join()


def _unknown_term(lib_path, x, a, seeds, out):
    import ctypes

    lib = ctypes.CDLL(str(lib_path))
    lib.banded_slice_sweep.argtypes = ([host_call.VP] * 5 + [host_call.CI] * 2 + [host_call.CF]
                                       + [host_call.CI] * 4 + [host_call.VP] * 5
                                       + [host_call.CF, host_call.VP])
    p = host_call._ptr
    # term 1 without its arrays
    out.put(lib.banded_slice_sweep(p(x), p(a), p(seeds), p(x), p(x), x.shape[0], x.shape[1], 10.0,
                                   20, 1, 1024, 1, None, None, None, None, None, 0.0, None))


def _k2(lib_path, x, betas, seeds, path, coord_deltas, n_passes, group, isvar=None,
        ref_params=None, max_iter=MAX_ITER, sampler=SAMPLER, err_wanted=0):
    """Kernel K2's entry point in a child process that imports numpy and
    ctypes only (``host_call``), so that it starts in well under a second;
    it must return ``err_wanted``."""
    density = path.device_density()
    variational = None
    if ref_params is not None:
        variational = tuple(t.numpy() for t in (isvar, ref_params["mean"], ref_params["std"],
                                                ref_params["active"].reshape(1)))
    return _in_child(host_call.slice_sweep_child, lib_path, x, betas, seeds, density.kind,
                     tuple(float(v) for v in density.params), coord_deltas, *sampler, n_passes,
                     max_iter, group, tuple(a.numpy() for a in density.arrays),
                     tuple(tuple(float(v) for v in row) for row in density.prior), variational,
                     err_wanted=err_wanted)


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
    path, x, betas, seeds, want = _full_case(name, B, d, n_passes)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, n_passes, group)
    _assert_bitwise(got, want, ("x", "lp", "stats"))


@functools.lru_cache(maxsize=None)
def _full_case(name, B, d, n_passes):
    """The path, inputs and the twin's sweep of a full-mode case (shared by
    the tests of each group)."""
    path = _full_path(name, d)
    x, betas, seeds = _inputs(B, d, d + n_passes)
    if name == "funnel" and B > 5:
        x[3, 0], x[4, 0], x[5, d - 1] = 95.0, -95.0, float("nan")
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=n_passes)
    return path, x, betas, seeds, want


def test_k2_chooses_its_group_from_the_shape(host_libraries):
    """group = 0, as the wrapper calls it."""
    path = _full_path("funnel", 10)
    x, betas, seeds = _inputs(33, 10, 5)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, 0)
    _assert_bitwise(got, cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1),
                    ("x", "lp", "stats"))


@functools.lru_cache(maxsize=None)
def _delta_case(B, d, n_passes):
    """The toy path, inputs and the twin's delta-mode sweep (shared by the
    tests of each group)."""
    path = toy_mvn_path(d)
    x, betas, seeds = _inputs(B, d, B)
    return path, x, betas, seeds, cuda_slice.sweep_reference(x, betas, seeds, path, True,
                                                             n_passes=n_passes)


@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("B,d,n_passes", [(8, 4, 2), (5, 1, 1), (130, 6, 1), (3, 100, 0)])
def test_k2_delta_host_build_matches_twin(host_libraries, B, d, n_passes, group):
    """Delta mode at the launcher's choice and one thread a lane: bitwise the
    twin. The entry point refuses a group of more threads (-1)."""
    path, x, betas, seeds, want = _delta_case(B, d, n_passes)
    if group > 1:
        _k2(host_libraries["sweep_slice"], x, betas, seeds, path, True, n_passes, group,
            err_wanted=-1)
        return
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, True, n_passes, group)
    _assert_bitwise(got, want, ("x", "lp", "stats"))


BAYESIAN = {
    "hierarchical_normal": lambda: T.hierarchical_normal(),
    # rows past the last full four, and fewer than four rows
    "hierarchical_normal_6x3": lambda: T.hierarchical_normal(6, 3, seed=2),
    "hierarchical_normal_3x2": lambda: T.hierarchical_normal(3, 2, seed=3),
    "eight_schools": lambda: T.eight_schools(),
    "unid": lambda: T.unid_target(),
    # two windows of the likelihood's sum, the first short of 32 terms
    "logistic_regression_40x3": lambda: T.logistic_regression(40, 3, seed=1),
    "bernoulli": lambda: T.bernoulli_target(),
    "eight_schools_centered": lambda: T.eight_schools(centered=True),
    "mrna": lambda: T.mrna_target(),
}


SHORT = 24  # shrink steps before a lane gives a coordinate up: the far-out lanes' limit


def _bayesian_inputs(model, B, seed):
    """States drawn from the prior, some far out and one NaN among them (those
    lanes shrink until ``max_iter`` ends it, so the tests set it to SHORT)."""
    x = model.initialization(rng.keys_for(rng.key(seed), torch.arange(B)))
    _, betas, seeds = _inputs(B, model.dim, seed)
    if B > 3:
        x[1, model.dim - 1], x[2, model.dim - 1], x[3, 0] = 95.0, -95.0, float("nan")
    return x, betas, seeds


def _reference_params(d, seed, active):
    rs = np.random.RandomState(seed)
    return {"mean": torch.from_numpy((rs.normal(size=d) * 0.3).astype(np.float32)),
            "std": torch.from_numpy(np.exp(rs.normal(size=d) * 0.5).astype(np.float32)),
            "active": torch.tensor(active)}


def _variational_path(name, d):
    from pigeons_tpu_torch import GaussianReference, VariationalPath

    if name in BAYESIAN:
        model = BAYESIAN[name]()
        return VariationalPath(model.create_path(model.default_reference()), GaussianReference())
    return VariationalPath(_full_path(name, d), GaussianReference())


@pytest.mark.parametrize("group", [1, 8, 16, 32])
@pytest.mark.parametrize("name,d", [("funnel", 10), ("toy", 5), ("banana", 4), ("mvn", 3),
                                    ("eight_schools", 10)])
def test_k2_variational_host_build_matches_twin(host_libraries, name, d, group):
    """Lanes of both legs under an active mean-field reference: the kernel
    reads ``isvar``, ``mean``, ``std`` and ``active`` from arrays."""
    path = _variational_path(name, d)
    B = 7
    x, betas, seeds = _inputs(B, d, d + group, scale=1.0)
    isvar = torch.from_numpy((np.arange(B) % 3 != 1).astype(np.float32))
    params = _reference_params(d, 3, 1.0)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group, isvar, params)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, isvar=isvar,
                                      ref_params=params)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    fixed = cuda_slice.sweep_reference(x, betas, seeds, path.fixed, False, n_passes=1)
    assert not torch.equal(want[0], fixed[0])


def test_k2_variational_before_activation_is_the_fixed_path(host_libraries):
    path = _variational_path("funnel", 6)
    x, betas, seeds = _inputs(9, 6, 4)
    isvar = torch.ones(9)
    params = _reference_params(6, 1, 0.0)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 2, 8, isvar, params)
    fixed = _k2(host_libraries["sweep_slice"], x, betas, seeds, path.fixed, False, 2, 8)
    _assert_bitwise(got, fixed, ("x", "lp", "stats"))
    _assert_bitwise(got, cuda_slice.sweep_reference(x, betas, seeds, path.fixed, False, n_passes=2),
                    ("x", "lp", "stats"))


def _bad_call(lib_path, case, out):
    """Calls that the entry point must refuse: -1, nothing launched."""
    import ctypes

    x = np.zeros((2, 23), np.float32)
    betas, seeds = np.zeros(2, np.float32), np.zeros(2, np.int64)
    model = T.hierarchical_normal()
    density = model.create_path(model.default_reference()).device_density()
    arrays = tuple(a.numpy() for a in density.arrays)
    prior, variational = density.prior, None
    if case == "short data":
        arrays = (arrays[0][:-1].copy(),)
    elif case == "no prior":
        prior = ()
    elif case == "prior past the state":
        prior = density.prior[:-1] + ((22, 2) + density.prior[-1][2:],)
    elif case == "half a reference":
        variational = (betas, None, None, None)
    if variational is not None:
        # host_call takes all four or none: call the library with one of them
        lib = ctypes.CDLL(str(lib_path))
        f, i, p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
        lib.slice_sweep.argtypes = ([p] * 6 + [i] * 4 + [p] * 4 + [i] + [p] * 4 + [f] + [i] * 4 + [p])
        ptr = host_call._ptr
        params = (f * 8)(*density.params)
        out.put((lib.slice_sweep(ptr(x), ptr(betas), ptr(seeds), ptr(x), ptr(betas), ptr(x), 2, 23,
                                 density.kind, 0, params, None, None, None, 0, ptr(betas), None,
                                 None, None, 10.0, 20, 1, 1024, 0, None),))
        return
    host_call.slice_sweep(lib_path, x, betas, seeds, density.kind, density.params, False, 10.0, 20,
                          1, 1024, 0, out, arrays, prior, None)


@pytest.mark.parametrize("case", ["short data", "no prior", "prior past the state",
                                  "half a reference"])
def test_k2_rejects_inconsistent_arrays(host_libraries, case):
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    child = ctx.Process(target=_bad_call, args=(host_libraries["sweep_slice"], case, out))
    child.start()
    assert out.get(timeout=CALL_TIMEOUT_S)[0] == -1
    child.join()
