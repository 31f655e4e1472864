"""User densities on kernel K2: CUDA source beside a torch form
(``pigeons_tpu_torch/device_source.py``), on the CPU.

Each example of ``pigeons_tpu_torch/models/source_examples.py`` is written
again in ``jnp`` for the JAX package and run through ``SliceSamplerPallas``
in the Pallas interpreter, as the JAX tests run it; the port's twin of K2
(``sweep_reference``, which evaluates the source's torch form) is held to it
at the tolerances of ``tests/test_torch_sweep_bayesian.py`` and
``tests/test_torch_coordwise_path.py``: densities within 1e-6, states within
1e-5 relative, and a lane whose decisions differ (a near tie of float32
sums taken in another order than XLA's) counted, at most 1 % of the lanes
(with 8 lanes: none). The same source, compiled for the host with ``g++``
against ``tests/cuda_stub/`` (one K2 instance, as ``_build.build_user``
compiles it with ``nvcc``), is held bit for bit to the twin.

Cases: the three new prior blocks (Cauchy, Exponential, LogNormal) against
the JAX distributions and inside K2; model U (all three priors, a
``"likelihood"`` source); the hierarchical normal (5 x 3) written as a
source; ``unid_target()`` and the hierarchical normal (5 x 3), library kinds,
under ``N(0, 2^2 I)`` (``params[0] = 1 / sigma``), for every group of
threads; Neal's funnel as a ``"target"`` source; a ``CustomPath`` with a
``"path"`` source; the target and likelihood hooks under a variational
reference; a three-round run of model U in both packages from one state; a
checkpointed run of model U resumed bitwise; the refusals. Kernel K1's user
term is ``tests/test_torch_user_coord.py``.
"""

import ctypes
import functools
import math
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import SliceSamplerPallas
from pigeons_tpu import rng as jrng
from pigeons_tpu.models import distributions as JD
from pigeons_tpu_torch import _build, convert
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.device_source import HOOKS, DeviceSource, SourceLikelihood
from pigeons_tpu_torch.models import distributions as TD
from pigeons_tpu_torch.models import source_examples as SE
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "pigeons_tpu_torch" / "csrc"
STUB = ROOT / "tests" / "cuda_stub"
sys.path.insert(0, str(STUB))
import host_call  # noqa: E402  (tests/cuda_stub/host_call.py: the children's side)

from test_torch_csrc_host import (  # noqa: E402,F401  (host_libraries is a fixture)
    BAYESIAN,
    SHORT,
    _assert_bitwise,
    _bayesian_inputs,
    _in_child,
    _k2,
    host_libraries,
)

B = 8
MAX_FLIP_SHARE = 0.01
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX package's forms of the examples


def _jax_grouped_normal(priors, y, group):
    y, group = jnp.asarray(y), jnp.asarray(np.asarray(group, np.int32))

    def log_likelihood(q):
        loc = q["mu"] + q["tau"] * q["theta_trans"][group]
        return JD.normal_logpdf(y, loc, q["sigma"])

    return J.BayesianModel(priors, log_likelihood)


def _jax_model_u(seed=0):
    y, group = SE.model_u_data(seed)
    return _jax_grouped_normal({"mu": J.models.Cauchy(0.0, 5.0), "sigma": J.models.LogNormal(0.0, 1.0),
                                "tau": J.models.Exponential(1.0),
                                "theta_trans": JD.Normal(shape=(4,))}, y, group)


class JaxFunnel(J.models.Target):
    """``source_examples.FUNNEL_CUDA`` in jnp: y ~ N(0, 3), x_i ~ N(0, exp(y / 2))."""

    def __init__(self, dim):
        self.dim = dim

    def log_density(self, x):
        y = x[0]
        head = -0.5 * (y / 3.0) ** 2 - math.log(3.0) - HALF_LOG_2PI
        return head + jnp.sum(-0.5 * (x[1:] / jnp.exp(y * 0.5)) ** 2 - y * 0.5 - HALF_LOG_2PI)

    def default_reference(self):
        return J.models.StandardNormalReference(self.dim, 1.0).as_reference()


def _jax_custom_path(dim, scale, seed):
    m = jnp.asarray(np.random.RandomState(seed).normal(size=dim).astype(np.float32))

    def lp(x, beta):
        return -0.5 * jnp.sum(x * x) + beta * (-0.5 * jnp.sum(((x - m) / scale) ** 2))

    return J.models.CustomPathTarget(J.models.CustomPath(lp, lambda k: jax.random.normal(k, (dim,))),
                                     dim)


def _jax_sweep(jpath, xs, betas, key_seed, max_iter=1024):
    keys = jrng.keys_for(jax.random.key(key_seed), jnp.arange(len(xs)))

    def ld(x, beta, isvar, rp):
        lp = jpath.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    out = SliceSamplerPallas(interpret=True, n_passes=1, max_iter=max_iter).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(len(xs)), ld, jnp.asarray(betas),
        jnp.zeros(len(xs)), (), (), 1, ld_coord=None)
    return {k: np.asarray(getattr(out, k)) for k in ("x", "lp", "accept_sum", "accept_n", "n_steps")}


def _port_sweep(tpath, xs, betas, key_seed, max_iter=1024):
    keys = trng.keys_for(trng.key(key_seed), torch.arange(len(xs)))
    before = dict(SliceSamplerCUDA.launches)
    explorer = SliceSamplerCUDA(n_passes=1, max_iter=max_iter)
    explorer.check_path(tpath)
    out = explorer.step_batched(keys, torch.from_numpy(xs), torch.from_numpy(betas), tpath)
    assert SliceSamplerCUDA.launches == before  # CPU tensors: the twin
    return out


def _hold_to_jax(ref, out):
    """States within 1e-5 relative and returned densities within 1e-5, the
    stats exact, for every lane whose decisions are the JAX kernel's; such
    lanes that differ (flips) are counted, at most 1 % of the lanes."""
    x, lp = out.x.numpy(), out.lp.numpy()
    stats = np.stack([out.accept_sum.numpy(), out.accept_n.numpy(), out.n_steps.numpy()])
    ref_stats = np.stack([ref["accept_sum"], ref["accept_n"], ref["n_steps"]])
    off = np.abs(x - ref["x"]) > 1e-5 * np.maximum(np.abs(ref["x"]), 1.0)
    flipped = off.any(1) | (stats != ref_stats).any(0)
    print(f"{int(flipped.sum())} of {len(x)} lanes flipped; {int((x != ref['x']).sum())} of {x.size} "
          f"state elements and {int((lp != ref['lp']).sum())} densities not bitwise equal")
    assert flipped.sum() <= MAX_FLIP_SHARE * len(x)
    np.testing.assert_allclose(lp[~flipped], ref["lp"][~flipped], rtol=1e-5, atol=1e-5)


def _sweep_inputs(model, seed):
    """States drawn from the prior (or N(0, I)), betas with both ends."""
    rs = np.random.RandomState(seed)
    if isinstance(model, T.BayesianModel):
        xs = model.initialization(trng.keys_for(trng.key(seed), torch.arange(B))).numpy()
    else:
        xs = rs.normal(size=(B, model.dim)).astype(np.float32)
    betas = rs.uniform(0.0, 1.0, B).astype(np.float32)
    betas[[0, 1]] = 0.0, 1.0
    return xs, betas


# ---------------------------------------------------------------------------
# the prior blocks

NEW_PRIORS = {
    "Cauchy": (TD.Cauchy(0.5, 5.0, shape=(3,)), J.models.Cauchy(0.5, 5.0, shape=(3,))),
    "Exponential": (TD.Exponential(1.5, shape=(3,)), J.models.Exponential(1.5, shape=(3,))),
    "LogNormal": (TD.LogNormal(0.2, 0.8, shape=(3,)), J.models.LogNormal(0.2, 0.8, shape=(3,))),
}


@pytest.mark.parametrize("name", sorted(NEW_PRIORS))
def test_prior_block_log_prob_matches_jax(name):
    """``log_prob`` of each new ``device_block`` row, on its bijector's
    values of 512 unconstrained draws, against the JAX distribution under
    ``jit(vmap(...))`` within 1e-6 (relative above 1), and the row in the
    model's prior table: (offset, size, kind, bijector, the block's three
    float32 parameters, 0)."""
    tdist, jdist = NEW_PRIORS[name]
    u = np.random.RandomState(1).normal(size=(512, 3)).astype(np.float32) * 2.0
    x_t, _ = tdist.bijector.forward(torch.from_numpy(u), (3,))
    have = tdist.log_prob(x_t).numpy()
    want = np.asarray(jax.jit(jax.vmap(jdist.log_prob))(jnp.asarray(x_t.numpy())))
    np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6)
    kind, params = tdist.device_block
    assert kind == {"Cauchy": TD.CAUCHY, "Exponential": TD.EXPONENTIAL,
                    "LogNormal": TD.LOG_NORMAL}[name]
    assert all(float(np.float32(p)) == p for p in params)
    model = T.BayesianModel({"w": TD.Normal(), "v": tdist}, lambda q: q["w"] * 0.0)
    assert model.prior_table()[1] == (1, 3, kind, tdist.bijector.kind, *params, 0.0)


# ---------------------------------------------------------------------------
# the user's K2 instance compiled for the host


def _host_user_library(source, out_dir):
    """``source`` compiled into a host library of its own: ``g++`` over its
    kernel's source with the text included, as ``_build.build_user`` runs
    ``nvcc``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    text = out_dir / f"user-{source.key}.cuh"
    text.write_text(source.code)
    lib = out_dir / f"user-{source.key}.so"
    if not lib.exists():
        subprocess.run(
            [gxx, "-x", "c++", "-std=c++17", "-O1", "-ffp-contract=off", "-pthread", "-shared",
             "-fPIC", "-I", str(STUB), f'-DPIGEONS_USER_SOURCE="{text}"',
             f"-DPIGEONS_USER_HOOK={HOOKS[source.hook]}", "-o", str(lib),
             str(CSRC / _build.USER_KERNELS[source.hook])],
            check=True, capture_output=True, text=True, timeout=300)
    return lib


@pytest.fixture(scope="module")
def user_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("user_host")


def _k2_user(lib, x, betas, seeds, density, max_iter=1024, isvar=None, ref_params=None,
             err_wanted=0, group=0):
    params = tuple(density.params) + (0.0,) * (8 - len(density.params))
    variational = None
    if ref_params is not None:
        variational = tuple(t.numpy() for t in (isvar, ref_params["mean"], ref_params["std"],
                                                ref_params["active"].reshape(1)))
    return _in_child(host_call.slice_sweep_user, str(lib), x, betas, seeds, params, 10.0, 20, 1,
                     max_iter, tuple(a.numpy() for a in density.arrays), density.prior,
                     variational, group, err_wanted=err_wanted)


EXAMPLES = {
    "model_u": lambda: SE.model_u(),
    "hierarchical_normal_source_5x3": lambda: SE.hierarchical_normal_source(5, 3, seed=2),
    "funnel_source": lambda: SE.funnel_source(6),
    "custom_path_source": lambda: SE.custom_path_source(4),
}


# threads a lane: the launcher's choice (32 slots at these few lanes), one
# thread, and 8, 16, 32 slots of speculated queries
USER_GROUPS = (0, 1, 8, 16, 32)


@functools.lru_cache(maxsize=None)
def _user_case(name):
    """A source's path, its inputs (lanes drawn from the prior or N(0, I),
    three of them far out or NaN) and the twin's sweep (shared by the tests
    of each group)."""
    model = EXAMPLES[name]()
    path = model.create_path(model.default_reference())
    x, betas, seeds = _bayesian_inputs(model, 7, len(name))
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, max_iter=SHORT)
    return path, (x, betas, seeds), want


@pytest.mark.parametrize("group", USER_GROUPS)
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_user_host_build_matches_twin(user_dir, name, group):
    """Each source's K2 instance against the twin, bit for bit, at every
    group: one thread a lane, or slots of speculated queries each with its
    own copy of the state."""
    path, (x, betas, seeds), want = _user_case(name)
    density = path.device_density()
    assert density.kind == T.paths.USER and density.source is not None
    lib = _host_user_library(density.source, user_dir)
    got = _k2_user(lib, x, betas, seeds, density, max_iter=SHORT, group=group)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    assert not torch.equal(got[0][0], x[0])


@functools.lru_cache(maxsize=None)
def _user_variational_case(name):
    model = EXAMPLES[name]()
    path = T.VariationalPath(model.create_path(model.default_reference()), T.GaussianReference())
    x, betas, seeds = _bayesian_inputs(model, 7, 3)
    isvar = torch.from_numpy((np.arange(7) % 3 != 1).astype(np.float32))
    rs = np.random.RandomState(5)
    ref_params = {"mean": torch.from_numpy((rs.normal(size=model.dim) * 0.3).astype(np.float32)),
                  "std": torch.from_numpy(np.exp(rs.normal(size=model.dim) * 0.5).astype(np.float32)),
                  "active": torch.tensor(1.0)}
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, max_iter=SHORT,
                                      isvar=isvar, ref_params=ref_params)
    fixed = cuda_slice.sweep_reference(x, betas, seeds, path.fixed, False, n_passes=1,
                                       max_iter=SHORT)
    assert not torch.equal(want[0], fixed[0])
    return path, (x, betas, seeds, isvar, ref_params), want


@pytest.mark.parametrize("group", USER_GROUPS)
@pytest.mark.parametrize("name", ["model_u", "funnel_source"])
def test_user_host_build_under_a_variational_reference(user_dir, name, group):
    """The likelihood and target hooks on a two-leg run's lanes, the
    reference active, at every group: the kernel reads isvar, mean, std and
    active, and each slot's copy of the state under the reference."""
    path, (x, betas, seeds, isvar, ref_params), want = _user_variational_case(name)
    density = path.device_density()
    lib = _host_user_library(density.source, user_dir)
    got = _k2_user(lib, x, betas, seeds, density, SHORT, isvar, ref_params, group=group)
    _assert_bitwise(got, want, ("x", "lp", "stats"))


def test_user_library_refuses_a_prior_table_it_cannot_read(user_dir):
    """A likelihood source without its prior table, or with one that does not
    cover the state: the entry point returns -1 and launches nothing."""
    model = SE.model_u()
    density = model.create_path(model.default_reference()).device_density()
    lib = _host_user_library(density.source, user_dir)
    x, betas, seeds = _bayesian_inputs(model, 4, 0)
    _k2_user(lib, x, betas, seeds, density._replace(prior=()), err_wanted=-1)
    _k2_user(lib, x, betas, seeds, density._replace(prior=density.prior[:-1]), err_wanted=-1)


# ---------------------------------------------------------------------------
# library kinds under N(0, sigma^2 I)

NORMAL_REFERENCE = ("unid", "hierarchical_normal_6x3", "eight_schools")


@functools.lru_cache(maxsize=None)
def _normal_reference_case(name):
    """A library model's path from N(0, 2^2 I), inputs and the twin's sweep
    (shared by the tests of each group)."""
    model = BAYESIAN[name]()
    path = model.create_path(T.StandardNormalReference(model.dim, 2.0).as_reference())
    x, betas, seeds = _bayesian_inputs(model, 6, 4)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, max_iter=SHORT)
    own = cuda_slice.sweep_reference(x, betas, seeds, model.create_path(model.default_reference()),
                                     False, n_passes=1, max_iter=SHORT)
    return path, x, betas, seeds, want, own


@pytest.mark.parametrize("group", [0, 1, 8, 16, 32])
@pytest.mark.parametrize("name", sorted(NORMAL_REFERENCE))
def test_library_kinds_under_a_normal_reference_host_build(host_libraries, name, group):
    """``params[0] = 1 / sigma``: K2's one-thread machine, its shared
    reduction (the hierarchical normal's ManyTerms) and its speculated
    queries (unid, eight schools) blend N(0, 2^2 I) as kMvn's reference,
    bit for bit the twin, which evaluates the path's reference and posterior."""
    path, x, betas, seeds, want, own = _normal_reference_case(name)
    density = path.device_density()
    assert density.params[0] == 0.5 and density.kind != T.paths.USER
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
              max_iter=SHORT)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    assert not torch.equal(want[1], own[1])  # the reference is not the prior


# ---------------------------------------------------------------------------
# the twin against the JAX package's Pallas kernel


def _unid_pair():
    return J.unid_target(), convert.bayesian_model_from_numpy("unid_target", n_trials=100,
                                                              n_successes=50)


def _hierarchical_pair():
    jm = J.hierarchical_normal(5, 3, seed=2)
    fn = jm.log_likelihood_fn
    data = np.asarray(fn.__closure__[fn.__code__.co_freevars.index("data")].cell_contents)
    return jm, convert.bayesian_model_from_numpy("hierarchical_normal", data=data)


@pytest.mark.parametrize("name", ["unid", "hierarchical_normal_5x3"])
def test_normal_reference_twin_matches_pallas_kernel(name):
    """``unid_target()`` and the hierarchical normal (5 x 3) under N(0, 2^2 I):
    the JAX package's path from that reference through ``_sweep_kernel``."""
    jm, tm = _unid_pair() if name == "unid" else _hierarchical_pair()
    jpath = jm.create_path(J.models.StandardNormalReference(jm.dim, 2.0).as_reference())
    tpath = tm.create_path(T.StandardNormalReference(tm.dim, 2.0).as_reference())
    assert tpath.device_density().params[0] == 0.5
    xs, betas = _sweep_inputs(tm, 1)
    _hold_to_jax(_jax_sweep(jpath, xs, betas, 7), _port_sweep(tpath, xs, betas, 7))


def _jax_user_pair(name):
    if name == "model_u":
        return _jax_model_u(), SE.model_u()
    if name == "hierarchical_normal_source_5x3":
        jm, _ = _hierarchical_pair()
        tm = SE.hierarchical_normal_source(5, 3, seed=2)
        y, group = (a.numpy() for a in tm.log_likelihood_fn.source.arrays)
        return _jax_grouped_normal(dict(jm.priors), y, group), tm
    if name == "funnel_source":
        return JaxFunnel(6), SE.funnel_source(6)
    return _jax_custom_path(4, 0.5, 0), SE.custom_path_source(4)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_user_twin_matches_pallas_kernel(name):
    """Each example through the JAX package's kernel, which traces the jnp
    density, against the port's twin of the user's K2 instance."""
    jm, tm = _jax_user_pair(name)
    jpath, tpath = jm.create_path(jm.default_reference()), tm.create_path(tm.default_reference())
    assert tpath.device_density().kind == T.paths.USER
    xs, betas = _sweep_inputs(tm, 2)
    x = torch.from_numpy(xs)
    dense_t = cuda_slice.sweep_density(tpath)(x, torch.from_numpy(betas)).numpy()
    dense_j = np.asarray(jax.jit(jax.vmap(jpath.log_density))(jnp.asarray(xs), jnp.asarray(betas)))
    np.testing.assert_allclose(dense_t, dense_j, rtol=1e-6, atol=1e-6)
    out = _port_sweep(tpath, xs, betas, 9)
    _hold_to_jax(_jax_sweep(jpath, xs, betas, 9), out)
    assert not np.array_equal(out.x.numpy(), xs)


# ---------------------------------------------------------------------------
# runs


def test_three_round_run_of_model_u_matches_jax():
    """The JAX package runs round 1 from the seed, its state is carried into
    the port (``convert.state_from_numpy``), and both run rounds 2 and 3:
    restarts, round trips and permutations equal, barrier and logZ within
    1e-3, states within 1e-5 relative with flips counted (none allowed)."""
    kw = dict(seed=3, n_rounds=3, show_report=False, n_chains=4, n_replicates=2)
    ja = J.PT(J.Inputs(target=_jax_model_u(), explorer=SliceSamplerPallas(interpret=True, n_passes=1),
                       **kw))
    ta = T.PT(T.Inputs(target=SE.model_u(), explorer=SliceSamplerCUDA(n_passes=1), device="cpu",
                       **kw))
    assert ta.path.device_density().kind == T.paths.USER
    ja.run_round()
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": np.asarray(ja.schedule.grids)}, round_idx=1)
    for _ in range(2):
        ja.run_round()
        ta.run_round()
        rj, rt = ja.reports[-1], ta.reports[-1]
        assert (rj.n_scans, rj.n_tempered_restarts, rj.n_round_trips) == \
            (rt.n_scans, rt.n_tempered_restarts, rt.n_round_trips)
        assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
        assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3 * max(1.0, abs(rj.log_z_estimate))
    sj, st = np.asarray(ja.states), ta.states.numpy()
    flipped = int((np.abs(st - sj) > 1e-5 * np.maximum(np.abs(sj), 1.0)).sum())
    print(f"{flipped} flipped of {sj.size} state elements, {int((sj != st).sum())} not bitwise equal")
    assert flipped == 0
    assert np.isfinite(ta.reports[-1].log_z_estimate)


def test_checkpointed_run_of_model_u_resumes_bitwise(tmp_path):
    """The source's text travels with the target in the checkpoint: a run
    stopped after round 2 and resumed is the uninterrupted run."""
    from pigeons_tpu_torch import increment_n_rounds

    kw = dict(target=SE.model_u(), n_chains=4, n_replicates=2, seed=5, show_report=False,
              explorer=SliceSamplerCUDA(n_passes=1), device="cpu")
    full = T.PT(T.Inputs(n_rounds=3, **kw)).run()
    folder = str(tmp_path / "run")
    T.PT(T.Inputs(n_rounds=2, checkpoint=True, checkpoint_folder=folder, **kw)).run()
    increment_n_rounds(folder, 1)
    resumed = T.pigeons(folder)
    src = resumed.path.device_density().source
    assert src.code == SE.GROUPED_NORMAL_CUDA and src.key == kw["target"].log_likelihood_fn.source.key
    assert torch.equal(full.states, resumed.states)
    assert torch.equal(full.chain_of, resumed.chain_of)
    assert np.array_equal(full.sample_array(), resumed.sample_array())
    assert full.reports[-1].log_z_estimate == resumed.reports[-1].log_z_estimate


# ---------------------------------------------------------------------------
# the source itself, the build key, the refusals


def test_source_is_validated_when_it_is_made():
    code = SE.FUNNEL_CUDA
    with pytest.raises(ValueError, match="hook"):
        DeviceSource(code, "density", SE.funnel_terms)
    with pytest.raises(ValueError, match="pigeons_user_path"):
        DeviceSource(code, "path", SE.funnel_terms)
    with pytest.raises(ValueError, match="at most 7"):
        DeviceSource(code, "target", SE.funnel_terms, params=tuple(range(8)))
    with pytest.raises(ValueError, match="at most 4"):
        DeviceSource(code, "target", SE.funnel_terms, arrays=(torch.zeros(2),) * 5)
    with pytest.raises(ValueError, match="float32"):
        DeviceSource(code, "target", SE.funnel_terms, arrays=(torch.zeros(2, dtype=torch.float64),))
    with pytest.raises(ValueError, match="torch_ref_fn"):
        DeviceSource(code, "target", SE.funnel_terms, torch_ref_fn=SE.funnel_terms)
    with pytest.raises(ValueError, match="likelihood"):
        SourceLikelihood(DeviceSource(code, "target", SE.funnel_terms))
    src = DeviceSource(code, "target", SE.funnel_terms, params=(1.0 / 3.0,))
    assert src.params == (float(np.float32(1.0 / 3.0)),)
    # more priors than the kernel's table has blocks: raised when the model is built
    priors = {f"w{i}": TD.Normal() for i in range(9)}
    with pytest.raises(ValueError, match="at most 8 priors"):
        T.BayesianModel(priors, SourceLikelihood(DeviceSource(
            SE.GROUPED_NORMAL_CUDA, "likelihood", SE.grouped_normal_terms)))


def test_build_key_follows_the_text_and_the_hook():
    a = SE.funnel_source(4).source
    b = DeviceSource(a.code + "\n", "target", SE.funnel_terms)
    assert _build.user_library_path(a) == _build.user_library_path(SE.funnel_source(9).source)
    assert _build.user_library_path(a) != _build.user_library_path(b)
    lik = SE.model_u().log_likelihood_fn.source
    assert _build.user_library_path(lik) == _build.user_library_path(
        SE.hierarchical_normal_source().log_likelihood_fn.source)  # one text, one library


def test_a_source_is_built_and_loaded_once_a_process(monkeypatch):
    """``load_user`` builds and opens a source's library at its first launch
    and keeps it by the source's key: a later launch looks up no file (the
    keyed name hashes the kernel's source and the headers)."""
    built = []
    monkeypatch.setattr(_build, "_USER_LIBRARIES", {})
    monkeypatch.setattr(_build, "build_user",
                        lambda src: (built.append(src.key), (Path(f"{src.key}.so"), 0.0))[1])
    monkeypatch.setattr(_build, "open_user", lambda path, kernel: (path.name, kernel))
    funnel, path = SE.funnel_source(3).source, SE.custom_path_source(3).path.source
    for _ in range(3):
        assert _build.load_user(funnel) == (f"{funnel.key}.so", "sweep_slice.cu")
        assert _build.load_user(path) == (f"{path.key}.so", "sweep_slice.cu")
    # the same text and hook is the same library, whatever its arrays
    assert _build.load_user(SE.funnel_source(5).source) == (f"{funnel.key}.so", "sweep_slice.cu")
    assert built == [funnel.key, path.key]


def test_cuda_wrappers_take_cuda_tensors_only(user_dir):
    """A user's density on CPU tensors runs its twin, never the build; the
    kernels' wrappers refuse CPU tensors. The launcher's group (asked of the
    source's host build): slots of speculated queries, 32 while the batch's
    groups fill at most a quarter of the card, down to 8, and one thread a
    lane where a block's copies of the state pass 227 KB (a target of 404
    coordinates: 16 lanes of 9 rows)."""
    t = SE.funnel_source(3)
    path = t.create_path(t.default_reference())
    x, betas = torch.zeros(2, 3), torch.zeros(2)
    seeds = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_slice.sweep_cuda(x, betas, seeds, path)
    c = SE.normal_product_source(3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_slice.banded_sweep_user_cuda(
            x, seeds, cuda_slice.UserTerm(betas, c.create_path(c.default_reference()).coord_source))
    lib = ctypes.CDLL(str(_host_user_library(path.device_density().source, user_dir)))
    assert [cuda_slice.launcher_group(path, B, 3, lib) for B in (640, 2048, 4096, 8192, 40000)] \
        == [32, 32, 16, 8, 1]
    assert cuda_slice.launcher_group(path, 8192, 403, lib) == 8
    assert cuda_slice.launcher_group(path, 8192, 404, lib) == 1


# (example, its path's batch in chip_smoke.py phase 12, the launcher's group,
# the widest state whose copies fit a block at that group)
USER_PATH_GROUPS = [("hierarchical_normal_source_20x10", 8192, 8, 213), ("model_u", 640, 32, 223),
                    ("custom_path_source", 640, 32, 440)]


@pytest.mark.parametrize("name,B,group,widest", USER_PATH_GROUPS)
def test_user_launcher_speculates_at_the_paths_batches(user_dir, name, B, group, widest):
    """At the batches its paths launch, the launcher gives every hook slots
    of speculated queries, under a variational reference too; one thread a
    lane from the width whose copies no longer fit a block: a likelihood's
    slot copies 2 d floats (the state and its constrained values), a path's
    d, beside the lanes' states, 16 of them at 8 slots and 4 at 32."""
    model = (SE.hierarchical_normal_source() if name.endswith("20x10") else EXAMPLES[name]())
    path = model.create_path(model.default_reference())
    lib = ctypes.CDLL(str(_host_user_library(path.device_density().source, user_dir)))
    assert cuda_slice.launcher_group(path, B, model.dim, lib) == group
    two_leg = T.VariationalPath(path, T.GaussianReference())
    assert cuda_slice.launcher_group(two_leg, B, model.dim, lib) == group
    assert cuda_slice.launcher_group(path, B, widest, lib) == group
    assert cuda_slice.launcher_group(path, B, widest + 1, lib) == 1


def test_paths_without_a_kind_or_a_source_are_refused():
    """The refusals name the source route beside ``SliceSampler()``."""
    target = T.BayesianModel({"w": TD.Normal()}, lambda q: -q["w"] ** 2)
    path = target.create_path(target.default_reference())
    with pytest.raises(NotImplementedError, match=r"DeviceSource.*SliceSampler\(\)"):
        SliceSamplerCUDA().check_path(path)
    custom = T.CustomPathTarget(T.CustomPath(lambda x, beta: -(x**2).sum(-1)), 2)
    with pytest.raises(NotImplementedError, match="DeviceSource"):
        SliceSamplerCUDA().check_path(custom.create_path(None))
    # a normal reference the model's kind is evaluated from; any other reference refused
    model = T.unid_target()
    SliceSamplerCUDA().check_path(model.create_path(T.StandardNormalReference(2, 2.0).as_reference()))
    other = T.models.Reference(log_density=lambda x: -(x**2).sum(-1))
    assert model.create_path(other).device_density() is None
    for name in ("model_u", "funnel_source", "custom_path_source"):
        m = EXAMPLES[name]()
        SliceSamplerCUDA().check_path(m.create_path(m.default_reference()))


def test_moving_a_custom_path_moves_its_source():
    """``CustomPathTarget.to`` moves the source's arrays, and a
    ``log_density_fn`` that is the source's torch form goes with them."""
    t = SE.custom_path_source(3)
    moved = t.to("meta")
    assert moved.path.source.arrays[0].device.type == "meta"
    assert moved.path.log_density_fn.__self__ is moved.path.source
    plain = T.CustomPathTarget(T.CustomPath(SE.custom_path_terms, source=t.path.source), 3).to("meta")
    assert plain.path.log_density_fn is SE.custom_path_terms
