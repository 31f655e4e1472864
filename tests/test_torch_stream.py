"""The port's stream-protocol bridge against the JAX package's, on the CPU.

Each package runs its own copy of the Python demo worker
(``pigeons_tpu[_torch].models.stream_worker_demo``, the same code) or the
compiled C++ worker of ``examples/native/stream_worker.cpp``, with the same
seeds. The workers' answers are deterministic and the swap decisions are
the same threefry draws, so ``sample_array()``, the permutations and the
round trips must be equal bit for bit. Also: ``java_seed`` against the JAX
package's, the protocol's round trips with both workers, the routing of a
run with replicates (one worker a lane, as in the JAX runtime), pickling
that rebuilds the pool, and the ecosystem targets' constructors.
"""

import functools
import pickle
import sys

import numpy as np
import pytest

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu.models import stream as JS
from pigeons_tpu_torch.models import stream as TS


def demo(package, dim=2):
    def build(replica_index: int):
        return [sys.executable, "-m", f"{package}.models.stream_worker_demo",
                "--seed", str(TS.java_seed(1, replica_index)), "--dim", str(dim)]

    return build


def compiled(binary, dim=2):
    def build(replica_index: int):
        return [binary, "--seed", str(TS.java_seed(1, replica_index)), "--dim", str(dim)]

    return build


@pytest.fixture(scope="module")
def worker_binary():
    return TS.example_worker()


def test_java_seed_is_the_jax_one():
    for seed in (0, 1, 7, 2**40 + 3):
        for i in (0, 1, 5, 1000):
            assert TS.java_seed(seed, i) == JS.java_seed(seed, i)
    assert TS.java_seed(1, 0) != TS.java_seed(1, 1) and TS.java_seed(1, 5) > 0


@pytest.mark.parametrize("kind", ["demo", "compiled"])
def test_worker_protocol_roundtrip(kind, worker_binary):
    cmd = demo("pigeons_tpu_torch")(0) if kind == "demo" else compiled(worker_binary)(0)
    w = TS._Worker(cmd, echo=False)
    try:
        lp = float(w.invoke("log_potential(0.0)"))
        assert np.isfinite(lp) and lp <= 0.0
        assert w.invoke("call_sampler!(0.5)") == ""
        lp1 = float(w.invoke("log_potential(0.0)"))
        assert np.isfinite(lp1) and lp1 != lp  # the move changed the state
        # precision interpolates 1 -> 10: the same state, 10 times the density
        np.testing.assert_allclose(float(w.invoke("log_potential(1.0)")), 10.0 * lp1, rtol=1e-12)
    finally:
        w.close()


def _runs(jbuild, tbuild, **kw):
    jt, tt = JS.StreamTarget(jbuild), TS.StreamTarget(tbuild)
    try:
        ja = J.pigeons(target=jt, show_report=False, **kw)
        ta = T.pigeons(target=tt, show_report=False, device="cpu", **kw)
        return ja, ta, sorted(jt.pool.workers), sorted(tt.pool.workers)
    finally:
        jt.close()
        tt.close()


@pytest.mark.parametrize("kind", ["demo", "compiled"])
def test_stream_run_is_the_jax_run(kind, worker_binary):
    if kind == "demo":
        builds = demo("pigeons_tpu"), demo("pigeons_tpu_torch")
    else:
        builds = compiled(worker_binary), compiled(worker_binary)
    ja, ta, jw, tw = _runs(*builds, n_chains=4, n_rounds=6)
    assert np.array_equal(ja.sample_array(), ta.sample_array())
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    assert [r.n_round_trips for r in ja.reports] == [r.n_round_trips for r in ta.reports]
    assert jw == tw == [0, 1, 2, 3]
    # the JAX file's law (tests/test_stream.py): -chi^2_2 / 2 at beta = 1
    lps = ta.sample_array()[:, -1]
    assert np.isfinite(lps).all() and abs(lps.mean() + 1.0) < 0.3
    assert ta.n_round_trips > 0 and ta.global_barrier > 0.0


def test_replicates_route_one_worker_a_lane(worker_binary):
    ja, ta, jw, tw = _runs(compiled(worker_binary), compiled(worker_binary), n_chains=3,
                           n_replicates=2, n_rounds=2)
    assert jw == tw == list(range(6))
    assert np.array_equal(ja.sample_array(), ta.sample_array())


def _command(binary, replica_index):
    return compiled(binary)(replica_index)


def test_pickling_rebuilds_the_pool(worker_binary):
    t = TS.StreamTarget(functools.partial(_command, worker_binary))
    t2 = pickle.loads(pickle.dumps(t))
    assert t2.pool is not t.pool and t2.pool.workers == {}
    assert isinstance(t2.default_explorer(), TS.StreamExplorer)
    assert isinstance(t2.create_path(t2.default_reference()), TS.StreamPath)
    with pytest.raises(ValueError, match=r"SliceSampler\(w=10.0"):
        T.PT(T.Inputs(target=t2, explorer=T.SliceSamplerCUDA(), device="cpu"))
    pt = T.pigeons(target=t2, n_chains=2, n_rounds=1, show_report=False, device="cpu")
    assert t2.pool.workers
    TS.kill_child_processes(pt)
    assert t2.pool.workers == {}


@pytest.mark.parametrize("cls", ["BlangTarget", "TreePPLTarget"])
def test_ecosystem_targets_construct(cls):
    t, j = getattr(T, cls)(["java", "my.Model"], seed=3), getattr(J, cls)(["java", "my.Model"],
                                                                           seed=3)
    assert t.dim == 1
    assert t._command_builder(2) == j._command_builder(2)
    if cls == "TreePPLTarget":
        assert t._env_builder(2)["PPL_SEED"] == j._env_builder(2)["PPL_SEED"]
    t.close()
