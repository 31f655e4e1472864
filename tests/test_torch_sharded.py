"""The port's sharded runs against its one-process runs and the JAX package's
sharded runs: the counterpart of ``tests/test_sharded.py``.

Each rank is an OS process on the CPU over gloo (``tests/torch_mesh_worker.py``,
``pigeons(inputs, on=MultiHostLauncher(...))``). One process group a rank
count runs every case of this file in turn, so the processes start once:
two ranks and four ranks, side by side (eight ranks under ``slow``).

Against the port's one-process run of the same Inputs, every rank must hold
the same bits: samples, ``chain_of``, states (sorted and as they lie), round
trips, restarts, every round's logZ, ``accept_mean``, ``energy_ac1``, the
extended traces and the index process. ``SliceSamplerCUDA`` runs its kernels'
plain twins on the CPU, so the K1 cases (``:106`` and ``:142`` of the JAX
file) and a chain-sharded ``hierarchical_normal()`` case run K1's and K2's
twins on each rank's lanes only.

Against the JAX package's run at the same device count
(``replica_mesh(jax.devices()[:P])`` on ``tests/conftest.py``'s 8 virtual
devices): permutations, round trips and restarts bitwise, floats within the
tolerances of ``tests/test_torch_pt.py`` (``rtol=1e-5``, ``atol=1e-6``; the
states' log densities sum in another order than XLA's). The JAX side runs
for the toy explorer, the slice sampler and replicate sharding; the K1 and
K2 cases compare with the port's one-process run only, since the Pallas
interpreter takes minutes there (the JAX file marks them slow), and the
port's twins are held to the JAX kernels by ``tests/test_torch_pt.py`` and
``tests/test_torch_sweep_bayesian.py``.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from torch_mesh_worker import inputs_for  # noqa: E402

# the cases each process group runs, in order
SUITES = {
    2: ["layout", "ladders", "k1_ladders", "k2_chains"],
    4: ["layout", "slice", "indivisible_chains", "indivisible_ladders", "ladders", "k1_chains"],
}
SPAWN_TIMEOUT_S = 600


def spawn(world, steps, outdir):
    """Start ``world`` ranks of ``torch_mesh_worker.py`` running ``steps``;
    returns a function that waits for them (each within ``SPAWN_TIMEOUT_S``)
    and raises with their output if one failed."""
    outdir.mkdir(parents=True, exist_ok=True)
    init = f"file://{outdir}/pg"
    env = dict(os.environ, PYTHONPATH=str(HERE.parent) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_mesh_worker.py"),
                               str(rank), str(world), init, str(outdir), *steps],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(world)]

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
        finally:
            for p in procs:
                p.kill()
        for rank, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {rank} of {world} failed:\n{out[-4000:]}"

    return wait


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """``{world: outdir}`` after both process groups have run their cases."""
    base = tmp_path_factory.mktemp("mesh")
    waits = {world: spawn(world, cases, base / f"p{world}") for world, cases in SUITES.items()}
    for wait in waits.values():
        wait()
    return {world: base / f"p{world}" for world in SUITES}


def rank_results(outdir, case, world):
    return [dict(np.load(outdir / f"{case}.rank{rank}.npz", allow_pickle=True))
            for rank in range(world)]


@functools.lru_cache(maxsize=None)
def one_process(case):
    """The port's one-process run of ``case`` (run once, read only)."""
    pt = T.PT(inputs_for(T, case))
    pt.run()
    return pt


def jax_run(case, n_devices):
    import jax
    from pigeons_tpu.parallel import replica_mesh

    pt = J.PT(inputs_for(J, case, mesh=replica_mesh(jax.devices()[:n_devices])))
    pt.run()
    return pt


def assert_bitwise(got, pt, where):
    """Every rank's results are the one-process run's, bit for bit."""
    want = {
        "traces": pt.sample_array(), "chain_of": pt.chain_of.numpy(),
        "replica_of": pt.replica_of.numpy(), "states": pt.states.numpy(),
        "extended_traces": pt.extended_traces, "index_process": pt.index_process,
        "logz": np.array([r.log_z_estimate for r in pt.reports]),
        "accept_mean": pt.reduced.accept_mean, "energy_ac1": pt.reduced.energy_ac1,
        "online_mean": pt.reduced.online_mean, "online_var": pt.reduced.online_var,
        "exp_steps": pt.reduced.exp_steps, "schedule": np.asarray(pt.schedule.grids),
    }
    for name, value in want.items():
        assert np.array_equal(got[name], value, equal_nan=True), f"{where}: {name}"
        assert got[name].dtype == np.asarray(value).dtype, f"{where}: {name} dtype"
    assert np.array_equal(np.sort(got["states"], axis=-2), np.sort(want["states"], axis=-2))
    assert int(got["round_trips"]) == pt.n_round_trips, where
    assert int(got["restarts"]) == pt.n_tempered_restarts, where
    assert float(got["barrier"]) == pt.global_barrier, where


def assert_near_jax(got, ja):
    """Permutations, round trips and restarts exact; floats within the
    tolerances of tests/test_torch_pt.py."""
    assert np.array_equal(got["chain_of"], np.asarray(ja.chain_of))
    assert np.array_equal(got["replica_of"], np.asarray(ja.replica_of))
    assert np.array_equal(got["index_process"], np.asarray(ja.index_process))
    assert int(got["round_trips"]) == ja.n_round_trips
    assert int(got["restarts"]) == ja.n_tempered_restarts
    close = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["traces"], ja.sample_array(), **close)
    np.testing.assert_allclose(got["states"], np.asarray(ja.states), **close)
    np.testing.assert_allclose(got["accept_mean"], ja.reduced.accept_mean, **close)
    np.testing.assert_allclose(got["logz"], [r.log_z_estimate for r in ja.reports], rtol=1e-5,
                               atol=1e-4)


def check_case(outdir, case, world, against_jax):
    got = rank_results(outdir, case, world)
    pt = one_process(case)
    n_lanes = pt.n_replicates * pt.n_chains
    for rank, g in enumerate(got):
        assert int(g["local_lanes"]) == n_lanes // world  # each rank moved its block only
        assert_bitwise(g, pt, f"{case}, rank {rank} of {world}")
    if against_jax:
        assert_near_jax(got[0], jax_run(case, world))


@pytest.mark.parametrize("world", [2, 4])
def test_bitwise_layout_invariance(sharded, world):
    check_case(sharded[world], "layout", world, against_jax=True)


def test_bitwise_invariance_slice_sampler(sharded):
    check_case(sharded[4], "slice", 4, against_jax=True)


@pytest.mark.parametrize("case", ["indivisible_chains", "indivisible_ladders"])
def test_indivisible_count_rejected(sharded, case):
    for g in rank_results(sharded[4], case, 4):
        assert "divisible" in str(g["error"])


@pytest.mark.parametrize("world", [2, 4])
def test_replicate_axis_sharding_bitwise(sharded, world):
    check_case(sharded[world], "ladders", world, against_jax=True)


@pytest.mark.parametrize("case,world", [("k1_chains", 4), ("k1_ladders", 2), ("k2_chains", 2)])
def test_cuda_sampler_twins_sharded(sharded, case, world):
    check_case(sharded[world], case, world, against_jax=False)


@pytest.mark.slow
def test_bitwise_layout_invariance_eight_ranks(tmp_path):
    spawn(8, ["layout"], tmp_path)()
    check_case(tmp_path, "layout", 8, against_jax=True)


def test_mesh_without_process_group_raises():
    from pigeons_tpu_torch.parallel import replica_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="MultiHostLauncher.*init_process_group"):
        replica_mesh()


def test_mesh_must_be_a_replica_mesh():
    with pytest.raises(TypeError, match="ReplicaMesh"):
        T.PT(T.Inputs(target=T.toy_mvn_target(3), device="cpu", mesh=object()))
