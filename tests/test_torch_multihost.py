"""Real multi-process runs of the port: the counterpart of
``tests/test_multihost.py``.

Two OS processes on the CPU join one gloo group through
``MultiHostLauncher`` (``init_method="file://..."``, so that no test races
for a port) and run, in one group (``tests/torch_mesh_worker.py``):

* the JAX file's two-process smoke run (``:108``);
* a one-process checkpoint resumed under the two processes (elastic resume,
  ``:130``);
* ``host_main`` on a pickled ``Inputs`` with ``checked_round=2``: rank 0
  re-runs it serially in a ``ChildProcess`` and every rank passes
  ``check_against_serial``. Its checkpoint, written by the two ranks, is
  then resumed in this process (the other direction of elastic resume).

Each must be the one-process run bit for bit on every rank; the smoke run is
also held to the JAX package's run on a two-device mesh (permutations
exact, floats within ``tests/test_torch_pt.py``'s tolerances). The JAX
file's slow cases (``:163``, ``:171``, ``:185``) are here under ``slow``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import pigeons_tpu_torch as T

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from test_torch_sharded import (  # noqa: E402
    assert_bitwise,
    assert_near_jax,
    jax_run,
    one_process,
    rank_results,
    spawn,
)
from torch_mesh_worker import inputs_for  # noqa: E402


def checkpointed(case, folder, n_rounds):
    """The one-process run of ``case`` to ``n_rounds``, checkpointed into
    ``folder``."""
    pt = T.PT(inputs_for(T, case, checkpoint=True, checkpoint_folder=str(folder),
                         n_rounds=n_rounds))
    pt.run()
    return pt


def write_inputs(path, inputs):
    from pigeons_tpu_torch.checkpoint import dump_object

    path.parent.mkdir(parents=True, exist_ok=True)
    dump_object(inputs, str(path), str(path.parent / "immutables"))
    return path


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    """The output folder of one two-rank group that ran the smoke case, the
    resume of a one-process checkpoint and the checked host_main run."""
    base = tmp_path_factory.mktemp("multihost")
    checkpointed("smoke", base / "one_process", 2)
    checked = write_inputs(base / "inputs" / "run.pkl", inputs_for(T, "smoke", checked_round=2))
    out = base / "out"
    spawn(2, ["smoke", f"resume={base / 'one_process'}:3:resume", f"host_main={checked}:checked"],
          out)()
    return out


def uninterrupted(case, n_rounds):
    pt = T.PT(inputs_for(T, case, n_rounds=n_rounds))
    pt.run()
    return pt


def test_two_process_smoke_bitwise(multihost):
    got = rank_results(multihost, "smoke", 2)
    pt = one_process("smoke")
    for rank, g in enumerate(got):
        assert_bitwise(g, pt, f"rank {rank}")
    assert_near_jax(got[0], jax_run("smoke", 2))


def test_elastic_resume_smoke_bitwise(multihost):
    pt = uninterrupted("smoke", 3)
    for rank, g in enumerate(rank_results(multihost, "resume", 2)):
        assert_bitwise(g, pt, f"rank {rank}")


def test_checked_round_passes_the_serial_check(multihost):
    pt = one_process("smoke")
    for rank, g in enumerate(rank_results(multihost, "checked", 2)):
        assert_bitwise(g, pt, f"rank {rank}")
    stdout = (multihost / "checked" / "serial_check" / "info" / "stdout.txt").read_text()
    assert "child process: 2 rounds on cpu" in stdout


def test_two_process_checkpoint_resumed_in_one_process(multihost):
    """Elastic resume, the other direction: the two ranks' round-1
    checkpoint continued here."""
    pt = T.load_pt(str(multihost / "checked"), round_idx=1)
    assert pt.mesh is None
    pt.run_round()
    want = one_process("smoke")
    assert np.array_equal(pt.sample_array(), want.sample_array())
    assert np.array_equal(pt.states.numpy(), want.states.numpy())
    assert pt.reports[-1].log_z_estimate == want.reports[-1].log_z_estimate


def test_launcher_finds_the_ranks_on_its_host(multihost):
    """The ranks were started as ``host_main`` starts them (a coordinator, a
    process count and an id, no torchrun environment): each finds that both
    run on this host, takes its place among them and the CPU's gloo."""
    for rank in range(2):
        got = np.load(multihost / f"launcher.rank{rank}.npz")
        assert int(got["host_rank"]) == rank
        assert str(got["backend"]) == "gloo"


@pytest.mark.parametrize("hosts, cards, places, backend", [
    # config 5: one card on each of three hosts
    (("h0", "h1", "h2"), 1, [0, 0, 0], "nccl"),
    # two ranks sharing one card
    (("h0", "h0"), 1, [0, 1], "gloo"),
    (("h0", "h0", "h1", "h1"), 2, [0, 1, 0, 1], "nccl"),
    # one host with more ranks than cards: every rank takes gloo
    (("h0", "h1", "h0", "h0"), 2, [0, 0, 1, 2], "gloo"),
])
def test_backend_follows_the_ranks_on_each_host(monkeypatch, hosts, cards, places, backend):
    """``MultiHostLauncher``'s rule on the host names that the ranks
    exchange (here over one in-process store, a thread a rank), with
    ``cards`` cards a host: NCCL only where no host runs more ranks than
    it has cards, and every rank chooses alike."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import torch.distributed as dist

    from pigeons_tpu_torch.submission.multihost import choose_backend, host_ranks

    store = dist.HashStore()
    with ThreadPoolExecutor(len(hosts)) as pool:
        got = list(pool.map(lambda r: host_ranks(store, r, len(hosts), hosts[r]),
                            range(len(hosts))))
    assert [local for local, _ in got] == places
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert [choose_backend("cuda", per_host) for _, per_host in got] == [backend] * len(hosts)
    assert choose_backend("cpu", 1) == "gloo"


@pytest.mark.slow
def test_two_process_distributed_bitwise(tmp_path):
    spawn(2, ["fresh"], tmp_path)()
    pt = one_process("fresh")
    for rank, g in enumerate(rank_results(tmp_path, "fresh", 2)):
        assert_bitwise(g, pt, f"rank {rank}")


@pytest.mark.slow
def test_single_process_checkpoint_resumed_under_two_processes(tmp_path):
    checkpointed("fresh", tmp_path / "ckpt", 2)
    spawn(2, [f"resume={tmp_path / 'ckpt'}:3:resume"], tmp_path / "out")()
    pt = uninterrupted("fresh", 3)
    for rank, g in enumerate(rank_results(tmp_path / "out", "resume", 2)):
        assert_bitwise(g, pt, f"rank {rank}")


@pytest.mark.slow
def test_two_process_checkpoint_resumed_single_process(tmp_path):
    inputs = write_inputs(tmp_path / "inputs" / "run.pkl", inputs_for(T, "fresh"))
    spawn(2, [f"host_main={inputs}:run"], tmp_path / "out")()
    pt = T.load_pt(str(tmp_path / "out" / "run"), round_idx=2)
    pt.run_round()
    want = one_process("fresh")
    assert np.array_equal(pt.sample_array(), want.sample_array())
    assert np.array_equal(pt.states.numpy(), want.states.numpy())
    assert pt.reports[-1].log_z_estimate == want.reports[-1].log_z_estimate
