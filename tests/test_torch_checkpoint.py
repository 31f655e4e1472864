"""The port's checkpoint / resume and the serial cross-process check, on the
CPU, against the JAX package where both write the same thing.

(a) A run stopped after a round and resumed (``increment_n_rounds``, then
    ``pigeons(folder)``) is the uninterrupted run bit for bit: the toy MVN
    on K1's twin, two legs whose reference is fitted before the stop, and
    AutoMALA's adapted state.
(b) At the round-3 checkpoint of the same ``Inputs`` in both packages
    (the iid ``ToyExplorer``), ``chain_of`` / ``replica_of`` are the JAX
    package's ``checkpoint.npz`` bit for bit; states and schedule within
    1e-6 (XLA's ``rsqrt`` may be 2 ulp off torch's; the schedule adapts from
    rejection rates of those states' densities).
(c) Writing: a model's data goes once into ``immutables/``; without
    cloudpickle the checkpoint still writes and a lambda extractor fails
    before anything is written.
(d) Checks: ``recursive_equal``'s cases, a corrupted ``states`` flagged, one
    ``check_against_serial`` through a ``ChildProcess`` on the CPU, and the
    preflight checks of ``checked_round`` and ``disk``.
"""

import glob
import os
import pickle
import shutil
import sys
from collections import namedtuple
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu_torch.checkpoint import (
    immutables_dir,
    increment_n_rounds,
    latest_checkpoint_round,
    load_pt,
    round_folder,
)
from pigeons_tpu_torch.checks import (
    ParallelismInvarianceError,
    check_checkpoint_folders,
    recursive_equal,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RUNS = {
    "toy_mvn": dict(target=T.toy_mvn_target(3), n_chains=4,
                    explorer=T.SliceSamplerCUDA(n_passes=1)),
    "two_legs": dict(target=T.toy_mvn_target(3), n_chains=3, n_chains_variational=3,
                     variational=T.GaussianReference(first_tuning_round=2),
                     explorer=T.SliceSamplerCUDA(n_passes=1)),
    "automala": dict(target=T.toy_mvn_target(3), n_chains=3, n_replicates=2,
                     explorer=T.AutoMALA()),
}


def _same_run(a, b):
    assert torch.equal(a.states, b.states)
    assert torch.equal(a.chain_of, b.chain_of) and torch.equal(a.replica_of, b.replica_of)
    assert np.array_equal(a.sample_array(), b.sample_array())
    assert a.reports[-1].log_z_estimate == b.reports[-1].log_z_estimate
    assert np.array_equal(a.schedule.grids, b.schedule.grids)


@pytest.mark.parametrize("name", list(RUNS))
def test_resume_is_the_uninterrupted_run(tmp_path, name):
    kw = dict(RUNS[name], seed=3, show_report=False, device="cpu")
    full = T.PT(T.Inputs(n_rounds=4, **kw)).run()
    folder = str(tmp_path / "run")
    T.PT(T.Inputs(n_rounds=2, checkpoint=True, checkpoint_folder=folder, **kw)).run()
    assert latest_checkpoint_round(folder) == 2
    assert increment_n_rounds(folder, 2) == folder
    resumed = T.pigeons(folder)
    assert resumed.round_idx == 4 and resumed.exec_folder == folder
    assert latest_checkpoint_round(folder) == 4
    _same_run(full, resumed)
    if full._ref_params is not None:
        assert float(resumed._ref_params["active"]) == 1.0
        for k in full._ref_params:
            assert torch.equal(full._ref_params[k], resumed._ref_params[k]), k
        assert np.array_equal(full.schedule_var.grids, resumed.schedule_var.grids)
    for k in full.exp_state or {}:
        assert torch.equal(full.exp_state[k], resumed.exp_state[k]), k
    # resuming from an earlier round than the last gives the same run again
    again = load_pt(folder, round_idx=3).run()
    _same_run(full, again)


def test_round_three_checkpoint_matches_jax(tmp_path):
    common = dict(n_chains=4, n_replicates=2, seed=5, n_rounds=3, show_report=False,
                  checkpoint=True)
    J.pigeons(target=J.toy_mvn_target(3), checkpoint_folder=str(tmp_path / "jax"), **common)
    T.pigeons(target=T.toy_mvn_target(3), checkpoint_folder=str(tmp_path / "port"),
              device="cpu", **common)
    j = np.load(os.path.join(round_folder(str(tmp_path / "jax"), 3), "checkpoint.npz"))
    t = np.load(os.path.join(round_folder(str(tmp_path / "port"), 3), "checkpoint.npz"))
    assert np.array_equal(j["chain_of"], t["chain_of"])
    assert np.array_equal(j["replica_of"], t["replica_of"])
    np.testing.assert_allclose(t["states"], j["states"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t["schedule"], j["schedule"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(t["traces"], j["traces"], rtol=1e-6, atol=1e-6)


def test_pigeons_folder_with_no_rounds_left(tmp_path):
    folder = str(tmp_path / "run")
    pt = T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_rounds=2, seed=1,
                   show_report=False, checkpoint=True, checkpoint_folder=folder, device="cpu")
    again = T.pigeons(folder)
    assert again.round_idx == 2
    assert torch.equal(again.states, pt.states)
    with pytest.raises(FileNotFoundError):
        load_pt(str(tmp_path / "nothing"))


def test_model_data_goes_to_immutables_once(tmp_path):
    target = T.logistic_regression(4096, 16, seed=0)  # X is 256 KiB
    folder = str(tmp_path / "run")
    pt = T.PT(T.Inputs(target=target, n_chains=3, n_rounds=3, seed=2, explorer=T.MALA(),
                       checkpoint=True, checkpoint_folder=folder, show_report=False,
                       device="cpu"))
    pt.run_round()
    stored = sorted(os.listdir(immutables_dir(folder)))
    x = target.log_likelihood_fn.X.numpy()
    digests = [name for name in stored
               if np.array_equal(np.load(os.path.join(immutables_dir(folder), name)), x)]
    assert len(digests) == 1
    pt.run_round()
    pt.run_round()
    assert sorted(os.listdir(immutables_dir(folder))) == stored
    metas = glob.glob(os.path.join(folder, "round=*", "checkpoint", "meta.pkl"))
    assert len(metas) == 3 and all(os.path.getsize(p) < 100_000 for p in metas)
    again = load_pt(folder, round_idx=2)
    assert isinstance(again.inputs.target.log_likelihood_fn.X, torch.Tensor)
    again.run_round()
    assert np.array_equal(pt.sample_array(), again.sample_array())


def _extract_first(x, lp):
    return x[..., :1]


def test_checkpoint_without_cloudpickle(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    folder = str(tmp_path / "run")
    common = dict(target=T.toy_mvn_target(2), n_chains=3, n_rounds=2, seed=1,
                  show_report=False, checkpoint=True, device="cpu")
    pt = T.pigeons(checkpoint_folder=folder, extractor=_extract_first, **common)
    assert latest_checkpoint_round(folder) == 2
    assert np.array_equal(load_pt(folder).sample_array(), pt.sample_array())
    lam = str(tmp_path / "lambda")
    with pytest.raises(pickle.PicklingError, match="lambda"):
        T.PT(T.Inputs(checkpoint_folder=lam, extractor=lambda x, lp: x, **common))
    assert not os.path.exists(lam)


Pair = namedtuple("Pair", "a b")


@dataclass
class Box:
    value: object
    wall_time_s: float = 0.0


class Plain:
    def __init__(self, v):
        self.v = v


def _f():
    pass


def _g():
    pass


EQUAL_CASES = {
    "arrays": (np.arange(3.0), np.arange(3.0)),
    "nan": (np.array([np.nan, 1.0]), np.array([np.nan, 1.0])),
    "tensor_vs_array": (torch.arange(3, dtype=torch.float32), np.arange(3, dtype=np.float32)),
    "nested": ({"x": [1, (2.0, "s")], "y": Pair(np.ones(2), None)},
               {"x": [1, (2.0, "s")], "y": Pair(np.ones(2), None)}),
    "float_nan": (float("nan"), float("nan")),
    "nonreproducible_field": (Box(1, wall_time_s=1.0), Box(1, wall_time_s=2.0)),
    "plain_object": (Plain(np.zeros(2)), Plain(np.zeros(2))),
    "function": (_f, _f),
}
DIFFERENT_CASES = {
    "one_bit": (np.float32([1.0]), np.nextafter(np.float32([1.0]), np.float32(2.0))),
    "dtype": (np.zeros(2, np.float32), np.zeros(2, np.float64)),
    "shape": (np.zeros(2), np.zeros(3)),
    "tensor": (torch.zeros(2), torch.ones(2)),
    "dict_keys": ({"a": 1}, {"b": 1}),
    "list_length": ([1, 2], [1]),
    "type": (1, 1.0),
    "namedtuple_field": (Pair(1, 2), Pair(1, 3)),
    "plain_object": (Plain(1), Plain(2)),
    "function": (_f, _g),
}


@pytest.mark.parametrize("case", list(EQUAL_CASES))
def test_recursive_equal_equal(case):
    assert recursive_equal(*EQUAL_CASES[case]) == []


@pytest.mark.parametrize("case", list(DIFFERENT_CASES))
def test_recursive_equal_different(case):
    assert recursive_equal(*DIFFERENT_CASES[case]) != []


def test_recursive_equal_names_the_path():
    a = {"reduced": Pair(np.zeros(2), 1), "round_idx": 3}
    b = {"reduced": Pair(np.ones(2), 1), "round_idx": 3}
    assert recursive_equal(a, b) == ["['reduced'].a"]


def test_corrupted_states_are_flagged(tmp_path):
    folder = str(tmp_path / "run")
    T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_rounds=2, seed=1, show_report=False,
              checkpoint=True, checkpoint_folder=folder, device="cpu")
    copy = str(tmp_path / "copy")
    shutil.copytree(folder, copy)
    check_checkpoint_folders(round_folder(folder, 2), round_folder(copy, 2),
                             immutables_dir(folder), immutables_dir(copy))
    path = os.path.join(round_folder(copy, 2), "checkpoint.npz")
    data = dict(np.load(path))
    data["states"] = data["states"] + 1.0
    np.savez(path, **data)
    with pytest.raises(ParallelismInvarianceError, match="states"):
        check_checkpoint_folders(round_folder(folder, 2), round_folder(copy, 2),
                                 immutables_dir(folder), immutables_dir(copy))


def test_checked_round_runs_the_serial_check_in_a_child(tmp_path):
    folder = str(tmp_path / "run")
    pt = T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_rounds=3, checked_round=2,
                   seed=1, show_report=False, checkpoint=True, checkpoint_folder=folder,
                   device="cpu")
    assert pt.round_idx == 3
    child = pt.serial_check
    assert child.exec_folder == os.path.join(folder, "serial_check")
    assert child.wall_time_s > 0 and latest_checkpoint_round(child.exec_folder) == 2
    with open(os.path.join(child.exec_folder, "info", "stdout.txt")) as f:
        assert "child process: 2 rounds on cpu" in f.read()
    assert torch.equal(child.load().states, load_pt(folder, round_idx=2).states)


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(checked_round=2), "activate checkpoint"),
        (dict(checked_round=5, checkpoint=True), r"\[1, n_rounds\]"),
        (dict(checked_round=2, checkpoint=True, n_replicates=2), "n_replicates"),
        (dict(record=("traces", "disk")), "disk recorder"),
    ],
    ids=["needs_checkpoint", "in_range", "one_ladder", "disk_needs_checkpoint"],
)
def test_preflight_refuses(tmp_path, kw, match):
    with pytest.raises(ValueError, match=match):
        T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_rounds=3, seed=1,
                  show_report=False, device="cpu", checkpoint_folder=str(tmp_path / "run"),
                  **kw)


def test_pigeons_on_a_child_process(tmp_path):
    folder = str(tmp_path / "child")
    result = T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_rounds=2, seed=1,
                       show_report=False, device="cpu", on=T.ChildProcess(exec_folder=folder))
    assert isinstance(result, T.Result) and result.exec_folder == folder
    here = T.pigeons(target=T.toy_mvn_target(2), n_chains=3, n_rounds=2, seed=1,
                     show_report=False, device="cpu")
    there = result.load()
    assert there.round_idx == 2 and torch.equal(there.states, here.states)

    # every JAX back end is ported (ROADMAP item 16): as the JAX entry point,
    # pigeons(on=...) hands any back end's submit the run's Inputs
    class Cluster:
        def submit(self, inputs):
            return ("submitted", inputs.n_chains)

    assert T.pigeons(target=T.toy_mvn_target(2), device="cpu", on=Cluster()) == ("submitted", 10)
