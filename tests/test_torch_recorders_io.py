"""The port's extended traces, index process, disk recorder, profile hook and
index-process plot, on the CPU.

The index process (the chain of each replica before each scan's swap) must
be the JAX package's bit for bit, for one ladder and for three, in its
shape ``[n_scans, (R,)? N]``; the extended traces are within 1e-6 of its
(the iid ``ToyExplorer``'s states: XLA's ``rsqrt`` may be 2 ulp off
torch's).
"""

import json
import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

import pigeons_tpu as J  # noqa: E402
import pigeons_tpu_torch as T  # noqa: E402
from pigeons_tpu_torch.checkpoint import process_sample  # noqa: E402
from pigeons_tpu_torch.inputs import RECORD_DEFAULT  # noqa: E402
from pigeons_tpu_torch.plots import plot_index_process  # noqa: E402


def run(tmp_path, **kw):
    base = dict(target=T.toy_mvn_target(2), n_chains=4, n_rounds=4, seed=1, show_report=False,
                checkpoint=True, checkpoint_folder=str(tmp_path / "run"), device="cpu")
    base.update(kw)
    return T.pigeons(**base)


def test_extended_traces(tmp_path):
    pt = run(tmp_path, extended_traces=True)
    ext = pt.extended_sample_array()
    assert ext.shape == (16, 4, 3)
    # the target chain's column is the pooled target trace
    np.testing.assert_array_equal(ext[:, 3, :], pt.sample_array())


@pytest.mark.parametrize("R", [1, 3])
def test_index_process_and_extended_traces_match_jax(R):
    kw = dict(n_chains=4, n_rounds=3, seed=2, n_replicates=R, show_report=False,
              record=RECORD_DEFAULT + ("index_process",), extended_traces=True)
    j = J.pigeons(target=J.toy_mvn_target(3), **kw)
    t = T.pigeons(target=T.toy_mvn_target(3), device="cpu", **kw)
    assert t.index_process.shape == np.asarray(j.index_process).shape
    assert np.array_equal(t.index_process, np.asarray(j.index_process))
    np.testing.assert_allclose(t.extended_traces, np.asarray(j.extended_traces), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t.extended_sample_array(), j.extended_sample_array(), rtol=1e-6,
                               atol=1e-6)


def test_disk_recorder_and_process_sample(tmp_path):
    pt = run(tmp_path, record=RECORD_DEFAULT + ("disk",))
    rows = list(process_sample(pt.exec_folder))
    assert len(rows) == 2 + 4 + 8 + 16
    last = np.stack([r[2] for r in rows if r[0] == 4])
    np.testing.assert_array_equal(last, pt.sample_array())
    assert [r[1] for r in rows if r[0] == 3] == list(range(8))
    assert len(list(process_sample(pt.exec_folder, round_idx=3))) == 8


def test_disk_recorder_alone_records_samples(tmp_path):
    """``disk`` without ``traces`` still records the target chain's samples,
    as in the JAX package."""
    pt = run(tmp_path, n_rounds=2, record=("online", "disk"))
    rows = list(process_sample(pt.exec_folder, round_idx=2))
    np.testing.assert_array_equal(np.stack([r[2] for r in rows]), pt.sample_array())


def test_profile_round_writes_a_trace(tmp_path):
    pt = run(tmp_path, n_rounds=2, profile_round=2, explorer=T.SliceSamplerCUDA(n_passes=1))
    assert not os.path.exists(os.path.join(pt.exec_folder, "profile", "round=1"))
    path = os.path.join(pt.exec_folder, "profile", "round=2", "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    # the kernel's wrapper names its launch (its twin, on the CPU)
    assert "banded_slice_sweep" in names


def test_plot_index_process(tmp_path):
    pt = run(tmp_path, n_rounds=2, n_replicates=2, record=RECORD_DEFAULT + ("index_process",))
    assert pt.index_process.shape == (4, 2, 4)
    ax = plot_index_process(pt)
    assert len(ax.lines) == 4
