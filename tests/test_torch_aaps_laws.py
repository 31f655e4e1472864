"""The law of the port's AAPS: ``tests/test_gradient_explorers.py::test_aaps_moments``
with the JAX test's bounds, on the CPU.

The JAX test runs 9 rounds of one ladder, whose last round gives 512
target-chain samples; here 5 rounds of 16 ladders give as many, in a
sixteenth of the scans (an AAPS scan on the CPU costs about as much for 64
lanes as for 4: its leapfrogs are set by the longest segment).
"""

import numpy as np
import pytest
import torch

import pigeons_tpu_torch as T


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_aaps_moments():
    pt = T.PT(T.Inputs(target=T.toy_mvn_target(2), n_chains=4, n_rounds=5, n_replicates=16,
                       seed=1, explorer=T.AAPS(step_size=0.3), show_report=False,
                       device="cpu")).run()
    print(f"mean {pt.mean()}, var {pt.var()}, {pt.traces.shape[0]} samples")
    assert pt.traces.shape[0] >= 512
    np.testing.assert_allclose(pt.mean(), 0.0, atol=0.06)
    np.testing.assert_allclose(pt.var(), 0.1, atol=0.05)
