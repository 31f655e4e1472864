"""Kernel K2's ``BayesianModel`` densities, compiled for the host and run
against the twin: the rest of ``tests/test_torch_csrc_host.py``, which has the
helpers and says how the sources are built and what is compared (everything
bitwise). Here: each model's density for 1, 8, 16 and 32 threads per lane
(the hierarchical normal also at shapes whose rows do not fill the four
partial sums of its likelihood), and the launcher's own choice of group.
"""

import pytest
import torch

from pigeons_tpu_torch.ops import cuda_slice
from test_torch_csrc_host import (  # noqa: F401  (host_libraries is a fixture)
    BAYESIAN,
    SHORT,
    _assert_bitwise,
    _bayesian_inputs,
    _k2,
    host_libraries,
)


@pytest.mark.parametrize("group", [1, 8, 16, 32])
@pytest.mark.parametrize("name", sorted(BAYESIAN))
def test_k2_bayesian_host_build_matches_twin(host_libraries, name, group):
    """A ``BayesianModel`` density: the prior from its table, the likelihood
    from the model's data arrays, whatever the number of threads per lane."""
    model = BAYESIAN[name]()
    path = model.create_path(model.default_reference())
    x, betas, seeds = _bayesian_inputs(model, 6, len(name))
    if name == "unid" and group > 1:  # one term: built for one thread per lane only
        with pytest.raises(AssertionError, match="returned -1"):
            _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
                max_iter=SHORT)
        return
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, group,
              max_iter=SHORT)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, max_iter=SHORT)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    assert not torch.equal(got[0][0], x[0])


@pytest.mark.parametrize("name", ["hierarchical_normal", "eight_schools",
                                  "logistic_regression_40x3"])
def test_k2_launchers_group_matches_twin(host_libraries, name):
    """The launcher's own choice of threads per lane (group 0)."""
    model = BAYESIAN[name]()
    path = model.create_path(model.default_reference())
    x, betas, seeds = _bayesian_inputs(model, 5, 11)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=1, max_iter=SHORT)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 1, 0, max_iter=SHORT)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
