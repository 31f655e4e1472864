"""Kernel K2's kept terms, compiled for the host and run against the twin: the
rest of ``tests/test_torch_csrc_host.py``, which has the helpers and says how
the sources are built and what is compared (everything bitwise). Here: the
terms a lane keeps from query to query under a variational reference
(``RefTerms``: its reference's; ``KeptSums``: the funnel's and banana's
target terms, under the fixed reference too), for every group size and the
launcher's choice.
"""

import functools

import numpy as np
import pytest
import torch

from pigeons_tpu_torch.ops import cuda_slice
from test_torch_csrc_host import (  # noqa: F401  (host_libraries is a fixture)
    BAYESIAN,
    _assert_bitwise,
    _bayesian_inputs,
    _inputs,
    _k2,
    _reference_params,
    _variational_path,
    host_libraries,
)


KEPT = {"funnel": 10, "banana": 4, "eight_schools": 10, "eight_schools_centered": 10,
        "mrna": 5, "unid": 2}


@functools.lru_cache(maxsize=None)
def _twin_case(name, active):
    """A path's inputs, lanes of both legs and the twin's two passes over
    them (shared by the tests of each group)."""
    d = KEPT[name]
    path = _variational_path(name, d)
    B = 12
    if name in BAYESIAN:
        x, betas, seeds = _bayesian_inputs(BAYESIAN[name](), B, 5)
        x[1:4] = x[0]  # no far-out lanes here: they shrink until max_iter
    else:
        x, betas, seeds = _inputs(B, d, 5, scale=1.0)
    isvar = torch.from_numpy((np.arange(B) % 2 == 0).astype(np.float32))
    params = _reference_params(d, 6, active)
    counts = torch.zeros(6, dtype=torch.int64)
    want = cuda_slice.sweep_reference(x, betas, seeds, path, False, n_passes=2, isvar=isvar,
                                      ref_params=params, phase_counts=counts)
    return path, x, betas, seeds, isvar, params, want, counts


# every group and the launcher's choice (0); unid, one target term, is built
# for one thread a lane only, whatever the reference's terms add
@pytest.mark.parametrize("active", [0.0, 1.0])
@pytest.mark.parametrize("name,group", [(name, group) for name in sorted(KEPT) if name != "unid"
                                        for group in (0, 1, 8, 16, 32)]
                         + [("unid", 0), ("unid", 1)])
def test_k2_kept_terms_match_twin(host_libraries, name, active, group):
    """The terms a lane keeps from query to query: the reference's under a
    variational reference (RefTerms: on the funnel and banana paths with their
    target's, KeptSums; on eight schools' terms; on centred eight schools'
    and mRNA's ManyTerms), and the funnel's and banana's fixed reference and
    target terms. Lanes of both legs, the reference active or not yet, two
    passes: queries of coordinate 0 (which prepare reads) and of the others,
    shrink candidates accepted and rejected; bitwise the twin, which
    recomputes every term for every query."""
    path, x, betas, seeds, isvar, params, want, counts = _twin_case(name, active)
    got = _k2(host_libraries["sweep_slice"], x, betas, seeds, path, False, 2, group, isvar, params)
    _assert_bitwise(got, want, ("x", "lp", "stats"))
    moved = want[0] != x
    assert moved[:, 0].any() and moved[:, 1:].any()
    assert float(want[2][0].sum()) < float(counts[3])  # fewer accepted than shrink candidates
