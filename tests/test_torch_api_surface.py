"""The port's public API held to the JAX package's: the counterpart of
``tests/test_api_surface.py``.

Every name the JAX package exports (``pigeons_tpu.__all__``) is exported by
the port, unless it stands in ``NOT_PORTED`` with the ROADMAP item that ports
it. ``Inputs`` has the JAX fields in the JAX order with the JAX defaults, and
one field of its own, ``device`` (``"cuda"``: entry points run on the card
unless the caller asks for the CPU). Every constructor and factory of both
packages takes the JAX parameters in the JAX order with the JAX defaults; the
port's own parameters come after them, each with a default, and are listed
in ``EXTENSIONS``. ``SliceSamplerPallas`` is ``SliceSamplerCUDA``: the two
constructors share their parameters and defaults, and the JAX one's
Pallas-only parameters are listed in ``PALLAS_ONLY`` with the reason.
"""

import dataclasses
import inspect

import pytest

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import submission as JS
from pigeons_tpu_torch import checks
from pigeons_tpu_torch import submission as TS

# JAX names the port does not export yet, each with the ROADMAP queue-1 item
# (ROADMAP.md section 1) that ports it: none since models/stan.py
NOT_PORTED: dict = {}
# the submission module's names: every one is ported
SUBMISSION_PORTED = ["ChildProcess", "MultiHostLauncher", "ThisProcess", "Result",
                     "ClusterSubmission", "MPISettings", "setup_mpi", "queue_status",
                     "queue_ncpus_free", "kill_job", "watch"]
SUBMISSION_NOT_PORTED: dict = {}
# Inputs options the port has but refuses, with their items (checks.py)
REFUSED_OPTIONS: dict = {}
# the launcher's parameter after the JAX ones: the group's timeout
LAUNCHER_EXTENSIONS = {"timeout_s"}
# parameters the port adds after the JAX ones, all with a default: Inputs
# its device, the model factories take their data (the JAX factories close over theirs),
# the path its device description, endpoint forms and coordinate terms as
# CUDA source, CustomPath its density as CUDA source, ToyExplorer the path
# it may take from the run (the port's explorers are batched over the
# run's path)
EXTENSIONS = {
    "Inputs": {"device"},
    "InterpolatingPath": {"device", "endpoints", "sweep_endpoints", "coord_source"},
    "CustomPath": {"source"},
    "eight_schools": {"y", "sigma"}, "hierarchical_normal": {"data"},
    "logistic_regression": {"X", "y"}, "mrna_target": {"ts", "ys"},
}
DEFAULTED = {"ToyExplorer": {"path"}}  # JAX parameters the port gives a default
# SliceSamplerPallas's parameters that SliceSamplerCUDA does not take: the
# Pallas interpreter flag and the TPU kernel's tiling (VMEM block bytes, band
# and parallel block of the separable kernel), and the masks, on which the JAX
# sampler runs its XLA sampler without saying so and the port's refuses the
# target, naming SliceSampler() (ops/cuda_slice.py: check_target)
PALLAS_ONLY = {"interpret", "block_bytes", "band", "parallel_blk", "integer_mask",
               "binary_mask"}


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


def test_every_jax_name_is_exported_or_listed():
    missing = [n for n in J.__all__ if not hasattr(T, n) and n not in NOT_PORTED]
    assert not missing, f"JAX names missing from the port: {missing}"
    assert not [n for n in NOT_PORTED if hasattr(T, n)], "a listed name is exported: unlist it"
    assert set(NOT_PORTED) <= set(J.__all__)
    assert set(T.__all__) >= {n for n in J.__all__ if n not in NOT_PORTED}
    for name in [*SUBMISSION_PORTED, *SUBMISSION_NOT_PORTED]:
        assert hasattr(JS, name), name
        assert hasattr(TS, name) != (name in SUBMISSION_NOT_PORTED), name


def test_inputs_fields_and_defaults_are_jaxs():
    jf, tf = dataclasses.fields(J.Inputs), dataclasses.fields(T.Inputs)
    assert [f.name for f in tf] == [f.name for f in jf] + ["device"]
    ji, ti = J.Inputs(target=None), T.Inputs(target=None)
    for f in jf:
        assert getattr(ti, f.name) == getattr(ji, f.name), f.name
    assert ti.device == "cuda"
    for option, item in REFUSED_OPTIONS.items():
        name, value = option.split("=") if "=" in option else (option, object())
        with pytest.raises(NotImplementedError, match=item):
            checks.unsupported_options(T.Inputs(target=None, **{name: value}))


def test_constructors_take_the_jax_parameters():
    checked = 0
    for name in J.__all__:
        jo, to = getattr(J, name), getattr(T, name, None)
        if to is None or not callable(jo) or name == "SliceSamplerPallas":
            continue
        try:
            jp, tp = _params(jo), _params(to)
        except (TypeError, ValueError):
            continue
        checked += 1
        assert [p.name for p in tp[:len(jp)]] == [p.name for p in jp], name
        for j, t in zip(jp, tp):
            if j.name in DEFAULTED.get(name, ()):
                assert j.default is inspect.Parameter.empty and t.default is None, (name, j.name)
            else:
                assert t.default == j.default and t.kind == j.kind, (name, j.name)
        extra = tp[len(jp):]
        assert {p.name for p in extra} == EXTENSIONS.get(name, set()), name
        assert all(p.default is not inspect.Parameter.empty for p in extra), name
    assert checked >= 40


def test_slice_sampler_pallas_is_the_cuda_sampler():
    assert T.SliceSamplerPallas is T.SliceSamplerCUDA
    jp = {p.name: p.default for p in _params(J.SliceSamplerPallas)}
    tp = {p.name: p.default for p in _params(T.SliceSamplerPallas)}
    assert set(jp) - set(tp) == PALLAS_ONLY
    assert set(tp) <= set(jp)
    assert all(tp[k] == jp[k] for k in tp), "a shared parameter's default differs"
    sampler = T.SliceSamplerPallas()
    assert (sampler.w, sampler.p, sampler.n_passes, sampler.max_iter) == (10.0, 20, 3, 1024)


def test_reference_parity_defaults():
    """``tests/test_api_surface.py``'s defaults, on the port."""
    sig = inspect.signature(T.SliceSampler.__init__)
    assert (sig.parameters["w"].default, sig.parameters["p"].default,
            sig.parameters["n_passes"].default) == (10.0, 20, 3)
    sig = inspect.signature(T.AutoMALA.__init__)
    assert sig.parameters["base_n_refresh"].default == 3
    assert sig.parameters["exponent_n_refresh"].default == 0.35
    i = T.Inputs(target=None)
    assert (i.seed, i.n_rounds, i.n_chains) == (1, 10, 10)


@pytest.mark.parametrize("name", ["ThisProcess", "MultiHostLauncher"])
def test_launchers_take_the_jax_parameters(name):
    """The multi-process launcher and ThisProcess take the JAX parameters in
    the JAX order with the JAX defaults, the port's own after them."""
    jp, tp = _params(getattr(JS, name)), _params(getattr(TS, name))
    assert [(p.name, p.default) for p in tp[:len(jp)]] == [(p.name, p.default) for p in jp]
    extra = {p.name for p in tp[len(jp):]}
    assert extra == (LAUNCHER_EXTENSIONS if name == "MultiHostLauncher" else set())
    assert getattr(T, name) is getattr(TS, name)
