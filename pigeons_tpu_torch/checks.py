"""Argument validation before a run, and the check of a run against its
serial re-execution in a fresh process.

Counterpart of ``pigeons_tpu/checks.py`` (reference ``src/pt/checks.jl``),
plus one check the port needs: every option of ``Inputs`` that the port does
not implement yet raises ``NotImplementedError`` naming the ROADMAP item that
brings it, rather than being ignored.

``checked_round``: the run re-executes itself from scratch, serially, in a
``ChildProcess`` up to that round and compares every checkpoint artifact of
the round with :func:`recursive_equal`: each array of ``checkpoint.npz``
bitwise and every entry of the pickled ``meta.pkl`` structurally, so that
new run state cannot escape the check. Diagnostics that legitimately differ
between the two (wall time, peak device memory, folder paths) are left out,
as the reference's ``NonReproducible`` wrapper leaves them out. A
cross-process divergence (state that depends on the process, the import
order or a cache) shows here; an in-process re-run could not see it.
"""

from __future__ import annotations

import dataclasses
import os
import types

import numpy as np
import torch

from .inputs import KNOWN_RECORDERS

# option -> (is it set?, ROADMAP item that ports it)
_NOT_YET = (
    ("dtype=float64", lambda i: i.dtype is not None and str(i.dtype).endswith("float64"),
     "queue 1, item 6c (float64 runs)"),
)

# meta entries and fields that legitimately differ between a run and its
# serial re-execution (recorders/recorder.jl:118-142 of the reference)
NONREPRODUCIBLE_META = {"inputs", "reports"}
NONREPRODUCIBLE_FIELDS = {"wall_time_s", "peak_memory_bytes", "checkpoint_folder", "exec_folder"}


class ParallelismInvarianceError(AssertionError):
    pass


def unsupported_options(inputs) -> None:
    for name, is_set, item in _NOT_YET:
        if is_set(inputs):
            raise NotImplementedError(
                f"Inputs.{name} is not ported to pigeons_tpu_torch yet (ROADMAP {item})"
            )
    if inputs.dtype is not None and not str(inputs.dtype).endswith("float32"):
        raise ValueError(f"unsupported Inputs.dtype {inputs.dtype!r}")


def check_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Inputs.device='cuda' but torch sees no CUDA device; pass device='cpu' "
            "to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Inputs.device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def preflight_checks(inputs) -> None:
    """Argument validation (reference ``checks.jl:1-30``)."""
    if inputs.n_chains < 0 or inputs.n_chains_variational < 0:
        raise ValueError("chain counts must be nonnegative")
    if inputs.n_chains + inputs.n_chains_variational < 1:
        raise ValueError("need at least one chain")
    if inputs.n_rounds < 0:
        raise ValueError("n_rounds must be nonnegative")
    if inputs.n_replicates < 1:
        raise ValueError("n_replicates must be at least 1")
    if inputs.checked_round and not 0 < inputs.checked_round <= inputs.n_rounds:
        raise ValueError("checked_round must lie in [1, n_rounds]")
    if inputs.checked_round and not inputs.checkpoint:
        # the comparison is over checkpoint files (checks.jl:14-16)
        raise ValueError("activate checkpoint when performing checks")
    if inputs.checked_round and inputs.n_replicates > 1:
        raise ValueError("checked_round with n_replicates > 1 is not supported")
    if "disk" in inputs.record and not inputs.checkpoint:
        raise ValueError("activate checkpoint when using the disk recorder")
    unknown = set(inputs.record) - KNOWN_RECORDERS
    if unknown:
        raise ValueError(
            f"unknown recorder name(s) {sorted(unknown)}; known recorders: "
            f"{sorted(KNOWN_RECORDERS)}"
        )
    unsupported_options(inputs)


def recursive_equal(a, b, path: str = "", failures=None) -> list:
    """Structural deep comparison; returns the list of differing paths
    (reference ``checks.jl:110-195``). Tensors are moved to the host and
    compared as arrays; arrays compare bitwise, with NaNs equal; callables
    by qualified name (closures are code, not data)."""
    if failures is None:
        failures = []

    def fail():
        failures.append(path or "<root>")
        return failures

    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    if isinstance(b, torch.Tensor):
        b = b.detach().cpu().numpy()
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a_arr, b_arr = np.asarray(a), np.asarray(b)
        if a_arr.shape != b_arr.shape or a_arr.dtype != b_arr.dtype:
            return fail()
        if a_arr.dtype == object:
            if a_arr.tolist() != b_arr.tolist():
                return fail()
            return failures
        if not np.array_equal(a_arr, b_arr, equal_nan=a_arr.dtype.kind == "f"):
            return fail()
        return failures
    if isinstance(a, types.FunctionType) or isinstance(b, types.FunctionType):
        na = getattr(a, "__qualname__", repr(a))
        nb = getattr(b, "__qualname__", repr(b))
        return fail() if na != nb else failures
    if type(a) is not type(b):
        return fail()
    if hasattr(a, "_fields"):  # namedtuple
        for f in a._fields:
            if f not in NONREPRODUCIBLE_FIELDS:
                recursive_equal(getattr(a, f), getattr(b, f), f"{path}.{f}", failures)
        return failures
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            if f.name not in NONREPRODUCIBLE_FIELDS:
                recursive_equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}",
                                failures)
        return failures
    if isinstance(a, dict):
        if set(a) != set(b):
            return fail()
        for k in a:
            if k not in NONREPRODUCIBLE_FIELDS:
                recursive_equal(a[k], b[k], f"{path}[{k!r}]", failures)
        return failures
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return fail()
        for i, (x, y) in enumerate(zip(a, b)):
            recursive_equal(x, y, f"{path}[{i}]", failures)
        return failures
    if isinstance(a, float):
        return failures if a == b or (np.isnan(a) and np.isnan(b)) else fail()
    if type(a).__eq__ is object.__eq__ and hasattr(a, "__dict__") and not isinstance(a, type):
        # a plain object with identity equality (an interpolator): compare
        # its attributes instead
        return recursive_equal(vars(a), vars(b), path, failures)
    try:
        if a != b:
            return fail()
    except Exception:
        failures.append(f"{path} (incomparable {type(a).__name__})")
    return failures


def compare_checkpoint_folders(folder_a: str, folder_b: str, immutables_a: str,
                               immutables_b: str) -> list:
    """Compare every checkpoint artifact of two round folders: each
    ``checkpoint.npz`` array bitwise and the ``meta.pkl`` entries
    structurally (reference ``compare_checkpoints``, ``checks.jl:80-86``).
    Returns the differing paths."""
    from .checkpoint import load_object

    failures = []
    npz_a = np.load(os.path.join(folder_a, "checkpoint.npz"))
    npz_b = np.load(os.path.join(folder_b, "checkpoint.npz"))
    if set(npz_a.files) != set(npz_b.files):
        failures.append(
            f"checkpoint.npz keys differ: {sorted(npz_a.files)} vs {sorted(npz_b.files)}"
        )
    for k in sorted(set(npz_a.files) & set(npz_b.files)):
        recursive_equal(npz_a[k], npz_b[k], f"npz:{k}", failures)
    meta_a = load_object(os.path.join(folder_a, "meta.pkl"), immutables_a)
    meta_b = load_object(os.path.join(folder_b, "meta.pkl"), immutables_b)
    for k in sorted(set(meta_a) | set(meta_b)):
        if k in NONREPRODUCIBLE_META:
            continue
        if k not in meta_a or k not in meta_b:
            failures.append(f"meta:{k} missing on one side")
            continue
        recursive_equal(meta_a[k], meta_b[k], f"meta:{k}", failures)
    return failures


def check_checkpoint_folders(folder_a: str, folder_b: str, immutables_a: str,
                             immutables_b: str) -> None:
    """:func:`compare_checkpoint_folders`, raising
    :class:`ParallelismInvarianceError` naming what differs."""
    failures = compare_checkpoint_folders(folder_a, folder_b, immutables_a, immutables_b)
    if failures:
        raise ParallelismInvarianceError(
            "the run differs from its serial cross-process re-execution in: "
            + ", ".join(failures[:20])
        )


def check_against_serial(pt):
    """Re-run ``pt``'s Inputs serially in a fresh OS process
    (:class:`~.submission.ChildProcess`, on the same ``Inputs.device``, with
    no mesh) up to ``pt``'s round, into ``<exec_folder>/serial_check``, and
    require every checkpoint artifact of that round to agree (reference
    ``checks.jl:36-78``). Returns the child's :class:`~.submission.Result`.
    Under a mesh every rank calls this: rank 0 runs the child and compares
    (the checkpoint it wrote holds every rank's state), and every rank
    returns its result or raises its error."""
    from .checkpoint import immutables_dir, round_folder
    from .submission import ChildProcess

    outcome = None
    if pt.rank == 0:
        inputs = dataclasses.replace(
            pt.inputs,
            mesh=None,
            n_rounds=pt.round_idx,
            checkpoint=True,
            checked_round=0,  # otherwise the child checks itself (checks.jl:69)
            profile_round=0,
            show_report=False,
        )
        child = os.path.join(pt.exec_folder, "serial_check")
        try:
            result = ChildProcess(exec_folder=child).submit(inputs)
            check_checkpoint_folders(
                round_folder(pt.exec_folder, pt.round_idx), round_folder(child, pt.round_idx),
                immutables_dir(pt.exec_folder), immutables_dir(child),
            )
            outcome = (result, None)
        except Exception as e:  # every rank raises it, not rank 0 alone
            if pt.mesh is None:
                raise
            outcome = (None, e)
    if pt.mesh is not None:
        outcome = pt.mesh.broadcast_object(outcome)
    result, error = outcome
    if error is not None:
        raise error
    return result
