"""Argument validation before a run.

Counterpart of ``pigeons_tpu/checks.py:preflight_checks`` (reference
``src/pt/checks.jl:1-30``), plus one check the port needs: every option of
``Inputs`` that the port does not implement yet raises
``NotImplementedError`` naming the ROADMAP item that brings it, rather than
being ignored.
"""

from __future__ import annotations

import torch

from .inputs import KNOWN_RECORDERS

# option -> (is it set?, ROADMAP item that ports it)
_NOT_YET = (
    ("mesh", lambda i: i.mesh is not None, "queue 1, item 15 (multi-GPU)"),
    ("checkpoint", lambda i: bool(i.checkpoint) or i.checkpoint_folder is not None,
     "queue 1, item 13 (checkpointing)"),
    ("checked_round", lambda i: bool(i.checked_round), "queue 1, item 13 (checks)"),
    ("extended_traces", lambda i: bool(i.extended_traces), "queue 1, item 13 (checks)"),
    ("record=index_process/disk",
     lambda i: bool({"index_process", "disk"} & set(i.record)), "queue 1, item 13 (checks)"),
    ("dtype=float64", lambda i: i.dtype is not None and str(i.dtype).endswith("float64"),
     "queue 1, item 6c (float64 runs)"),
    ("profile_round", lambda i: bool(i.profile_round), "queue 1, item 13 (checks)"),
)


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
    unknown = set(inputs.record) - KNOWN_RECORDERS
    if unknown:
        raise ValueError(
            f"unknown recorder name(s) {sorted(unknown)}; known recorders: "
            f"{sorted(KNOWN_RECORDERS)}"
        )
    unsupported_options(inputs)
