"""Run configuration: the single ``Inputs`` struct.

Counterpart of ``pigeons_tpu/inputs.py`` (reference ``src/pt/Inputs.jl``),
with one field more: ``device``, ``"cuda"`` or ``"cpu"``. A run asked for on
``"cuda"`` without a card raises; it never continues on the CPU.

Every field of the JAX ``Inputs`` is taken. ``dtype`` is float32 (``None``)
or float64, given as ``torch.float64``, ``np.float64`` or ``"float64"``
(``checks.run_dtype``). The JAX package runs float64 only under JAX's x64
mode and raises without it; torch needs no mode, so the port has no such
switch: the run sets torch's default dtype for its own duration instead
(``rng.default_float``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

RECORD_DEFAULT = ("swap_acceptance_pr", "log_sum_ratio", "round_trip", "traces", "online")
RECORD_ALL = RECORD_DEFAULT + ("index_process", "energy_ac1")
KNOWN_RECORDERS = frozenset(RECORD_ALL) | {"disk"}


@dataclass
class Inputs:
    target: Any
    seed: int = 1
    n_rounds: int = 10
    n_chains: int = 10
    # independent PT ladders run as one flat batch of lanes; recorders pool
    n_replicates: int = 1
    n_chains_variational: int = 0
    reference: Optional[Any] = None
    variational: Optional[Any] = None
    checkpoint: bool = False
    checkpoint_folder: Optional[str] = None
    checked_round: int = 0
    record: Sequence[str] = field(default_factory=lambda: RECORD_DEFAULT)
    explorer: Optional[Any] = None
    extractor: Optional[Any] = None
    show_report: bool = True
    extended_traces: bool = False
    mesh: Optional[Any] = None
    profile_round: int = 0
    dtype: Optional[Any] = None
    swap_graph: Optional[Any] = None
    device: str = "cuda"

    def __post_init__(self):
        self.record = tuple(self.record)

    @property
    def n_chains_total(self) -> int:
        return self.n_chains + self.n_chains_variational
