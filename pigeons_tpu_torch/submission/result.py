"""Result handle over a submitted run (reference ``src/submission/Result.jl``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Result:
    """Handle to a (possibly still running) submitted run; ``load()`` rebuilds
    the finished run from its checkpoint folder (reference ``Result.jl:4-16``).
    ``wall_time_s`` is the child's wall time, when the submitter waited."""

    exec_folder: str
    job_id: Optional[str] = None
    wall_time_s: Optional[float] = None

    def load(self, device: Optional[str] = None):
        from ..checkpoint import load_pt

        return load_pt(self.exec_folder, device=device)
