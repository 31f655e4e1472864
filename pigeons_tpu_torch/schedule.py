"""Annealing schedules: sorted grids on [0, 1] with pinned endpoints.

Reference semantics: ``src/schedules/Schedule.jl`` (monotone grid, endpoints 0/1,
``equally_spaced_schedule``) and ``src/schedules/discretize.jl`` (schedule ->
per-chain interpolated log potentials). Here a schedule is a float64 numpy array
held on the host; the device kernels receive it as a ``betas`` vector.

The same numpy code as ``pigeons_tpu/schedule.py``: the port keeps its own copy because
importing any ``pigeons_tpu`` module imports JAX.
"""

from __future__ import annotations

import numpy as np


class Schedule:
    """Monotone increasing grid over [0, 1], endpoints pinned at 0 and 1.

    Mirrors the validation in reference ``src/schedules/Schedule.jl:5-44``.
    """

    def __init__(self, grids):
        grids = np.asarray(grids, dtype=np.float64)
        if grids.ndim != 1:
            raise ValueError("schedule grid must be one-dimensional")
        if len(grids) == 1:
            if grids[0] != 1.0:
                raise ValueError("single-chain schedule must be [1.0]")
            self.grids = grids
            return
        if not (
            np.all(np.diff(grids) > 0)
            and grids[0] == 0.0
            and grids[-1] == 1.0
        ):
            raise ValueError(f"invalid schedule: {grids}")
        self.grids = grids

    @property
    def n_chains(self) -> int:
        return len(self.grids)

    def __repr__(self):
        return f"Schedule({np.array2string(self.grids, precision=4)})"


def equally_spaced_schedule(n_chains: int) -> Schedule:
    """Reference: ``src/schedules/Schedule.jl:36-44``."""
    if n_chains < 1:
        raise ValueError("need at least one chain")
    if n_chains == 1:
        return Schedule([1.0])
    return Schedule(np.linspace(0.0, 1.0, n_chains))
