"""Round-to-round schedule adaptation and communication-barrier estimation.

Host-side (numpy, float64): adaptation runs once per round, between device
rounds, so there is no reason to trace it — and host execution keeps it bitwise
stable across device layouts.

Reference semantics (``src/tempering/adaptation.jl``):
  * rejection rates  r_i = 1 - mean swap acceptance for pair (i, i+1), with a
    0.5 default when a pair was never observed (``adaptation.jl:103-112``);
  * cumulative barrier Lambda(beta): Fritsch-Carlson monotone cubic
    interpolation of x = schedule grid, y = [0; cumsum(r)] (``:56-65``);
  * local barrier lambda(beta) = d/dbeta Lambda(beta) (``:67-70``);
  * new schedule: normalize xt = [0; cumsum(r)] / sum(r), interpolate the old
    grid as a function of xt, evaluate on a uniform grid (inverse-CDF regrid,
    equalizing rejection across pairs); zero/duplicate intensities handled by a
    one-time 1e-6 nudge (``:74-93``).

The same numpy code as ``pigeons_tpu/adaptation.py``: the port keeps its own copy because
importing any ``pigeons_tpu`` module imports JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .schedule import Schedule


# ---------------------------------------------------------------------------
# Fritsch-Carlson monotone cubic (PCHIP) interpolation
# ---------------------------------------------------------------------------


class MonotoneCubic:
    """Fritsch-Carlson monotone piecewise-cubic Hermite interpolant.

    Tangents follow Fritsch & Carlson (1980): secant-based initialization with
    the alpha^2 + beta^2 <= 9 circle restriction, which guarantees the
    interpolant is monotone wherever the data are.
    """

    def __init__(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 1 or x.shape != y.shape or len(x) < 2:
            raise ValueError("need 1-d x, y of equal length >= 2")
        if np.any(np.diff(x) <= 0):
            raise ValueError("x must be strictly increasing")
        self.x, self.y = x, y
        h = np.diff(x)
        delta = np.diff(y) / h

        n = len(x)
        m = np.empty(n)
        # interior tangents: average of neighboring secants, zeroed across
        # sign changes / flat segments
        m[0] = delta[0]
        m[-1] = delta[-1]
        for i in range(1, n - 1):
            if delta[i - 1] * delta[i] <= 0.0:
                m[i] = 0.0
            else:
                m[i] = 0.5 * (delta[i - 1] + delta[i])
        # Fritsch-Carlson restriction to the monotonicity region
        for i in range(n - 1):
            if delta[i] == 0.0:
                m[i] = 0.0
                m[i + 1] = 0.0
            else:
                a = m[i] / delta[i]
                b = m[i + 1] / delta[i]
                r = np.hypot(a, b)
                if r > 3.0:
                    t = 3.0 / r
                    m[i] = t * a * delta[i]
                    m[i + 1] = t * b * delta[i]
        self.m = m
        self.h = h
        self.delta = delta

    def _segment(self, q):
        idx = np.searchsorted(self.x, q, side="right") - 1
        return np.clip(idx, 0, len(self.x) - 2)

    def __call__(self, q):
        q = np.asarray(q, dtype=np.float64)
        i = self._segment(q)
        h = self.h[i]
        t = (q - self.x[i]) / h
        t2 = t * t
        t3 = t2 * t
        h00 = 2 * t3 - 3 * t2 + 1
        h10 = t3 - 2 * t2 + t
        h01 = -2 * t3 + 3 * t2
        h11 = t3 - t2
        return (
            h00 * self.y[i]
            + h10 * h * self.m[i]
            + h01 * self.y[i + 1]
            + h11 * h * self.m[i + 1]
        )

    def derivative(self, q):
        q = np.asarray(q, dtype=np.float64)
        i = self._segment(q)
        h = self.h[i]
        t = (q - self.x[i]) / h
        t2 = t * t
        dh00 = (6 * t2 - 6 * t) / h
        dh10 = (3 * t2 - 4 * t + 1)
        dh01 = (-6 * t2 + 6 * t) / h
        dh11 = (3 * t2 - 2 * t)
        return (
            dh00 * self.y[i]
            + dh10 * self.m[i]
            + dh01 * self.y[i + 1]
            + dh11 * self.m[i + 1]
        )


# ---------------------------------------------------------------------------
# Communication barriers
# ---------------------------------------------------------------------------


@dataclass
class CommunicationBarriers:
    """Estimated barrier functions for a leg of the annealing path."""

    cumulative: MonotoneCubic  # Lambda(beta)
    global_barrier: float  # Lambda(1) = sum of rejections

    def local_barrier(self, beta):
        return self.cumulative.derivative(beta)

    def cumulative_barrier(self, beta):
        return self.cumulative(beta)


def rejections_from_acceptance(accept_mean, accept_count):
    """Per-pair rejection rates with the 0.5 default for unobserved pairs
    (reference ``adaptation.jl:103-112``)."""
    accept_mean = np.asarray(accept_mean, dtype=np.float64)
    accept_count = np.asarray(accept_count, dtype=np.float64)
    filled = np.where(accept_count > 0, accept_mean, 0.5)
    return np.clip(1.0 - filled, 0.0, 1.0)


def communication_barriers(rejections, schedule_grids) -> CommunicationBarriers:
    rejections = np.asarray(rejections, dtype=np.float64)
    grids = np.asarray(schedule_grids, dtype=np.float64)
    if len(grids) != len(rejections) + 1:
        raise ValueError("need len(schedule) == len(rejections) + 1")
    if np.any(rejections < 0):
        raise ValueError(f"bad intensities: {rejections}")
    y = np.concatenate([[0.0], np.cumsum(rejections)])
    cumulative = MonotoneCubic(grids, y)
    return CommunicationBarriers(cumulative=cumulative, global_barrier=float(y[-1]))


def optimal_schedule(rejections, old_grids, n_chains_new=None, _nudged=False) -> Schedule:
    """Inverse-CDF regrid equalizing rejection across pairs
    (reference ``adaptation.jl:74-93``)."""
    rejections = np.asarray(rejections, dtype=np.float64)
    old_grids = np.asarray(old_grids, dtype=np.float64)
    if n_chains_new is None:
        n_chains_new = len(old_grids)
    x = np.concatenate([[0.0], np.cumsum(rejections)])
    norm = x[-1]
    if norm > 0:
        x = x / norm
    if len(np.unique(x)) != len(x):
        # zero / underflowing intensities: nudge once and retry
        if _nudged:
            raise RuntimeError("nudge failed to deduplicate intensities")
        return optimal_schedule(rejections + 1e-6, old_grids, n_chains_new, True)
    generator = MonotoneCubic(x, old_grids)
    interior = np.linspace(0.0, 1.0, n_chains_new)[1:-1]
    grids = np.concatenate([[0.0], generator(interior), [1.0]])
    # numerical safety: enforce strict monotonicity before constructing Schedule
    for i in range(1, len(grids)):
        if grids[i] <= grids[i - 1]:
            grids[i] = np.nextafter(grids[i - 1], 1.0)
    return Schedule(grids)
