"""Stepping-stone estimation of log normalization constants.

Reference: ``src/evidence/stepping_stone.jl`` — from the per-pair streaming
logsumexp recorders, forward estimator = sum over adjacent pairs (i, i+1) of
(logsumexp of forward log ratios - log n); backward symmetric; the returned
estimate averages the two (an unbiased sandwich for Z and 1/Z under Syed et
al. 2021 assumptions A1-2).

The same numpy code as ``pigeons_tpu/evidence.py``: the port keeps its own copy because
importing any ``pigeons_tpu`` module imports JAX.
"""

from __future__ import annotations

import numpy as np


def stepping_stone_pair_from_reduced(reduced, pair_mask=None) -> tuple[float, float]:
    """``pair_mask`` restricts the sum to a subset of adjacent pairs — used by
    2-leg PT to estimate on the variational leg only (reference
    ``evidence/stepping_stone.jl:53-67``)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        fwd = np.where(
            reduced.lsr_fwd_n > 0,
            reduced.lsr_fwd - np.log(np.maximum(reduced.lsr_fwd_n, 1)),
            0.0,
        )
        bwd = np.where(
            reduced.lsr_bwd_n > 0,
            reduced.lsr_bwd - np.log(np.maximum(reduced.lsr_bwd_n, 1)),
            0.0,
        )
        if pair_mask is not None:
            fwd = np.where(pair_mask, fwd, 0.0)
            bwd = np.where(pair_mask, bwd, 0.0)
    return float(np.sum(fwd)), float(-np.sum(bwd))


def stepping_stone_from_reduced(reduced, pair_mask=None) -> float:
    if not (np.any(reduced.lsr_fwd_n > 0) or np.any(reduced.lsr_bwd_n > 0)):
        return float("nan")  # log_sum_ratio recorder disabled (Inputs.record)
    e1, e2 = stepping_stone_pair_from_reduced(reduced, pair_mask)
    if not np.isfinite(e1):
        return e2
    if not np.isfinite(e2):
        return e1
    return 0.5 * (e1 + e2)


def stepping_stone_pair(pt) -> tuple[float, float]:
    return stepping_stone_pair_from_reduced(pt.reduced, pt._stepping_stone_pair_mask())


def stepping_stone(pt) -> float:
    return stepping_stone_from_reduced(pt.reduced, pt._stepping_stone_pair_mask())
