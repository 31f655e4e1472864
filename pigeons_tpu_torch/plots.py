"""Diagnostic plots (reference ``src/pt/plots.jl`` RecipesBase recipes:
index process and local communication barrier).

The same code as ``pigeons_tpu/plots.py`` (the port keeps its own copy because
importing any ``pigeons_tpu`` module imports JAX); matplotlib is imported
inside the functions."""

from __future__ import annotations

import numpy as np


def plot_index_process(pt, ax=None, max_replicas: int = 10):
    """Chain index of each replica over the last round's scans
    (reference ``plots.jl:10-24``); requires ``record=('index_process', ...)``."""
    import matplotlib.pyplot as plt

    if getattr(pt, "index_process", None) is None:
        raise RuntimeError("run with record including 'index_process'")
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 4))
    ip = pt.index_process  # [n_scans, (R,)? N]: chain of each replica
    if ip.ndim == 3:
        ip = ip[:, 0]  # the first ladder
    n_scans, n = ip.shape
    # plot the trajectory of each replica through chain space
    for r in range(min(n, max_replicas)):
        ax.plot(np.arange(n_scans), ip[:, r], lw=1, alpha=0.8)
    ax.set_xlabel("scan")
    ax.set_ylabel("chain index")
    ax.set_title("index process")
    return ax


def plot_local_barrier(pt, ax=None, n_points: int = 200):
    """Local communication barrier lambda(beta)
    (reference ``plots.jl:26-39``)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    betas = np.linspace(0.0, 1.0, n_points)
    ax.plot(betas, pt.barriers.local_barrier(betas), label="fixed leg")
    if pt.barriers_var is not None:
        ax.plot(betas, pt.barriers_var.local_barrier(betas), label="variational leg")
        ax.legend()
    ax.set_xlabel("beta")
    ax.set_ylabel("local barrier lambda(beta)")
    ax.set_title("local communication barrier")
    return ax


def plot_cumulative_barrier(pt, ax=None, n_points: int = 200):
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4))
    betas = np.linspace(0.0, 1.0, n_points)
    ax.plot(betas, pt.barriers.cumulative_barrier(betas), label="fixed leg")
    if pt.barriers_var is not None:
        ax.plot(betas, pt.barriers_var.cumulative_barrier(betas), label="variational leg")
        ax.legend()
    # schedule grid points on the curve
    grids = pt.schedule.grids
    ax.plot(grids, pt.barriers.cumulative_barrier(grids), "o", ms=4)
    ax.set_xlabel("beta")
    ax.set_ylabel("cumulative barrier Lambda(beta)")
    ax.set_title(f"global barrier = {pt.global_barrier:.3f}")
    return ax
