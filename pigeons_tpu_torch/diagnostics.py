"""Posterior diagnostics: ESS, split-R-hat, summaries, report tables.

Plays the role of the reference's MCMCChains extension
(``ext/PigeonsMCMCChainsExt``: ``Chains(pt)`` + downstream summaries) and the
report DataFrames (``src/pt/report.jl:119-141``).

The same numpy and pandas code as ``pigeons_tpu/diagnostics.py``: the port
keeps its own copy because importing any ``pigeons_tpu`` module imports JAX.
"""

from __future__ import annotations

import numpy as np


def ess(x: np.ndarray) -> float:
    """Effective sample size of a 1-d chain via the initial-monotone-positive
    -sequence estimator (Geyer 1992)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    if n < 4:
        return float(n)
    x = x - x.mean()
    var = x.var()
    if var == 0:
        return float(n)
    acf = np.correlate(x, x, mode="full")[n - 1 :] / (var * n)
    # pair sums Gamma_k = rho_{2k} + rho_{2k+1}; truncate at first negative,
    # enforce monotone decrease
    gamma = acf[0:-1:2][: (n - 1) // 2] + acf[1::2][: (n - 1) // 2]
    tau = -1.0 + 2.0 * acf[0]
    running_min = np.inf
    for g in gamma:
        if g < 0:
            break
        running_min = min(running_min, g)
        tau += 2.0 * running_min
    return float(n / max(tau, 1.0 / n))


def split_rhat(chains: np.ndarray) -> float:
    """Split-R-hat over [n_chains, n_samples] (Gelman et al. BDA3)."""
    chains = np.asarray(chains, dtype=np.float64)
    m, n = chains.shape
    half = n // 2
    splits = np.concatenate([chains[:, :half], chains[:, half : 2 * half]], axis=0)
    m2, n2 = splits.shape
    means = splits.mean(axis=1)
    w = splits.var(axis=1, ddof=1).mean()
    b = n2 * means.var(ddof=1)
    var_plus = (n2 - 1) / n2 * w + b / n2
    return float(np.sqrt(var_plus / w)) if w > 0 else 1.0


def summary(pt, names=None) -> "pandas.DataFrame":
    """Posterior summary table over the last-round target samples."""
    import pandas as pd

    samples = pt.sample_array()  # [iters, d+1]
    d = samples.shape[1] - 1
    target = pt.inputs.target
    if names is None:
        if hasattr(target, "sample_names"):
            names = target.sample_names()
        else:
            names = [f"x[{i}]" for i in range(d)] + ["log_density"]
    rows = []
    for j, name in enumerate(names):
        col = samples[:, j]
        rows.append(
            {
                "variable": name,
                "mean": col.mean(),
                "std": col.std(ddof=1),
                "q5": np.quantile(col, 0.05),
                "q50": np.quantile(col, 0.50),
                "q95": np.quantile(col, 0.95),
                "ess": ess(col),
            }
        )
    return pd.DataFrame(rows)


def reports_dataframe(pt) -> "pandas.DataFrame":
    """Round-by-round report as a DataFrame (reference ``report.jl:119-141``)."""
    import pandas as pd

    return pd.DataFrame([r.__dict__ for r in pt.reports])


def swap_prs_dataframe(pt) -> "pandas.DataFrame":
    """Last-round per-pair swap acceptance (reference ``shared.reports.swap_prs``)."""
    import pandas as pd

    acc = pt.reduced.accept_mean
    return pd.DataFrame(
        {
            "pair": np.arange(len(acc)),
            "mean_swap_acceptance": acc,
            "count": pt.reduced.accept_n,
        }
    )
