"""Recorders: fixed-shape statistic accumulators carried through a round.

Counterpart of ``pigeons_tpu/recorders.py``. Every recorder is a tensor with
a leading ladder axis ``R`` (the JAX package vmaps over it), updated each
scan with gathers keyed by chain index; at round end the tensors go to the
host as float64 numpy and reduce to :class:`ReducedRecorders`. Additive
accumulators are ``[R, 2, ...]`` Kahan stacks of float32, as in the
reference, so the round totals are bitwise the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import f32math


def kadd(acc, delta):
    """Kahan-compensated accumulation: ``acc [R, 2, ...]`` stacks each
    ladder's running sum and its compensation; ``delta`` broadcasts against
    ``acc[:, 0]``. Returns the new stack."""
    val, comp = acc[:, 0], acc[:, 1]
    if torch.is_tensor(delta):
        # a float64 run's deltas are folded into the float32 stack, as the
        # JAX runtime folds them (its scan carry keeps one dtype)
        delta = delta.to(val.dtype)
    y = delta - comp
    t = val + y
    comp_new = (t - val) - y
    return torch.stack([t, comp_new], dim=1)


def kinit(*shape, R: int = 1, device=None):
    return torch.zeros((R, 2) + tuple(shape), dtype=torch.float32, device=device)


class Recorders(NamedTuple):
    # swap statistics, indexed by pair = lower chain, length N-1
    accept_sum: torch.Tensor
    accept_n: torch.Tensor
    lsr_fwd: torch.Tensor  # running logsumexp of forward log-ratios
    lsr_fwd_n: torch.Tensor
    lsr_bwd: torch.Tensor
    lsr_bwd_n: torch.Tensor
    # round-trip state machine per replica
    rt_state: torch.Tensor  # [R, N] in {0, 1, 2}
    rt_restarts: torch.Tensor
    rt_trips: torch.Tensor
    # online moments of extract(x, lp) at the target chain, length d+1
    online_n: torch.Tensor
    online_sum: torch.Tensor
    online_sumsq: torch.Tensor
    # energy before/after exploration, per chain: (n, sx, sy, sxx, syy, sxy)
    energy: torch.Tensor
    # explorer statistics per chain
    exp_accept_sum: torch.Tensor
    exp_accept_n: torch.Tensor
    exp_steps: torch.Tensor
    # explorer-specific per-chain stats [N, K]
    extra_sum: torch.Tensor
    extra_n: torch.Tensor


def init_recorders(n_chains: int, extract_dim: int, n_extras: int = 0,
                   R: int = 1, device=None) -> Recorders:
    n, m = n_chains, max(n_chains - 1, 1)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return Recorders(
        accept_sum=kinit(m, R=R, device=device),
        accept_n=kinit(m, R=R, device=device),
        lsr_fwd=torch.full((R, m), -float("inf"), **f32),
        lsr_fwd_n=torch.zeros((R, m), **f32),
        lsr_bwd=torch.full((R, m), -float("inf"), **f32),
        lsr_bwd_n=torch.zeros((R, m), **f32),
        rt_state=torch.zeros((R, n), **i32),
        rt_restarts=torch.zeros((R, n), **i32),
        rt_trips=torch.zeros((R, n), **i32),
        online_n=kinit(R=R, device=device),
        online_sum=kinit(extract_dim, R=R, device=device),
        online_sumsq=kinit(extract_dim, R=R, device=device),
        energy=kinit(n, 6, R=R, device=device),
        exp_accept_sum=kinit(n, R=R, device=device),
        exp_accept_n=kinit(n, R=R, device=device),
        exp_steps=kinit(n, R=R, device=device),
        extra_sum=kinit(n, n_extras, R=R, device=device),
        extra_n=kinit(n, n_extras, R=R, device=device),
    )


def update_round_trips(rec: Recorders, is_ref, is_target) -> Recorders:
    """Per-replica 3-state machine, fed (is_ref, is_target) of the pre-swap
    chain each scan."""
    s = rec.rt_state
    to1 = (s == 0) & is_ref
    to2 = (s == 1) & is_target
    trip = (s == 2) & is_ref
    new_state = torch.where(to1 | trip, 1, torch.where(to2, 2, s))
    return rec._replace(
        rt_state=new_state.to(rec.rt_state.dtype),
        rt_restarts=rec.rt_restarts + to2.to(rec.rt_restarts.dtype),
        rt_trips=rec.rt_trips + trip.to(rec.rt_trips.dtype),
    )


def update_logsum(lse, n, value, active):
    """Streaming logsumexp, masked: ``jnp.logaddexp`` evaluated as XLA does."""
    new_lse = f32math.logaddexp(lse, value.to(lse.dtype))
    return torch.where(active, new_lse, lse), n + active.to(n.dtype)


class ReducedRecorders(NamedTuple):
    """Host-side (numpy, float64) snapshot of one round's recorders."""

    accept_mean: np.ndarray  # [N-1]
    accept_n: np.ndarray
    lsr_fwd: np.ndarray
    lsr_fwd_n: np.ndarray
    lsr_bwd: np.ndarray
    lsr_bwd_n: np.ndarray
    n_tempered_restarts: int
    n_round_trips: int
    online_n: float
    online_mean: np.ndarray  # [d+1] (last entry: log density)
    online_var: np.ndarray
    energy_ac1: np.ndarray  # [N]
    exp_accept: np.ndarray  # [N]
    exp_steps: np.ndarray  # [N]
    extra_mean: np.ndarray  # [N, K]
    extra_n: np.ndarray  # [N, K]


def merge_replicates(host: Recorders) -> Recorders:
    """Merge the leading ladder axis of host (float64 numpy) recorders: sums,
    except logaddexp for the streaming logsumexps and the first ladder's
    round-trip machine state."""
    return host._replace(
        accept_sum=host.accept_sum.sum(0),
        accept_n=host.accept_n.sum(0),
        lsr_fwd=np.logaddexp.reduce(host.lsr_fwd, axis=0),
        lsr_fwd_n=host.lsr_fwd_n.sum(0),
        lsr_bwd=np.logaddexp.reduce(host.lsr_bwd, axis=0),
        lsr_bwd_n=host.lsr_bwd_n.sum(0),
        rt_state=host.rt_state[0],
        rt_restarts=host.rt_restarts.sum(0),
        rt_trips=host.rt_trips.sum(0),
        online_n=host.online_n.sum(0),
        online_sum=host.online_sum.sum(0),
        online_sumsq=host.online_sumsq.sum(0),
        energy=host.energy.sum(0),
        exp_accept_sum=host.exp_accept_sum.sum(0),
        exp_accept_n=host.exp_accept_n.sum(0),
        exp_steps=host.exp_steps.sum(0),
        extra_sum=host.extra_sum.sum(0),
        extra_n=host.extra_n.sum(0),
    )


_KAHAN_FIELDS = (
    "accept_sum", "accept_n", "online_n", "online_sum", "online_sumsq",
    "energy", "exp_accept_sum", "exp_accept_n", "exp_steps", "extra_sum",
    "extra_n",
)


def reduce_recorders(rec: Recorders, n_replicates: int = 1) -> ReducedRecorders:
    """Host reduction. ``rec`` carries the ladder axis; with one ladder it is
    dropped, as the JAX package's single-ladder recorders have none."""
    host = Recorders(*(t.detach().cpu().numpy().astype(np.float64) for t in rec))
    # resolve compensated stacks to f64 values: true sum = sum - compensation
    host = host._replace(
        **{f: getattr(host, f)[:, 0] - getattr(host, f)[:, 1] for f in _KAHAN_FIELDS}
    )
    if n_replicates > 1:
        host = merge_replicates(host)
    else:
        host = Recorders(*(a[0] for a in host))
    with np.errstate(invalid="ignore", divide="ignore"):
        accept_mean = np.where(host.accept_n > 0, host.accept_sum / np.maximum(host.accept_n, 1), np.nan)
        n = host.online_n
        mean = host.online_sum / max(n, 1.0)
        var = host.online_sumsq / max(n, 1.0) - mean**2
        var = np.maximum(var, 0.0) * (n / max(n - 1.0, 1.0))
        en = host.energy
        cnt = np.maximum(en[:, 0], 1.0)
        mx, my = en[:, 1] / cnt, en[:, 2] / cnt
        vx = en[:, 3] / cnt - mx**2
        vy = en[:, 4] / cnt - my**2
        cxy = en[:, 5] / cnt - mx * my
        ac1 = np.where((vx > 0) & (vy > 0), cxy / np.sqrt(np.maximum(vx * vy, 1e-300)), np.nan)
        exp_accept = np.where(host.exp_accept_n > 0, host.exp_accept_sum / np.maximum(host.exp_accept_n, 1), np.nan)
        extra_mean = np.where(host.extra_n > 0, host.extra_sum / np.maximum(host.extra_n, 1), np.nan)
    return ReducedRecorders(
        accept_mean=accept_mean,
        accept_n=host.accept_n,
        lsr_fwd=host.lsr_fwd,
        lsr_fwd_n=host.lsr_fwd_n,
        lsr_bwd=host.lsr_bwd,
        lsr_bwd_n=host.lsr_bwd_n,
        n_tempered_restarts=int(host.rt_restarts.sum()),
        n_round_trips=int(host.rt_trips.sum()),
        online_n=float(n),
        online_mean=mean,
        online_var=var,
        energy_ac1=ac1,
        exp_accept=exp_accept,
        exp_steps=host.exp_steps,
        extra_mean=extra_mean,
        extra_n=host.extra_n,
    )
