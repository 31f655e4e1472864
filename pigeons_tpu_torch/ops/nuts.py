"""NUTS, the No-U-Turn Sampler (multinomial variant), over the batch.

Counterpart of ``pigeons_tpu/ops/nuts.py`` (Hoffman & Gelman 2014 with
Betancourt's multinomial state selection and Stan's biased progressive
sampling across doublings; not in the reference Pigeons.jl). The trajectory
doubles until it makes a U-turn, a subtree diverges or turns inside, or the
depth reaches ``max_depth``; a doubling extends one end, chosen at random,
by ``2^depth`` leapfrogs, with the gradient carried from leaf to leaf. The
backward end is extended by the forward machine on ``(x, -v)``, so leaf
order always runs forward in the subtree's own time. A subtree's U-turns
are tested without recursion on a stack of ``max_depth`` states: with ``i``
the leaf's index from 1, the leaf starts a balanced range of ``2^m`` leaves
where ``i = 1 (mod 2^m)`` (stored in slot ``m``) and ends one where ``i = 0
(mod 2^m)`` (tested against slot ``m``). Between rounds the step size
follows ``exp(mean acceptance - target_accept)``, bounded to [1/2, 2] a
round, and the preconditioner re-estimates, in numpy on the host.

The JAX package runs the doublings as a per-lane ``lax.while_loop`` and
each subtree's leaves as a ``fori_loop`` under ``vmap``. Every lane still
going is at the same depth, so here the doubling loop is a host loop of at
most ``max_depth`` iterations with one host read each (the lanes still
going, the only ones evaluated), and inside a subtree the leaf index is a
host int: the stack's starts and ends are decided on the host, a slot holds
the leaf's state tensors, and the leaves' uniforms are drawn at once. A
lane whose subtree has stopped keeps its values, as under ``vmap``; every
``_CHECK`` leaves one host read ends the subtree once no lane goes on.

Streams as the JAX explorer derives them from a lane's key: ``split(
fold_in(key, 0), 3)`` gives the preconditioner's, the momentum's and the
tree's key; doubling ``depth`` splits ``fold_in(tree key, depth)`` three
ways into the direction's (``bernoulli``), the merge's uniform and the
subtree's key, whose leaf ``j`` draws ``uniform(fold_in(subtree key, j))``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import f32math, rng
from .base import Explorer, StepOut
from .hamiltonian import (LaneGradient, MixDiagonalPreconditioner, adapted_std_devs, lane_dot,
                          log_joint, value_and_cond_grad)
from .mala import select

_CHECK = 8  # leaves of a subtree between two reads of the lanes still going


def _uturn(x_s, v_s, x_e, v_e, precond):
    """Whether the trajectory from ``(x_s, v_s)`` to ``(x_e, v_e)`` turns, in
    the integrator's velocity form (``dx/dt = v / precond``)."""
    dx = x_e - x_s
    return (lane_dot(dx, v_s / precond) < 0.0) | (lane_dot(dx, v_e / precond) < 0.0)


class NUTS(Explorer):
    extra_names = ("nuts_accept", "tree_depth")

    def __init__(self, step_size: float = 1.0, max_depth: int = 8, preconditioner=None,
                 divergence_threshold: float = 1000.0, target_accept: float = 0.8):
        self.step_size = float(step_size)
        self.max_depth = int(max_depth)
        self.preconditioner = (
            preconditioner if preconditioner is not None else MixDiagonalPreconditioner()
        )
        self.divergence_threshold = float(divergence_threshold)
        self.target_accept = float(target_accept)

    def init_state(self, n_chains: int, dim: int, device=None):
        return {
            "step_size": torch.full((n_chains,), self.step_size, dtype=torch.float32,
                                    device=device),
            "std_devs": torch.ones((n_chains, dim), dtype=torch.float32, device=device),
        }

    def needs_online_moments(self) -> bool:
        return self.preconditioner.adapts

    def adapt(self, state, reduced, round_idx: int):
        acc_mean = reduced.extra_mean[:, 0]
        observed = np.isfinite(acc_mean)
        acc = float(np.mean(acc_mean[observed])) if observed.any() else self.target_accept
        factor = float(np.clip(math.exp(acc - self.target_accept), 0.5, 2.0))
        std_devs = state["std_devs"]
        if self.preconditioner.adapts:
            std_devs = adapted_std_devs(std_devs, reduced)
        return {"step_size": state["step_size"] * float(np.float32(factor)),
                "std_devs": std_devs}

    def _subtree(self, k_sub, c, depth, eps, precond, vg, h0):
        """Extend every lane's end ``c`` (a dict ``x, v, lp, g``) forward by
        ``2^depth`` leaves. Returns the subtree's carry: its last leaf, the
        log of its summed weights ``lsw``, its proposal ``xp, lpp``, whether
        it stopped (a U-turn inside or a divergence), its acceptance sum and
        leaves."""
        n_leaves = 1 << depth
        b = c["x"].shape[0]
        dev = c["x"].device
        e = eps[:, None]
        leaf_keys = rng.fold_in(k_sub[:, None, :], torch.arange(n_leaves, device=dev))
        log_u = f32math.log(rng.uniform(leaf_keys))  # [lanes, leaves]
        z = torch.zeros(b, dtype=torch.float32, device=dev)
        no = torch.zeros(b, dtype=torch.bool, device=dev)
        c = dict(c, lsw=torch.full((b,), -float("inf"), device=dev), xp=c["x"], lpp=c["lp"],
                 turned=no, diverged=no, acc=z, n=z)
        slots = {}
        for j in range(n_leaves):
            live = ~(c["turned"] | c["diverged"])
            v_half = c["v"] + (0.5 * e) * c["g"]
            x_n = c["x"] + e * (v_half / precond)
            lp_n, g_n = value_and_cond_grad(vg, x_n, precond)
            v_n = v_half + (0.5 * e) * g_n
            w = log_joint(lp_n, v_n) - h0
            div_n = ~torch.isfinite(w) | (w < -self.divergence_threshold)
            w_safe = torch.where(div_n, -float("inf"), w)
            lsw_new = f32math.logaddexp(c["lsw"], w_safe)
            take = log_u[:, j] < (w_safe - lsw_new)
            i = j + 1
            turn_new = no
            for m in range(1, self.max_depth + 1):
                if i % (1 << m) == 1:  # the leaf starts a range of 2^m leaves
                    slots[m] = (x_n, v_n)
                elif i % (1 << m) == 0:  # it ends one
                    turn_new = turn_new | _uturn(*slots[m], x_n, v_n, precond)
            acc_leaf = f32math.exp(torch.clamp_max(w_safe, 0.0))
            new = {"x": x_n, "v": v_n, "lp": lp_n, "g": g_n, "lsw": lsw_new,
                   "xp": select(take, x_n, c["xp"]), "lpp": torch.where(take, lp_n, c["lpp"]),
                   "turned": c["turned"] | turn_new, "diverged": c["diverged"] | div_n,
                   "acc": c["acc"] + acc_leaf, "n": c["n"] + 1.0}
            c = {k: select(live, new[k], c[k]) for k in c}
            if i % _CHECK == 0 and i < n_leaves and not bool((~(c["turned"] | c["diverged"]))
                                                             .any()):
                break  # no lane goes on: the rest of the leaves would change nothing
        return c

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        """One NUTS trajectory of every lane. ``accept_sum`` / ``accept_n``
        are the summed leaf acceptances and the leaves, ``n_steps`` the
        gradient evaluations (a leaf each and the start), and the extras
        the mean leaf acceptance (``nan`` without a leaf) and the depth."""
        B, d = xs.shape
        dev = xs.device
        if chain_params is None:
            chain_params = self.init_state(B, d, dev)
        eps = chain_params["step_size"].to(xs.dtype)
        k_prec, k_mom, k_tree = rng.split(rng.fold_in(keys, 0), 3).unbind(-2)
        precond = self.preconditioner.build(k_prec, chain_params["std_devs"])
        vg = LaneGradient(path, betas, isvar, ref_params)
        v0 = rng.normal(k_mom, (d,))
        lp0, g0 = value_and_cond_grad(vg, xs, precond)
        h0 = log_joint(lp0, v0)
        z = torch.zeros(B, dtype=torch.float32, device=dev)
        # ends carry forward-time velocities; the left end is extended on (x, -v)
        tr = {"x_l": xs, "v_l": v0, "g_l": g0, "lp_l": lp0, "x_r": xs, "v_r": v0, "g_r": g0,
              "lp_r": lp0, "x_prop": xs, "lp_prop": lp0, "lsw": z, "acc": z, "n": z,
              "depth": z}
        tr = {k: t.clone() for k, t in tr.items()}
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for depth in range(self.max_depth):
            idx = torch.nonzero(~done).squeeze(1)  # the doubling's read on the host
            if idx.numel() == 0:
                break
            s = {k: t[idx] for k, t in tr.items()}
            p = precond[idx]
            k_dir, k_take, k_sub = rng.split(rng.fold_in(k_tree[idx], depth), 3).unbind(-2)
            right = rng.bernoulli(k_dir)
            end = {"x": select(right, s["x_r"], s["x_l"]), "v": select(right, s["v_r"], -s["v_l"]),
                   "g": select(right, s["g_r"], s["g_l"]),
                   "lp": torch.where(right, s["lp_r"], s["lp_l"])}
            sub = self._subtree(k_sub, end, depth, eps[idx], p, vg.at(idx), h0[idx])
            # merge a completed subtree only (Stan: a subtree that stopped inside
            # adds no sample and ends the trajectory)
            valid = ~(sub["turned"] | sub["diverged"])
            take_pr = f32math.exp(torch.clamp_max(sub["lsw"] - s["lsw"], 0.0))
            take = valid & (rng.uniform(k_take) < take_pr)
            s["x_prop"] = select(take, sub["xp"], s["x_prop"])
            s["lp_prop"] = torch.where(take, sub["lpp"], s["lp_prop"])
            s["lsw"] = torch.where(valid, f32math.logaddexp(s["lsw"], sub["lsw"]), s["lsw"])
            for side, upd, sign in (("r", valid & right, 1.0), ("l", valid & ~right, -1.0)):
                s[f"x_{side}"] = select(upd, sub["x"], s[f"x_{side}"])
                s[f"v_{side}"] = select(upd, sign * sub["v"], s[f"v_{side}"])
                s[f"g_{side}"] = select(upd, sub["g"], s[f"g_{side}"])
                s[f"lp_{side}"] = torch.where(upd, sub["lp"], s[f"lp_{side}"])
            s["acc"] = s["acc"] + sub["acc"]
            s["n"] = s["n"] + sub["n"]
            s["depth"] = s["depth"] + 1.0
            for k, t in s.items():
                tr[k][idx] = t
            done[idx] = ~valid | _uturn(s["x_l"], s["v_l"], s["x_r"], s["v_r"], p)
        acc, n = tr["acc"], tr["n"]
        acc_mean = torch.where(n > 0, acc / n, float("nan"))
        return StepOut(tr["x_prop"], tr["lp_prop"], acc, n, n + 1.0,
                       extras_sum=torch.stack([acc_mean, tr["depth"]], dim=1),
                       extras_n=torch.ones(B, 2, dtype=torch.float32, device=dev))
