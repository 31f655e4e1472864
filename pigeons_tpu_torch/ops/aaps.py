"""AAPS, the Apogee-to-Apogee Path Sampler (Sherlock et al. 2022), over the batch.

Counterpart of ``pigeons_tpu/ops/aaps.py`` (reference ``src/explorers/AAPS.jl``):
from ``(x, v ~ N(0, I))`` a forward and a backward trajectory are extended
segment by segment, a segment ending at the first apogee (``v . M^{-1/2}
grad log pi`` turning from negative to positive); ``K + 1`` segments in all,
the initial forward and backward pair and then ``K`` more, each continuing
an end chosen at random. Every visited state ``z`` of a segment gets the
weight ``log_joint(z) + Gumbel`` and the largest weight is the proposal
(scheme (1) of the paper, acceptance probability 1). A divergence anywhere,
or a segment that reaches ``max_segment_steps`` without an apogee, bails
the move: the lane keeps its state. The backward segment skips its first
state, which the forward one has counted.

The JAX package runs a segment as a per-lane ``lax.while_loop`` under
``vmap``. Here all lanes start a segment together, so the leapfrog index
``i``, and with it the Gumbel key ``fold_in(segment key, i + 1)``, is a host
int: one loop over the lanes still going, whose finished lanes keep their
values, as under ``vmap``. The Gumbel draws of ``_CHECK`` leapfrogs are
drawn at once, and after them one host read asks which lanes go on; only
those are evaluated next.

Streams as the JAX explorer derives them from a lane's key: the
preconditioner's ``fold_in(key, 1000003)``, the momentum's
``fold_in(key, 1000004)``, segment ``s`` (0 forward, 1 backward, ``2 + k``
the continuations) ``fold_in(key, s)``, and a continuation's direction
``bernoulli(fold_in(segment key, 1000005))``.
"""

from __future__ import annotations

import torch

from .. import rng
from ..paths import lane_log_density
from .base import Explorer, StepOut
from .hamiltonian import (LaneGradient, MixDiagonalPreconditioner, adapted_std_devs, lane_dot,
                          log_joint, value_and_cond_grad)
from .mala import select

_CHECK = 8  # leapfrogs between two reads of the lanes still going


class AAPS(Explorer):
    def __init__(self, step_size: float = 1.0, K: int = 5, preconditioner=None,
                 max_segment_steps: int = 256):
        self.step_size = float(step_size)
        self.K = int(K)
        self.preconditioner = (
            preconditioner if preconditioner is not None else MixDiagonalPreconditioner()
        )
        self.max_segment_steps = int(max_segment_steps)

    def init_state(self, n_chains: int, dim: int, device=None):
        return {"std_devs": torch.ones((n_chains, dim), dtype=torch.float32, device=device)}

    def needs_online_moments(self) -> bool:
        return self.preconditioner.adapts

    def adapt(self, state, reduced, round_idx: int):
        if not self.preconditioner.adapts:
            return state
        return {"std_devs": adapted_std_devs(state["std_devs"], reduced)}

    def _leapfrog(self, s, vg, precond, gumbel):
        """One leapfrog of the segment's lanes ``s`` (a dict of their carry),
        the lanes already done keeping their values."""
        eps = self.step_size
        live = ~s["done"]
        v_half = s["v"] + (0.5 * eps) * s["cg"]
        x_n = s["x"] + eps * (v_half / precond)
        lp_n, cg_n = value_and_cond_grad(vg, x_n, precond)
        v_n = v_half + (0.5 * eps) * cg_n
        joint = log_joint(lp_n, v_n)
        ok_n = s["ok"] & torch.isfinite(joint)
        sign_n = torch.sign(lane_dot(v_n, cg_n))
        apogee = (s["sign"] < 0) & (sign_n > 0)
        w = joint + gumbel
        better = live & ok_n & ~apogee & (w > s["wmax"])
        return {"x": select(live, x_n, s["x"]), "v": select(live, v_n, s["v"]),
                "cg": select(live, cg_n, s["cg"]), "sign": torch.where(live, sign_n, s["sign"]),
                "wmax": torch.where(better, w, s["wmax"]), "xmax": select(better, x_n, s["xmax"]),
                "ok": torch.where(live, ok_n, s["ok"]),
                "done": s["done"] | (live & (apogee | ~ok_n)), "n": s["n"] + live.to(torch.float32)}

    def _segment(self, keys, vg, precond, x, v, skip_first: bool):
        """Extend ``(x, v)`` of every lane to its next apogee. Returns the
        segment's end ``(x, v)``, its largest weight and the state that has
        it, its leapfrogs ``[B]`` and whether it is valid."""
        B = x.shape[0]
        lp, cg = value_and_cond_grad(vg, x, precond)
        if skip_first:
            w0 = torch.full((B,), -float("inf"), dtype=torch.float32, device=x.device)
        else:
            w0 = log_joint(lp, v) + rng.gumbel(rng.fold_in(keys, 0))
        out = {"x": x, "v": v, "cg": cg, "sign": torch.sign(lane_dot(v, cg)), "wmax": w0,
               "xmax": x, "ok": torch.ones(B, dtype=torch.bool, device=x.device),
               "done": torch.zeros(B, dtype=torch.bool, device=x.device),
               "n": torch.zeros(B, dtype=torch.float32, device=x.device)}
        idx, s, i, M = None, out, 0, self.max_segment_steps
        while i < M:
            n = min(_CHECK, M - i)
            k_s, vg_s, p_s = (keys, vg, precond) if idx is None else (keys[idx], vg.at(idx),
                                                                      precond[idx])
            steps = torch.arange(i + 1, i + 1 + n, dtype=torch.int64, device=x.device)
            gumbels = rng.gumbel(rng.fold_in(k_s[:, None, :], steps))  # [lanes, n]
            for j in range(n):
                s = self._leapfrog(s, vg_s, p_s, gumbels[:, j])
            i += n
            if idx is None:
                out = s
            else:
                for name, t in s.items():
                    out[name][idx] = t
            going = torch.nonzero(~s["done"]).squeeze(1)  # the read on the host
            if i >= M or going.numel() == 0:
                break
            idx = going if idx is None else idx[going]
            s = {name: t[going] for name, t in s.items()}
        ok = out["ok"] & (out["n"] < M)  # reaching the cap without an apogee bails
        return out["x"], out["v"], out["wmax"], out["xmax"], out["n"], ok

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        """One AAPS move of every lane. ``n_steps`` counts the leapfrogs;
        the acceptance statistics are 0, as in the JAX explorer."""
        B, d = xs.shape
        if chain_params is None:
            chain_params = self.init_state(B, d, xs.device)
        vg = LaneGradient(path, betas, isvar, ref_params)
        precond = self.preconditioner.build(rng.fold_in(keys, 1000003), chain_params["std_devs"])
        v0 = rng.normal(rng.fold_in(keys, 1000004), (d,))
        fx, fv, fw, fxmax, n1, ok1 = self._segment(rng.fold_in(keys, 0), vg, precond, xs, v0,
                                                   False)
        bx, bv, bw, bxmax, n2, ok2 = self._segment(rng.fold_in(keys, 1), vg, precond, xs, -v0,
                                                   True)
        wmax = torch.maximum(fw, bw)
        pos = select(fw > bw, fxmax, bxmax)
        valid = ok1 & ok2
        n_steps = n1 + n2
        for k in range(self.K):
            kk = rng.fold_in(keys, 2 + k)
            go_fwd = rng.bernoulli(rng.fold_in(kk, 1000005))
            ex, ev, w, xm, n, ok = self._segment(kk, vg, precond, select(go_fwd, fx, bx),
                                                 select(go_fwd, fv, bv), False)
            better = valid & ok & (w > wmax)
            wmax = torch.where(better, w, wmax)
            pos = select(better, xm, pos)
            fwd, bwd = go_fwd & ok, ~go_fwd & ok
            fx, fv = select(fwd, ex, fx), select(fwd, ev, fv)
            bx, bv = select(bwd, ex, bx), select(bwd, ev, bv)
            valid = valid & ok
            n_steps = n_steps + n
        if lp is None:
            lp = lane_log_density(path, xs, betas, isvar, ref_params)
        lp_new = torch.where(valid, lane_log_density(path, pos, betas, isvar, ref_params), lp)
        z = torch.zeros(B, dtype=torch.float32, device=xs.device)
        return StepOut(select(valid, pos, xs), lp_new, z, z, n_steps)
