"""AutoMALA: MALA with a step size chosen at every refreshment, over the batch.

Counterpart of ``pigeons_tpu/ops/automala.py`` (reference
``src/explorers/AutoMALA.jl``, Biron-Lattes et al. 2024): per refreshment,
draw ``(a, b) ~ U(0, 1)^2`` giving log-acceptance bounds ``[log min(a, b),
log max(a, b)]``; starting from the round's base step size, double (grow) or
halve (shrink) until the one-step leapfrog log-joint difference enters the
bounds; move with the selected step size; then search again from the
proposal with flipped momentum and require the same exponent (the
reversibility check) before the MH correction. MH is skipped on the first
scan of each round. Between rounds the base step size is multiplied by the
mean across chains of the mean selected factor ``2^exponent``, and the
preconditioner's std deviations are re-estimated. The search stops at
``max_exponent`` halvings or doublings.

The JAX package writes the search for one lane and vmaps its
``lax.while_loop``; here the batch is written out. The sequential search
runs one ``while`` until every lane is done (its test reads the lanes still
searching on the host, once per iteration); an iteration evaluates those
lanes only, at their next exponent, and a lane that is done changes nothing
and counts no evaluation. Its two variants select the same exponent and candidate, bit for
bit, and differ only in the evaluations they spend:

* ``window=W``: after the exponent-0 trial, the ``W`` next exponents in the
  search direction are one leapfrog over ``W * B`` lanes, the stopping rule
  is applied by selection, and only lanes whose search goes past the window
  go on in the sequential loop;
* ``queued=True``: each iteration evaluates only the first ``queue_width``
  lanes still searching (a stable ``argsort`` of the active mask), each at
  its next ``max(1, window)`` exponents, and scatters their search state
  back; the selected candidate is then recomputed by one leapfrog at the
  selected step size. ``queue_tail_width`` hands the last few lanes to a
  narrower queue.

Streams as the JAX explorer derives them from a lane's key: refreshment
``i`` splits ``fold_in(key, i)`` five ways into the momentum's, the
preconditioner's, the two bounds' and the MH uniform's keys.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import f32math, rng
from .base import StepOut
from .hamiltonian import leapfrog1_cached, log_joint
from .mala import GradientExplorer, select


def _direction(diff0, lower, upper):
    """+1 to grow, -1 to shrink, 0 where the exponent-0 trial is inside the
    bounds (int32)."""
    finite = torch.isfinite(diff0)
    shrink = ~finite | (diff0 < lower)
    grow = finite & (diff0 > upper)
    return torch.where(grow, 1, torch.where(shrink, -1, 0)).to(torch.int32)


def _stops(direction, diff, lower, upper):
    """Whether a trial ends the search: a grow ends at the first trial below
    ``upper`` (or not finite), a shrink at the first finite one above
    ``lower``."""
    finite = torch.isfinite(diff)
    return torch.where(direction > 0, ~finite | (diff < upper), finite & (diff > lower))


def _exponent(direction, n):
    """Grow selects one less than its last trial (the acceptance cliff),
    shrink its last."""
    return torch.where(direction > 0, n - 1, torch.where(direction < 0, -n, 0))


def _pow2(e):
    return torch.pow(2.0, e.to(torch.float32))


class AutoMALA(GradientExplorer):
    extra_names = ("am_factor", "reversibility_rate")

    def __init__(self, step_size: float = 1.0, base_n_refresh: int = 3,
                 exponent_n_refresh: float = 0.35, preconditioner=None, max_exponent: int = 40,
                 window: int = 0, queued: bool = False, queue_width: int = 0,
                 queue_tail_width: int = 0):
        super().__init__(step_size, base_n_refresh, exponent_n_refresh, preconditioner)
        self.max_exponent = int(max_exponent)
        self.window = int(window)
        if not 0 <= self.window <= self.max_exponent:
            raise ValueError(f"window must be in [0, max_exponent]; got {self.window}")
        self.queued = bool(queued)
        self.queue_width = int(queue_width)  # 0: max(min(B, 128), B // 8)
        self.queue_tail_width = int(queue_tail_width)  # -1: max(64, width // 8); 0: none

    def adapt(self, state, reduced, round_idx: int):
        # step size *= mean over chains of the chain-mean selected factor
        # (reference AutoMALA.jl:73-75)
        factor_mean = reduced.extra_mean[:, 0]
        observed = np.isfinite(factor_mean)
        factor = float(np.mean(factor_mean[observed])) if observed.any() else 1.0
        return {"step_size": state["step_size"] * float(np.float32(factor)),
                "std_devs": self._std_devs(state, reduced)}

    # -- step-size search --------------------------------------------------

    def _search(self, vg, precond, x, v, lp, cgrad, base_step, lower, upper,
                need_candidate=True):
        """The step-size exponent of every lane. ``cgrad`` is the conditioned
        gradient at ``x``, computed once per refreshment, so each trial costs
        one evaluation, at its proposal. Returns ``(exponent [B] int32,
        n_evals [B], candidate)`` with ``candidate`` the leapfrog ``(x', v',
        lp', cgrad', ok)`` at the selected step size (``None`` from the queued
        search when ``need_candidate`` is False)."""
        h_before = log_joint(lp, v)

        def try_step(eps, lanes=None):
            if lanes is None:
                cand = leapfrog1_cached(vg, precond, x, v, eps, cgrad)
                h = h_before
            else:
                cand = leapfrog1_cached(vg.at(lanes), precond[lanes], x[lanes], v[lanes], eps,
                                        cgrad[lanes])
                h = h_before[lanes]
            _, v_n, lp_n, _, ok = cand
            diff = torch.where(ok, log_joint(lp_n, v_n) - h, float("nan"))
            return diff, cand

        diff0, cand0 = try_step(base_step)
        direction = _direction(diff0, lower, upper)
        if self.queued:
            exponent, n_evals = self._queued_search(try_step, direction, base_step, lower, upper)
            if not need_candidate:
                return exponent, n_evals, None
            # the selected candidate: one leapfrog at the selected step, from
            # the inputs of the winning trial, so with its bits
            _, cand = try_step(base_step * _pow2(exponent))
            return exponent, n_evals + 1.0, cand
        return self._sequential_search(try_step, direction, cand0, base_step, lower, upper)

    def _sequential_search(self, try_step, direction, cand0, base_step, lower, upper):
        B = direction.shape[0]
        W = self.window
        n0 = torch.zeros(B, dtype=torch.int32, device=direction.device)
        if W == 0:
            step, done, prev, cur = base_step, direction == 0, cand0, cand0
        else:
            # exponents 1..W in each lane's direction as one leapfrog over
            # W * B lanes, the sequential stopping rule applied by selection
            exps = torch.arange(1, W + 1, dtype=torch.float32, device=direction.device)[:, None]
            factors = torch.where(direction[None, :] >= 0, torch.pow(2.0, exps),
                                  torch.pow(0.5, exps))  # [W, B]
            lanes = torch.arange(B, device=direction.device).repeat(W)
            diffs, cands = try_step((base_step[None, :] * factors).reshape(-1), lanes)
            stop = _stops(direction[None, :], diffs.reshape(W, B), lower, upper)
            stopped = stop.any(0) & (direction != 0)
            n_stop = torch.argmax(stop.to(torch.int32), dim=0).to(torch.int32) + 1
            everything = [torch.cat([c0[None], cw.reshape((W, B) + c0.shape[1:])])
                          for c0, cw in zip(cand0, cands)]  # [W + 1, B, ...]
            rows = torch.arange(B, device=direction.device)

            def pick(idx):
                return tuple(c[idx.long(), rows] for c in everything)

            n0 = torch.where(direction == 0, 0, torch.where(stopped, n_stop, W)).to(torch.int32)
            step = base_step * torch.where(direction >= 0, 2.0**W, 0.5**W)
            done = stopped | (direction == 0)
            # the sequential loop's carry at exponent n0: prev = candidate at
            # n0 - 1, cur = candidate at n0
            prev = pick(torch.where(stopped, torch.clamp_min(n_stop - 1, 0), W - 1))
            cur = pick(torch.where(direction == 0, 0, torch.where(stopped, n_stop, W)))
        # one exponent per iteration, evaluated for the lanes still searching
        # only (lanes are independent, so a lane's trials have the same bits
        # as in a full-width evaluation)
        n, step, done = n0.clone(), step.clone(), done.clone()
        prev, cur = [t.clone() for t in prev], [t.clone() for t in cur]
        while True:
            idx = torch.nonzero(~done & (n < self.max_exponent)).squeeze(1)
            if idx.numel() == 0:  # the iteration's one read on the host
                break
            d_i = direction[idx]
            n[idx] += 1
            step_i = torch.where(d_i > 0, step[idx] * 2.0, step[idx] * 0.5)
            step[idx] = step_i
            diff, cand = try_step(step_i, idx)
            done[idx] = _stops(d_i, diff, lower[idx], upper[idx])
            for p, c, new in zip(prev, cur, cand):
                p[idx] = c[idx]
                c[idx] = new
        selected = tuple(select(direction > 0, p, c) for p, c in zip(prev, cur))
        n_evals = (1 + W + (n - n0)).to(torch.float32)
        return _exponent(direction, n).to(torch.int32), n_evals, selected

    def _queued_search(self, try_step, direction, base_step, lower, upper):
        """The compacted work-queue search (JAX ``_queued_search``): returns
        ``(exponent, n_evals)``; the per-lane carry is scalars only."""
        B = direction.shape[0]
        dev = direction.device
        Wq = min(self.queue_width or max(min(B, 128), B // 8), B)
        if self.queue_tail_width < 0:
            Wq_tail = min(Wq, max(64, Wq // 8))
            Wq_tail = 0 if Wq_tail >= Wq else Wq_tail
        else:
            Wq_tail = min(self.queue_tail_width, Wq)
        W = max(1, self.window)  # exponents tried per selected lane and iteration
        js = torch.arange(1, W + 1, dtype=torch.float32, device=dev)
        n = torch.zeros(B, dtype=torch.int32, device=dev)
        step = base_step.clone()
        done = direction == 0
        evals = torch.ones(B, dtype=torch.float32, device=dev)

        def run(min_active, width):
            nonlocal n, step, done, evals
            while True:
                active = ~done & (n < self.max_exponent)
                n_active = int(active.sum()) if min_active else int(active.any())
                if n_active <= min_active:
                    return
                order = torch.argsort((~active).to(torch.int8), stable=True)  # active first
                idx = order[:width]
                valid = active[idx]
                d_i = direction[idx]
                fac = torch.where(d_i[:, None] > 0, torch.pow(2.0, js)[None, :],
                                  torch.pow(0.5, js)[None, :])
                eps = (step[idx][:, None] * fac).reshape(-1)  # [width * W]
                diff, _ = try_step(eps, idx.repeat_interleave(W))
                diff = diff.reshape(-1, W)
                stop = _stops(d_i[:, None], diff, lower[idx][:, None], upper[idx][:, None])
                # trials past max_exponent never count (the sequential loop stops there)
                j_lim = torch.clamp(self.max_exponent - n[idx], 0, W)
                stop = stop & (torch.arange(1, W + 1, device=dev)[None, :] <= j_lim[:, None])
                stopped = stop.any(1)
                j_stop = torch.argmax(stop.to(torch.int32), dim=1).to(torch.int32) + 1
                j_eff = torch.where(stopped, j_stop, j_lim.to(torch.int32))
                scale = torch.where(d_i > 0, _pow2(j_eff), torch.pow(0.5, j_eff.to(torch.float32)))
                n[idx] = torch.where(valid, n[idx] + j_eff, n[idx])
                step[idx] = torch.where(valid, step[idx] * scale, step[idx])
                done[idx] = torch.where(valid, stopped, done[idx])
                evals[idx] = torch.where(valid, evals[idx] + W, evals[idx])

        if 0 < Wq_tail < Wq:
            run(Wq_tail, Wq)
            run(0, Wq_tail)
        else:
            run(0, Wq)
        return _exponent(direction, n).to(torch.int32), evals

    # -- full step ---------------------------------------------------------

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        """``n_refresh`` AutoMALA moves of every lane. ``scan_idx == 1`` (the
        first scan of a round) skips MH and the reversibility search: a
        valid move is taken, as in the reference, and only the forward
        search's factor is recorded."""
        vg, lp, raw_grad, chain_params = self._start(xs, betas, path, isvar, ref_params, lp,
                                                     chain_params)
        base_step, std_devs = chain_params["step_size"], chain_params["std_devs"]
        use_mh = scan_idx != 1
        B, d = xs.shape
        x = xs
        z = torch.zeros(B, dtype=torch.float32, device=xs.device)
        a_s, a_n, f_s, f_n, r_s, r_n = z, z, z, z, z, z
        ns = z + 1.0  # the start point's gradient
        for i in range(self.n_refresh(d)):
            k = rng.split(rng.fold_in(keys, i), 5)  # momentum, preconditioner, a, b, MH
            precond = self.preconditioner.build(k[:, 1], std_devs)
            cgrad = raw_grad / precond
            v = rng.normal(k[:, 0], (d,))
            h0 = log_joint(lp, v)
            a, b, u_mh = rng.uniform(k[:, 2:]).unbind(-1)
            lower, upper = f32math.log(torch.stack([torch.minimum(a, b), torch.maximum(a, b)]))
            exp_f, n_f, cand = self._search(vg, precond, x, v, lp, cgrad, base_step, lower, upper)
            # the move is the search's selected candidate
            x_new, v_new, lp_new, cgrad_new, ok = cand
            f_s = f_s + _pow2(exp_f)
            f_n = f_n + 1.0
            ns = ns + n_f
            if use_mh:
                # from the proposal with flipped momentum, seeded by the
                # candidate's own end-point gradient
                exp_r, n_r, _ = self._search(vg, precond, x_new, -v_new, lp_new, cgrad_new,
                                             base_step, lower, upper, need_candidate=False)
                reversible = (exp_r == exp_f) & ok
                f_s = f_s + _pow2(exp_r)
                f_n = f_n + 1.0
                ns = ns + n_r
                h1 = log_joint(lp_new, v_new)
                pr = torch.where(reversible, torch.clamp_max(f32math.exp(h1 - h0), 1.0), 0.0)
                accept = u_mh < pr
                a_s = a_s + pr
                a_n = a_n + 1.0
                r_s = r_s + reversible.to(torch.float32)
                r_n = r_n + 1.0
            else:
                accept = ok
            x = select(accept, x_new, x)
            lp = torch.where(accept, lp_new, lp)
            # the raw gradient of the new state; the candidate's is conditioned
            raw_grad = select(accept, cgrad_new * precond, raw_grad)
        return StepOut(x, lp, a_s, a_n, ns, extras_sum=torch.stack([f_s, r_s], dim=1),
                       extras_n=torch.stack([f_n, r_n], dim=1))
