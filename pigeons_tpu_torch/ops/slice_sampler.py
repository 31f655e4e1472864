"""Coordinate-wise slice sampler (Neal 2003) with doubling and shrinking, as
plain torch ops over the whole batch of lanes.

Counterpart of ``pigeons_tpu/ops/slice_sampler.py`` (reference
``src/explorers/SliceSampler.jl``): for each of ``n_passes * d`` coordinate
steps, a vertical draw ``z = lp - Exp(1)``, an initial window of width ``w``
around the point, then one flat machine DOUBLE / SHRINK / CHECK / STOP with
exactly one density evaluation per iteration. The JAX package writes the step
for one lane and vmaps it; here the batch is written out: the coordinate
index is shared by all lanes, one ``while`` runs until every lane is at STOP,
every iteration evaluates the density of the whole batch once, and a lane at
STOP changes nothing and counts no evaluation.

It takes any path with a batched torch ``log_density``, evaluated through
:func:`~..paths.lane_log_density` as the runtime evaluates it, so it is the
explorer for paths that the CUDA slice kernels cannot evaluate on the device
(``SliceSamplerCUDA.check_path`` says which). It is a torch module, not a
kernel: every iteration is a handful of eager threefry calls.

Streams as the JAX sampler derives them from a lane's key: coordinate step
``i`` uses ``k_c = fold_in(key, i)``; the exponential comes from
``fold_in(k_c, 0)`` and the window's offset from ``fold_in(k_c, 1)``;
iteration ``it`` of the machine draws its side and its candidate from
``fold_in(fold_in(k_c, 2 + it), 0)`` and ``(..., 1)``. Arithmetic follows
XLA's CPU code (the step-out and the candidate are fused multiply-adds,
``exponential`` is ``-log1p(-u)`` with the Cephes ``log1p``), so that on a
density that agrees bit for bit the whole step does.

Mixed coordinate types, as in the JAX sampler (reference
``SliceSampler.jl:65-86,136-142,189``). ``integer_mask`` marks ordinal
coordinates: the window is ``L = old - floor(u (w + 1))``, ``R = L + w``
(``w`` must be a whole number), a shrink candidate is ``Lb + floor(u (Rb -
Lb + 1))``, drawn from the inclusive range, and the bracket is exhausted when
``Rb - Lb < 0.5``. ``binary_mask`` marks Bool coordinates, which take the
exact Gibbs draw instead of a slice: one evaluation at the flipped value,
``p(0) = 1 / (1 + exp(lp1 - lp0))`` against the uniform of ``fold_in(k_c,
0)``, counted as one accepted, considered step. A mask is per coordinate and
the same for every lane, so each coordinate step takes one branch for the
whole batch, as ``lax.cond`` on the shared coordinate index does in the JAX
version. States stay float, holding whole numbers or {0, 1} there.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import f32math, rng
from ..paths import lane_log_density
from .base import Explorer, StepOut

DOUBLE, SHRINK, CHECK, STOP = range(4)  # phases of the per-coordinate machine


def coordinate_draws(keys, i: int):
    """For coordinate step ``i`` and lane keys ``[B, 2]``: the step's key
    ``k_c [B, 2]``, the exponential ``[B]`` and the window's uniform ``[B]``."""
    k_c = rng.fold_in(keys, i)
    e = -f32math.log1p(-rng.uniform(rng.fold_in(k_c, 0)))
    return k_c, e, rng.uniform(rng.fold_in(k_c, 1))


def iteration_draws(k_c, it: int):
    """The side and candidate uniforms ``(u_side, u_shr)`` of iteration ``it``."""
    k_it = rng.fold_in(k_c, 2 + it)
    return rng.uniform(rng.fold_in(k_it, 0)), rng.uniform(rng.fold_in(k_it, 1))


class SliceSampler(Explorer):
    """Same defaults and meaning as the JAX ``SliceSampler``: ``w=10, p=20,
    n_passes=3, max_iter=1024``."""

    def __init__(self, w: float = 10.0, p: int = 20, n_passes: int = 3,
                 max_iter: int = 1024, integer_mask=None, binary_mask=None):
        self.w = float(w)
        self.p = int(p)
        self.n_passes = int(n_passes)
        self.max_iter = int(max_iter)
        if integer_mask is not None:
            integer_mask = np.asarray(integer_mask, bool)
            if integer_mask.any() and self.w != round(self.w):
                raise ValueError(
                    f"integer coordinates need a whole-number slice width; got w={self.w}")
        if binary_mask is not None:
            binary_mask = np.asarray(binary_mask, bool)
            if integer_mask is not None and (binary_mask & integer_mask).any():
                raise ValueError("a coordinate cannot be both binary and integer")
        self.integer_mask = integer_mask
        self.binary_mask = binary_mask

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        """One sweep over ``xs [B, d]``. ``lp [B]`` is the density of ``xs``
        when the caller has it (the runtime carries it from scan to scan)."""
        B, d = xs.shape
        W = float(np.float32(self.w))
        narrow_w = float(np.float32(1.1) * np.float32(self.w))

        def lp_fn(x):
            return lane_log_density(path, x, betas, isvar, ref_params)

        x = xs.clone()
        lp_cur = lp_fn(x) if lp is None else lp
        fz = torch.zeros(B, dtype=torch.float32, device=xs.device)
        acc_sum, acc_n, n_evals = fz.clone(), fz.clone(), fz.clone()

        for i in range(self.n_passes * d):
            c = i % d
            old = x[:, c].clone()

            def lp_at(v):
                xq = x.clone()
                xq[:, c] = v
                return lp_fn(xq)

            if self.binary_mask is not None and self.binary_mask[c]:
                # the exact full conditional of a Bool coordinate
                lp_other = lp_at(1.0 - old)
                is_one = old > 0.5
                lp1 = torch.where(is_one, lp_cur, lp_other)
                lp0v = torch.where(is_one, lp_other, lp_cur)
                p_zero = 1.0 / (1.0 + f32math.exp(lp1 - lp0v))
                u = rng.uniform(rng.fold_in(rng.fold_in(keys, i), 0))
                new = torch.where(u < p_zero, 0.0, 1.0)
                x[:, c] = new
                lp_cur = torch.where(new == old, lp_cur, lp_other)
                acc_sum, acc_n, n_evals = acc_sum + 1.0, acc_n + 1.0, n_evals + 1.0
                continue
            is_int = self.integer_mask is not None and bool(self.integer_mask[c])

            k_c, e, u_init = coordinate_draws(keys, i)
            z = lp_cur - e
            L = old - torch.floor(u_init * (W + 1.0)) if is_int else f32math.fma(u_init, -W, old)
            R = L + W
            lpL, lpR = lp_at(L), lp_at(R)
            start_dbl = (z < lpL) | (z < lpR) if self.p > 0 else torch.zeros_like(z, dtype=torch.bool)
            phase = torch.where(start_dbl, DOUBLE, SHRINK)
            K = torch.full_like(phase, self.p)
            Lb, Rb, cand, lp_cand = L, R, old, lp_cur
            Lh, Rh, lpLh, lpRh = fz, fz, fz, fz
            n_shr = torch.zeros_like(phase)
            accepted = torch.zeros(B, dtype=torch.bool, device=xs.device)
            considered, evals = fz, fz

            it = 0
            while bool((phase != STOP).any()):
                u_side, u_shr = iteration_draws(k_c, it)
                grow_left = u_side <= 0.5
                span = R - L
                dbl_q = torch.where(grow_left, L - span, R + span)
                if is_int:  # the inclusive range {Lb .. Rb}
                    cand_draw = Lb + torch.floor(u_shr * ((Rb - Lb) + 1.0))
                elif self.integer_mask is not None:
                    # XLA selects between the two draws of a traced is_int,
                    # and the continuous one's multiply is no longer fused
                    cand_draw = Lb + u_shr * (Rb - Lb)
                else:
                    cand_draw = f32math.fma(u_shr, Rb - Lb, Lb)
                M = (Lh + Rh) * 0.5
                ph_dbl, ph_shr, ph_chk = phase == DOUBLE, phase == SHRINK, phase == CHECK
                query = torch.where(ph_dbl, dbl_q, torch.where(ph_shr, cand_draw,
                                                               torch.where(ph_chk, M, old)))
                lp_q = lp_at(query)
                evals = evals + (phase != STOP).to(torch.float32)

                # DOUBLE: commit the grown side; go on while an end is inside
                # the slice and the budget lasts
                L = torch.where(ph_dbl & grow_left, dbl_q, L)
                R = torch.where(ph_dbl & ~grow_left, dbl_q, R)
                lpL = torch.where(ph_dbl & grow_left, lp_q, lpL)
                lpR = torch.where(ph_dbl & ~grow_left, lp_q, lpR)
                K = torch.where(ph_dbl, K - 1, K)
                more_dbl = (K > 0) & ((z < lpL) | (z < lpR))
                start_shrink = ph_dbl & ~more_dbl
                Lb = torch.where(start_shrink, L, Lb)
                Rb = torch.where(start_shrink, R, Rb)

                # SHRINK: the vertical test; maybe start the validity check
                cand = torch.where(ph_shr, cand_draw, cand)
                lp_cand = torch.where(ph_shr, lp_q, lp_cand)
                n_shr = torch.where(ph_shr, n_shr + 1, n_shr)
                consider = ph_shr & (z < lp_q)
                considered = considered + consider.to(torch.float32)
                narrow = (R - L) <= narrow_w  # doubling never ran: nothing to check
                accept_shr = consider & narrow
                to_check = consider & ~narrow
                Lh = torch.where(to_check, L, Lh)
                Rh = torch.where(to_check, R, Rh)
                lpLh = torch.where(to_check, lpL, lpLh)
                lpRh = torch.where(to_check, lpR, lpRh)

                # CHECK: halve toward the candidate
                take_left = cand < M
                crossed = (old < M) ^ take_left
                Lh = torch.where(ph_chk & ~take_left, M, Lh)
                Rh = torch.where(ph_chk & take_left, M, Rh)
                lpLh = torch.where(ph_chk & ~take_left, lp_q, lpLh)
                lpRh = torch.where(ph_chk & take_left, lp_q, lpRh)
                chk_rej = ph_chk & crossed & (z >= lpLh) & (z >= lpRh)
                chk_more = ph_chk & ~chk_rej & ((Rh - Lh) > narrow_w)
                accept_chk = ph_chk & ~chk_rej & ~chk_more

                # a rejected candidate shrinks the bracket toward itself
                rejected = (ph_shr & ~consider) | chk_rej
                shrink_left = cand < old
                Lb = torch.where(rejected & shrink_left, cand, Lb)
                Rb = torch.where(rejected & ~shrink_left, cand, Rb)
                if is_int:  # a single candidate left
                    degenerate = (Rb - Lb) < 0.5
                else:
                    degenerate = torch.abs(Rb - Lb) <= 3.5e-4 * torch.maximum(torch.abs(Lb), torch.abs(Rb))
                bail = rejected & (degenerate | (n_shr >= self.max_iter))

                accepted = accepted | accept_shr | accept_chk
                stop = accept_shr | accept_chk | bail
                phase = torch.where(
                    stop, STOP,
                    torch.where(more_dbl & ph_dbl, DOUBLE,
                    torch.where(start_shrink | (rejected & ~bail), SHRINK,
                    torch.where(to_check | chk_more, CHECK, phase))))
                it += 1

            x[:, c] = torch.where(accepted, cand, old)
            lp_cur = torch.where(accepted, lp_cand, lp_cur)
            acc_sum = acc_sum + accepted.to(torch.float32)
            acc_n = acc_n + considered
            n_evals = n_evals + 2.0 + evals
        return StepOut(x, lp_cur, acc_sum, acc_n, n_evals)
