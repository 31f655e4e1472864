"""Slice sampler over the whole replica batch: CUDA kernels K1 and K2 and
their plain torch twins.

Counterpart of ``SliceSamplerPallas.step_batched``
(``pigeons_tpu/ops/pallas_slice.py:598-896``) and of its two TPU kernels.

**K1, banded sweep** (replaces ``pallas_slice.py:_banded_sweep_kernel``). For
a density that is a sum of per-coordinate terms, ``lp(x) = sum_c f(x_c)``,
the joint density cancels from every coordinate's slice test, so each (lane,
coordinate) element runs its own one-dimensional Neal slice sampler
(doubling, shrinking, halving check) for ``n_passes`` passes, independently
of every other element. ``csrc/banded_slice.cu`` runs as many blocks as stay
resident on the card; each owns a contiguous share of the row-major
``[B, d]`` state, and a warp hands the next elements of its run of the share
to whichever of its lanes have finished theirs, so that the lanes stay busy
although elements need anything from 6 to over 100 iterations.
:func:`banded_sweep_reference` is the same machine as torch ops over all
elements at once.

**K2, general sweep** (replaces ``pallas_slice.py:_sweep_kernel``). For any
density, each lane runs ONE machine ENTER / INIT_R / DOUBLE / SHRINK / CHECK
/ DONE through all ``n_passes * d`` coordinate steps, one density evaluation
per loop iteration, and never waits for another lane at a coordinate
boundary. ``csrc/sweep_slice.cu`` keeps the lane's state, its machine and the
density evaluation (``csrc/densities.cuh``, selected by the path's
:class:`~..paths.DeviceDensity`) inside one launch for the whole sweep. In
full mode a group of 8, 16 or 32 threads works for one lane: each computes
its share of the density's terms (coordinates, or a ``BayesianModel``'s
observations), and all of them run the in-order sums and the machine, so
nothing is broadcast; for the two likelihoods of many terms (hierarchical
normal, logistic regression) each partial sum of XLA's order has a thread of
its own, the partials meet by warp shuffles, and a lane keeps its current
terms, row partials and prior blocks, so that a query recomputes what its
coordinate changes. For eight schools, unid and the Bernoulli model,
whose queries are a few terms, each thread of the group evaluates one of
the machine's next queries (the draws are counter-based, so a run's queries
are known before its densities), and the group takes the iterations up to
the first that ends the run. What the Pallas kernel receives as hoisted array
constants the CUDA kernel reads from device arrays: a model's data and prior
table (``DeviceDensity.arrays`` / ``.prior``) and, under a
:class:`~..paths.VariationalPath`, the lanes' ``isvar`` and the reference's
``mean`` / ``std`` / ``active``. In delta mode a
separable path's query is answered as ``base + f_c(query)`` by one thread
per lane, which hashes the draws of a run's next iterations at once and
takes them in turn, and the final density is recomputed. :func:`sweep_reference` is the
same machine as torch ops over ``[B]`` rows.

**A user's density** (``device_source.DeviceSource``, CUDA source beside its
torch form) has a library of its own, built at first use
(``_build.build_user``): K2's instances for it (``slice_sweep_user``, full
mode; groups of threads speculate the machine's next queries, each with its
own copy of the lane's state, as for eight schools) for a target, a
``CustomPath`` or a ``BayesianModel`` likelihood (``DeviceDensity`` of kind
``USER``), K1's user term (``banded_slice_sweep_user``) for a path with
``coord_source``. The twins evaluate the source's torch form.

CPU tensors run the twins; a CUDA tensor reaches the kernel or raises. Each
kernel agrees with its twin bit for bit on the card.

Random numbers are counter-based, as in the JAX kernels. In K1 the element
of lane ``b`` and coordinate ``c`` draws its two uniforms of loop iteration
``it`` from ``fmix32(fmix32(0x9E3779B9 ^ s) ^ (2 it + k))``, with
``s = fmix32(lane_seed[b] ^ c * 0x85EBCA77)``; in K2 lane ``b`` draws its
four from ``fmix32(fmix32(0x9E3779B9 ^ lane_seed[b]) ^ (4 it + k))``. The
lane seed is the first word of ``jax.random.bits`` of the lane's key. Each
element or lane counts its own iterations from 0, as every lane of a TPU
block does, so the draws do not depend on how the batch is cut into blocks.

XLA's CPU backend, which runs the JAX kernels in the tests, evaluates the
coordinate term's ``precision(beta)``, the step-out ``old - w * u`` and the
shrink draw ``Lb + u * (Rb - Lb)`` as fused multiply-adds and ``log`` as the
Cephes polynomial. Kernels and twins do the same (``__fmaf_rn`` and an exact
torch emulation of it), and nothing else is fused.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import f32math, rng
from ..paths import USER, VariationalPath, _guarded_mul, lane_log_density
from ..variational import GaussianReference
from .base import Explorer, StepOut

ENTER, INIT_R, DOUBLE, SHRINK, CHECK, DONE = range(6)  # the JAX kernels' phase codes

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_COORD_MIX = 0x85EBCA77


def _mul32(h, c: int):
    """Low 32 bits of ``h * c`` for uint32 words held as int64, without
    overflowing int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def fmix32(h):
    """murmur3's 32-bit finalizer (``pallas_slice.py:_fmix32``)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def uniform_from_bits(bits):
    """Top 24 bits ``b`` -> ``b * 2^-24 + 2^-25`` in float32
    (``pallas_slice.py:_uniform_from_bits``)."""
    return (bits >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


def lane_seeds(keys: torch.Tensor) -> torch.Tensor:
    """One uint32 seed per lane, ``bits(key, (), uint32)`` of its key, as
    int64 (``pallas_slice.py:660-664``)."""
    return rng.bits(keys)


def element_hash_base(seeds: torch.Tensor, d: int) -> torch.Tensor:
    """``[B, d]`` int64: ``fmix32(0x9E3779B9 ^ fmix32(seed ^ c * 0x85EBCA77))``,
    the per-element state of ``_hash_words`` before the draw counter."""
    c = torch.arange(d, dtype=torch.int64, device=seeds.device)
    s = fmix32(seeds[:, None] ^ _mul32(c, _COORD_MIX)[None, :])
    return fmix32(s ^ _GOLDEN)


def element_uniforms(base: torch.Tensor, it: int):
    """The two uniforms ``(uA, uB)`` every element draws at iteration ``it``."""
    ua = uniform_from_bits(fmix32(base ^ (2 * it)))
    ub = uniform_from_bits(fmix32(base ^ (2 * it + 1)))
    return ua, ub


class VariationalTerm(NamedTuple):
    """What kernel K1's second coordinate term needs besides the factors
    ``a``: the term of a :class:`~..paths.VariationalPath` over a path with a
    quadratic coordinate term and a mean-field Gaussian reference. A lane
    with ``isvar > 0``, once ``active > 0``, has the term
    ``gm(1 - beta, l_ref) + gm(beta, (a_target v) v)`` with ``l_ref =
    -0.5 log(2 pi std_c^2) - 0.5 ((v - mean_c) / std_c)^2`` and ``gm`` the
    guarded multiply; every other lane keeps ``(a v) v``."""

    beta: torch.Tensor  # [B] float32
    isvar: torch.Tensor  # [B] float32
    active: torch.Tensor  # [] or [1] float32, on the states' device
    a_target: float  # the path's factor at beta = 1
    mean: torch.Tensor  # [d] float32
    std: torch.Tensor  # [d] float32


class UserTerm(NamedTuple):
    """Kernel K1's user term: the lanes' betas and the ``"coord"``
    :class:`~..device_source.DeviceSource` whose two terms it blends,
    ``gm(1 - beta, ref(v, c)) + gm(beta, target(v, c))`` with ``gm`` the
    guarded multiply (the JAX runtime's ``ld_coord``,
    ``pigeons_tpu/pt.py:693-696``)."""

    beta: torch.Tensor  # [B] float32
    source: object


def coord_term(v, a, variational: VariationalTerm = None, log_norm=None, user: UserTerm = None):
    """K1's coordinate term of ``v [B, d]`` for factors ``a [B]``: ``(a v) v``,
    or with ``variational`` the term of :class:`VariationalTerm`
    (``pigeons_tpu/pt.py:703-712``), or with ``user`` the
    :class:`UserTerm` (``a`` unused); NaN reads as -inf. ``log_norm [d]`` is
    the reference's ``coord_log_norm(std)``, where the caller keeps it."""
    if user is not None:
        c = torch.arange(v.shape[-1], device=v.device)
        beta = user.beta[:, None]
        return nan_to_neg_inf(_guarded_mul(1.0 - beta, user.source.ref_coord(v, c))
                              + _guarded_mul(beta, user.source.target_coord(v, c)))
    f = (a[:, None] * v) * v
    if variational is not None:
        vt = variational
        beta = vt.beta[:, None]
        l_ref = GaussianReference.coord_log_density(v, vt.mean, vt.std, log_norm)
        l_tgt = (vt.a_target * v) * v
        use_var = ((vt.isvar > 0) & (vt.active.reshape(()) > 0))[:, None]
        f = torch.where(use_var, _guarded_mul(1.0 - beta, l_ref) + _guarded_mul(beta, l_tgt), f)
    return nan_to_neg_inf(f)


def banded_sweep_reference(x, a, lane_seeds, w: float = 10.0, p: int = 20,
                           n_passes: int = 3, max_iter: int = 1024, phase_counts=None,
                           element_iterations=None, variational: VariationalTerm = None,
                           user: UserTerm = None):
    """Plain torch twin of kernel K1.

    ``x [B, d]`` float32 states, ``a [B]`` float32 coordinate-term factors
    (the term is ``f(v) = (a v) v``, NaN read as -inf; with ``variational``
    the term of :class:`VariationalTerm`, with ``user`` that of
    :class:`UserTerm`, and ``a`` unused), ``lane_seeds [B]``
    uint32 seeds as int64. Returns ``(x_new [B, d], stats [3, B])`` with the
    rows accept_sum, accept_n and n_evals summed over coordinates. To
    ``phase_counts``, an int64 ``[6]`` tensor on the states' device, every
    loop iteration adds the number of elements in each phase; to
    ``element_iterations``, an int64 ``[B, d]`` tensor, it adds one for every
    element that is not DONE (what the kernel's mapping of elements to warps
    has to balance).
    """
    B, d = x.shape
    dev = x.device
    W = float(np.float32(w))
    narrow_w = float(np.float32(1.1) * np.float32(w))  # the kernel's 1.1f * w
    # once for a coordinate, as in the kernel
    log_norm = None if variational is None else GaussianReference.coord_log_norm(variational.std)

    def ceval(v):
        return coord_term(v, a, variational, log_norm, user)

    base = element_hash_base(lane_seeds, d)
    x = x.clone()
    fz = torch.zeros((B, d), dtype=torch.float32, device=dev)
    iz = torch.zeros((B, d), dtype=torch.int32, device=dev)
    z, L, R, lcL, lcR, Lb, Rb, cand, Lh, Rh, lcLh, lcRh = (fz.clone() for _ in range(12))
    acc_sum, acc_n, n_evals = fz.clone(), fz.clone(), fz.clone()
    phase = iz + (ENTER if n_passes > 0 else DONE)
    pass_i, K, n_shr = iz.clone(), iz.clone(), iz.clone()

    it = 0
    while bool((phase != DONE).any()):
        if phase_counts is not None:
            phase_counts += torch.bincount(phase.reshape(-1), minlength=6)
        if element_iterations is not None:
            element_iterations += phase != DONE
        uA, uB = element_uniforms(base, it)
        is_enter = phase == ENTER
        active = phase != DONE
        old = x
        L = torch.where(is_enter, f32math.fma(uA, -W, old), L)
        R = torch.where(is_enter, L + W, R)

        grow_left = uA <= 0.5
        span = R - L
        dbl_q = torch.where(grow_left, L - span, R + span)
        cand_draw = f32math.fma(uA, Rb - Lb, Lb)
        M = (Lh + Rh) * 0.5
        query = torch.where(
            is_enter, R,
            torch.where(phase == DOUBLE, dbl_q,
            torch.where(phase == SHRINK, cand_draw,
            torch.where(phase == CHECK, M, old))))

        lp_q = ceval(query)
        lc_old = ceval(old)
        lc_L = ceval(L)
        n_evals = n_evals + torch.where(is_enter, 2.0, 1.0) * active.to(torch.float32)

        e_z = -f32math.log(uB)
        z = torch.where(is_enter, lc_old - e_z, z)
        lcL = torch.where(is_enter, lc_L, lcL)
        lcR = torch.where(is_enter, lp_q, lcR)
        K = torch.where(is_enter, p, K)

        ph_dbl = phase == DOUBLE
        L = torch.where(ph_dbl & grow_left, dbl_q, L)
        R = torch.where(ph_dbl & ~grow_left, dbl_q, R)
        lcL = torch.where(ph_dbl & grow_left, lp_q, lcL)
        lcR = torch.where(ph_dbl & ~grow_left, lp_q, lcR)
        K = torch.where(ph_dbl, K - 1, K)

        more_dbl = (K > 0) & ((z < lcL) | (z < lcR))
        start_shrink = (is_enter | ph_dbl) & ~more_dbl
        Lb = torch.where(start_shrink, L, Lb)
        Rb = torch.where(start_shrink, R, Rb)
        n_shr = torch.where(start_shrink, 0, n_shr)

        ph_shr = phase == SHRINK
        cand = torch.where(ph_shr, cand_draw, cand)
        n_shr = torch.where(ph_shr, n_shr + 1, n_shr)
        consider = ph_shr & (z < lp_q)
        acc_n = acc_n + consider.to(torch.float32)
        narrow = (R - L) <= narrow_w
        accept_shr = consider & narrow
        to_check = consider & ~narrow
        Lh = torch.where(to_check, L, Lh)
        Rh = torch.where(to_check, R, Rh)
        lcLh = torch.where(to_check, lcL, lcLh)
        lcRh = torch.where(to_check, lcR, lcRh)

        ph_chk = phase == CHECK
        take_left = cand < M
        crossed = (old < M) ^ take_left
        Lh = torch.where(ph_chk & ~take_left, M, Lh)
        Rh = torch.where(ph_chk & take_left, M, Rh)
        lcLh = torch.where(ph_chk & ~take_left, lp_q, lcLh)
        lcRh = torch.where(ph_chk & take_left, lp_q, lcRh)
        chk_rej = ph_chk & crossed & (z >= lcLh) & (z >= lcRh)
        chk_more = ph_chk & ~chk_rej & ((Rh - Lh) > narrow_w)
        accept_chk = ph_chk & ~chk_rej & ~chk_more

        rejected = (ph_shr & ~consider) | chk_rej
        shrink_left = cand < old
        Lb = torch.where(rejected & shrink_left, cand, Lb)
        Rb = torch.where(rejected & ~shrink_left, cand, Rb)
        degenerate = torch.abs(Rb - Lb) <= torch.maximum(torch.abs(Lb), torch.abs(Rb)) * 3.5e-4
        bail = rejected & (degenerate | (n_shr >= max_iter))

        accepted = accept_shr | accept_chk
        finish = accepted | bail
        x = torch.where(accepted, cand, old)
        acc_sum = acc_sum + accepted.to(torch.float32)

        pass_i = torch.where(finish, pass_i + 1, pass_i)
        all_done = pass_i >= n_passes
        phase = torch.where(
            finish,
            torch.where(all_done, DONE, ENTER),
            torch.where((is_enter | ph_dbl) & more_dbl, DOUBLE,
            torch.where(start_shrink | (rejected & ~bail), SHRINK,
            torch.where(to_check | chk_more, CHECK, phase)))).to(torch.int32)
        it += 1

    stats = torch.stack([acc_sum.sum(1), acc_n.sum(1), n_evals.sum(1)])
    return x, stats


def lane_hash_base(seeds: torch.Tensor) -> torch.Tensor:
    """``[B]`` int64: ``fmix32(0x9E3779B9 ^ seed)``, the per-lane state of
    ``_hash_words`` in K2 before the draw counter."""
    return fmix32(seeds ^ _GOLDEN)


def lane_uniforms(base: torch.Tensor, it: int):
    """The four uniforms ``(u_init, u_z, u_side, u_shr)`` every lane of K2
    draws at iteration ``it`` (``pallas_slice.py:167-171``)."""
    return tuple(uniform_from_bits(fmix32(base ^ (4 * it + k))) for k in range(4))


def nan_to_neg_inf(lp):
    """NaN read as -inf, the runtime's guard for out-of-support queries."""
    return torch.where(torch.isnan(lp), torch.full_like(lp, -float("inf")), lp)


def sweep_density(path, isvar=None, ref_params=None):
    """The batched density ``(x [B, d], betas [B]) -> [B]`` that K2 evaluates
    for ``path``: :func:`~..paths.lane_log_density` with the sums in the
    kernel's order (a path's ``sweep_log_density`` where it has one); NaN
    reads as -inf. ``isvar [B]`` and ``ref_params`` are those of a
    :class:`~..paths.VariationalPath`."""
    return lambda x, betas: lane_log_density(path, x, betas, isvar, ref_params, sweep=True)


def sweep_reference(x, betas, lane_seeds, path, coord_deltas: bool = False,
                    w: float = 10.0, p: int = 20, n_passes: int = 3, max_iter: int = 1024,
                    phase_counts=None, isvar=None, ref_params=None, coord_counts=None):
    """Plain torch twin of kernel K2.

    ``x [B, d]`` float32 states, ``betas [B]`` float32, ``lane_seeds [B]``
    uint32 seeds as int64. The density is :func:`sweep_density` of the path
    (under a :class:`~..paths.VariationalPath`, of the lanes' ``isvar [B]``
    and the reference's ``ref_params``); with ``coord_deltas`` a query of
    coordinate ``c`` is
    answered as ``base + path.coord_log_density(query, c, beta)``. Returns
    ``(x_new [B, d], lp [B], stats [3, B])`` with ``lp`` the density of
    ``x_new`` and the stats rows accept_sum, accept_n and n_evals. To
    ``phase_counts``, an int64 ``[6]`` tensor on the states' device, every
    loop iteration adds the number of lanes in each phase; to ``coord_counts``,
    an int64 ``[d]`` tensor, the number of lanes that query each coordinate.
    """
    B, d = x.shape
    dev = x.device
    W = float(np.float32(w))
    narrow_w = float(np.float32(1.1) * np.float32(w))  # the kernel's 1.1f * w
    density = sweep_density(path, isvar, ref_params)

    def lp_eval(xv):
        return density(xv, betas)

    def coord_eval(v, c):
        return nan_to_neg_inf(path.coord_log_density(v, c, betas))

    hash_base = lane_hash_base(lane_seeds)
    x = x.clone()
    lp_cur = lp_eval(x)
    fz = torch.zeros(B, dtype=torch.float32, device=dev)
    iz = torch.zeros(B, dtype=torch.int64, device=dev)
    (old, z, L, R, lpL, lpR, Lb, Rb, cand, lp_cand, Lh, Rh, lpLh, lpRh, base) = (
        fz.clone() for _ in range(15))
    acc_sum, acc_n, n_evals = fz.clone(), fz.clone(), fz.clone()
    n_steps = n_passes * d
    phase = iz + (ENTER if n_steps > 0 else DONE)
    j, K, n_shr = iz.clone(), iz.clone(), iz.clone()

    it = 0
    while bool((phase != DONE).any()):
        if phase_counts is not None:
            phase_counts += torch.bincount(phase, minlength=6)
        u_init, u_z, u_side, u_shr = lane_uniforms(hash_base, it)
        e_z = -f32math.log(u_z)

        c = (j % d)[:, None]
        if coord_counts is not None:
            coord_counts += torch.bincount(c[phase != DONE, 0], minlength=d)
        is_enter = phase == ENTER
        xc = x.gather(1, c)[:, 0]
        old = torch.where(is_enter, xc, old)
        z = torch.where(is_enter, lp_cur - e_z, z)
        L = torch.where(is_enter, f32math.fma(u_init, -W, old), L)
        R = torch.where(is_enter, L + W, R)

        grow_left = u_side <= 0.5
        span = R - L
        dbl_q = torch.where(grow_left, L - span, R + span)
        cand_draw = f32math.fma(u_shr, Rb - Lb, Lb)
        M = (Lh + Rh) * 0.5
        query = torch.where(
            is_enter, L,
            torch.where(phase == INIT_R, R,
            torch.where(phase == DOUBLE, dbl_q,
            torch.where(phase == SHRINK, cand_draw,
            torch.where(phase == CHECK, M, old)))))

        if coord_deltas:
            base = torch.where(is_enter, lp_cur - coord_eval(xc, c[:, 0]), base)
            lp_q = base + coord_eval(query, c[:, 0])
        else:
            lp_q = lp_eval(x.scatter(1, c, query[:, None]))
        n_evals = n_evals + (phase != DONE).to(torch.float32)

        lpL = torch.where(is_enter, lp_q, lpL)
        ph_initr = phase == INIT_R
        lpR = torch.where(ph_initr, lp_q, lpR)
        K = torch.where(ph_initr, p, K)

        ph_dbl = phase == DOUBLE
        L = torch.where(ph_dbl & grow_left, dbl_q, L)
        R = torch.where(ph_dbl & ~grow_left, dbl_q, R)
        lpL = torch.where(ph_dbl & grow_left, lp_q, lpL)
        lpR = torch.where(ph_dbl & ~grow_left, lp_q, lpR)
        K = torch.where(ph_dbl, K - 1, K)

        more_dbl = (K > 0) & ((z < lpL) | (z < lpR))
        start_shrink = (ph_initr | ph_dbl) & ~more_dbl
        Lb = torch.where(start_shrink, L, Lb)
        Rb = torch.where(start_shrink, R, Rb)
        n_shr = torch.where(start_shrink, 0, n_shr)

        ph_shr = phase == SHRINK
        cand = torch.where(ph_shr, cand_draw, cand)
        lp_cand = torch.where(ph_shr, lp_q, lp_cand)
        n_shr = torch.where(ph_shr, n_shr + 1, n_shr)
        consider = ph_shr & (z < lp_q)
        acc_n = acc_n + consider.to(torch.float32)
        narrow = (R - L) <= narrow_w
        accept_shr = consider & narrow
        to_check = consider & ~narrow
        Lh = torch.where(to_check, L, Lh)
        Rh = torch.where(to_check, R, Rh)
        lpLh = torch.where(to_check, lpL, lpLh)
        lpRh = torch.where(to_check, lpR, lpRh)

        ph_chk = phase == CHECK
        take_left = cand < M
        crossed = (old < M) ^ take_left
        Lh = torch.where(ph_chk & ~take_left, M, Lh)
        Rh = torch.where(ph_chk & take_left, M, Rh)
        lpLh = torch.where(ph_chk & ~take_left, lp_q, lpLh)
        lpRh = torch.where(ph_chk & take_left, lp_q, lpRh)
        chk_rej = ph_chk & crossed & (z >= lpLh) & (z >= lpRh)
        chk_more = ph_chk & ~chk_rej & ((Rh - Lh) > narrow_w)
        accept_chk = ph_chk & ~chk_rej & ~chk_more

        rejected = (ph_shr & ~consider) | chk_rej
        shrink_left = cand < old
        Lb = torch.where(rejected & shrink_left, cand, Lb)
        Rb = torch.where(rejected & ~shrink_left, cand, Rb)
        degenerate = torch.abs(Rb - Lb) <= torch.maximum(torch.abs(Lb), torch.abs(Rb)) * 3.5e-4
        bail = rejected & (degenerate | (n_shr >= max_iter))

        accepted = accept_shr | accept_chk
        finish = accepted | bail
        x = x.scatter(1, c, torch.where(accepted, cand, xc)[:, None])
        lp_cur = torch.where(accepted, lp_cand, lp_cur)
        acc_sum = acc_sum + accepted.to(torch.float32)

        j = torch.where(finish, j + 1, j)
        all_done = j >= n_steps
        phase = torch.where(
            finish,
            torch.where(all_done, DONE, ENTER),
            torch.where(is_enter, INIT_R,
            torch.where(more_dbl & (ph_initr | ph_dbl), DOUBLE,
            torch.where(start_shrink | (rejected & ~bail), SHRINK,
            torch.where(to_check | chk_more, CHECK, phase)))))
        it += 1

    if coord_deltas:
        # the deltas drift by float32 rounding over the sweep: hand back the
        # exactly recomputed density of the final state, as the JAX kernel does
        lp_cur = lp_eval(x)
    return x, lp_cur, torch.stack([acc_sum, acc_n, n_evals])


class SliceSamplerCUDA(Explorer):
    """Coordinate-wise slice sampler over the whole replica batch.

    Same defaults and meaning as ``SliceSamplerPallas``: ``w=10, p=20,
    n_passes=3, max_iter=1024``. A path that is a sum of per-coordinate terms
    (``coord_factor``) runs the banded kernel K1 when ``coord_deltas`` and
    ``parallel_coords`` are both true; every other case runs the general
    kernel K2, in delta mode when ``coord_deltas`` is true and the path has a
    coordinate term. A path with a user's CUDA source runs that source's
    library: K1's user term for ``coord_source`` (with ``coord_deltas`` and
    ``parallel_coords``), K2's user instance for a ``DeviceDensity`` of kind
    ``USER``. ``launches`` counts the launches of each CUDA kernel (K1 with
    the toy term, the variational term and a user's term, K2 for the
    library's densities and for a user's), for every instance.
    """

    launches = {"banded_slice_sweep": 0, "banded_slice_sweep_variational": 0, "slice_sweep": 0,
                "slice_sweep_user": 0, "banded_slice_sweep_user": 0}

    def __init__(self, w: float = 10.0, p: int = 20, n_passes: int = 3,
                 max_iter: int = 1024, coord_deltas: bool = True,
                 parallel_coords: bool = True):
        self.w = float(w)
        self.p = int(p)
        self.n_passes = int(n_passes)
        self.max_iter = int(max_iter)
        self.coord_deltas = bool(coord_deltas)
        self.parallel_coords = bool(parallel_coords)

    @classmethod
    def reset_launches(cls) -> None:
        for name in cls.launches:
            cls.launches[name] = 0

    def _banded(self, path) -> bool:
        if isinstance(path, VariationalPath):  # K1's variational term, on the toy term's path
            if not hasattr(path.variational, "coord_param_arrays"):
                return False
            path = path.fixed
        elif getattr(path, "coord_source", None) is not None:
            return self.coord_deltas and self.parallel_coords
        return self.coord_deltas and self.parallel_coords and hasattr(path, "coord_factor")

    def check_target(self, target) -> None:
        """The kernels take continuous coordinates only, with a density on
        the device: a host-evaluated target, or one with an
        ``integer_mask`` or a ``binary_mask``, raises. (The JAX
        ``SliceSamplerPallas`` runs its XLA sampler for such a target instead,
        without saying so.)"""
        refusal = getattr(target, "device_refusal", None)
        if refusal is not None:
            raise ValueError(
                f"SliceSamplerCUDA: {refusal}, so no CUDA kernel can evaluate this "
                f"{type(target).__name__}. Pass explorer={self._plain()}, or keep the "
                "target's default explorer, AutoMALA().")
        if getattr(target, "host_evaluated", False):
            raise ValueError(
                f"SliceSamplerCUDA: {type(target).__name__}'s density is evaluated on the host, "
                "which a CUDA kernel cannot call (as the JAX runtime refuses its Pallas "
                f"kernels for such a target). Pass explorer={self._plain()}.")
        for mask in ("integer_mask", "binary_mask"):
            if getattr(target, mask, None) is not None:
                raise NotImplementedError(
                    f"SliceSamplerCUDA: {type(target).__name__} has a {mask} (ordinal or Bool "
                    "coordinates), which the CUDA slice kernels do not take. Pass "
                    "explorer=SliceSampler(), the target's default explorer, which takes the "
                    "masks from the target.")

    def _plain(self) -> str:
        """The torch sampler with this sampler's values, for the refusals."""
        return (f"SliceSampler(w={self.w}, p={self.p}, n_passes={self.n_passes}, "
                f"max_iter={self.max_iter})")

    def check_dtype(self, dtype) -> None:
        """The kernels compute in float32: a float64 run raises. (The JAX
        runtime runs its XLA sampler in place of ``SliceSamplerPallas`` for
        such a run, without saying so.)"""
        if dtype != torch.float32:
            raise ValueError(
                f"SliceSamplerCUDA: the CUDA slice kernels compute in float32; a {dtype} run "
                f"takes the torch sampler: pass explorer={self._plain()}.")

    def check_path(self, path) -> None:
        if self._banded(path):
            return
        describe = getattr(path, "device_density", None)
        if describe is not None and describe() is not None:
            return
        if isinstance(path, VariationalPath) and not hasattr(path.variational, "coord_param_arrays"):
            raise NotImplementedError(
                f"SliceSamplerCUDA: the general slice kernel K2 takes a mean-field Gaussian "
                f"reference's mean and std as arrays; {type(path.variational).__name__} is "
                "not one (ROADMAP queue 1, item 11b: references of other families). Pass "
                "explorer=SliceSampler() for this run."
            )
        fixed = path.fixed if isinstance(path, VariationalPath) else path
        if getattr(fixed, "coord_source", None) is not None:
            raise NotImplementedError(
                f"SliceSamplerCUDA: {type(fixed).__name__}'s coordinate terms as CUDA source "
                "(coord_source) run on kernel K1's user term, which takes neither a variational "
                "reference nor coord_deltas=False or parallel_coords=False; this run has "
                f"{'a variational reference' if fixed is not path else 'one of those settings'}."
                " Give the path a device density for K2 (a DeviceSource of hook 'target'), or "
                "pass explorer=SliceSampler() for this run.")
        if getattr(fixed, "has_coordwise", False):
            raise NotImplementedError(
                f"SliceSamplerCUDA: {type(fixed).__name__} has coordinate-wise densities but "
                "no device density. They are torch callables, which the CUDA kernels cannot "
                "run: give the path its two terms as CUDA source beside them "
                "(InterpolatingPath(..., coord_source=DeviceSource(hook='coord', ...)), "
                "pigeons_tpu_torch/device_source.py: SourceCoordTarget), which kernel K1 runs, "
                "or pass explorer=SliceSampler() for this run.")
        raise NotImplementedError(
            f"SliceSamplerCUDA: {type(fixed).__name__} has no device density for the general "
            "slice kernel K2, which evaluates the density inside the kernel. It has compiled "
            "in the toy MVN, the funnel, the banana, the flat-prior MVN and the BayesianModel "
            "targets hierarchical_normal, eight_schools (centred and not), unid_target, "
            "logistic_regression, bernoulli_target and mrna_target, under their own prior or "
            "N(0, sigma^2 I). Give a user's density as CUDA source beside its torch form "
            "(pigeons_tpu_torch/device_source.py: DeviceSource, as SourceTarget, "
            "CustomPath(..., source=...) or a BayesianModel with SourceLikelihood), which K2 "
            "compiles into a library of its own, or pass explorer=SliceSampler() for this "
            "run."
        )

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        """One sweep over ``xs [B, d]``; ``keys [B, 2]`` are the lanes' keys,
        ``betas [B]`` their annealing parameters. K1 does not compute the
        joint density (``lp`` is ``None``); K2 returns it. Either way the
        runtime evaluates it again, fused with the swap's. Under a
        :class:`~..paths.VariationalPath` K1 runs with its variational term
        and K2, always in full mode, with the variational blend, from
        ``isvar [B]`` and the reference's ``ref_params``."""
        self.check_path(path)
        seeds = lane_seeds(keys)
        if self._banded(path) and getattr(path, "coord_source", None) is not None:
            x_new, stats = banded_sweep(xs, betas, seeds, self.w, self.p, self.n_passes,
                                        self.max_iter, user=UserTerm(betas, path.coord_source))
            lp = None
        elif self._banded(path):
            term = None
            if isinstance(path, VariationalPath):
                mean, std = path.variational.coord_param_arrays(ref_params)
                path = path.fixed
                a_target = float(path.coord_factor(torch.ones((), dtype=torch.float32)))
                term = VariationalTerm(betas, isvar, ref_params["active"], a_target, mean, std)
            x_new, stats = banded_sweep(xs, path.coord_factor(betas), seeds, self.w, self.p,
                                        self.n_passes, self.max_iter, term)
            lp = None
        else:
            # delta mode has one coordinate term, the toy path's (kToyMvn); a
            # delta query cannot read the reference's per-coordinate arrays
            deltas = self.coord_deltas and hasattr(path, "coord_factor")
            x_new, lp, stats = sweep(xs, betas, seeds, path, deltas, self.w, self.p,
                                     self.n_passes, self.max_iter, isvar, ref_params)
        return StepOut(x=x_new, lp=lp, accept_sum=stats[0], accept_n=stats[1],
                       n_steps=stats[2])


def banded_sweep(x, a, seeds, w: float = 10.0, p: int = 20, n_passes: int = 3,
                 max_iter: int = 1024, variational: VariationalTerm = None, user: UserTerm = None):
    """Run one sweep: the twin for CPU tensors, kernel K1 for CUDA tensors
    (with ``user``, the user's library; ``a`` is then the lanes' betas and
    unused), inside a profiler range named as its launch counter."""
    name = ("banded_slice_sweep_user" if user is not None else "banded_slice_sweep"
            if variational is None else "banded_slice_sweep_variational")
    with torch.profiler.record_function(name):
        if x.device.type == "cpu":
            return banded_sweep_reference(x, a, seeds, w, p, n_passes, max_iter,
                                          variational=variational, user=user)
        if user is not None:
            return banded_sweep_user_cuda(x, seeds, user, w, p, n_passes, max_iter)
        return banded_sweep_cuda(x, a, seeds, w, p, n_passes, max_iter, variational)


def sweep(x, betas, seeds, path, coord_deltas: bool = False, w: float = 10.0, p: int = 20,
          n_passes: int = 3, max_iter: int = 1024, isvar=None, ref_params=None):
    """Run one sweep: the twin for CPU tensors, kernel K2 for CUDA tensors
    (a user's density: its library's instance), inside a profiler range named
    as its launch counter."""
    density = path.device_density() if hasattr(path, "device_density") else None
    user = density is not None and density.kind == USER
    with torch.profiler.record_function("slice_sweep_user" if user else "slice_sweep"):
        if x.device.type == "cpu":
            return sweep_reference(x, betas, seeds, path, coord_deltas, w, p, n_passes,
                                   max_iter, isvar=isvar, ref_params=ref_params)
        return sweep_cuda(x, betas, seeds, path, coord_deltas, w, p, n_passes, max_iter,
                          isvar=isvar, ref_params=ref_params)


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


TOY_QUADRATIC, VARIATIONAL_QUADRATIC = 0, 1  # csrc/densities.cuh: enum CoordTerm


def banded_sweep_cuda(x, a, seeds, w: float = 10.0, p: int = 20,
                      n_passes: int = 3, max_iter: int = 1024,
                      variational: VariationalTerm = None):
    """Launch kernel K1 on the current stream. Same contract as
    :func:`banded_sweep_reference`."""
    if x.device.type != "cuda":
        raise ValueError(f"banded_sweep_cuda needs CUDA tensors, got {x.device}")
    B, d = x.shape
    _check(x, "x", torch.float32, (B, d), x.device)
    _check(a, "a", torch.float32, (B,), x.device)
    _check(seeds, "lane_seeds", torch.int64, (B,), x.device)
    term, term_args = TOY_QUADRATIC, (None, None, None, None, None, 0.0)
    if variational is not None:
        vt = variational
        active = vt.active.reshape(1)
        _check(vt.beta, "beta", torch.float32, (B,), x.device)
        _check(vt.isvar, "isvar", torch.float32, (B,), x.device)
        _check(active, "active", torch.float32, (1,), x.device)
        _check(vt.mean, "mean", torch.float32, (d,), x.device)
        _check(vt.std, "std", torch.float32, (d,), x.device)
        term = VARIATIONAL_QUADRATIC
        term_args = (vt.beta.data_ptr(), vt.isvar.data_ptr(), active.data_ptr(),
                     vt.mean.data_ptr(), vt.std.data_ptr(), float(vt.a_target))
    from .._build import load_library

    lib = load_library()
    x_out = torch.empty_like(x)
    stats = torch.zeros((3, B), dtype=torch.float32, device=x.device)
    err = lib.banded_slice_sweep(
        x.data_ptr(), a.data_ptr(), seeds.data_ptr(), x_out.data_ptr(), stats.data_ptr(), B, d,
        w, p, n_passes, max_iter, term, *term_args,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"banded_slice_sweep (term {term}) launch failed: CUDA error {err}")
    SliceSamplerCUDA.launches[
        "banded_slice_sweep" if variational is None else "banded_slice_sweep_variational"] += 1
    return x_out, stats


MAX_DENSITY_PARAMS = 8  # csrc/densities.cuh: DensityParams
MAX_DENSITY_ARRAYS = 4  # csrc/densities.cuh: DensityArrays
PRIOR_ROW = 8  # floats in a row of the prior table


def _array_args(arrays, device, what):
    """The ctypes pointers and lengths of up to ``MAX_DENSITY_ARRAYS`` 1-D
    float32 tensors on ``device``, which a kernel reads in place."""
    if len(arrays) > MAX_DENSITY_ARRAYS:
        raise ValueError(f"{what}: more than {MAX_DENSITY_ARRAYS} arrays")
    for i, t in enumerate(arrays):
        _check(t, f"{what} array {i}", torch.float32, (t.numel(),), device)
    pad = MAX_DENSITY_ARRAYS - len(arrays)
    return ((ctypes.c_void_p * MAX_DENSITY_ARRAYS)(*[t.data_ptr() for t in arrays], *[None] * pad),
            (ctypes.c_int * MAX_DENSITY_ARRAYS)(*[t.numel() for t in arrays], *[0] * pad))


def banded_sweep_user_cuda(x, seeds, user: UserTerm, w: float = 10.0, p: int = 20,
                           n_passes: int = 3, max_iter: int = 1024, lib=None):
    """Launch kernel K1 with a user's term (``UserTerm``: the lanes' betas
    and the ``"coord"`` source, whose library is built at first use) on the
    current stream. Same contract as :func:`banded_sweep_reference` with
    ``user``. ``lib``: another build of the source's library
    (``_build.open_user``), for the tools that time variants."""
    if x.device.type != "cuda":
        raise ValueError(f"banded_sweep_user_cuda needs CUDA tensors, got {x.device}")
    B, d = x.shape
    _check(x, "x", torch.float32, (B, d), x.device)
    _check(user.beta, "beta", torch.float32, (B,), x.device)
    _check(seeds, "lane_seeds", torch.int64, (B,), x.device)
    src = user.source
    arrays, lens = _array_args(src.arrays, x.device, "the coordinate source's")
    from .._build import load_user

    lib = lib or load_user(src)
    x_out = torch.empty_like(x)
    stats = torch.zeros((3, B), dtype=torch.float32, device=x.device)
    err = lib.banded_slice_sweep_user(
        x.data_ptr(), user.beta.data_ptr(), seeds.data_ptr(), x_out.data_ptr(), stats.data_ptr(),
        B, d, w, p, n_passes, max_iter, (ctypes.c_float * MAX_DENSITY_PARAMS)(*src.params),
        arrays, lens, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_slice_sweep_user launch failed: CUDA error {err}")
    SliceSamplerCUDA.launches["banded_slice_sweep_user"] += 1
    return x_out, stats


class KernelInputs(NamedTuple):
    """What :func:`sweep_cuda` hands kernel K2 besides the states, as ctypes
    values; ``keep`` holds the tensors whose pointers they are."""

    params: object
    arrays: object
    array_lens: object
    prior: object
    n_prior: int
    variational: tuple  # isvar, mean, std, active: device pointers or None
    keep: tuple


def kernel_inputs(density, B: int, d: int, device, isvar=None, ref_params=None) -> KernelInputs:
    """Check ``density`` (a :class:`~..paths.DeviceDensity`) and a variational
    run's ``isvar [B]`` and ``ref_params`` (``mean [d]``, ``std [d]``,
    ``active``: float32 tensors on ``device``, which the kernel reads in
    place) and lay them out for ``slice_sweep``."""
    if len(density.params) > MAX_DENSITY_PARAMS:
        raise ValueError(f"density kind {density.kind}: too many parameters for kernel K2")
    arrays, lens = _array_args(density.arrays, device, f"density kind {density.kind}:")
    rows = [float(v) for row in density.prior for v in row]
    if len(rows) != PRIOR_ROW * len(density.prior):
        raise ValueError(f"a row of the prior table has {PRIOR_ROW} entries")
    keep = tuple(density.arrays)
    variational = (None, None, None, None)
    if ref_params is not None:
        active = ref_params["active"].reshape(1)
        _check(isvar, "isvar", torch.float32, (B,), device)
        _check(ref_params["mean"], "mean", torch.float32, (d,), device)
        _check(ref_params["std"], "std", torch.float32, (d,), device)
        _check(active, "active", torch.float32, (1,), device)
        tensors = (isvar, ref_params["mean"], ref_params["std"], active)
        variational = tuple(t.data_ptr() for t in tensors)
        keep += tensors
    return KernelInputs(
        (ctypes.c_float * MAX_DENSITY_PARAMS)(*density.params), arrays, lens,
        (ctypes.c_float * max(len(rows), 1))(*rows), len(density.prior), variational, keep)


def launcher_group(path, B: int, d: int, lib=None) -> int:
    """The threads a lane kernel K2's launcher picks in full mode for ``B``
    lanes of ``path`` (``sweep_cuda(..., group=0)``), as the library ``lib``
    computes it: by default the card's library, or for a user's density its
    source's (``slice_sweep_user_group``: slots of speculated queries, or one
    thread where a block's copies of the state do not fit)."""
    from .._build import load_library, load_user

    density = path.device_density()
    variational = int(isinstance(path, VariationalPath))
    if density.kind == USER:
        return (lib or load_user(density.source)).slice_sweep_user_group(B, d, variational)
    params = (ctypes.c_float * MAX_DENSITY_PARAMS)(*density.params)
    return (lib or load_library()).slice_sweep_group(B, d, density.kind, params, variational)


def sweep_cuda(x, betas, seeds, path, coord_deltas: bool = False, w: float = 10.0,
               p: int = 20, n_passes: int = 3, max_iter: int = 1024, group: int = 0,
               isvar=None, ref_params=None, lib=None):
    """Launch kernel K2 on the current stream. Same contract as
    :func:`sweep_reference`; the density is the path's ``device_density()``,
    whose arrays (model data) and, under a :class:`~..paths.VariationalPath`,
    ``isvar`` and ``ref_params`` the kernel reads from device memory: nothing
    comes back to the host. ``group`` is the number of threads that share a
    lane's density evaluation in full mode (1, 8, 16 or 32; for eight
    schools, unid, the Bernoulli model and a user's density the group
    evaluates the machine's next queries at once; the result does not depend
    on it); 0 leaves the choice to the launcher, which makes it from the
    density, ``B`` and ``d``. Delta mode runs one thread a lane and refuses a
    larger group. A density of kind ``USER`` runs its source's library (built
    at first use) in full mode: ``slice_sweep_user``; ``lib`` is another
    build of that library (``_build.open_user``'s; one of sources without
    groups takes none and runs one thread a lane), for the tools that time
    variants."""
    if x.device.type != "cuda":
        raise ValueError(f"sweep_cuda needs CUDA tensors, got {x.device}")
    B, d = x.shape
    _check(x, "x", torch.float32, (B, d), x.device)
    _check(betas, "betas", torch.float32, (B,), x.device)
    _check(seeds, "lane_seeds", torch.int64, (B,), x.device)
    density = path.device_density()
    if density is None:
        raise ValueError(f"{type(path).__name__} has no device density for kernel K2")
    if not isinstance(path, VariationalPath):
        isvar = ref_params = None
    inputs = kernel_inputs(density, B, d, x.device, isvar, ref_params)
    x_out = torch.empty_like(x)
    lp = torch.empty(B, dtype=torch.float32, device=x.device)
    stats = torch.empty((3, B), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if density.kind == USER:
        if coord_deltas:
            raise ValueError("a user's density runs kernel K2 in full mode, not with coord_deltas")
        from .._build import load_user

        lib = lib or load_user(density.source)
        if group > 1 and not lib.takes_group:
            raise ValueError("this build of the source's library runs one thread a lane")
        err = lib.slice_sweep_user(
            x.data_ptr(), betas.data_ptr(), seeds.data_ptr(), x_out.data_ptr(), lp.data_ptr(),
            stats.data_ptr(), B, d, inputs.params, inputs.arrays, inputs.array_lens,
            inputs.prior, inputs.n_prior, *inputs.variational, w, p, n_passes, max_iter,
            *[group] * lib.takes_group, stream)
        if err != 0:
            raise RuntimeError(f"slice_sweep_user failed for a {density.source.hook!r} source, "
                               f"d={d}, group={group}: error {err} (-1: arrays, prior table or "
                               "group it does not take, -2: a lane's state and its copies too "
                               "large for shared memory; positive: CUDA error code)")
        SliceSamplerCUDA.launches["slice_sweep_user"] += 1
        return x_out, lp, stats
    from .._build import load_library

    lib = load_library()
    err = lib.slice_sweep(
        x.data_ptr(), betas.data_ptr(), seeds.data_ptr(), x_out.data_ptr(), lp.data_ptr(),
        stats.data_ptr(), B, d, density.kind, int(coord_deltas), inputs.params, inputs.arrays,
        inputs.array_lens, inputs.prior, inputs.n_prior, *inputs.variational, w, p, n_passes,
        max_iter, group, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"slice_sweep failed for density kind {density.kind}, d={d}, "
            f"coord_deltas={coord_deltas}, group={group}: error {err} (negative: the kernel "
            "does not take this case, -2 where a block's lane states and buffers would need "
            "more than the 227 KB of shared memory a block may use; positive: CUDA error code)"
        )
    SliceSamplerCUDA.launches["slice_sweep"] += 1
    return x_out, lp, stats
