"""Banded slice sampler for separable densities: CUDA kernel K1 and its twin.

Counterpart of the banded branch of ``SliceSamplerPallas.step_batched``
(``pigeons_tpu/ops/pallas_slice.py:598-840``). The TPU kernel it replaces is
``pallas_slice.py:_banded_sweep_kernel``. For a density that is a sum of
per-coordinate terms, ``lp(x) = sum_c f(x_c)``, the joint density cancels
from every coordinate's slice test, so each (lane, coordinate) element runs
its own one-dimensional Neal slice sampler (doubling, shrinking, halving
check) for ``n_passes`` passes, independently of every other element.

Two implementations of that machine, which agree bit for bit on the card:

* ``csrc/banded_slice.cu``: one CUDA thread per element, working on the
  row-major ``[B, d]`` states in place of the TPU kernel's padded ``[d, B]``
  bands. It reads and writes the 8 MB of state of bench config 1 once, so
  on an H100 it is bound by integer and float ALU work and by warp
  divergence: a warp runs until its slowest element is DONE. The design does
  nothing about that divergence yet.
* :func:`banded_sweep_reference`, the same machine as torch ops over all
  ``[B, d]`` elements at once: the JAX kernel with one band of all ``d``
  rows. CPU tensors run here; a CUDA tensor reaches the kernel or raises.

Random numbers are counter-based, as in the JAX kernel: the element of lane
``b`` and coordinate ``c`` draws its two uniforms of loop iteration ``it``
from ``fmix32(fmix32(0x9E3779B9 ^ s) ^ (2 it + k))``, with
``s = fmix32(lane_seed[b] ^ c * 0x85EBCA77)`` and the lane seed the first
word of ``jax.random.bits`` of the lane's key. Each element counts its own
iterations from 0, as every element of a TPU band does, so the draws do not
depend on how the batch is cut into blocks or bands.

XLA's CPU backend, which runs the JAX kernel in the tests, evaluates the
coordinate term's ``precision(beta)``, the step-out ``old - w * u`` and the
shrink draw ``Lb + u * (Rb - Lb)`` as fused multiply-adds and ``log`` as the
Cephes polynomial. Both implementations here do the same (``__fmaf_rn`` and
an exact torch emulation of it), and nothing else is fused.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import f32math, rng
from .base import Explorer, StepOut

ENTER, DOUBLE, SHRINK, CHECK, DONE = 0, 2, 3, 4, 5  # the JAX kernel's phase codes

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


def banded_sweep_reference(x, a, lane_seeds, w: float = 10.0, p: int = 20,
                           n_passes: int = 3, max_iter: int = 1024):
    """Plain torch twin of kernel K1.

    ``x [B, d]`` float32 states, ``a [B]`` float32 coordinate-term factors
    (the term is ``f(v) = (a v) v``, NaN read as -inf), ``lane_seeds [B]``
    uint32 seeds as int64. Returns ``(x_new [B, d], stats [3, B])`` with the
    rows accept_sum, accept_n and n_evals summed over coordinates.
    """
    B, d = x.shape
    dev = x.device
    W = float(np.float32(w))
    narrow_w = float(np.float32(1.1) * np.float32(w))  # the kernel's 1.1f * w
    a2 = a[:, None]
    neg_inf = torch.full((), -float("inf"), device=dev)

    def ceval(v):
        f = (a2 * v) * v
        return torch.where(torch.isnan(f), neg_inf, f)

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


class SliceSamplerCUDA(Explorer):
    """Coordinate-wise slice sampler over the whole replica batch, for paths
    whose density is a sum of per-coordinate terms (``coord_factor``).

    Same defaults as ``SliceSamplerPallas``: ``w=10, p=20, n_passes=3,
    max_iter=1024``. ``n_kernel_launches`` counts launches of the CUDA kernel,
    for every instance.
    """

    n_kernel_launches = 0

    def __init__(self, w: float = 10.0, p: int = 20, n_passes: int = 3,
                 max_iter: int = 1024):
        self.w = float(w)
        self.p = int(p)
        self.n_passes = int(n_passes)
        self.max_iter = int(max_iter)

    def check_path(self, path) -> None:
        if not hasattr(path, "coord_factor"):
            raise NotImplementedError(
                f"SliceSamplerCUDA needs a path whose density is a sum of "
                f"per-coordinate terms; {type(path).__name__} has none. The "
                "general-density kernel K2 (_sweep_kernel) is not ported yet "
                "(ROADMAP queue 2, K2)."
            )

    def step_batched(self, keys, xs, betas, path) -> StepOut:
        """One sweep over ``xs [B, d]``; ``keys [B, 2]`` are the lanes' keys,
        ``betas [B]`` their annealing parameters. The joint density is not
        computed: the runtime evaluates it fused with the swap's."""
        self.check_path(path)
        a = path.coord_factor(betas)
        x_new, stats = banded_sweep(xs, a, lane_seeds(keys), self.w, self.p,
                                    self.n_passes, self.max_iter)
        return StepOut(x=x_new, lp=None, accept_sum=stats[0], accept_n=stats[1],
                       n_steps=stats[2])


def banded_sweep(x, a, seeds, w: float = 10.0, p: int = 20, n_passes: int = 3,
                 max_iter: int = 1024):
    """Run one sweep: the twin for CPU tensors, kernel K1 for CUDA tensors."""
    if x.device.type == "cpu":
        return banded_sweep_reference(x, a, seeds, w, p, n_passes, max_iter)
    return banded_sweep_cuda(x, a, seeds, w, p, n_passes, max_iter)


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def banded_sweep_cuda(x, a, seeds, w: float = 10.0, p: int = 20,
                      n_passes: int = 3, max_iter: int = 1024):
    """Launch kernel K1 on the current stream. Same contract as
    :func:`banded_sweep_reference`."""
    if x.device.type != "cuda":
        raise ValueError(f"banded_sweep_cuda needs CUDA tensors, got {x.device}")
    B, d = x.shape
    _check(x, "x", torch.float32, (B, d), x.device)
    _check(a, "a", torch.float32, (B,), x.device)
    _check(seeds, "lane_seeds", torch.int64, (B,), x.device)
    from .._build import load_library

    lib = load_library()
    x_out = torch.empty_like(x)
    stats = torch.zeros((3, B), dtype=torch.float32, device=x.device)
    err = lib.banded_slice_sweep(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(a.data_ptr()),
        ctypes.c_void_p(seeds.data_ptr()), ctypes.c_void_p(x_out.data_ptr()),
        ctypes.c_void_p(stats.data_ptr()), ctypes.c_int(B), ctypes.c_int(d),
        ctypes.c_float(w), ctypes.c_int(p), ctypes.c_int(n_passes),
        ctypes.c_int(max_iter),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"banded_slice_sweep launch failed: CUDA error {err}")
    SliceSamplerCUDA.n_kernel_launches += 1
    return x_out, stats
