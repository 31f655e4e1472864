"""float32 ``exp``, ``expm1``, ``log``, ``log1p``, ``erfinv``, ``lgamma`` and the
power ``10 ** q`` as plain torch ops.

The JAX package computes its swap acceptances (``exp``), its streaming
logsumexp recorders (``log1p`` of ``exp``) and its normal draws (``erf_inv``)
with the float32 polynomials that XLA emits: the Cephes ``expf``/``logf``/
``log1pf`` approximations and Giles' single-precision ``erfinv``. torch's own
``exp``/``log1p``/``erfinv`` are accurate too, but round differently in about
one case in ten (up to tens of ulp for ``erfinv``), which would make swap
decisions, Kahan stacks and normal draws drift from the reference.

The functions below evaluate the same polynomials operation for operation.
XLA's CPU backend contracts each multiply that feeds an add into a fused
multiply-add, so those steps go through :func:`fma`, an exact emulation of
the float32 fused multiply-add in float64 (the card's ``fmaf`` gives the same
bits). XLA's CPU code also flushes subnormal results to zero, which
:func:`exp` and :func:`log` reproduce. Everything else is a separate IEEE
multiply, add, divide or ``sqrt``.

``exp``, ``log``, ``log1p`` and ``logaddexp`` are bitwise equal to the JAX
package's on the CPU (checked in ``tests/test_torch_rng.py``). ``erfinv``
is too, except in its tail branch (``|x| > 0.9966``), where XLA takes
``sqrt`` from the CPU's reciprocal-square-root estimate refined by one
Newton step, which can be 1 ulp off the correctly rounded ``sqrt`` used here;
normal draws then differ by at most 2 ulp. All of them give identical bits
on torch's CPU and CUDA backends.

``expm1`` is XLA's CPU expansion: ``exp(x) - 1`` for ``|x| > 0.5``, else
``tanh(x / 2) (exp(x) + 1)`` with XLA's rational ``tanh``; bitwise. ``10 ** q``
(:func:`pow10`) is not XLA's own code: its CPU backend calls the C library's
``powf``, and on glibc (2.28 on) that is the Arm optimized-routines
algorithm: ``log2`` of the base by a 16-entry table and a degree-5 polynomial
(for the base 10 one double constant, ``_LOG2_10``), ``q`` times it in double,
then ``exp2`` by a 32-entry table and a cubic, all in double, rounded once to
float32. :func:`pow10` is that algorithm in double arithmetic without fused
multiply-adds (glibc's FMA build fuses four of them; in double that moves the
float32 result only when it lies within about 2^-50 of a rounding boundary):
bitwise equal to XLA's on every float32 ``q`` of a sweep of 4 million over
[-5, 5] (``tests/test_torch_library_models.py``), subnormal results flushed
to 0 as XLA's CPU code flushes them.

float64. Every function here takes a float64 tensor to its float64 form in
:mod:`.f64math`, the one XLA's CPU code evaluates in a float64 run (its
``exp``, glibc's ``log``, ...), so that one call site serves both dtypes.

Gradients. The bit-level forwards view floats as integers, which autograd
cannot pass through, so ``fma``, ``exp``, ``log``, ``log1p`` and ``lgamma``
(and ``expm1`` and ``pow10``) are ``torch.autograd.Function``s whose forward is the plain function above
and whose backward is the analytic derivative in float32, the rule that
``jax.grad`` applies to the same primitive (``exp``'s is ``g * exp(x)``,
not a derivative of the Cephes polynomial). A call goes through the
``Function`` only when grad mode is on and an argument requires a gradient;
every other call, the whole runtime's included, is the plain function.
"""

from __future__ import annotations

import math
import struct

import torch

from . import f64math


def _round(v: float) -> float:
    """``v`` rounded to float32, as an exact Python float."""
    return struct.unpack("<f", struct.pack("<f", v))[0]


def _f(bits: int) -> float:
    """The float32 with IEEE bit pattern ``bits``, as an exact Python float."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# Cephes expf
_EXP_LO, _EXP_HI = _f(0xC2AF999A), _f(0x42B1999A)  # -87.8, 88.8
_LOG2EF = _f(0x3FB8AA3B)
_C1 = _f(0x3F318000)  # 0.693359375
_C2 = _f(0xB95E8083)  # -2.12194440e-4
_EXP_P = [_f(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)]

# Cephes logf
_FLT_MIN = _f(0x00800000)
_SQRTHF = _f(0x3F3504F3)
_LOG_A = [_f(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A)]
_LOG_B = [_f(b) for b in (0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50)]
_LOG_C = [_f(b) for b in (0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]

# Cephes log1pf rational approximation on |x| < sqrt(2) - 1
_LOG1P_SMALL = _f(0x3ED413CD)
_LOG1P_P = [_f(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C,
                            0x4273CC76, 0x426473AD, 0x41A05101)]
_LOG1P_Q = [_f(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3,
                            0x43586D8A, 0x42707982)]

# Giles' single-precision erfinv, branches w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)

# XLA's lgamma: Lanczos approximation with g = 7 and nine terms
_LANCZOS_BASE = 0.99999999999980993227684700473478
_LANCZOS = (676.520368121885098567009190444019, -1259.13921672240287047156078755283,
            771.3234287776530788486528258894, -176.61502916214059906584551354,
            12.507343278686904814458936853, -0.13857109526572011689554707,
            9.984369578019570859563e-6, 1.50563273514931155834e-7)
_LOG_SQRT_2PI = (math.log(2.0) + math.log(math.pi)) / 2.0
_LOG_7_5 = math.log(7.5)

# XLA's float32 tanh, the small-argument branch of its expm1: the argument is
# clamped to +-7.99881172, odd polynomial over even polynomial in its square,
# the argument itself below 0.0004
_TANH_CLAMP = _f(0x40FFF644)
_TANH_SMALL = _f(0x39D1B717)
_TANH_P = [_f(b) for b in (0xA59F25C0, 0x2A61337E, 0xAEBD37FF, 0x335C0041, 0x3779434A,
                           0x3A270DED, 0x3BA059DC)]
_TANH_Q = [_f(b) for b in (0x35A0D3D8, 0x38F895D6, 0x3B14AA05, 0x3BA059DD)]

# glibc's powf (the Arm optimized-routines algorithm): log2(10) as its log2
# step computes it (table entry 13, degree-5 polynomial, fused multiply-adds;
# the correctly rounded log2(10) is 0x1.a934f0979a371p+1), the exp2 step's
# shift, cubic and table of 2^(i/32)
_LOG2_10 = float.fromhex("0x1.a934f0979b22dp+1")
_EXP2_SHIFT = float.fromhex("0x1.8p+47")
_EXP2_C = [float.fromhex(h) for h in ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
                                      "0x1.62e42ff0c52d6p-1")]
_EXP2_TAB = [struct.unpack("<d", struct.pack("<Q", b + (i << 47)))[0] for i, b in enumerate((
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540))]
_LN10 = _round(math.log(10.0))


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding.

    The float64 product of two float32 values is exact. The float64 sum is
    rounded to odd (its error, from TwoSum, sets the last bit), and a
    53-bit round-to-odd result rounds to the correct 24-bit one."""
    a = a.double() if torch.is_tensor(a) else a
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    prod = a * b
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)
    # round to odd: an inexact sum becomes its truncation toward zero (one
    # step back where it was rounded away, ``err`` of the other sign) with
    # the last bit set; an exact or non-finite one (``err`` 0 or NaN) stays
    bits = s.view(torch.int64)
    odd = (bits - (err * s < 0).to(torch.int64)) | 1
    return torch.where(torch.abs(err) > 0, odd.view(torch.float64), s).float()


def _exp(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.clamp(torch.floor(_fma(x, _LOG2EF, 0.5)), -127.0, 127.0)
    x = _fma(-fx, _C1, x)
    x = _fma(-fx, _C2, x)
    xd = x.double()  # exact; converted once for the polynomial's steps
    y = _fma(xd, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        y = _fma(y, xd, c)
    y = _fma(y, xd, 0.5)
    y = _fma(y, x * x, xd) + 1.0
    pow2 = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * pow2
    return torch.where(out < _FLT_MIN, torch.zeros_like(out), out)


def _log(y: torch.Tensor) -> torch.Tensor:
    y = torch.where(torch.abs(y) < _FLT_MIN, torch.zeros_like(y), y)
    yc = torch.where(y > _FLT_MIN, y, torch.full_like(y, _FLT_MIN))
    bits = yc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    lt = m < _SQRTHF
    e = e - lt.to(torch.float32)
    x = (m + -1.0) + torch.where(lt, m, torch.zeros_like(m))
    z = x * x
    xd, x3 = x.double(), (z * x).double()  # exact; converted once
    ya = _fma(_fma(xd, _LOG_A[0], _LOG_A[1]), xd, _LOG_A[2])
    yb = _fma(_fma(xd, _LOG_B[0], _LOG_B[1]), xd, _LOG_B[2])
    yc = _fma(_fma(xd, _LOG_C[0], _LOG_C[1]), xd, _LOG_C[2])
    yb = _fma(ya, x3, yb)
    yc = _fma(yb, x3, yc)
    r = _fma(yc, x3, e * _C2)
    r = _fma(e, _C1, (x - z * 0.5) + r)
    nan = torch.full_like(r, float("nan"))
    r = torch.where((y <= 0) | torch.isnan(y), nan, r)
    r = torch.where(y == 0, torch.full_like(r, -float("inf")), r)
    return torch.where(y == float("inf"), y, r)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    xd = x.double()  # exact; converted once for the polynomials' steps
    p = _fma(xd, _LOG1P_P[0], _LOG1P_P[1])
    for c in _LOG1P_P[2:]:
        p = _fma(p, xd, c)
    q = x + _LOG1P_Q[0]
    for c in _LOG1P_Q[1:]:
        q = _fma(q, xd, c)
    small = x + _fma(x2, -0.5, (x * x2) * (p / q))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, _log(x + 1.0))


def _tanh(h: torch.Tensor) -> torch.Tensor:
    hc = torch.clamp(h, -_TANH_CLAMP, _TANH_CLAMP)
    z = hc * hc
    zd = z.double()  # exact; converted once for the polynomials' steps
    p = _fma(zd, _TANH_P[0], _TANH_P[1])
    for c in _TANH_P[2:]:
        p = _fma(zd, p, c)
    q = _fma(zd, _TANH_Q[0], _TANH_Q[1])
    for c in _TANH_Q[2:]:
        q = _fma(zd, q, c)
    t = torch.where(torch.abs(h) < _TANH_SMALL, h, (hc * p) / q)
    return torch.where(torch.abs(h) >= 20.0, torch.copysign(torch.ones_like(h), h), t)


def _expm1(x: torch.Tensor) -> torch.Tensor:
    e = _exp(x)
    h = x * 0.5
    out = torch.where(torch.abs(x) > 0.5, e - 1.0, _tanh(h) * (e + 1.0))
    return torch.where(h == 0, x, out)


def _pow10(q: torch.Tensor) -> torch.Tensor:
    xd = q.double() * _LOG2_10
    kd = (xd + _EXP2_SHIFT) - _EXP2_SHIFT  # xd rounded to a multiple of 1/32
    k = (kd * 32.0).nan_to_num(0.0).clamp(-1e5, 1e5).to(torch.int64)
    r = xd - kd
    tab = torch.tensor(_EXP2_TAB, dtype=torch.float64, device=q.device)
    e = (k >> 5).clamp(-1022, 1023)
    s = tab[k & 31] * ((e + 1023) << 52).view(torch.float64)  # times 2^e, exactly
    y = (_EXP2_C[0] * r + _EXP2_C[1]) * (r * r) + (_EXP2_C[2] * r + 1.0)
    out = (y * s).float()
    out = torch.where(out < _FLT_MIN, torch.zeros_like(out), out)
    out = torch.where(torch.isinf(q), torch.where(q > 0, q, torch.zeros_like(q)), out)
    return torch.where(torch.isnan(q), q, out)


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.logaddexp``: ``max + log1p(exp(-|a - b|))``, ``a + b`` where
    ``a - b`` is NaN (both infinite of one sign, or a NaN operand)."""
    if _is64(a, b):
        return f64math.logaddexp(a, b)
    delta = a - b
    out = torch.maximum(a, b) + _log1p(_exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), a + b, out)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.float64:
        return f64math.erfinv(x)
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    coef = torch.where(lt[..., None], lo, hi)
    p = coef[..., 0]
    wd = w.double()  # exact; converted once
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, wd, coef[..., i])
    out = p * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), out)


def _lgamma(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.gammaln`` in float32 for ``x >= 0.5``: XLA's
    Lanczos sum, step for step, the division by the constant 7.5 a multiplication
    by its float32 reciprocal and the last product fused into its add (the branch that reflects smaller arguments is
    not reproduced: NaN there). Not correctly rounded, up to 4 ulp off; the
    JAX package folds such values into its binomial and beta constants."""
    z = x - 1.0
    s = torch.full_like(x, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        s = s + torch.full_like(x, c) / (z + float(i) + 1.0)
    t = z + 7.5
    log_t = _log1p(z * _round(1.0 / 7.5)) + _round(_LOG_7_5)
    a = (z + 0.5) - t / log_t
    out = _fma(a, log_t, _round(_LOG_SQRT_2PI)) + _log(s)
    return torch.where(x >= 0.5, out, torch.full_like(out, float("nan")))


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------


def _is64(*args) -> bool:
    return any(torch.is_tensor(a) and a.dtype == torch.float64 for a in args)


def _fma_any(a, b, c):
    return f64math.fma(a, b, c) if _is64(a, b, c) else _fma(a, b, c)


def _by_dtype(f32_fn, f64_fn):
    """The float32 form, or for a float64 tensor the :mod:`.f64math` one."""
    return lambda x: f64_fn(x) if x.dtype == torch.float64 else f32_fn(x)


_exp_any = _by_dtype(_exp, f64math.exp)
_log_any = _by_dtype(_log, f64math.log)
_log1p_any = _by_dtype(_log1p, f64math.log1p)
_lgamma_any = _by_dtype(_lgamma, f64math.lgamma)
_expm1_any = _by_dtype(_expm1, f64math.expm1)


def needs_grad(*args) -> bool:
    """Whether a call on ``args`` must go through the ``Function``: to
    record a gradient, or under ``torch.func.vmap``, where an argument does
    not show whether the tensor it stands for requires one, and where the
    bit-level forwards' ``view(dtype)`` has no batching rule in every torch
    version (the ``Function``'s vmap rule runs them on the whole batch)."""
    return any(torch.is_tensor(a) and (_is_batched(a) or (torch.is_grad_enabled()
                                                          and a.requires_grad)) for a in args)


def _is_batched(a) -> bool:
    return torch._C._functorch.is_batchedtensor(a)


def elementwise_vmap(cls):
    """``cls``, an elementwise ``torch.autograd.Function`` of tensors and
    numbers, with a rule for ``torch.func.vmap``: the batched inputs' batch
    dimensions moved to the front (and padded to the widest input's rank),
    the function applied once to the whole batch."""

    def vmap(info, in_dims, *args):
        del info
        rank = max((a.dim() - (d is not None) for a, d in zip(args, in_dims)
                    if torch.is_tensor(a)), default=0)
        out = []
        for a, d in zip(args, in_dims):
            if torch.is_tensor(a) and d is not None:
                a = a.movedim(d, 0)
                a = a.reshape(a.shape[:1] + (1,) * (rank - a.dim() + 1) + a.shape[1:])
            out.append(a)
        return cls.apply(*out), 0

    cls.vmap = staticmethod(vmap)
    return cls


def _unbroadcast(g, like):
    """``g`` summed down to the shape of ``like``: broadcasting's adjoint."""
    return g if g.shape == like.shape else g.sum_to_size(like.shape)


@elementwise_vmap
class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(a, b, c):
        return _fma_any(a, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*(v if torch.is_tensor(v) else None for v in inputs))
        ctx.consts = tuple(None if torch.is_tensor(v) else v for v in inputs[:2])

    @staticmethod
    def backward(ctx, g):
        ta, tb, tc = ctx.saved_tensors
        a = ta if ta is not None else ctx.consts[0]
        b = tb if tb is not None else ctx.consts[1]
        need = ctx.needs_input_grad
        return (_unbroadcast(g * b, ta) if need[0] else None,
                _unbroadcast(g * a, tb) if need[1] else None,
                _unbroadcast(g, tc) if need[2] else None)


@elementwise_vmap
class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _exp_any(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


@elementwise_vmap
class _Log(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _log_any(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / x


@elementwise_vmap
class _Log1p(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _log1p_any(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g / (x + 1.0)


@elementwise_vmap
class _Lgamma(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _lgamma_any(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.digamma(x)


@elementwise_vmap
class _Expm1(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _expm1_any(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y + 1.0)


@elementwise_vmap
class _Pow10(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _pow10(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (_LN10 * y)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding (:func:`_fma`); its
    gradient is ``(g b, g a, g)``."""
    return _Fma.apply(a, b, c) if needs_grad(a, b, c) else _fma_any(a, b, c)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` (:func:`_exp`); gradient ``g exp(x)``."""
    return _Exp.apply(x) if needs_grad(x) else _exp_any(x)


def log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` (:func:`_log`); gradient ``g / y``."""
    return _Log.apply(y) if needs_grad(y) else _log_any(y)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p`` (:func:`_log1p`); gradient ``g / (1 + x)``."""
    return _Log1p.apply(x) if needs_grad(x) else _log1p_any(x)


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``gammaln`` for ``x >= 0.5`` (:func:`_lgamma`); gradient
    ``g digamma(x)``."""
    return _Lgamma.apply(x) if needs_grad(x) else _lgamma_any(x)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``expm1`` (:func:`_expm1`); gradient ``g (expm1(x) + 1)``."""
    return _Expm1.apply(x) if needs_grad(x) else _expm1_any(x)


def pow10(q: torch.Tensor) -> torch.Tensor:
    """``10 ** q`` in float32 as XLA's CPU code computes it, glibc's ``powf``
    (:func:`_pow10`); gradient ``g log(10) 10^q``."""
    return _Pow10.apply(q) if needs_grad(q) else _pow10(q)
