"""Counter-based RNG stream derivation: threefry2x32 keys as torch tensors.

Counterpart of ``pigeons_tpu/rng.py``. Every random draw's key is a pure
function of ``(seed, round, scan, replica, purpose)`` through ``fold_in``, so
the streams do not depend on the device or the batch layout. The functions
reproduce ``jax.random`` (JAX 0.9, ``jax_threefry_partitionable=True``) bit
for bit: the same seed gives the same keys, bits and uniforms as the JAX
package, and the same normals, Gumbel draws, Bernoulli draws and integers
(``randint``); and ``gamma``, ``loggamma``, ``beta`` and ``poisson`` are
``jax.random``'s algorithms on these streams.

A key is a ``[..., 2]`` tensor of uint32 words held as int64 (torch has no
full uint32 arithmetic); every operation masks back to 32 bits. Leading
dimensions batch keys, the way ``jax.vmap`` batches them in the reference.
Nothing here touches torch's global RNG. Float draws take the default float
dtype where none is given (:func:`float_dtype`), as ``jax.random`` does: a
float64 run draws its uniforms from 52 bits of two words, and its normals and
exponentials through the float64 forms of :mod:`.f64math`, bit for bit.
"""

from __future__ import annotations

import contextlib
import math

import torch

from . import f32math

EXPLORE = 0
SWAP_UNIFORM = 1
IID = 2
INIT = 3

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds, on broadcastable int64
    tensors of uint32 words. Returns the two output words."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``: the words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of every key in ``keys [..., 2]`` with ``data``
    (an int, or an integer tensor that broadcasts against ``keys[..., 0]``)."""
    # an int stays a Python int: no tensor to copy to the keys' device
    data = int(data) & _M32 if not torch.is_tensor(data) else data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _words(keys: torch.Tensor, shape):
    """The two threefry output words of every element of ``shape`` for every
    key (its 64-bit counter split in two words, the high one 0)."""
    shape = tuple(shape)
    n = math.prod(shape)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k2 = keys[..., 1].reshape(lead + (1,) * len(shape))
    lo = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` for every key: ``[..., *shape]``
    uint32 words as int64."""
    y0, y1 = _words(keys, shape)
    return y0 ^ y1


scalar = f32math.f64math.scalar  # a number's 0-dim tensor, made once


@contextlib.contextmanager
def default_float(dtype: torch.dtype):
    """torch's default dtype set to ``dtype`` for the duration: a run's
    scope, so that its default float draws and the tensors made from Python
    numbers are in its dtype, as JAX's x64 mode makes them float64."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def float_dtype(dtype=None) -> torch.dtype:
    """``dtype``, or where it is None the default float dtype, as
    ``jax.random`` takes its default: float32, and in a float64 run (the
    runtime sets torch's default dtype for its duration, the counterpart of
    JAX's x64 mode) float64."""
    return dtype if dtype is not None else torch.get_default_dtype()


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0, maxval: float = 1.0,
            dtype=None) -> torch.Tensor:
    """``jax.random.uniform``: the mantissa's random bits under the exponent
    of 1.0, minus 1, scaled into ``[minval, maxval)``; in float32 23 bits of
    one word, in float64 52 bits of the two words as one 64-bit word (high
    word first)."""
    dtype = float_dtype(dtype)
    if dtype == torch.float64:
        y0, y1 = _words(keys, shape)
        f = ((y0 << 20) | (y1 >> 12) | 0x3FF0000000000000).view(torch.float64) - 1.0
    else:
        f = ((bits(keys, shape) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = scalar(minval, dtype, keys.device), scalar(maxval, dtype, keys.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


_NORMAL_LO = {torch.float32: f32math._f(0xBF7FFFFF),  # nextafter(-1, 0)
              torch.float64: -(1.0 - 2.0 ** -53)}
_SQRT2 = math.sqrt(2.0)


def normal(keys: torch.Tensor, shape=(), dtype=None, scale: float = 1.0) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
    ``[nextafter(-1, 0), 1)``. ``scale`` is a constant factor that XLA folds
    into ``sqrt(2)``: ``scale * normal(...)`` as it computes it."""
    dtype = float_dtype(dtype)
    u = uniform(keys, shape, _NORMAL_LO[dtype], 1.0, dtype)
    return f32math.erfinv(u) * (_SQRT2 * scale)


def exponential(keys: torch.Tensor, shape=(), dtype=None) -> torch.Tensor:
    """``jax.random.exponential``: ``-log1p(-u)``."""
    return -f32math.log1p(-uniform(keys, shape, dtype=dtype))


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` for every key in ``keys [..., 2]``:
    ``[..., n, 2]``. With partitionable threefry, child ``i`` is
    ``fold_in(key, i)``."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    return fold_in(keys.unsqueeze(-2), idx)


_TINY = {torch.float32: f32math._f(0x00800000), torch.float64: 2.0 ** -1022}  # smallest normals


def gumbel(keys: torch.Tensor, shape=(), dtype=None) -> torch.Tensor:
    """``jax.random.gumbel`` in its default ``mode="low"``:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    dtype = float_dtype(dtype)
    return -f32math.log(-f32math.log(uniform(keys, shape, _TINY[dtype], 1.0, dtype)))


def bernoulli(keys: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli`` in its default ``mode="low"``: ``uniform < p``."""
    return uniform(keys, shape) < p


def randint(keys: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` in int32: two words of ``bits`` from the two
    children of ``split(key)``, combined modulo the span as ``(hi mod span)
    m + lo mod span`` with ``m = (2^16 mod span)^2 mod span``, every product
    and sum wrapping as uint32; ``minval`` where ``maxval <= minval``."""
    k_hi, k_lo = split(keys).unbind(-2)
    hi, lo = bits(k_hi, shape), bits(k_lo, shape)
    span = maxval - minval if maxval > minval else 1
    multiplier = ((2**16 % span) ** 2 & _M32) % span
    offset = (((hi % span) * multiplier) & _M32) + lo % span
    return (minval + (offset & _M32) % span).to(torch.int32)


def master_key(seed: int, device=None) -> torch.Tensor:
    return key(seed, device)


def scan_key(keys: torch.Tensor, round_idx, scan_idx, purpose: int) -> torch.Tensor:
    """Key for a (round, scan, purpose) triple; fold in the replica downstream."""
    k = fold_in(keys, round_idx)
    k = fold_in(k, scan_idx)
    return fold_in(k, purpose)


def replica_keys(keys: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """One key per replica, ``[..., n_replicas, 2]``, derived by replica index."""
    idx = torch.arange(n_replicas, dtype=torch.int64, device=keys.device)
    return keys_for(keys, idx)


def keys_for(keys: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Keys ``[..., len(indices), 2]`` for explicit global replica indices."""
    return fold_in(keys.unsqueeze(-2), indices)


# ---------------------------------------------------------------------------
# jax.random.gamma, loggamma, beta and poisson (JAX 0.9.0, jax/_src/random.py)
#
# The same algorithms on the same threefry streams, batched over leading key
# dimensions. Each draw first takes a fixed number of its while loop's
# iterations for every element at once (the keys of an iteration are a
# split sequence, known before the draws) and keeps the first that ends the
# loop, with one question to the device whether every element has ended.
# The rare elements that have not run the loop itself from the start: a
# masked loop over the elements still running that asks the device once
# every ``_LOOP_CHECK`` iterations, where an element that has finished keeps
# its values, as under ``vmap`` of the while loop. ``fused`` selects between
# the two forms XLA gives one draw: compiled with its parameter a constant
# (the reference chain's draws inside the runtime's compiled scan; XLA folds
# the functions of the constant, correctly rounded) or with the parameter an
# argument (an eager call, the initial states; the same functions at run
# time, ``log`` by XLA's polynomial).

_LOOP_CHECK = 4
_GAMMA_TRIES = 4  # Marsaglia-Tsang iterations taken at once (each accepts with p > 0.95)
_NORMAL_TRIES = 3  # normals for each (one is refused with p < 0.008)
_PTRS_TRIES = 8  # transformed-rejection iterations (each accepts with p > 0.75)
_R = f32math._round
_SQUEEZE = _R(0.0331)
_THIRD = _R(1.0 / 3.0)


def _masked_loop(running, step):
    """``step(mask)`` while ``running()`` (a bool tensor) has an element
    left, asking the device that once every ``_LOOP_CHECK`` steps."""
    while bool(running().any()):
        for _ in range(_LOOP_CHECK):
            step(running())


def _tries_then_loop(keys, tries, loop):
    """``tries(keys)`` gives every element's result and whether it is final;
    ``loop`` draws the others again from their keys, from the start."""
    out, done = tries(keys)
    if not bool(done.all()):
        out[~done] = loop(keys[~done])
    return out


def _first(ok, values):
    """``values [n, ...]`` at each element's first true ``ok`` along axis 0."""
    i = ok.to(torch.uint8).argmax(0, keepdim=True)
    return values.gather(0, i).squeeze(0)


def _const_log(v: float, fused: bool) -> float:
    """float32 ``log`` of the constant ``v``: correctly rounded where XLA
    folds it, else XLA's run-time polynomial."""
    if fused:
        return _R(math.log(v))
    return float(f32math.log(torch.tensor(v, dtype=torch.float32)))


def _mt_again(X, V, U, d):
    """Marsaglia-Tsang's loop condition: the proposal is refused."""
    return ((U >= f32math.fma(-_SQUEEZE, X * X, 1.0))
            & (f32math.log(U) >= f32math.fma(X, 0.5, d * ((1.0 - V) + f32math.log(V)))))


def _mt_tries(key, d: float, c: float):
    """The loop's first ``_GAMMA_TRIES`` iterations, each with its first
    ``_NORMAL_TRIES`` normals: ``V`` of the first accepted iteration, final
    where one is accepted and no earlier one ran short of normals."""
    x_keys, u_keys = [], []
    for _ in range(_GAMMA_TRIES):
        key, x_key, u_key = split(key, 3).unbind(-2)
        x_keys.append(x_key)
        u_keys.append(u_key)
    x_key, subs = torch.stack(x_keys), []
    for _ in range(_NORMAL_TRIES):
        x_key, sub = split(x_key).unbind(-2)
        subs.append(sub)
    xn = normal(torch.stack(subs))  # [normal, iteration, ...]
    vn = f32math.fma(xn, c, 1.0)
    positive = vn > 0.0
    x, v = _first(positive, xn), _first(positive, vn)
    accept = ~_mt_again(x * x, (v * v) * v, uniform(torch.stack(u_keys)), d)
    known = positive.any(0).to(torch.uint8).cumprod(0).bool()
    return _first(accept & known, (v * v) * v), (accept & known).any(0)


def _mt_loop(key, d: float, c: float):
    """The loop itself, for keys ``[..., 2]``: ``V`` of its accepted
    iteration."""
    f32, dev, lead = torch.float32, key.device, key.shape[:-1]
    X = torch.zeros(lead, dtype=f32, device=dev)
    V = torch.ones(lead, dtype=f32, device=dev)
    U = torch.full(lead, 2.0, dtype=f32, device=dev)
    running = torch.ones(lead, dtype=torch.bool, device=dev)

    def step(mask):  # body, then the loop's condition, for the running elements
        nonlocal key, X, V, U, running
        new_key, x_key, u_key = split(key, 3).unbind(-2)
        x = torch.zeros(lead, dtype=f32, device=dev)
        v = torch.full(lead, -1.0, dtype=f32, device=dev)

        def redraw(m):  # the inner loop: a normal until v > 0
            nonlocal x, v, x_key
            nxt, sub = split(x_key).unbind(-2)
            xn = normal(sub)
            x = torch.where(m, xn, x)
            v = torch.where(m, f32math.fma(xn, c, 1.0), v)
            x_key = torch.where(m[..., None], nxt, x_key)

        _masked_loop(lambda: mask & (v <= 0.0), redraw)
        key = torch.where(mask[..., None], new_key, key)
        X = torch.where(mask, x * x, X)
        V = torch.where(mask, (v * v) * v, V)
        U = torch.where(mask, uniform(u_key), U)
        running = torch.where(mask, _mt_again(X, V, U, d), running)

    _masked_loop(lambda: running, step)
    return V


def _gamma_one(keys, alpha: float, log_space: bool, fused: bool):
    """``_gamma_one``, Marsaglia and Tsang, for keys ``[..., 2]``, one draw of
    shape ``alpha`` each (in log space for ``log_space``). Below ``alpha =
    1`` the draw of ``alpha + 1`` is boosted by a uniform's power ``1 /
    alpha`` (in log space, its log over ``alpha``)."""
    boost = alpha < 1.0
    alpha1 = _R(_R(alpha) + 1.0) if boost else _R(alpha)
    d = _R(alpha1 - _THIRD)
    c = _R(_THIRD / _R(math.sqrt(d)))
    key, subkey = split(keys).unbind(-2)
    V = _tries_then_loop(key, lambda k: _mt_tries(k, d, c), lambda k: _mt_loop(k, d, c))
    if log_space:
        out = f32math.log(V) + _const_log(d, fused)
        if boost:
            log_samples = f32math.log1p(-uniform(subkey))
            log_boost = log_samples * _R(1.0 / _R(alpha))
            out = out + torch.where(log_samples == 0.0, torch.zeros_like(out), log_boost)
        return out
    out = d * V
    if boost:
        samples = 1.0 - uniform(subkey)
        out = out * torch.pow(samples.double(), _R(1.0 / _R(alpha))).float()
    return out


def _element_keys(keys, shape):
    """``_gamma_impl``'s keys: each key split into one per element of
    ``shape``, ``[..., *shape, 2]``."""
    n = math.prod(shape)
    return split(keys, n).reshape(keys.shape[:-1] + tuple(shape) + (2,))


def gamma(keys, a: float, shape=(), fused: bool = True) -> torch.Tensor:
    """``jax.random.gamma(key, a, shape)`` for every key in ``keys [..., 2]``:
    ``[..., *shape]`` float32."""
    return _gamma_one(_element_keys(keys, tuple(shape)), a, False, fused)


def loggamma(keys, a: float, shape=(), fused: bool = True) -> torch.Tensor:
    """``jax.random.loggamma(key, a, shape)`` for every key."""
    return _gamma_one(_element_keys(keys, tuple(shape)), a, True, fused)


def beta(keys, a: float, b: float, shape=(), fused: bool = True) -> torch.Tensor:
    """``jax.random.beta(key, a, b, shape)`` for every key: the two
    log-gammas of the key's two children (one batch of draws where ``a ==
    b``), exponentiated after their maximum is taken off."""
    children = split(keys)
    if a == b:
        lga, lgb = loggamma(children, a, shape, fused).unbind(keys.dim() - 1)
    else:
        key_a, key_b = children.unbind(-2)
        lga, lgb = loggamma(key_a, a, shape, fused), loggamma(key_b, b, shape, fused)
    log_max = torch.maximum(lga, lgb)
    ga, gb = f32math.exp(lga - log_max), f32math.exp(lgb - log_max)
    return ga / (ga + gb)


def _knuth_count(logs, lam: float):
    """Knuth's count from the logs of its uniforms ``[n, ...]``: the draws
    while the log of the product stays above ``-lam``, less one; final
    where the product has fallen to ``-lam``."""
    k = torch.zeros(logs.shape[1:], dtype=torch.int64, device=logs.device)
    log_prod = torch.zeros(logs.shape[1:], dtype=torch.float32, device=logs.device)
    for log_u in logs:  # log_prod only falls, so the count stops where the loop does
        k = k + (log_prod > -_R(lam))
        log_prod = log_prod + log_u
    return k - 1, log_prod <= -_R(lam)


def _knuth_n(lam: float) -> int:
    """How many of Knuth's uniforms are drawn at once: a count past ``n - 1``
    has probability below 1e-4 at every rate below 10."""
    return math.ceil(lam + 4.0 * math.sqrt(lam)) + 3


def _knuth_tries(keys, lam: float):
    """Knuth's first ``_knuth_n(lam)`` uniforms at once."""
    subs = []
    for _ in range(_knuth_n(lam)):
        keys, sub = split(keys).unbind(-2)
        subs.append(sub)
    return _knuth_count(f32math.log(uniform(torch.stack(subs))), lam)


def _knuth_loop(keys, lam: float):
    """Knuth's product of uniforms, one uniform an iteration."""
    lead = keys.shape[:-1]
    k = torch.zeros(lead, dtype=torch.int64, device=keys.device)
    log_prod = torch.zeros(lead, dtype=torch.float32, device=keys.device)
    key = keys

    def step(mask):
        nonlocal k, log_prod, key
        nxt, sub = split(key).unbind(-2)
        k = torch.where(mask, k + 1, k)
        log_prod = torch.where(mask, log_prod + f32math.log(uniform(sub)), log_prod)
        key = torch.where(mask[..., None], nxt, key)

    _masked_loop(lambda: log_prod > -_R(lam), step)
    return k - 1


class _Ptrs:
    """Hormann's transformed rejection (PTRS) at rate ``lam``: its constants,
    and one iteration from its two uniforms."""

    def __init__(self, lam: float, fused: bool):
        self.lam = lam = _R(lam)
        self.log_lam = _const_log(lam, fused)
        self.b = b = _R(0.931 + _R(2.53 * _R(math.sqrt(lam))))
        self.a = _R(-0.059 + _R(0.02483 * b))
        self.inv_alpha = _R(1.1239 + _R(1.1328 / _R(b - 3.4)))
        self.v_r = _R(0.9277 - _R(3.6224 / _R(b - 2.0)))

    def __call__(self, u, v):
        """The proposal ``k`` of uniforms ``u - 0.5`` and ``v``, and whether
        it is accepted."""
        a, b, lam = self.a, self.b, self.lam
        us = 0.5 - torch.abs(u)
        k = torch.floor(f32math.fma(_R(2.0 * a) / us + b, u, lam) + _R(0.43))
        s = f32math.log((v * self.inv_alpha) / (a / (us * us) + b))
        t = f32math.fma(k, self.log_lam, -lam) - f32math.lgamma(k + 1.0)
        accept = ((us >= _R(0.07)) & (v <= self.v_r)) | (
            ~((k < 0) | ((us < _R(0.013)) & (v > us))) & (s <= t))
        return k, accept

    def tries(self, keys):
        """The first ``_PTRS_TRIES`` iterations at once."""
        k0s, k1s = [], []
        for _ in range(_PTRS_TRIES):
            keys, k0, k1 = split(keys, 3).unbind(-2)
            k0s.append(k0)
            k1s.append(k1)
        k, accept = self(uniform(torch.stack(k0s)) - 0.5, uniform(torch.stack(k1s)))
        return _first(accept, k).to(torch.int64), accept.any(0)

    def loop(self, keys):
        """The loop itself, one iteration at a time."""
        lead = keys.shape[:-1]
        k_out = torch.full(lead, -1.0, dtype=torch.float32, device=keys.device)
        accepted = torch.zeros(lead, dtype=torch.bool, device=keys.device)
        key = keys

        def step(mask):
            nonlocal k_out, accepted, key
            nxt, k0, k1 = split(key, 3).unbind(-2)
            k, accept = self(uniform(k0) - 0.5, uniform(k1))
            k_out = torch.where(mask & accept, k, k_out)
            accepted = accepted | (mask & accept)
            key = torch.where(mask[..., None], nxt, key)

        _masked_loop(lambda: ~accepted, step)
        return k_out.to(torch.int64)


def poisson(keys, lam: float, fused: bool = True) -> torch.Tensor:
    """``jax.random.poisson(key, lam)`` for every key in ``keys [..., 2]``,
    as int64: Knuth's algorithm below ``lam = 10``, the transformed
    rejection from there on (both on the key itself), 0 at ``lam = 0``."""
    if lam == 0.0:
        return torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
    if lam < 10.0:
        return _tries_then_loop(keys, lambda k: _knuth_tries(k, lam), lambda k: _knuth_loop(k, lam))
    ptrs = _Ptrs(lam, fused)
    return _tries_then_loop(keys, ptrs.tries, ptrs.loop)
