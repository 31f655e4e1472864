"""The port's threefry key streams and float32 math against JAX.

Keys, ``fold_in``, ``bits`` and ``uniform`` must be bitwise equal to
``jax.random`` (JAX 0.9, partitionable threefry): every later comparison
between the packages rests on them. ``f32math`` reproduces XLA's CPU
polynomials, so ``exp``/``log``/``log1p``/``logaddexp`` are bitwise too.
``erfinv`` (hence ``normal``) is bitwise except in its tail branch, where
XLA's ``sqrt`` comes from a hardware reciprocal-square-root estimate: the
bound stated and held there is 2 ulp.

``rng.gamma``, ``rng.loggamma``, ``rng.beta`` and ``rng.poisson`` are JAX
0.9.0's algorithms on these streams (Marsaglia-Tsang with its key splits and
squeeze, the beta's two log-gammas, Knuth's product below rate 10 and the
transformed rejection above), held bitwise to ``jax.random`` on 4,096 keys in
both of XLA's forms: compiled with the parameter a constant (``fused``) and
eager. Where they are not bitwise the flips are counted and their cause
checked: ``gamma`` below shape 1 boosts by a float32 ``pow``, which XLA takes
from glibc's ``powf`` and the port rounds once from double precision (4 of
4,096 draws one ulp apart at shape 0.3); eager draws whose parameters give a
``d = a - 1/3`` at which XLA's run-time ``(1/3) / sqrt(d)`` (1/3 times its
reciprocal-square-root estimate) is not the correctly rounded quotient.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigeons_tpu import rng as jrng
from pigeons_tpu_torch import f32math
from pigeons_tpu_torch import rng as trng

SEEDS = (0, 1, 2**31 + 5)
NORMAL_ULP_BOUND = 2


def _jkey_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _bits32(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(a, b):
    """Bitwise equal, any NaN payload counting as the same NaN."""
    return (_bits32(a) == _bits32(b)) | (np.isnan(a) & np.isnan(b))


def _ulp(a, b):
    return np.abs(_bits32(a).astype(np.int64) - _bits32(b).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_master_key_and_fold_in_bitwise(seed):
    jk, tk = jrng.master_key(seed), trng.master_key(seed)
    assert np.array_equal(_jkey_data(jk), tk.numpy())
    for data in (0, 1, 7, 2**31 + 5, 2**32 - 1):
        assert np.array_equal(
            _jkey_data(jax.random.fold_in(jk, data)), trng.fold_in(tk, data).numpy()
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,)])
def test_scan_keys_bits_uniforms_bitwise(seed, shape):
    """Grid over round, scan, purpose 0-3 and replica 0-63."""
    jk, tk = jrng.master_key(seed), trng.master_key(seed)
    replicas = np.arange(64)
    v_bits = jax.jit(jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32)))
    v_unif = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, shape)))
    for round_idx in (1, 4):
        for scan_idx in (1, 2, 9):
            for purpose in range(4):
                jsk = jrng.scan_key(jk, round_idx, scan_idx, purpose)
                tsk = trng.scan_key(tk, round_idx, scan_idx, purpose)
                assert np.array_equal(_jkey_data(jsk), tsk.numpy())
                jkk = jrng.keys_for(jsk, jnp.asarray(replicas))
                tkk = trng.keys_for(tsk, torch.as_tensor(replicas))
                assert np.array_equal(_jkey_data(jkk), tkk.numpy())
                jb = np.asarray(v_bits(jkk)).astype(np.int64)
                assert np.array_equal(jb, trng.bits(tkk, shape).numpy())
                ju = np.asarray(v_unif(jkk))
                assert np.array_equal(_bits32(ju), _bits32(trng.uniform(tkk, shape).numpy()))


@pytest.mark.parametrize("seed", SEEDS)
def test_replica_keys_bitwise(seed):
    jk = jax.random.fold_in(jrng.master_key(seed), jrng.INIT)
    tk = trng.fold_in(trng.master_key(seed), trng.INIT)
    assert np.array_equal(_jkey_data(jrng.replica_keys(jk, 10)), trng.replica_keys(tk, 10).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_ulp_bound(seed):
    jkk = jrng.keys_for(jrng.master_key(seed), jnp.arange(512))
    tkk = trng.keys_for(trng.master_key(seed), torch.arange(512))
    jn = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.normal(k, (100,))))(jkk))
    tn = trng.normal(tkk, (100,)).numpy()
    ulp = _ulp(jn, tn)
    print(f"seed {seed}: {int((ulp > 0).sum())} of {ulp.size} normals differ, max {ulp.max()} ulp")
    assert ulp.max() <= NORMAL_ULP_BOUND
    assert (ulp > 0).mean() < 1e-3  # only the tail branch of erfinv differs


def _args(name, n=200_000):
    rs = np.random.RandomState({"exp": 1, "log": 2, "log1p": 3, "erfinv": 4}[name])
    if name == "exp":
        x = rs.uniform(-100.0, 90.0, n)
    elif name == "log":
        x = np.concatenate([rs.uniform(0.0, 1.0, n // 2), rs.uniform(0.0, 1e5, n // 2)])
    elif name == "log1p":
        x = rs.uniform(-0.999, 5.0, n)
    else:
        x = rs.uniform(-1.0, 1.0, n)
    x = x.astype(np.float32)
    x[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    return x


@pytest.mark.parametrize(
    "name,jf,tf",
    [
        ("exp", jnp.exp, f32math.exp),
        ("log", jnp.log, f32math.log),
        ("log1p", jnp.log1p, f32math.log1p),
    ],
)
def test_f32math_bitwise(name, jf, tf):
    x = _args(name)
    j = np.asarray(jax.jit(jf)(x))
    t = tf(torch.from_numpy(x)).numpy()
    same = _same(j, t)
    assert same.all(), f"{name}: {int((~same).sum())} differ"


def test_logaddexp_bitwise():
    rs = np.random.RandomState(3)
    a = rs.uniform(-50.0, 5.0, 200_000).astype(np.float32)
    b = rs.uniform(-50.0, 5.0, 200_000).astype(np.float32)
    a[:4], b[:4] = [-np.inf, -np.inf, np.inf, 1.0], [1.0, -np.inf, np.inf, np.nan]
    j = np.asarray(jax.jit(jnp.logaddexp)(a, b))
    t = f32math.logaddexp(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _same(j, t).all()


def test_erfinv_within_one_ulp():
    x = _args("erfinv")[5:]
    j = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    t = f32math.erfinv(torch.from_numpy(x)).numpy()
    ulp = _ulp(j, t)
    assert ulp.max() <= 1
    assert np.all(np.abs(x[ulp > 0]) > 0.996)  # the sqrt branch only


def test_fma_is_correctly_rounded():
    rs = np.random.RandomState(5)
    a, b = rs.normal(size=(2, 4000)).astype(np.float32)
    c = (rs.normal(size=4000) * 10.0 ** rs.randint(-8, 3, 4000)).astype(np.float32)
    got = f32math.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        f = np.float32(float(exact))
        near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        best = min(near, key=lambda v: (abs(Fraction(float(v)) - exact), int(_bits32(v)) & 1))
        assert got[i] == best


# ---------------------------------------------------------------------------
# jax.random.gamma, loggamma, beta and poisson

DRAW_KEYS = 4096


def _draw_keys():
    return (jrng.keys_for(jax.random.key(2), jnp.arange(DRAW_KEYS)),
            trng.keys_for(trng.key(2), torch.arange(DRAW_KEYS)))


def _jax_draws(fn, jk, fused):
    """``fn`` vmapped over the keys, compiled (its parameters constants) or
    eager (each primitive on its own: the jitted samplers get their
    parameters as arguments)."""
    f = jax.vmap(fn)
    return np.asarray(jax.jit(f)(jk) if fused else f(jk))


def _n_flips(have, want):
    return int((~_same(have, want)).sum())


def _run_time_c(a):
    """XLA's ``(1/3) / sqrt(a - 1/3)`` with ``a`` an argument, as the eager
    sampler computes it, and the correctly rounded value."""
    third = np.float32(1.0 / 3.0)
    arr = np.full(64, a, np.float32)
    xla = np.asarray(jax.jit(lambda v: third / jnp.sqrt(v - third))(arr))[0]
    d = np.float32(np.float32(a) - third)
    return xla, np.float32(third / np.float32(np.sqrt(np.float64(d))))


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("alpha", [0.3, 1.0, 4.0])
def test_gamma_is_jaxs(alpha, log_space, fused):
    jk, tk = _draw_keys()
    jf = jax.random.loggamma if log_space else jax.random.gamma
    want = _jax_draws(lambda k: jf(k, alpha), jk, fused)
    have = (trng.loggamma if log_space else trng.gamma)(tk, alpha, fused=fused).numpy()
    flips = _n_flips(have, want)
    print(f"gamma({alpha}), log space {log_space}, fused {fused}: {flips} of {DRAW_KEYS} differ")
    if alpha < 1.0 and not log_space:  # the boost's powf: one ulp apart where it flips
        assert flips == 4 and _ulp(have, want).max() == 1
    else:
        assert flips == 0


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("a,b", [(1.0, 1.0), (0.5, 0.7), (1.0, 2.5), (3.0, 9.0)])
def test_beta_is_jaxs(a, b, fused):
    """The library's ``Beta(1, 1)``, and shapes below, at and above 1."""
    jk, tk = _draw_keys()
    want = _jax_draws(lambda k: jax.random.beta(k, a, b), jk, fused)
    have = trng.beta(tk, a, b, fused=fused).numpy()
    flips = _n_flips(have, want)
    print(f"beta({a}, {b}), fused {fused}: {flips} of {DRAW_KEYS} differ")
    # the shapes that the sampler runs (a shape below 1 is boosted to shape + 1)
    shapes = [v if v >= 1.0 else v + 1.0 for v in (a, b)]
    exact_c = all(np.equal(*_run_time_c(v)) for v in shapes)
    if not fused:
        print(f"XLA's run-time c at shapes {shapes}: {[_run_time_c(v) for v in shapes]}")
    # eager draws at a shape whose run-time c is one ulp off the correctly
    # rounded one, 2.5, 3 and 9 (the draws of every other case are exact)
    assert exact_c == (b < 2.5)
    assert flips == {(1.0, 2.5, False): 493, (3.0, 9.0, False): 743}.get((a, b, fused), 0)


@pytest.mark.parametrize("draw", ["gamma 0.3", "gamma 4", "beta 1 1", "beta 0.5 0.7", "poisson 5",
                                  "poisson 40"])
def test_draws_finished_by_the_loop_are_jaxs(monkeypatch, draw):
    """With one iteration taken at once (one normal for each, one uniform
    for Knuth), many elements are left to the masked loop, which must give
    the same draws as the default split: JAX's (but for the boost's ``pow``
    flips of ``test_gamma_is_jaxs``), on 512 keys."""
    kind, *params = draw.split()
    params = [float(p) for p in params]
    fn = getattr(trng, kind)
    tk = trng.keys_for(trng.key(5), torch.arange(512))
    default = fn(tk, *params)
    for name in ("_GAMMA_TRIES", "_NORMAL_TRIES", "_PTRS_TRIES"):
        monkeypatch.setattr(trng, name, 1)
    monkeypatch.setattr(trng, "_knuth_n", lambda lam: 1)
    have = fn(tk, *params)
    assert torch.equal(have.view(torch.int32) if have.is_floating_point() else have,
                       default.view(torch.int32) if default.is_floating_point() else default)
    if kind != "gamma" or params[0] >= 1.0:
        jk = jrng.keys_for(jax.random.key(5), jnp.arange(512))
        want = _jax_draws(lambda k: getattr(jax.random, kind)(k, *params), jk, True)
        assert np.array_equal(have.numpy().view(np.int32) if kind != "poisson" else have.numpy(),
                              want.view(np.int32) if kind != "poisson" else want)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("lam", [0.5, 5.0, 15.0, 40.0])
def test_poisson_is_jaxs(lam, fused):
    """Knuth's algorithm at rates 0.5 and 5, the transformed rejection at 15
    and 40."""
    jk, tk = _draw_keys()
    want = _jax_draws(lambda k: jax.random.poisson(k, lam), jk, fused)
    have = trng.poisson(tk, lam, fused=fused).numpy()
    assert np.array_equal(have, want)
    assert abs(have.mean() - lam) < 4 * np.sqrt(lam / DRAW_KEYS)


# ---------------------------------------------------------------------------
# the draws of AAPS, NUTS and Mix: gumbel, bernoulli, randint


def _lane_keys(seed, n=4096):
    return (jrng.keys_for(jrng.master_key(seed), jnp.arange(n)),
            trng.keys_for(trng.master_key(seed), torch.arange(n)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (5,)])
def test_gumbel_bitwise(seed, shape):
    """``jax.random.gumbel`` (``mode="low"``), compiled and eager."""
    jk, tk = _lane_keys(seed)
    t = trng.gumbel(tk, shape).numpy()
    for fn in (jax.jit(jax.vmap(lambda k: jax.random.gumbel(k, shape))),
               jax.vmap(lambda k: jax.random.gumbel(k, shape))):
        assert np.array_equal(_bits32(np.asarray(fn(jk))), _bits32(t))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli_bitwise(seed, p):
    jk, tk = _lane_keys(seed)
    j = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.bernoulli(k, p)))(jk))
    assert np.array_equal(trng.bernoulli(tk, p).numpy(), j)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi,shape", [(0, 2, ()), (0, 3, ()), (0, 5, ()), (-2, 4, (3,)),
                                         (0, 65537, ()), (0, 2**31 - 1, (3,)), (3, 3, ())])
def test_randint_bitwise(seed, lo, hi, shape):
    """``jax.random.randint`` in int32, at the spans ``Mix`` draws (K = 2, 3,
    5 components) and at spans where the uint32 products wrap."""
    jk, tk = _lane_keys(seed)
    j = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi)))(jk))
    t = trng.randint(tk, shape, lo, hi)
    assert t.dtype == torch.int32
    assert np.array_equal(t.numpy(), j)
