"""The port's threefry key streams and float32 math against JAX.

Keys, ``fold_in``, ``bits`` and ``uniform`` must be bitwise equal to
``jax.random`` (JAX 0.9, partitionable threefry): every later comparison
between the packages rests on them. ``f32math`` reproduces XLA's CPU
polynomials, so ``exp``/``log``/``log1p``/``logaddexp`` are bitwise too.
``erfinv`` (hence ``normal``) is bitwise except in its tail branch, where
XLA's ``sqrt`` comes from a hardware reciprocal-square-root estimate: the
bound stated and held there is 2 ulp.
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
