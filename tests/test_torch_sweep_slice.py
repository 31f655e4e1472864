"""Kernel K2's twin against the JAX package's general Pallas slice kernel.

The JAX side runs ``SliceSamplerPallas(interpret=True,
parallel_coords=False).step_batched`` (``_sweep_kernel`` in the Pallas
interpreter) with the runtime's ``ld`` / ``ld_coord`` closures; the port side
runs ``SliceSamplerCUDA(parallel_coords=False).step_batched``, which on CPU
tensors goes to ``sweep_reference``. Same states, betas and keys from a numpy
seed, B=8 lanes, d=4 coordinates, 1 and 2 passes, for the funnel, banana and
flat-prior MVN paths (full mode) and the toy MVN path (delta mode).

Tolerance: everything bitwise. The port's densities follow XLA's CPU
evaluation of the JAX ones operation for operation (folded constants,
reciprocal multiplies, fused multiply-adds, coordinate-order sums, Cephes
``exp`` and ``log``), so states, returned densities and the stats rows
accept_sum, accept_n and n_evals are held with ``array_equal`` and no lane is
allowed to diverge. The lane uniforms ``_hash_words(seed, 4 it + k)`` are
bitwise too.

Where XLA evaluates a density outside the kernel (``jit(vmap(log_density))``
over a ``[B, d]`` batch) it may vectorize the coordinate sum differently, so
the batched ``log_density`` functions are held to 2e-6 relative there, and
``sample_iid_target`` to 2e-6 (normals differ by <= 2 ulp in the erfinv
tail).

The law tests are the port's stand-in for the Geweke test until
``invariance_test.py`` is ported: lanes start from exact draws of the target,
the twin sweeps them at beta = 1, and a coordinate's marginal is held to its
exact law with a two-sample Kolmogorov-Smirnov test at level 1e-3 (the seeds
are fixed, so the test is deterministic).

The kernel itself runs only on a card: see ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from scipy import stats as sps

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import SliceSamplerPallas
from pigeons_tpu import rng as jrng
from pigeons_tpu.ops.pallas_slice import _hash_words, _uniform_from_bits
from pigeons_tpu.paths import toy_mvn_path as jax_toy_mvn_path
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice
from pigeons_tpu_torch.paths import sum_squares, toy_mvn_path

B, D = 8, 4
KS_LEVEL = 1e-3


def _paths(name):
    """The same path in both packages, and whether it runs in delta mode."""
    if name == "toy":
        return jax_toy_mvn_path(D), toy_mvn_path(D), True
    make = {"funnel": lambda m: m.funnel(D - 1), "banana": lambda m: m.banana(D - 1, 1.5),
            "mvn": lambda m: m.mvn_target(D, 2.5)}[name]
    jt, tt = make(J), make(T)
    return jt.create_path(jt.default_reference()), tt.create_path(tt.default_reference()), False


def _inputs(seed):
    rs = np.random.RandomState(seed)
    xs = (rs.normal(size=(B, D)) * 1.5).astype(np.float32)
    betas = rs.uniform(0.0, 1.0, B).astype(np.float32)
    betas[0], betas[-1] = 0.0, 1.0
    return xs, betas


def _jax_sweep(ld, ld_coord, xs, betas, key_seed, n_passes):
    keys = jrng.keys_for(jax.random.key(key_seed), jnp.arange(len(xs)))
    out = SliceSamplerPallas(interpret=True, n_passes=n_passes, parallel_coords=False).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(len(xs)), ld, jnp.asarray(betas), jnp.zeros(len(xs)),
        (), (), 1, ld_coord=ld_coord,
    )
    return {k: np.asarray(getattr(out, k)) for k in ("x", "lp", "accept_sum", "accept_n", "n_steps")}


def _runtime_closures(path, delta):
    """``ld`` and ``ld_coord`` as the JAX runtime builds them (``pt.py:122-127,
    693-696``)."""

    def ld(x, beta, isvar, ref_params):
        lp = path.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    def ld_coord(v, c, beta, isvar, ref_params):
        lp = path.coord_log_density(v, c, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    return ld, (ld_coord if delta else None)


def _assert_bitwise(ref, out):
    got = {"x": out.x, "lp": out.lp, "accept_sum": out.accept_sum, "accept_n": out.accept_n,
           "n_steps": out.n_steps}
    for name, want in ref.items():
        have = got[name].numpy()
        n_diff = int((have.view(np.int32) != want.view(np.int32)).sum())
        assert n_diff == 0, f"{name}: {n_diff} of {want.size} elements differ in their bits"


@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("name", ["funnel", "banana", "mvn", "toy"])
def test_twin_matches_pallas_kernel(name, n_passes):
    jpath, tpath, delta = _paths(name)
    xs, betas = _inputs(n_passes)
    ref = _jax_sweep(*_runtime_closures(jpath, delta), xs, betas, 7, n_passes)
    keys = trng.keys_for(trng.key(7), torch.arange(B))
    before = dict(SliceSamplerCUDA.launches)
    out = SliceSamplerCUDA(n_passes=n_passes, parallel_coords=False).step_batched(
        keys, torch.from_numpy(xs), torch.from_numpy(betas), tpath)
    assert SliceSamplerCUDA.launches == before  # CPU tensors: the twin
    _assert_bitwise(ref, out)
    assert not np.array_equal(out.x.numpy(), xs)  # the sweep moved
    # the returned density is the density of the returned state
    fresh = cuda_slice.sweep_density(tpath)(out.x, torch.from_numpy(betas))
    np.testing.assert_allclose(out.lp.numpy(), fresh.numpy(), atol=1e-5)


class _ScaledNormalClosure:
    """The non-separable closure of ``tests/test_replicates.py:64`` as a port
    path: ``-0.5 (0.5 + beta) sum(x^2)``."""

    @staticmethod
    def log_density(x, beta):
        return ((0.5 + beta) * -0.5) * sum_squares(x)


def test_twin_matches_pallas_kernel_on_a_closure():
    """The call of ``test_pallas_kernel_single_sweep_interpret``: a density
    given as a plain closure, ones as states, betas on a grid."""
    ld = lambda x, beta, isvar, rp: -0.5 * (0.5 + beta) * jnp.sum(x * x)  # noqa: E731
    xs = np.ones((B, 3), np.float32)
    betas = np.linspace(0.0, 1.0, B).astype(np.float32)
    ref = _jax_sweep(ld, None, xs, betas, 0, 1)
    seeds = cuda_slice.lane_seeds(trng.keys_for(trng.key(0), torch.arange(B)))
    x, lp, stats = cuda_slice.sweep(torch.from_numpy(xs), torch.from_numpy(betas), seeds,
                                    _ScaledNormalClosure, n_passes=1)
    out = cuda_slice.StepOut(x, lp, stats[0], stats[1], stats[2])
    _assert_bitwise(ref, out)
    ne = stats[2].numpy()
    assert (ne >= 2 * 3).all() and (ne < 200).all()


def test_delta_mode_returns_recomputed_density():
    """Delta and full mode of the toy path draw the same uniforms; both hand
    back the density of their final state."""
    _, tpath, _ = _paths("toy")
    xs, betas = (torch.from_numpy(a) for a in _inputs(3))
    seeds = cuda_slice.lane_seeds(trng.keys_for(trng.key(5), torch.arange(B)))
    for delta in (True, False):
        x, lp, _ = cuda_slice.sweep_reference(xs, betas, seeds, tpath, delta, n_passes=2)
        assert torch.equal(lp, tpath.sweep_log_density(x, betas))


@pytest.mark.parametrize("name", ["funnel", "banana", "mvn"])
def test_batched_log_density_matches_jax(name):
    make = {"funnel": lambda m: m.funnel(9, 2.0), "banana": lambda m: m.banana(9, 1.5),
            "mvn": lambda m: m.mvn_target(10, 2.5)}[name]
    jt, tt = make(J), make(T)
    rs = np.random.RandomState(4)
    x = (rs.normal(size=(512, 10)) * 2.0).astype(np.float32)
    beta = rs.uniform(size=512).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jt.log_density))(x))
    have = tt.log_density(torch.from_numpy(x)).numpy()
    print(f"{name}: {int((want.view(np.int32) != have.view(np.int32)).sum())} of 512 not bitwise equal")
    np.testing.assert_allclose(have, want, rtol=2e-6, atol=1e-6)
    jpath, tpath = jt.create_path(jt.default_reference()), tt.create_path(tt.default_reference())
    want = np.asarray(jax.jit(jax.vmap(jpath.log_density))(x, beta))
    have = tpath.log_density(torch.from_numpy(x), torch.from_numpy(beta)).numpy()
    np.testing.assert_allclose(have, want, rtol=2e-6, atol=1e-6)
    assert tpath.device_density() is not None and tpath.has_iid_reference


@pytest.mark.parametrize("name", ["funnel", "banana"])
def test_sample_iid_target_matches_jax(name):
    jt, tt = getattr(J, name)(5, 1.0), getattr(T, name)(5, 1.0)
    want = np.asarray(jax.vmap(jt.sample_iid_target)(jrng.keys_for(jax.random.key(2), jnp.arange(256))))
    have = tt.sample_iid_target(trng.keys_for(trng.key(2), torch.arange(256))).numpy()
    np.testing.assert_allclose(have, want, rtol=2e-6, atol=1e-7)
    ref_j = np.asarray(jax.vmap(jt.default_reference().sample_iid)(
        jrng.keys_for(jax.random.key(3), jnp.arange(64))))
    ref_t = tt.default_reference().sample_iid(trng.keys_for(trng.key(3), torch.arange(64))).numpy()
    np.testing.assert_allclose(ref_t, ref_j, rtol=2e-6, atol=1e-7)


def test_split_is_fold_in_bitwise():
    keys = jrng.keys_for(jax.random.key(6), jnp.arange(32))
    want = np.asarray(jax.vmap(lambda k: jax.random.key_data(jax.random.split(k)))(keys)).astype(np.int64)
    a, b = trng.split(trng.keys_for(trng.key(6), torch.arange(32))).unbind(-2)
    assert np.array_equal(want[:, 0], a.numpy()) and np.array_equal(want[:, 1], b.numpy())


def _jax_lane_uniforms(seeds, it):
    """The JAX kernel's four draws at iteration ``it``, by its own helpers
    inside an interpreted Pallas kernel (``pallas_slice.py:167-171``)."""

    def kern(s_ref, *u_refs):
        s = s_ref[...]
        for k, u_ref in enumerate(u_refs):
            u_ref[...] = _uniform_from_bits(_hash_words(s, jnp.uint32(4 * it + k)))

    shape = jax.ShapeDtypeStruct(seeds.shape, jnp.float32)
    return [np.asarray(u) for u in pl.pallas_call(kern, out_shape=(shape,) * 4, interpret=True)(seeds)]


def test_lane_uniforms_bitwise():
    keys = jrng.keys_for(jax.random.key(4), jnp.arange(64))
    seeds = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(keys)[None, :]
    base = cuda_slice.lane_hash_base(cuda_slice.lane_seeds(trng.keys_for(trng.key(4), torch.arange(64))))
    for it in (0, 1, 5, 100, 4095):
        for want, have in zip(_jax_lane_uniforms(seeds, it), cuda_slice.lane_uniforms(base, it), strict=True):
            assert np.array_equal(want[0].view(np.int32), have.numpy().view(np.int32))


def _ks_after_sweeps(path, x0, exact, coord, delta):
    n = len(x0)
    betas = torch.ones(n)
    seeds = cuda_slice.lane_seeds(trng.keys_for(trng.key(21), torch.arange(n)))
    x, lp, stats = cuda_slice.sweep_reference(x0, betas, seeds, path, delta, n_passes=3)
    assert torch.isfinite(x).all() and torch.isfinite(lp).all()
    assert float(stats[0].sum()) > 0 and not torch.equal(x, x0)
    res = sps.ks_2samp(x[:, coord].numpy(), exact[:, coord].numpy())
    print(f"KS statistic {res.statistic:.4f}, p-value {res.pvalue:.4f}")
    return res.pvalue


def test_funnel_sweeps_keep_the_target_law():
    """4,096 lanes of exact funnel(3) draws, three sweeps at beta = 1: the y
    marginal stays N(0, 3) (held against an independent exact sample)."""
    target = T.funnel(3)
    path = target.create_path(target.default_reference())
    x0 = target.sample_iid_target(trng.keys_for(trng.key(31), torch.arange(4096)))
    exact = target.sample_iid_target(trng.keys_for(trng.key(32), torch.arange(4096)))
    assert sps.kstest(exact[:, 0].numpy(), "norm", args=(0.0, 3.0)).pvalue > KS_LEVEL
    assert _ks_after_sweeps(path, x0, exact, 0, delta=False) > KS_LEVEL


def test_toy_delta_sweeps_keep_the_target_law():
    """The same for the toy MVN path in delta mode: coordinate 0 stays
    N(0, 1 / sqrt(10))."""
    path = toy_mvn_path(D)
    x0 = path.sample_at(trng.keys_for(trng.key(33), torch.arange(4096)), 1.0)
    exact = path.sample_at(trng.keys_for(trng.key(34), torch.arange(4096)), 1.0)
    assert _ks_after_sweeps(path, x0, exact, 0, delta=True) > KS_LEVEL


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        cuda_slice.sweep_cuda(torch.zeros(2, 3), torch.zeros(2), torch.zeros(2, dtype=torch.int64),
                              toy_mvn_path(3))


def test_kernel_choice_follows_the_jax_explorer():
    """Separable path and both options true: K1 (no density returned);
    otherwise K2, which returns the density."""
    xs, betas = (torch.from_numpy(a) for a in _inputs(0))
    keys = trng.keys_for(trng.key(1), torch.arange(B))
    path = toy_mvn_path(D)
    assert SliceSamplerCUDA(n_passes=1).step_batched(keys, xs, betas, path).lp is None
    for kw in ({"parallel_coords": False}, {"coord_deltas": False}):
        out = SliceSamplerCUDA(n_passes=1, **kw).step_batched(keys, xs, betas, path)
        assert torch.equal(out.lp, path.sweep_log_density(out.x, betas))
