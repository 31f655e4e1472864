"""Kernel K1's twin against the JAX package's banded Pallas kernel.

The JAX side runs ``SliceSamplerPallas(interpret=True).step_batched`` with
the runtime's ``ld_coord`` closure, as ``tests/test_replicates.py`` runs it;
the port side runs ``SliceSamplerCUDA.step_batched``, which on CPU tensors
goes to ``banded_sweep_reference``. Same states, betas and keys, B=16 lanes,
d=10 coordinates (so the TPU kernel pads the coordinate band from 10 to 16).

Tolerance: lane seeds and per-element uniforms bitwise. States within 1e-6
relative outside a counted set of flipped elements (an accept/reject that
went the other way on a 1-ulp difference), which must be at most 0.1% of
elements; the stats (accept_sum, accept_n, n_evals) exact on every lane with
no flip. The twin follows the kernel's fused multiply-adds and Cephes log,
so no flips are expected; the count is printed.

With the variational coordinate term (``pigeons_tpu/pt.py:703-712``, the
two-leg runtime's ``ld_coord`` with the reference's mean and std as
``coord_arrays``) the target is bitwise states and stats, lanes on both legs,
the reference active and not yet active; before activation the twin's result
must also be the toy term's, bit for bit.

The kernel itself runs only on a card: see ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pigeons_tpu import SliceSamplerPallas
from pigeons_tpu import rng as jrng
from pigeons_tpu.ops.pallas_slice import _fmix32, _hash_words, _uniform_from_bits
from pigeons_tpu.paths import toy_mvn_path as jax_toy_mvn_path
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice
from pigeons_tpu_torch.paths import toy_mvn_path

B, D = 16, 10
MAX_FLIP_SHARE = 1e-3
REL_TOL = 1e-6


def _inputs(seed):
    rs = np.random.RandomState(seed)
    xs = (rs.normal(size=(B, D)) * 2.0).astype(np.float32)
    betas = rs.uniform(0.0, 1.0, B).astype(np.float32)
    betas[0], betas[-1] = 0.0, 1.0
    return xs, betas


def _jax_sweep(xs, betas, key_seed, n_passes):
    path = jax_toy_mvn_path(D)

    def ld(x, beta, isvar, ref_params):
        return path.log_density(x, beta)

    def ld_coord(v, c, beta, isvar, ref_params):  # the runtime's closure, pt.py:693-696
        lp = path.coord_log_density(v, c, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    keys = jrng.keys_for(jax.random.key(key_seed), jnp.arange(B))
    out = SliceSamplerPallas(interpret=True, n_passes=n_passes).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(B), ld, jnp.asarray(betas), jnp.zeros(B), (), (),
        1, ld_coord=ld_coord, compute_final_lp=False,
    )
    stats = np.stack([np.asarray(out.accept_sum), np.asarray(out.accept_n), np.asarray(out.n_steps)])
    return np.asarray(out.x), stats


def _port_sweep(xs, betas, key_seed, n_passes):
    keys = trng.keys_for(trng.key(key_seed), torch.arange(B))
    before = dict(SliceSamplerCUDA.launches)
    out = SliceSamplerCUDA(n_passes=n_passes).step_batched(
        keys, torch.from_numpy(xs), torch.from_numpy(betas), toy_mvn_path(D)
    )
    assert SliceSamplerCUDA.launches == before  # CPU tensors: the twin
    stats = torch.stack([out.accept_sum, out.accept_n, out.n_steps]).numpy()
    return out.x.numpy(), stats


def compare_sweeps(x_ref, s_ref, x, s):
    """Counted flips and the tolerance checks of the module docstring."""
    rel = np.abs(x - x_ref) / np.maximum(np.abs(x_ref), 1e-30)
    flipped = rel > REL_TOL
    n_flip = int(flipped.sum())
    print(f"{n_flip} flipped of {x.size} elements; {int((x != x_ref).sum())} not bitwise equal")
    assert n_flip <= MAX_FLIP_SHARE * x.size
    clean = ~flipped.any(1)
    assert np.array_equal(s[:, clean], s_ref[:, clean])
    return n_flip


@pytest.mark.parametrize("n_passes", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_pallas_kernel(n_passes, seed):
    xs, betas = _inputs(seed)
    xj, sj = _jax_sweep(xs, betas, seed + 7, n_passes)
    xt, st = _port_sweep(xs, betas, seed + 7, n_passes)
    compare_sweeps(xj, sj, xt, st)
    assert not np.array_equal(xt, xs)  # the sweep moved


def _variational_inputs(seed):
    """Lanes of both legs, a reference whose mean and std differ by
    coordinate, one std the smallest a fit can give (sqrt of the 1e-12 floor)."""
    rs = np.random.RandomState(seed)
    xs = rs.normal(size=(B, D)).astype(np.float32)
    betas = rs.uniform(0.0, 1.0, B).astype(np.float32)
    betas[[0, 1, -2, -1]] = 0.0, 1.0, 0.0, 1.0  # both ends on both legs
    isvar = (np.arange(B) < B // 2).astype(np.float32)
    mean = (rs.normal(size=D) * 0.2).astype(np.float32)
    std = np.exp(rs.normal(size=D) * 0.5 - 1.0).astype(np.float32)
    std[3] = 1e-6
    return xs, betas, isvar, mean, std


def _jax_variational_sweep(xs, betas, isvar, mean, std, active, key_seed, n_passes):
    import pigeons_tpu as J

    pt = J.PT(J.Inputs(target=J.toy_mvn_target(D), n_chains=3, n_chains_variational=3,
                       explorer=SliceSamplerPallas(interpret=True), show_report=False))
    ref_params = {"mean": jnp.asarray(mean), "std": jnp.asarray(std),
                  "active": jnp.asarray(active, jnp.float32)}

    def ld(x, beta, iv, rp):  # the runtime's guarded density, pt.py:122-127
        lp = pt._path_log_density(x, beta, iv, rp)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    keys = jrng.keys_for(jax.random.key(key_seed), jnp.arange(B))
    out = SliceSamplerPallas(interpret=True, n_passes=n_passes).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(B), ld, jnp.asarray(betas), jnp.asarray(isvar),
        ref_params, (), 1, ld_coord=pt._ld_coord, coord_arrays=pt._coord_arrays_fn(ref_params),
        compute_final_lp=False,
    )
    stats = np.stack([np.asarray(out.accept_sum), np.asarray(out.accept_n), np.asarray(out.n_steps)])
    return np.asarray(out.x), stats


def _port_variational_sweep(xs, betas, isvar, mean, std, active, key_seed, n_passes):
    from pigeons_tpu_torch import GaussianReference, VariationalPath

    keys = trng.keys_for(trng.key(key_seed), torch.arange(B))
    ref_params = {"mean": torch.from_numpy(mean), "std": torch.from_numpy(std),
                  "active": torch.tensor(active)}
    out = SliceSamplerCUDA(n_passes=n_passes).step_batched(
        keys, torch.from_numpy(xs), torch.from_numpy(betas),
        VariationalPath(toy_mvn_path(D), GaussianReference()),
        isvar=torch.from_numpy(isvar), ref_params=ref_params)
    assert out.lp is None
    return out.x.numpy(), torch.stack([out.accept_sum, out.accept_n, out.n_steps]).numpy()


@pytest.mark.parametrize("n_passes", [1, 3])
@pytest.mark.parametrize("active", [0.0, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_variational_twin_matches_pallas_kernel(seed, active, n_passes):
    inputs = _variational_inputs(seed)
    xj, sj = _jax_variational_sweep(*inputs, active, seed + 7, n_passes)
    xt, st = _port_variational_sweep(*inputs, active, seed + 7, n_passes)
    n_diff = int((xj.view(np.int32) != xt.view(np.int32)).sum())
    print(f"{n_diff} of {xj.size} state elements differ in their bits")
    assert n_diff == 0 and np.array_equal(sj, st)
    toy, toy_stats = _port_sweep(inputs[0], inputs[1], seed + 7, n_passes)
    assert (active == 0.0) == np.array_equal(toy.view(np.int32), xt.view(np.int32))
    assert (active == 0.0) == np.array_equal(toy_stats, st)


def test_variational_coordinate_term_matches_jax():
    """The twin's variational term (``cuda_slice.coord_term``) against the
    JAX runtime's ``ld_coord`` under ``jit(vmap(...))``, bitwise, over both
    legs, both ends of the path and a std of 1e-6."""
    import pigeons_tpu as J

    n = 512
    rs = np.random.RandomState(5)
    v = (rs.normal(size=n) * 2).astype(np.float32)
    beta = rs.uniform(size=n).astype(np.float32)
    beta[:40], beta[40:80] = 0.0, 1.0
    isvar = (rs.uniform(size=n) < 0.7).astype(np.float32)
    mean = (rs.normal(size=n) * 0.3).astype(np.float32)
    std = (np.exp(rs.normal(size=n)) * 0.3).astype(np.float32)
    std[80:90] = 1e-6
    pt = J.PT(J.Inputs(target=J.toy_mvn_target(D), n_chains=3, n_chains_variational=3,
                       show_report=False))
    rp = {"mean": jnp.zeros(D), "std": jnp.ones(D), "active": jnp.ones(())}
    j = np.asarray(jax.jit(jax.vmap(lambda *a: pt._ld_coord(a[0], 0, a[1], a[2], rp, a[3], a[4])))(
        v, beta, isvar, mean, std))
    # one lane, n coordinates with their own mean and std, for each beta / isvar
    path = toy_mvn_path(D)
    tbeta, tisvar = torch.from_numpy(beta), torch.from_numpy(isvar)
    a_target = float(path.coord_factor(torch.ones(())))
    t = torch.stack([cuda_slice.coord_term(
        torch.from_numpy(v[i:i + 1])[None], path.coord_factor(tbeta[i:i + 1]),
        cuda_slice.VariationalTerm(tbeta[i:i + 1], tisvar[i:i + 1], torch.ones(()), a_target,
                                   torch.from_numpy(mean[i:i + 1]), torch.from_numpy(std[i:i + 1])))
        for i in range(n)]).reshape(-1).numpy()
    assert np.array_equal(j.view(np.int32), t.view(np.int32))


def test_variational_path_on_the_general_kernel_raises():
    """The general kernel takes a variational path whose fixed part has a
    device density and whose reference is mean-field (its mean and std reach
    the kernel as arrays); it raises for any other, naming what is missing."""
    from pigeons_tpu_torch import GaussianReference, VariationalPath
    from pigeons_tpu_torch.paths import InterpolatingPath

    vp = VariationalPath(toy_mvn_path(D), GaussianReference())
    for explorer in (SliceSamplerCUDA(parallel_coords=False), SliceSamplerCUDA(coord_deltas=False),
                     SliceSamplerCUDA()):
        explorer.check_path(vp)
    no_density = InterpolatingPath(lambda x: -(x**4).sum(-1), lambda x: -(x**2).sum(-1))
    with pytest.raises(NotImplementedError, match="DeviceSource"):
        SliceSamplerCUDA().check_path(VariationalPath(no_density, GaussianReference()))

    class FullRank:  # a reference without per-coordinate parameters
        pass

    with pytest.raises(NotImplementedError, match="mean-field"):
        SliceSamplerCUDA(parallel_coords=False).check_path(VariationalPath(toy_mvn_path(D), FullRank()))


def test_coordinate_term_matches_jax_density():
    """``coord_log_density`` (``(a v) v`` with ``a = coord_factor(beta)``, the
    kernel's term) is bitwise the JAX coordinate term."""
    rs = np.random.RandomState(2)
    v = rs.normal(size=4096).astype(np.float32)
    beta = rs.uniform(size=4096).astype(np.float32)
    jpath = jax_toy_mvn_path(D)
    j = np.asarray(jax.jit(jax.vmap(lambda vv, b: jpath.coord_log_density(vv, 0, b)))(v, beta))
    path = toy_mvn_path(D)
    t = path.coord_log_density(torch.from_numpy(v), 0, torch.from_numpy(beta)).numpy()
    assert np.array_equal(j.view(np.int32), t.view(np.int32))
    a = path.coord_factor(torch.from_numpy(beta))
    assert torch.equal((a * torch.from_numpy(v)) * torch.from_numpy(v), torch.from_numpy(t))


def test_lane_seeds_bitwise():
    keys = jrng.keys_for(jax.random.key(3), jnp.arange(64))
    j = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(keys)).astype(np.int64)
    t = cuda_slice.lane_seeds(trng.keys_for(trng.key(3), torch.arange(64))).numpy()
    assert np.array_equal(j, t)


def _jax_element_uniforms(seed2d, it):
    """The JAX kernel's draws ``(uA, uB)`` at iteration ``it``, computed by its
    own helpers inside an interpreted Pallas kernel (``_uniform_from_bits``
    uses a Mosaic bitcast)."""

    def kern(s_ref, ua_ref, ub_ref):
        s = s_ref[...]
        ua_ref[...] = _uniform_from_bits(_hash_words(s, jnp.uint32(2 * it)))
        ub_ref[...] = _uniform_from_bits(_hash_words(s, jnp.uint32(2 * it + 1)))

    shape = jax.ShapeDtypeStruct(seed2d.shape, jnp.float32)
    ua, ub = pl.pallas_call(kern, out_shape=(shape, shape), interpret=True)(seed2d)
    return np.asarray(ua), np.asarray(ub)


def test_element_uniforms_bitwise():
    keys = jrng.keys_for(jax.random.key(4), jnp.arange(B))
    seeds = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(keys)
    c = jnp.arange(D, dtype=jnp.uint32)
    seed2d = _fmix32(seeds[:, None] ^ (c[None, :] * jnp.uint32(0x85EBCA77)))  # pallas_slice.py:373-376
    base = cuda_slice.element_hash_base(cuda_slice.lane_seeds(trng.keys_for(trng.key(4), torch.arange(B))), D)
    for it in (0, 1, 5, 100, 1023):
        ja, jb = _jax_element_uniforms(seed2d, it)
        ta, tb = cuda_slice.element_uniforms(base, it)
        assert np.array_equal(ja.view(np.int32), ta.numpy().view(np.int32))
        assert np.array_equal(jb.view(np.int32), tb.numpy().view(np.int32))


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_slice.banded_sweep_cuda(x, torch.zeros(2), torch.zeros(2, dtype=torch.int64))


def test_explorer_refuses_non_separable_path():
    from pigeons_tpu_torch.paths import InterpolatingPath

    path = InterpolatingPath(lambda x: -(x**4).sum(-1), lambda x: -(x**2).sum(-1))
    with pytest.raises(NotImplementedError, match="K2"):
        SliceSamplerCUDA().step_batched(
            trng.keys_for(trng.key(0), torch.arange(2)), torch.zeros(2, 3), torch.zeros(2), path
        )
