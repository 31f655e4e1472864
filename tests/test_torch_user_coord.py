"""A user's coordinate terms on kernel K1: a ``"coord"`` source
(``pigeons_tpu_torch/device_source.py``) beside its torch form, on the CPU.

The separable path of ``tests/test_torch_coordwise_path.py`` (a product of
d = 6 normals with per-coordinate means and scales, from N(0, 3^2) per
coordinate) is ``source_examples.normal_product_source``: its two terms as
CUDA source, the means, scales and log norms as arrays. Held:

* its coordinate terms against the JAX package's within 1e-6;
* one sweep of K1's twin with the user term (``banded_sweep_reference``,
  which evaluates the source's torch forms) against the JAX package's banded
  Pallas kernel in the interpreter with the runtime's ``ld_coord``: states
  within 1e-6 relative, the stats exact for every element that is not a
  counted flip (at most 0.1 % of the elements: the tolerance of
  ``tests/test_torch_banded_slice.py``);
* the source compiled for the host with ``g++`` against ``tests/cuda_stub/``
  (K1 with the user term alone, as ``_build.build_user`` compiles it), bit
  for bit the twin, at the shapes of ``tests/test_torch_csrc_host.py``;
* two rounds of ``PT`` in both packages (K1's twin and the JAX banded
  kernel): restarts, round trips and permutations equal, barrier and logZ
  within 1e-3, states within 1e-5 relative;
* the refusals: K1's user term takes no variational reference and needs
  ``coord_deltas`` and ``parallel_coords``.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import SliceSamplerPallas
from pigeons_tpu import paths as JP
from pigeons_tpu import rng as jrng
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.models import source_examples as SE
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice

sys.path.insert(0, str(Path(__file__).resolve().parent / "cuda_stub"))
import host_call  # noqa: E402

from test_torch_csrc_host import _assert_bitwise, _in_child, _inputs  # noqa: E402
from test_torch_user_density import _host_user_library, user_dir  # noqa: E402,F401

D, B = 6, 16
MAX_FLIP_SHARE = 1e-3
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSeparable(J.models.Target):
    """The JAX package's form of the path, as ``tests/test_torch_coordwise_path.py``."""

    dim = D
    mu = np.linspace(-1.0, 1.5, D).astype(np.float32)
    scale = np.linspace(0.5, 2.0, D).astype(np.float32)

    def coord(self, v, c):
        mu, scale = jnp.asarray(self.mu)[c], jnp.asarray(self.scale)[c]
        return -0.5 * ((v - mu) / scale) ** 2 - jnp.log(scale) - HALF_LOG_2PI

    @staticmethod
    def ref_coord(v, c):
        return -0.5 * (v / SE.REF_SCALE) ** 2 - math.log(SE.REF_SCALE) - HALF_LOG_2PI

    def log_density(self, x):
        return jnp.sum(self.coord(x, jnp.arange(D)))

    def default_reference(self):
        return J.models.Reference(
            log_density=lambda x: jnp.sum(self.ref_coord(x, jnp.arange(D))),
            sample_iid=lambda key: SE.REF_SCALE * jax.random.normal(key, (D,)))

    def create_path(self, reference):
        return JP.InterpolatingPath(reference.log_density, self.log_density,
                                    reference.sample_iid, self.ref_coord, self.coord)


def _port_path(d=D):
    target = SE.normal_product_source(d)
    return target, target.create_path(target.default_reference())


def _sweep_inputs(seed):
    rs = np.random.RandomState(seed)
    xs = (rs.normal(size=(B, D)) * 2.0).astype(np.float32)
    betas = rs.uniform(0.0, 1.0, B).astype(np.float32)
    betas[0], betas[-1] = 0.0, 1.0
    return xs, betas


def test_coordinate_terms_match_jax():
    jt = JaxSeparable()
    jpath = jt.create_path(jt.default_reference())
    _, tpath = _port_path()
    assert tpath.has_coordwise and tpath.coord_source is not None
    xs, betas = _sweep_inputs(1)
    j = np.asarray(jax.jit(jax.vmap(lambda x, b: jax.vmap(
        lambda v, c: jpath.coord_log_density(v, c, b))(x, jnp.arange(D))))(xs, betas))
    t = tpath.coord_log_density(torch.from_numpy(xs), torch.arange(D),
                                torch.from_numpy(betas)[:, None]).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    # the full densities are the sums of the terms
    np.testing.assert_allclose(tpath.log_density(torch.from_numpy(xs), torch.from_numpy(betas)).numpy(),
                               t.sum(-1), rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("n_passes", [1, 3])
def test_twin_matches_pallas_banded_kernel(n_passes):
    jt = JaxSeparable()
    jpath = jt.create_path(jt.default_reference())
    xs, betas = _sweep_inputs(n_passes)

    def ld(x, beta, isvar, ref_params):
        return jpath.log_density(x, beta)

    def ld_coord(v, c, beta, isvar, ref_params):  # the runtime's closure, pt.py:693-696
        lp = jpath.coord_log_density(v, c, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    keys = jrng.keys_for(jax.random.key(5), jnp.arange(B))
    ref = SliceSamplerPallas(interpret=True, n_passes=n_passes).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(B), ld, jnp.asarray(betas), jnp.zeros(B), (), (), 1,
        ld_coord=ld_coord, compute_final_lp=False)
    _, tpath = _port_path()
    explorer = SliceSamplerCUDA(n_passes=n_passes)
    explorer.check_path(tpath)
    before = dict(SliceSamplerCUDA.launches)
    out = explorer.step_batched(trng.keys_for(trng.key(5), torch.arange(B)), torch.from_numpy(xs),
                                torch.from_numpy(betas), tpath)
    assert SliceSamplerCUDA.launches == before and out.lp is None  # K1's twin
    x, x_ref = out.x.numpy(), np.asarray(ref.x)
    flipped = np.abs(x - x_ref) > 1e-6 * np.maximum(np.abs(x_ref), 1e-30)
    print(f"{int(flipped.sum())} flipped of {x.size} elements; {int((x != x_ref).sum())} not "
          "bitwise equal")
    assert flipped.sum() <= MAX_FLIP_SHARE * x.size
    clean = ~flipped.any(1)
    for have, want in ((out.accept_sum, ref.accept_sum), (out.accept_n, ref.accept_n),
                       (out.n_steps, ref.n_steps)):
        assert np.array_equal(have.numpy()[clean], np.asarray(want)[clean])
    assert not np.array_equal(x, xs)


# the shapes of the host-build tests of the toy term: B * d below a warp, tiles
# that end inside a lane, more than one tile a block, d = 1, a d above the tile
@pytest.mark.parametrize("B,d,n_passes", [(1, 5, 3), (37, 13, 1), (700, 13, 3), (300, 1, 2),
                                          (40, 100, 3), (3, 4100, 1)])
def test_user_term_host_build_matches_twin(user_dir, B, d, n_passes):
    _, path = _port_path(d)
    source = path.coord_source
    lib = _host_user_library(source, user_dir)
    x, betas, seeds = _inputs(B, d, n_passes, scale=2.0)
    want = cuda_slice.banded_sweep_reference(x, betas, seeds, n_passes=n_passes,
                                             user=cuda_slice.UserTerm(betas, source))
    got = _in_child(host_call.banded_slice_sweep_user, str(lib), x, betas, seeds, source.params,
                    10.0, 20, n_passes, 1024, tuple(a.numpy() for a in source.arrays))
    _assert_bitwise(got, want, ("x", "stats"))
    assert (n_passes == 0) == torch.equal(got[0], x)


# A coordinate source that reads its tables as a source may: the entry of
# another coordinate than c (c + 1, wrapping), and an array of another length
# than the state's, which the hooks read where they lie.
NEIGHBOUR_CUDA = r"""
using namespace pigeons;

__device__ float pigeons_user_ref_coord(float v, int c, const float* params,
                                        const DensityArrays& arrays) {
  const float q = v * params[0];
  return (q * q) * -0.5f;
}

// arrays: m [d], s [1]
__device__ float pigeons_user_target_coord(float v, int c, const float* params,
                                           const DensityArrays& arrays) {
  const float* m = arrays.ptr[0];
  const float q = (v - m[c]) * arrays.ptr[1][0];
  return (q * q) * -0.5f + m[c + 1 == arrays.n[0] ? 0 : c + 1] * params[1];
}
"""


def _neighbour_ref(v, c, params, arrays):
    q = v * params[0]
    return (q * q) * -0.5


def _neighbour_target(v, c, params, arrays):
    m, s = arrays
    q = (v - m[c]) * s[0]
    return (q * q) * -0.5 + m[torch.where(c + 1 == m.numel(), 0, c + 1)] * params[1]


def _neighbour_source(d):
    m = torch.from_numpy(np.linspace(-1.0, 1.5, d).astype(np.float32))
    return T.DeviceSource(NEIGHBOUR_CUDA, "coord", _neighbour_target, params=(1.0 / 3.0, 0.25),
                          arrays=(m, torch.tensor([1.5])), torch_ref_fn=_neighbour_ref)


# K1's tile is 4,096 elements: d = 13 and 100 within one, 4,100 above it (a
# block's share of coordinates wraps around)
@pytest.mark.parametrize("B,d", [(37, 13), (40, 100), (3, 4100)])
def test_hooks_read_any_entry_of_their_arrays(user_dir, B, d):
    """A hook that reads a neighbour's entry of a coordinate's table and an
    array of another length: bit for bit the twin, within a tile and above."""
    source = _neighbour_source(d)
    lib = _host_user_library(source, user_dir)
    x, betas, seeds = _inputs(B, d, d, scale=2.0)
    want = cuda_slice.banded_sweep_reference(x, betas, seeds, n_passes=1,
                                             user=cuda_slice.UserTerm(betas, source))
    got = _in_child(host_call.banded_slice_sweep_user, str(lib), x, betas, seeds, source.params,
                    10.0, 20, 1, 1024, tuple(a.numpy() for a in source.arrays))
    _assert_bitwise(got, want, ("x", "stats"))
    assert not torch.equal(got[0], x)


def test_two_round_run_matches_jax():
    """Both packages' runs of the path from the seed: the port's on K1's twin
    with the user term, the JAX package's on its banded kernel."""
    kw = dict(n_chains=4, n_replicates=2, n_rounds=2, seed=3, show_report=False)
    ja = J.PT(J.Inputs(target=JaxSeparable(), explorer=SliceSamplerPallas(interpret=True, n_passes=1),
                       **kw)).run()
    target, _ = _port_path()
    ta = T.PT(T.Inputs(target=target, explorer=SliceSamplerCUDA(n_passes=1), device="cpu", **kw)).run()
    assert ta.path.coord_source is not None
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        assert (rj.n_tempered_restarts, rj.n_round_trips) == (rt.n_tempered_restarts,
                                                              rt.n_round_trips)
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    sj, st = np.asarray(ja.states), ta.states.numpy()
    flipped = int((np.abs(st - sj) > 1e-5 * np.maximum(np.abs(sj), 1.0)).sum())
    print(f"{flipped} flipped of {sj.size} state elements, {int((sj != st).sum())} not bitwise equal")
    assert flipped == 0


def test_user_term_refusals():
    _, path = _port_path()
    for explorer in (SliceSamplerCUDA(coord_deltas=False), SliceSamplerCUDA(parallel_coords=False)):
        with pytest.raises(NotImplementedError, match=r"K1's user term.*SliceSampler\(\)"):
            explorer.check_path(path)
    with pytest.raises(NotImplementedError, match="variational reference"):
        SliceSamplerCUDA().check_path(T.VariationalPath(path, T.GaussianReference()))
    # another reference than the source's own: no coordinate terms, no kernel
    target = SE.normal_product_source(D)
    other = target.create_path(T.StandardNormalReference(D, 1.0).as_reference())
    assert other.coord_source is None and not other.has_coordwise
    with pytest.raises(NotImplementedError, match="DeviceSource"):
        SliceSamplerCUDA().check_path(other)
