"""Coordinate-wise densities on the port's ``InterpolatingPath``, against the
JAX package's on the CPU.

A separable path, a product of d = 6 normals with per-coordinate means and
scales as the target and N(0, 3^2) per coordinate as the reference, is built
in both packages with ``ref_coord_log_density`` / ``target_coord_log_density``
beside the full densities. Held:

* the fields: the JAX dataclass's in its order, the port's own after them and
  keyword only, so that a positional call means the same in both;
* ``sum_c coord_log_density(x[c], c, beta) == log_density(x, beta)`` in each
  package (within 2e-6 relative: a sum of coordinates against the full
  density's own sum), and the port's ``coord_log_density`` against the JAX
  one within 1e-6;
* two rounds of ``PT`` with the torch ``SliceSampler`` in the port and the JAX
  package's XLA ``SliceSampler``, which both ignore the fields: restarts and
  round trips equal, permutations and explorer step counts exact, barrier
  and logZ within 1e-3, states within 1e-5 relative (the tolerances of
  ``tests/test_torch_slice_sampler.py``);
* ``SliceSamplerCUDA`` refuses such a path without a device density or a
  ``coord_source``, naming ``SliceSampler()`` and the ``coord_source`` route
  (a user's terms as CUDA source, ``tests/test_torch_user_coord.py``), and
  runs one that has a device density on kernel K2 (its twin here) in full
  mode, as before.
"""

import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import paths as JP
from pigeons_tpu_torch import paths as TP
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice

D = 6
MU = np.linspace(-1.0, 1.5, D).astype(np.float32)
SCALE = np.linspace(0.5, 2.0, D).astype(np.float32)
REF_SCALE = 3.0
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSeparable(J.models.Target):
    dim = D

    @staticmethod
    def coord(v, c):
        mu, scale = jnp.asarray(MU)[c], jnp.asarray(SCALE)[c]
        return -0.5 * ((v - mu) / scale) ** 2 - jnp.log(scale) - HALF_LOG_2PI

    @staticmethod
    def ref_coord(v, c):
        return -0.5 * (v / REF_SCALE) ** 2 - math.log(REF_SCALE) - HALF_LOG_2PI

    def log_density(self, x):
        return jnp.sum(self.coord(x, jnp.arange(D)))

    def default_reference(self):
        return J.models.Reference(
            log_density=lambda x: jnp.sum(self.ref_coord(x, jnp.arange(D))),
            sample_iid=lambda key: REF_SCALE * jax.random.normal(key, (D,)))

    def create_path(self, reference):
        return JP.InterpolatingPath(reference.log_density, self.log_density,
                                    reference.sample_iid, self.ref_coord, self.coord)


class TorchSeparable(T.models.Target):
    dim = D
    mu, scale = torch.from_numpy(MU), torch.from_numpy(SCALE)

    @classmethod
    def coord(cls, v, c):
        c = torch.as_tensor(c)
        return (-0.5 * ((v - cls.mu[c]) / cls.scale[c]) ** 2 - torch.log(cls.scale[c])
                - HALF_LOG_2PI)

    @staticmethod
    def ref_coord(v, c):
        del c
        return -0.5 * (v / REF_SCALE) ** 2 - math.log(REF_SCALE) - HALF_LOG_2PI

    def log_density(self, x):
        return torch.sum(self.coord(x, torch.arange(D)), dim=-1)

    def default_reference(self):
        return T.models.Reference(
            log_density=lambda x: torch.sum(self.ref_coord(x, None), dim=-1),
            sample_iid=lambda keys: REF_SCALE * trng.normal(keys, (D,)))

    def create_path(self, reference):
        return TP.InterpolatingPath(reference.log_density, self.log_density,
                                    reference.sample_iid, self.ref_coord, self.coord)


def _states(n, seed):
    return (np.random.RandomState(seed).normal(size=(n, D)) * 2.0).astype(np.float32)


def test_fields_follow_the_jax_dataclass():
    jf = [f.name for f in dataclasses.fields(JP.InterpolatingPath)]
    tf = [f for f in dataclasses.fields(TP.InterpolatingPath)]
    assert [f.name for f in tf[:len(jf)]] == jf
    assert all(not f.kw_only for f in tf[:len(jf)])
    assert [f.name for f in tf[len(jf):]] == ["device", "endpoints", "sweep_endpoints",
                                              "coord_source"]
    assert all(f.kw_only for f in tf[len(jf):])
    assert list(inspect.signature(TP.InterpolatingPath.coord_log_density).parameters) == \
        list(inspect.signature(JP.InterpolatingPath.coord_log_density).parameters)


def test_coordinate_sum_is_the_density_in_each_package():
    jt, tt = JaxSeparable(), TorchSeparable()
    jpath, tpath = jt.create_path(jt.default_reference()), tt.create_path(tt.default_reference())
    assert jpath.has_coordwise and tpath.has_coordwise
    assert not TP.InterpolatingPath(lambda x: x, lambda x: x).has_coordwise
    x = _states(64, 1)
    betas = np.linspace(0.0, 1.0, 64).astype(np.float32)

    def jax_both(xi, beta):
        coords = jax.vmap(lambda v, c: jpath.coord_log_density(v, c, beta))(xi, jnp.arange(D))
        return jpath.log_density(xi, beta), coords

    jfull, jcoord = (np.asarray(a) for a in jax.jit(jax.vmap(jax_both))(x, betas))
    tx, tb = torch.from_numpy(x), torch.from_numpy(betas)
    tfull = tpath.log_density(tx, tb).numpy()
    tcoord = tpath.coord_log_density(tx, torch.arange(D), tb[:, None]).numpy()
    np.testing.assert_allclose(jcoord.sum(-1), jfull, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(tcoord.sum(-1), tfull, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(tcoord, jcoord, rtol=1e-6, atol=1e-6)
    # at the ends the guarded multiply keeps an infinite endpoint out
    inf = TP.InterpolatingPath(lambda x: x, lambda x: x, None, lambda v, c: -torch.inf + 0 * v,
                               lambda v, c: 0.0 * v)
    assert float(inf.coord_log_density(torch.tensor(1.0), 0, torch.tensor(1.0))) == 0.0


def test_run_with_the_torch_sampler_matches_jax():
    """Two rounds, 4 chains x 2 ladders; the samplers ignore the fields."""
    kw = dict(n_chains=4, n_replicates=2, n_rounds=2, seed=3, show_report=False)
    ja = J.PT(J.Inputs(target=JaxSeparable(), explorer=J.SliceSampler(n_passes=1), **kw)).run()
    ta = T.PT(T.Inputs(target=TorchSeparable(), explorer=T.SliceSampler(n_passes=1),
                       device="cpu", **kw)).run()
    assert ta.path.has_coordwise
    for rj, rt in zip(ja.reports, ta.reports, strict=True):
        assert (rj.n_tempered_restarts, rj.n_round_trips) == (rt.n_tempered_restarts,
                                                              rt.n_round_trips)
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
    sj, st = np.asarray(ja.states), ta.states.numpy()
    assert (np.abs(st - sj) <= 1e-5 * np.maximum(np.abs(sj), 1e-30)).all()


def test_cuda_sampler_refuses_coordinate_densities_without_a_device_density():
    t = TorchSeparable()
    path = t.create_path(t.default_reference())
    with pytest.raises(NotImplementedError, match=r"SliceSampler\(\)") as err:
        SliceSamplerCUDA().check_path(path)
    assert "coord_source" in str(err.value) and "coordinate-wise" in str(err.value)
    with pytest.raises(NotImplementedError, match="coord_source"):
        T.PT(T.Inputs(target=t, explorer=SliceSamplerCUDA(), device="cpu", show_report=False))


def test_cuda_sampler_runs_a_path_with_a_device_density_in_full_mode():
    """The flat-prior MVN's path (a device density) with coordinate
    densities added: the same sweep of K2's twin as the plain path's."""
    target = T.models.library.MVN(D)
    plain = target.create_path(target.default_reference())
    coordwise = dataclasses.replace(plain, ref_coord_log_density=lambda v, c: 0.0 * v,
                                    target_coord_log_density=lambda v, c: -0.5 * v * v)
    assert coordwise.has_coordwise and coordwise.device_density() == plain.device_density()
    x = torch.from_numpy(_states(8, 2))
    betas = torch.linspace(0.0, 1.0, 8)
    keys = trng.keys_for(trng.key(4), torch.arange(8))
    sampler = SliceSamplerCUDA(n_passes=1)
    sampler.check_path(coordwise)
    got = sampler.step_batched(keys, x, betas, coordwise)
    want = sampler.step_batched(keys, x, betas, plain)
    assert torch.equal(got.x, want.x) and torch.equal(got.lp, want.lp)
    full = cuda_slice.sweep_reference(x, betas, cuda_slice.lane_seeds(keys), plain, False,
                                      n_passes=1)
    assert torch.equal(got.x, full[0])
