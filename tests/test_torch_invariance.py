"""The port's exact invariance test (modified Geweke) on the CPU, through
the kernels' plain twins, against the JAX package's.

The draws are the JAX ``invariance_test``'s: the same keys give the same
iid batches within 2e-6 (the normals are within 2 ulp of XLA's). Then one
step of every explorer of the port, each kernel's twin in each of its
modes among them, must leave the target invariant at the JAX test's
``N = 4000`` and threshold; the explorers that both packages have give
the JAX test's p-values. A kernel that drifts must fail, in both packages.
The variational term is tested at beta = 0.3, where the reference's half
of the blend weighs 0.7 (at beta = 1 it weighs nothing), under a reference
far from the target, and a step that reads a wrong reference must fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu.invariance_test import invariance_test as jax_invariance_test
from pigeons_tpu.ops.base import Explorer as JaxExplorer
from pigeons_tpu.ops.base import StepOut as JaxStepOut
from pigeons_tpu_torch.invariance_test import iid_draws, invariance_test
from pigeons_tpu_torch.ops.base import Explorer, StepOut

N = 4000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["toy_mvn", "funnel"])
def test_draws_are_the_jax_draws(name):
    jt, tt = {"toy_mvn": (J.toy_mvn_target(3), T.toy_mvn_target(3)),
              "funnel": (J.funnel(3), T.funnel(3))}[name]
    sampler = jt.sample_iid_target if name == "funnel" else (
        lambda k: jt.path.sample_at(k, 1.0))
    k_init, k_final, _ = jax.random.split(jrng.master_key(7), 3)
    want = [np.asarray(jax.vmap(sampler)(jrng.replica_keys(k, N))) for k in (k_init, k_final)]
    initial, xs, _ = iid_draws(tt, 7, N, torch.device("cpu"))
    np.testing.assert_allclose(initial.numpy(), want[0], rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(xs.numpy(), want[1], rtol=2e-6, atol=2e-6)


REFERENCE = {"mean": torch.tensor([0.8, -0.6, 0.3]), "std": torch.tensor([0.5, 1.2, 0.8]),
             "active": torch.tensor(1.0)}
BLEND = dict(beta=0.3, variational=T.GaussianReference(), ref_params=REFERENCE)
CASES = {
    "slice_sampler": (T.toy_mvn_target(3), T.SliceSampler(n_passes=1), {}),
    "mala": (T.toy_mvn_target(3),
             T.MALA(step_size=0.4, preconditioner=T.IdentityPreconditioner()), {}),
    "automala": (T.toy_mvn_target(3), T.AutoMALA(preconditioner=T.IdentityPreconditioner()),
                 {}),
    "k1_toy_term": (T.toy_mvn_target(3), T.SliceSamplerCUDA(), {}),
    "k1_toy_term_beta_0.3": (T.toy_mvn_target(3), T.SliceSamplerCUDA(), dict(beta=0.3)),
    "k1_variational_term": (T.toy_mvn_target(3), T.SliceSamplerCUDA(), BLEND),
    "k2_full_funnel": (T.funnel(3), T.SliceSamplerCUDA(n_passes=1), {}),
    "k2_full_variational_toy_mvn": (T.toy_mvn_target(3),
                                    T.SliceSamplerCUDA(parallel_coords=False), BLEND),
    "k2_delta_toy_mvn": (T.toy_mvn_target(3), T.SliceSamplerCUDA(parallel_coords=False), {}),
}
JAX_EXPLORERS = {
    "slice_sampler": lambda: J.SliceSampler(n_passes=1),
    "mala": lambda: J.MALA(step_size=0.4, preconditioner=J.IdentityPreconditioner()),
    "automala": lambda: J.AutoMALA(preconditioner=J.IdentityPreconditioner()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_explorers_are_invariant(name):
    target, explorer, kw = CASES[name]
    res = invariance_test(target, explorer, n_iid_samples=N, device="cpu", **kw)
    assert res.passed, f"failed dims {res.failed_dims}, p-values {res.pvalues}"
    assert res.pvalues.shape == (target.dim,)
    if name in JAX_EXPLORERS:
        ref = jax_invariance_test(J.toy_mvn_target(3), JAX_EXPLORERS[name](), n_iid_samples=N)
        np.testing.assert_allclose(res.pvalues, ref.pvalues, rtol=0, atol=2e-6)


class WrongReference(Explorer):
    """Steps along the blend with the reference's std 1.5 times too large:
    a variational term computed wrong."""

    def __init__(self, inner):
        self.inner = inner

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, **kw):
        wrong = dict(ref_params, std=ref_params["std"] * 1.5)
        return self.inner.step_batched(keys, xs, betas, path, isvar=isvar, ref_params=wrong,
                                       **kw)


@pytest.mark.parametrize("parallel_coords", [True, False], ids=["k1", "k2"])
def test_wrong_variational_term_fails(parallel_coords):
    explorer = WrongReference(T.SliceSamplerCUDA(parallel_coords=parallel_coords))
    res = invariance_test(T.toy_mvn_target(3), explorer, n_iid_samples=N, device="cpu", **BLEND)
    assert not res.passed and 0 in res.failed_dims


def test_blend_draws_are_the_blend():
    """At beta the blend of N(0, I / 10) and N(m, s^2) is N(mu, v): 1 / v =
    (1 - beta) / s^2 + 10 beta, mu = v (1 - beta) m / s^2."""
    initial, xs, _ = iid_draws(T.toy_mvn_target(3), 5, 20_000, torch.device("cpu"),
                               **BLEND)
    m, s2 = REFERENCE["mean"].double(), REFERENCE["std"].double() ** 2
    prec = 0.7 / s2 + 3.0
    for batch in (initial, xs):
        np.testing.assert_allclose(batch.double().mean(0), 0.7 * m / s2 / prec, atol=0.02)
        np.testing.assert_allclose(batch.double().var(0), 1.0 / prec, rtol=0.03)


class BrokenKernel(Explorer):
    """Deterministic drift: not invariant."""

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None):
        z = torch.zeros(xs.shape[0], device=xs.device)
        return StepOut(xs + 0.2, None, z, z, z)


class JaxBrokenKernel(JaxExplorer):
    def step(self, key, x, lp0, lp_fn, beta, chain_params, scan_idx):
        x2 = x + 0.2
        z = jnp.zeros((), jnp.float32)
        return JaxStepOut(x2, lp_fn(x2), z, z, z)


def test_broken_kernel_fails_as_in_jax():
    port = invariance_test(T.toy_mvn_target(3), BrokenKernel(), n_iid_samples=N, device="cpu")
    ref = jax_invariance_test(J.toy_mvn_target(3), JaxBrokenKernel(), n_iid_samples=N)
    assert not port.passed and not ref.passed
    assert list(port.failed_dims) == list(ref.failed_dims) == [0, 1, 2]


def test_target_without_iid_sampler_raises():
    with pytest.raises(ValueError, match="sample_iid_target"):
        invariance_test(T.eight_schools(), T.SliceSampler(), n_iid_samples=10, device="cpu")


def test_beta_without_iid_draws_raises():
    with pytest.raises(ValueError, match="iid draws at that beta"):
        invariance_test(T.funnel(3), T.SliceSampler(), n_iid_samples=10, device="cpu", beta=0.5)
