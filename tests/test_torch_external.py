"""The port's host-evaluated targets against the JAX package's, on the CPU:
``ExternalTarget`` (a batched numpy density), ``LazyTarget`` and
``NativeTarget`` (a ``ptn_`` shared library: ``examples/native/het_normal.cpp``
built with ``g++``; the JAX package's own build of the same file for its
side).

Tolerances and why: with the ``SliceSampler`` both runs evaluate the same
host function or library on the same float32 states, so states, samples
and permutations must be equal bit for bit; ``AutoMALA`` on the native
target is held as the gradient files hold it (at most 1 % of lanes end
elsewhere). The native density and gradient are held to het_normal's closed
form (float32 of a float64 evaluation: 1e-6 relative) and to the JAX
package's ``jax.value_and_grad`` through its ``custom_vjp`` bitwise.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu.models import register_lazy_target as j_register
from pigeons_tpu.models.native import NativeTarget as JNative
from pigeons_tpu_torch.models import register_lazy_target as t_register
from pigeons_tpu_torch.models.native import NativeTarget, example_library
from pigeons_tpu_torch.paths import value_and_grad

PREC = np.array([500.0, 167.0, 56.0, 1.0])


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib_path():
    return example_library("het_normal")


def _both(kw, jex=None, tex=None, rounds=None):
    ja = J.PT(J.Inputs(**{**kw, "target": kw["target"][0]}, explorer=jex, show_report=False))
    ta = T.PT(T.Inputs(**{**kw, "target": kw["target"][1]}, explorer=tex, show_report=False,
                       device="cpu"))
    for pt in (ja, ta):
        if rounds is None:
            pt.run()
        else:
            for _ in range(rounds):
                pt.run_round()
    return ja, ta


def _assert_same_run(ja, ta):
    assert np.array_equal(np.asarray(ja.states), ta.states.numpy())
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    assert np.array_equal(ja.sample_array(), ta.sample_array())
    assert [r.n_round_trips for r in ja.reports] == [r.n_round_trips for r in ta.reports]


def _quadratic(xb):
    return (-0.5 * (xb**2).sum(axis=1) * 5.0).astype("float32")


def test_external_target_run_is_the_jax_run():
    calls = []

    def counted(xb):
        calls.append(xb.shape)
        return _quadratic(xb)

    # the JAX file's run (tests/test_extensions.py) cut from 7 rounds to 4:
    # the torch slice sampler takes about 0.1 s a scan on the CPU
    kw = dict(target=(J.ExternalTarget(_quadratic, dim=2), T.ExternalTarget(counted, dim=2)),
              n_chains=3, n_rounds=4, seed=1)
    ja, ta = _both(kw)
    _assert_same_run(ja, ta)
    # the online moments' Kahan sums end in the last bits of float32
    np.testing.assert_allclose(ta.var(), np.asarray(ja.var()), rtol=1e-5)
    # one host call a batched evaluation, on the whole block of lanes
    assert calls and all(s[0] == 3 and s[1] == 2 for s in calls)


def test_lazy_target_run_is_the_jax_run():
    j_register("toy3-torch-test", lambda: J.toy_mvn_target(3))
    t_register("toy3-torch-test", lambda: T.toy_mvn_target(3))
    lt = T.LazyTarget("toy3-torch-test")
    assert len(pickle.dumps(lt)) < 200  # only the flag is serialized
    assert pickle.loads(pickle.dumps(lt)).dim == 3
    kw = dict(target=(J.LazyTarget("toy3-torch-test"), lt), n_chains=3, n_rounds=6, seed=1)
    ja, ta = _both(kw)
    np.testing.assert_allclose(ta.var(), 0.1, atol=0.06)
    # ToyExplorer's draws scale by rsqrt(precision), which XLA may round 2 ulp
    # off torch's (tests/test_torch_pt.py): 1e-6 relative
    np.testing.assert_allclose(ta.states.numpy(), np.asarray(ja.states), rtol=1e-6)
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())


def test_native_density_and_gradient(lib_path):
    t, j = NativeTarget(lib_path), JNative(lib_path)
    assert t.dim == j.dim == 4
    x = np.array([[0.1, -0.2, 0.3, 1.0], [0.2, -0.4, 0.6, 2.0], [0.0, 0.0, 0.0, 0.0],
                  [np.inf, 0.0, 0.0, 0.0]], np.float32)  # the last: -inf, a zero gradient
    lp = t.log_density(torch.from_numpy(x))
    want = -0.5 * (x[:3].astype(np.float64) ** 2 * PREC).sum(1)
    np.testing.assert_allclose(lp.numpy()[:3], want, rtol=1e-6)
    assert lp.dtype == torch.float32 and lp[3] == -np.inf
    xg = torch.from_numpy(x).requires_grad_(True)
    t.log_density(xg).sum().backward()
    assert torch.equal(xg.grad[3], torch.zeros(4))
    beta = torch.full((3,), 0.7)
    path = t.create_path(t.default_reference())
    lpg, grad = value_and_grad(path, torch.from_numpy(x[:3]), beta)
    jpath = j.create_path(j.default_reference())
    jl, jg = jax.vmap(jax.value_and_grad(lambda v, b: jpath.log_density(v, b)))(
        jnp.asarray(x[:3]), jnp.asarray(beta.numpy()))
    assert np.array_equal(lpg.numpy(), np.asarray(jl))
    assert np.array_equal(grad.numpy(), np.asarray(jg))
    np.testing.assert_allclose(grad.numpy(), -(0.7 * PREC + 0.3) * x[:3], rtol=1e-5)


def test_native_defaults_and_pickling(lib_path):
    t = NativeTarget(lib_path)
    assert isinstance(t.default_explorer(), T.AutoMALA)
    t2 = pickle.loads(pickle.dumps(t))
    x = torch.ones((2, 4))
    assert torch.equal(t.log_density(x), t2.log_density(x))
    assert len(pickle.dumps(t)) < 400  # the path, not the library
    with pytest.raises(ValueError, match=r"SliceSampler\(w=10.0, p=20, n_passes=1"):
        T.PT(T.Inputs(target=t, explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu"))


def test_native_slice_sampler_run_is_the_jax_run(lib_path):
    kw = dict(target=(JNative(lib_path), NativeTarget(lib_path)), n_chains=5, n_rounds=3,
              seed=2)
    ja, ta = _both(kw, J.SliceSampler(n_passes=1), T.SliceSampler(n_passes=1))
    _assert_same_run(ja, ta)


def test_native_automala_run_follows_the_jax_run(lib_path):
    kw = dict(target=(JNative(lib_path), NativeTarget(lib_path)), n_chains=4, n_replicates=6,
              n_rounds=3, seed=3)
    ja, ta = _both(kw)  # the target's default explorer: AutoMALA in both
    assert isinstance(ta.explorer, T.AutoMALA)
    moved = np.abs(np.asarray(ja.states) - ta.states.numpy()).max(-1) > 1e-4
    assert moved.sum() <= 0.01 * moved.size + 1
    np.testing.assert_allclose(ta.exp_state["step_size"].numpy(),
                               np.asarray(ja.exp_state["step_size"]), rtol=1e-3)
