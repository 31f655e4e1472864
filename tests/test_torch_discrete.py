"""Ordinal and Bool coordinates in the port, against the JAX package on the
CPU: the masked ``SliceSampler``, ``BinaryGibbs``, ``ising_target``,
``poisson_count_target`` and ``binary_mixture_target``.

(a) One step of the masked ``SliceSampler`` (``integer_mask`` on the
    Poisson count target, ``binary_mask`` on the binary mixture) and of
    ``BinaryGibbs`` (all coordinates, and a mask) against
    ``jax.vmap(step)`` of the JAX explorers, 32 lanes, betas in [0, 1]:
    the integer and Bool coordinates, ``accept_sum``, ``accept_n`` and
    ``n_steps`` exact; the continuous coordinates of the integer-masked
    sampler within 1e-6 (XLA selects between the two candidate draws there,
    and the densities of the continuous coordinates' queries differ in last
    bits), of the binary-masked one and of ``BinaryGibbs`` bitwise.
(b) The targets' densities, references and draws against the JAX ones:
    bitwise (the Poisson reference draws have the law of
    ``jax.random.poisson``, not its stream: a chi-square test).
(c) The laws, at ``tests/test_models.py``'s and ``tests/test_ising.py``'s
    thresholds, with fewer rounds and more ladders: the 2 x 2 Ising
    single-sweep conditional, ``ising_target(0.4, 3)`` against its
    enumeration oracle (logZ within 0.2, |M| within 0.05, states exactly
    binary), the Poisson count run's moments and the binary mixture's
    P(b = 1). The Ising and mixture runs start from the JAX run's state
    (``convert.state_from_numpy``) and are held to its second round:
    permutations and restarts exact, states within 1e-5 (the mixture's
    continuous coordinates differ in last bits inside the JAX run's fused
    scan, 1 of 64 in round 2), logZ within 1e-4.
(d) ``SliceSamplerCUDA`` refuses a masked target, naming ``SliceSampler()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu.models import library as JL
from pigeons_tpu.ops.binary_gibbs import BinaryGibbs as JBinaryGibbs
from pigeons_tpu.ops.slice_sampler import SliceSampler as JSliceSampler
from pigeons_tpu_torch import convert
from pigeons_tpu_torch import rng as trng

B = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TARGETS = {
    "poisson": lambda pkg: (JL if pkg is J else T).poisson_count_target(5.0, 1),
    "mixture": lambda pkg: (JL if pkg is J else T).binary_mixture_target(),
    "mixture_mu0": lambda pkg: (JL if pkg is J else T).binary_mixture_target(mu=0.0),
    "ising": lambda pkg: pkg.ising_target(0.4, 3),
}


def _pair(name):
    return TARGETS[name](J), TARGETS[name](T)


def _explorers(name, jt, tt, n_passes):
    if name == "poisson":
        return (JSliceSampler(integer_mask=jt.integer_mask, n_passes=n_passes),
                T.SliceSampler(integer_mask=tt.integer_mask, n_passes=n_passes))
    if name == "mixture":
        return (JSliceSampler(binary_mask=jt.binary_mask, n_passes=n_passes),
                T.SliceSampler(binary_mask=tt.binary_mask, n_passes=n_passes))
    mask = None if name == "ising" else (1, 0, 1, 1, 0, 1, 1, 1, 0)
    return JBinaryGibbs(mask, n_passes), T.BinaryGibbs(mask, n_passes)


@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("name", ["poisson", "mixture", "ising", "ising_masked"])
def test_masked_step_matches_jax(name, n_passes):
    jt, tt = _pair("ising" if name == "ising_masked" else name)
    je, te = _explorers(name, jt, tt, n_passes)
    xs = np.asarray(jax.vmap(jt.initialization)(jrng.keys_for(jax.random.key(3), jnp.arange(B))))
    betas = np.linspace(0.0, 1.0, B).astype(np.float32)
    jp, tp = jt.create_path(jt.default_reference()), tt.create_path(tt.default_reference())

    def one(key, x, beta):
        def lp_fn(v):
            return jp.log_density(v, beta)

        return je.step(key, x, lp_fn(x), lp_fn, beta, (), 2)

    ref = jax.jit(jax.vmap(one))(jrng.keys_for(jax.random.key(9), jnp.arange(B)), jnp.asarray(xs),
                                 jnp.asarray(betas))
    out = te.step_batched(trng.keys_for(trng.key(9), torch.arange(B)), torch.from_numpy(xs.copy()),
                          torch.from_numpy(betas), tp)
    for key in ("accept_sum", "accept_n", "n_steps"):
        assert np.array_equal(getattr(out, key).numpy(), np.asarray(getattr(ref, key))), key
    jx, tx = np.asarray(ref.x), out.x.numpy()
    assert not np.array_equal(tx, xs)
    discrete = np.zeros(jt.dim, bool)
    for mask in ("integer_mask", "binary_mask"):
        if getattr(tt, mask, None) is not None:
            discrete |= getattr(tt, mask)
    if name.startswith("ising"):
        discrete[:] = True
    assert np.array_equal(tx[:, discrete], jx[:, discrete])
    if name == "poisson":
        assert np.array_equal(tx[:, 0], np.round(tx[:, 0]))
        print(f"continuous coordinates: {int((tx != jx).sum())} of {B} not bitwise equal")
        np.testing.assert_allclose(tx, jx, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out.lp.numpy(), np.asarray(ref.lp), rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(tx, jx) and np.array_equal(out.lp.numpy(), np.asarray(ref.lp))


def test_mask_checks_match_jax():
    with pytest.raises(ValueError, match="whole-number"):
        T.SliceSampler(w=2.5, integer_mask=[True, False])
    with pytest.raises(ValueError, match="both binary and integer"):
        T.SliceSampler(integer_mask=[True, False], binary_mask=[True, True])
    assert isinstance(T.ising_target(0.4, 3).default_explorer(), T.BinaryGibbs)
    sampler = T.poisson_count_target().default_explorer()
    assert isinstance(sampler, T.SliceSampler) and sampler.integer_mask.tolist() == [True, False]
    assert T.binary_mixture_target().default_explorer().binary_mask.tolist() == [True, True, False,
                                                                                False]


@pytest.mark.parametrize("name", ["poisson", "mixture", "mixture_mu0", "ising"])
def test_densities_and_draws_match_jax(name):
    jt, tt = _pair(name)
    assert jt.dim == tt.dim
    keys = jrng.keys_for(jax.random.key(3), jnp.arange(512))
    xj = np.asarray(jax.vmap(jt.initialization)(keys))
    xt = tt.initialization(trng.keys_for(trng.key(3), torch.arange(512))).numpy()
    if name == "poisson":  # the count's law only; the normal coordinate bitwise
        assert np.array_equal(xt[:, 1:], xj[:, 1:])
    else:
        assert np.array_equal(xt, xj)
    x = torch.from_numpy(xj.copy())
    for jfn, tfn in ((jt.log_density, tt.log_density),
                     (jt.default_reference().log_density, tt.default_reference().log_density)):
        assert np.array_equal(tfn(x).numpy(), np.asarray(jax.jit(jax.vmap(jfn))(xj)))
    if name != "ising":  # a count or Bool coordinate off its support
        bad = x.clone()
        bad[:, 0] = 0.5
        assert torch.isinf(tt.log_density(bad)).all()


def test_poisson_reference_draws_have_the_law():
    """Chi-square of 20,000 draws of Poisson(5) over the counts 0..14 and
    the tail, against the pmf and against ``jax.random.poisson``'s counts."""
    t = T.poisson_count_target(5.0, 1)
    k = t.sample_iid_target(trng.keys_for(trng.key(11), torch.arange(20_000)))[:, 0].numpy()
    assert np.array_equal(k, np.round(k)) and (k >= 0).all()
    counts = np.bincount(np.minimum(k.astype(int), 15), minlength=16)
    p = sps.poisson(5.0).pmf(np.arange(15))
    expected = 20_000 * np.append(p, 1.0 - p.sum())
    pvalue = sps.chisquare(counts, expected).pvalue
    jk = np.asarray(jax.random.poisson(jax.random.key(12), 5.0, (20_000,)))
    jcounts = np.bincount(np.minimum(jk, 15), minlength=16)
    two_sample = sps.chi2_contingency(np.stack([counts, jcounts])).pvalue
    print(f"chi-square p-value against the pmf {pvalue:.4f}, against jax.random.poisson "
          f"{two_sample:.4f}")
    assert pvalue > 1e-3 and two_sample > 1e-3


# ---------------------------------------------------------------------------
# laws


def test_binary_gibbs_single_sweep_conditional():
    """One sweep from the all-aligned 2 x 2 state leaves it with the exact
    full-conditional probability (``tests/test_ising.py``)."""
    t = T.ising_target(beta_ising=0.4, base_length=2)
    x = torch.ones((3000, 4))
    out = T.BinaryGibbs().step_batched(trng.keys_for(trng.key(0), torch.arange(3000)), x,
                                       torch.ones(3000), t.create_path(t.default_reference()))
    frac_left = float((out.x.min(dim=1).values == 0).float().mean())
    assert 0.10 < frac_left < 0.20


def test_enumerate_oracle_matches_jax():
    for beta, L in ((0.4, 3), (0.3, 2), (0.44, 4)):
        lz, mag = T.ising_target(beta, L).enumerate_oracle()
        jlz, jmag = J.ising_target(beta, L).enumerate_oracle()
        assert abs(lz - jlz) < 1e-5 and abs(mag - jmag) < 1e-6


def _run_from_jax(jt, tt, n_rounds, explorers=(None, None), **kw):
    """The JAX package's first round, the port continuing from its state;
    the JAX run's next round, to compare with."""
    common = dict(seed=1, n_rounds=n_rounds, show_report=False, **kw)
    ja = J.PT(J.Inputs(target=jt, explorer=explorers[0], **common))
    ta = T.PT(T.Inputs(target=tt, explorer=explorers[1], device="cpu", **common))
    ja.run_round()
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": np.asarray(ja.schedule.grids)}, round_idx=1)
    ja.run_round()
    ta.run_round()
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
    assert ja.reports[-1].n_tempered_restarts == ta.reports[-1].n_tempered_restarts
    assert abs(ja.reports[-1].log_z_estimate - ta.reports[-1].log_z_estimate) < 1e-4
    sj, st = np.asarray(ja.states), ta.states.numpy()
    print(f"round 2: {int((sj != st).sum())} of {sj.size} state elements not bitwise equal")
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)
    for _ in range(n_rounds - 2):
        ta.run_round()
    return ta


def test_ising_matches_its_enumeration():
    """``tests/test_ising.py``'s thresholds: logZ within 0.2, mean |M|
    within 0.05, states exactly binary; round 2 the JAX package's."""
    jt, tt = J.ising_target(0.4, 3), T.ising_target(0.4, 3)
    lz, mag = tt.enumerate_oracle()
    pt = _run_from_jax(jt, tt, 8, n_chains=6, n_replicates=8)
    samples = pt.sample_array()[:, :-1]
    est_mag = np.abs((2.0 * samples - 1.0).mean(axis=1)).mean()
    print(f"logZ {pt.reports[-1].log_z_estimate:.4f} (exact {lz:.4f}), |M| {est_mag:.4f} "
          f"(exact {mag:.4f}), round trips {pt.n_round_trips}")
    assert abs(pt.reports[-1].log_z_estimate - lz) < 0.2
    assert abs(est_mag - mag) < 0.05
    assert set(np.unique(samples)) <= {0.0, 1.0}


def test_binary_mixture_law():
    """``tests/test_models.py``: with mu = 0 the posterior marginal of each
    b is p = 0.4, and x's mean is 0; round 2 the JAX package's. One slice
    pass a scan, 16 ladders, 6 rounds (the JAX test: 3 passes, one ladder, 9
    rounds)."""
    mask = [True, True, False, False]
    pt = _run_from_jax(JL.binary_mixture_target(mu=0.0), T.binary_mixture_target(mu=0.0), 6,
                       n_chains=4, n_replicates=16,
                       explorers=(JSliceSampler(binary_mask=mask, n_passes=1),
                                  T.SliceSampler(binary_mask=mask, n_passes=1)))
    sa = pt.sample_array()
    b = sa[:, :2]
    print(f"P(b = 1) {b.mean():.4f}, mean x {sa[:, 2].mean():.4f}")
    assert set(np.unique(b)) <= {0.0, 1.0}
    assert abs(b.mean() - 0.4) < 0.05
    assert abs(sa[:, 2].mean()) < 0.15


def test_poisson_count_law():
    """``tests/test_models.py``: pooled mean and variance of k within 0.6 and
    1.5 of 5, of x within 0.25 and 0.35 of 0 and 1; whole counts. One slice
    pass a scan, 64 ladders, 5 rounds (the JAX test: 3 passes, one ladder,
    9 rounds). Starts from the JAX run's state; the runs part at the first
    reference draw (the Poisson draw's law, not its stream)."""
    common = dict(seed=4, n_chains=2, n_replicates=64, show_report=False)
    ja = J.PT(J.Inputs(target=JL.poisson_count_target(5.0, 1), n_rounds=1, **common))
    ja.run_round()
    explorer = T.SliceSampler(integer_mask=[True, False], n_passes=1)
    ta = T.PT(T.Inputs(target=T.poisson_count_target(5.0, 1), n_rounds=5, explorer=explorer,
                       device="cpu", **common))
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": np.asarray(ja.schedule.grids)}, round_idx=1)
    ta.run()
    mean, var = ta.mean(), ta.var()
    print(f"mean {mean}, var {var}")
    assert abs(mean[0] - 5.0) < 0.6 and abs(var[0] - 5.0) < 1.5
    assert abs(mean[1]) < 0.25 and abs(var[1] - 1.0) < 0.35
    samples = ta.sample_array()[:, 0]
    assert np.array_equal(samples, np.round(samples))


# ---------------------------------------------------------------------------
# the kernels refuse masks


@pytest.mark.parametrize("name", ["poisson", "mixture"])
def test_cuda_sampler_refuses_masked_targets(name):
    tt = TARGETS[name](T)
    with pytest.raises(NotImplementedError, match=r"SliceSampler\(\)"):
        T.PT(T.Inputs(target=tt, explorer=T.SliceSamplerCUDA(), device="cpu", show_report=False))
    pt = T.PT(T.Inputs(target=tt, device="cpu", show_report=False))  # the default explorer
    assert type(pt.explorer) is T.SliceSampler
