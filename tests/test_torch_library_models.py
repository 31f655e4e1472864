"""The last ``BayesianModel`` targets of the JAX library in the port --
``bernoulli_target()``, ``eight_schools(centered=True)``, ``mrna_target()``
-- and what they brought, against the JAX package on the CPU.

(a) ``f32math.expm1`` and ``f32math.pow10`` against ``jax.jit(jnp.expm1)``
    and ``jax.jit(lambda q: 10.0 ** q)`` on sweeps of float32 inputs (expm1:
    [-1, 1], [-0.01, 0.01], [-100, 100], down to -e^12, near 0 and the
    special values; ``10 ** q``: 4 million over [-5, 5], [-60, 60] and the
    special values): **bitwise** (XLA's own expm1; glibc's ``powf``, which
    XLA's CPU code calls). Their gradients within 1e-6 relative of
    ``jax.grad``.
(b) ``Beta.log_prob`` against ``jit(vmap(log_prob))``: bitwise where the
    folded ``log B(a, b)`` is XLA's (the Bernoulli model's ``Beta(1, 1)``,
    ``Beta(3, 9)``, ``Beta(0.5, 0.7)``, ``Beta(1, 1.5)``), else within 1e-5
    with the differing elements counted (the constant is 1 ulp off:
    ``distributions._folded_gammaln``). Its device block is the kernel's
    ``kBeta`` with those constants.
(c) The three models on the JAX models' own data
    (``convert.bayesian_model_from_numpy``): ``log_prior``,
    ``log_likelihood`` and ``log_density`` of ``jit(vmap(...))`` bitwise
    (mRNA's runtime pass in XLA's fused form: the residual of the first
    ``n - n mod 8`` observations one fused multiply-add, read off the
    compiled loop's machine code). ``constrain`` bitwise, ``unconstrain``,
    names and prior draws in both forms, initial (eager) and the reference
    chain's (compiled): bitwise for Bernoulli (``rng.beta``, JAX's stream)
    and mRNA, within 1e-5 for centred eight schools (the half-Cauchy's
    tangent); ``Uniform.sample`` bitwise;
    ``paths.value_and_grad`` against ``jax.value_and_grad``: values within
    1e-6 relative, gradients within 1e-5 of the lane's largest, as PR 7's
    file holds the others.
(d) **K2's twin against ``_sweep_kernel`` in the Pallas interpreter** for
    ``kBernoulli``, ``kEightSchoolsCentered`` and ``kMrna``, 24 lanes, 1 and
    3 passes: states, returned densities and stats bitwise (mRNA's 150 terms
    are summed by windows of 32 inside the kernel as in the runtime pass;
    mRNA also at states whose levels are subnormal).
(e) Three-round ``PT`` runs of each model in both packages from one state
    (``convert.state_from_numpy``), the reference chain's iid draws the
    port's own (centred eight schools: the JAX package's, its half-Cauchy
    draws differ in last bits): permutations, restarts, round trips and step
    counts exact, barrier and logZ within 1e-3, states within 1e-5; and a
    seeded ``bernoulli_target()`` run from its start, which is the JAX run:
    the same bits in every round.
The kernel itself is compiled for the host in
``tests/test_torch_csrc_host_bayesian.py`` and runs on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import SliceSamplerPallas
from pigeons_tpu import rng as jrng
from pigeons_tpu.models import distributions as JD
from pigeons_tpu.models.library import _load_mrna_data
from pigeons_tpu_torch import convert, f32math, paths
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.models import distributions as TD
from pigeons_tpu_torch.models import library as TL
from pigeons_tpu_torch.ops import SliceSamplerCUDA, cuda_slice

N = 512


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: thousands of small torch ops, which the thread
    pool slows when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _n_differ(have, want):
    have, want = np.asarray(have), np.asarray(want)
    same_nan = np.isnan(have) & np.isnan(want)
    return int(((have.view(np.int32) != want.view(np.int32)) & ~same_nan).sum())


# ---------------------------------------------------------------------------
# (a) expm1 and 10 ** q


def test_expm1_is_xlas_bit_for_bit():
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.uniform(-1, 1, 400_000), rs.uniform(-0.01, 0.01, 200_000),
                        rs.uniform(-100, 100, 200_000), -np.exp(rs.uniform(0, 12, 200_000)),
                        rs.uniform(-1e-6, 1e-6, 50_000),
                        [0.0, -0.0, 0.5, -0.5, np.inf, -np.inf, np.nan, 88.7, 89.0, 100.0]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.expm1)(x))
    assert _n_differ(f32math.expm1(torch.from_numpy(x)).numpy(), want) == 0


def test_pow10_is_glibc_powf_bit_for_bit():
    """The mRNA model's ``10 ** q`` for q in its priors' [-5, 5], and far
    out (overflow to inf, subnormal results flushed to 0)."""
    rs = np.random.RandomState(1)
    q = np.concatenate([rs.uniform(-5, 5, 4_000_000), rs.uniform(-60, 60, 500_000),
                        [np.inf, -np.inf, np.nan, 0.0, -0.0, 38.5, 38.6, -45.0, -38.0]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: 10.0 ** v)(q))
    assert _n_differ(f32math.pow10(torch.from_numpy(q)).numpy(), want) == 0


@pytest.mark.parametrize("name", ["expm1", "pow10"])
def test_expm1_and_pow10_gradients(name):
    fn, jfn = {"expm1": (f32math.expm1, jnp.expm1),
               "pow10": (f32math.pow10, lambda v: 10.0 ** v)}[name]
    x = np.random.RandomState(2).uniform(-4, 4, 512).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    assert torch.equal(y.detach(), fn(torch.tensor(x)))
    (g,) = torch.autograd.grad(y.sum(), xt)
    want = np.asarray(jax.jit(jax.vmap(jax.grad(jfn)))(x))
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# (b) Beta


@pytest.mark.parametrize("shape", [(), (5,)])
@pytest.mark.parametrize("a,b,bitwise", [(1.0, 1.0, True), (3.0, 9.0, True), (0.5, 0.7, True),
                                         (1.0, 1.5, True), (2.0, 3.5, False)])
def test_beta_log_prob_matches_jax(a, b, bitwise, shape):
    x = (1.0 / (1.0 + np.exp(-np.random.RandomState(3).normal(size=(N,) + shape) * 2.0))
         ).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(JD.Beta(a, b, shape=shape).log_prob))(x))
    td = TD.Beta(a, b, shape=shape)
    have = td.log_prob(torch.from_numpy(x)).numpy()
    n_diff = _n_differ(have, want)
    print(f"Beta({a}, {b}){shape}: {n_diff} of {N} not bitwise equal")
    if bitwise:
        assert n_diff == 0
    np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-5)
    kind, params = td.device_block
    assert kind == TD.BETA and params == (np.float32(a - 1), np.float32(b - 1), td.log_norm)


def test_beta_one_one_constant_is_xlas_fold():
    """``log B(1, 1)`` folds to 2^-21 in XLA (its Lanczos sum at 1 and 2),
    not 0: read off ``jit(Beta(1, 1).log_prob)`` where both products are 0."""
    want = float(jax.jit(JD.Beta(1.0, 1.0).log_prob)(jnp.float32(0.5)))
    assert TD.Beta(1.0, 1.0).log_norm == want == -2.0 ** -21


# ---------------------------------------------------------------------------
# (c) the models


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _models(name):
    """The JAX model and the port's on the JAX model's own data."""
    if name == "bernoulli_target":
        jm = J.bernoulli_target()
        return jm, convert.bayesian_model_from_numpy(name, data=[0, 1, 0, 0, 0, 0, 0, 0, 0, 1])
    if name == "eight_schools_centered":
        jm = J.eight_schools(centered=True)
        fn = jm.log_likelihood_fn
        return jm, convert.bayesian_model_from_numpy("eight_schools", centered=True,
                                                     y=_closure(fn, "y"), sigma=_closure(fn, "sigma"))
    ts, ys = _load_mrna_data()
    return J.mrna_target(), convert.bayesian_model_from_numpy("mrna_target", ts=ts, ys=ys)


MODELS = ["bernoulli_target", "eight_schools_centered", "mrna_target"]


def _u(shape, seed, scale=1.5):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(np.float32)


def test_models_are_the_library_defaults():
    """The converter's models are the port's own defaults: the same data,
    read from the port's copy of the mRNA file."""
    for name in MODELS:
        _, converted = _models(name)
        default = {"bernoulli_target": T.bernoulli_target,
                   "eight_schools_centered": lambda: T.eight_schools(centered=True),
                   "mrna_target": T.mrna_target}[name]()
        x = torch.from_numpy(_u((64, converted.dim), 9))
        assert torch.equal(converted.log_density(x), default.log_density(x))
    ts, ys = TL.load_mrna_data()
    want_ts, want_ys = _load_mrna_data()
    assert ts.shape == (150,) and np.array_equal(ts.numpy(), want_ts.astype(np.float32))
    assert np.array_equal(ys.numpy(), want_ys.astype(np.float32))


@pytest.mark.parametrize("name", MODELS)
def test_model_densities_match_jax(name):
    jm, tm = _models(name)
    assert tm.dim == jm.dim and tm.sample_names() == jm.sample_names()
    x = _u((N, jm.dim), 1)
    tx = torch.from_numpy(x)
    for fn in ("log_prior", "log_likelihood", "log_density"):
        want = np.asarray(jax.jit(jax.vmap(getattr(jm, fn)))(x))
        have = getattr(tm, fn)(tx).numpy()
        n_diff = _n_differ(have, want)
        print(f"{name} {fn}: {n_diff} of {N} not bitwise equal")
        assert n_diff == 0
    lp, post = tm.prior_and_posterior(tx)
    assert torch.equal(lp, tm.log_prior(tx)) and torch.equal(post, tm.log_density(tx))


@pytest.mark.parametrize("name", MODELS)
def test_constrain_matches_jax(name):
    jm, tm = _models(name)
    x = _u((N, jm.dim), 2)
    jq, jlj = jax.jit(jax.vmap(jm.constrain))(x)
    tq, tlj = tm.constrain(torch.from_numpy(x))
    for key, want in jq.items():
        assert _n_differ(tq[key].numpy(), want) == 0, key
    assert _n_differ(tlj.numpy(), jlj) == 0
    back = tm.unconstrain({k: tq[k] for k in jq})
    np.testing.assert_allclose(back.numpy(), np.asarray(jax.jit(jax.vmap(jm.unconstrain))(jq)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_prior_draws_match_jax(name):
    """One child key per prior, mapped to unconstrained space, both forms:
    the initial states (eager) and the reference chain's draws (compiled).
    Bitwise for the Bernoulli model (``Beta(1, 1)`` by ``rng.beta``, JAX's
    stream) and mRNA (uniforms); within 1e-5 for centred eight schools (the
    half-Cauchy's tangent)."""
    jm, tm = _models(name)
    jk = jrng.keys_for(jax.random.key(2), jnp.arange(2048))
    tk = trng.keys_for(trng.key(2), torch.arange(2048))
    pairs = ((np.asarray(jax.vmap(jm.initialization)(jk)), tm.initialization(tk)),
             (np.asarray(jax.jit(jax.vmap(jm.default_reference().sample_iid))(jk)),
              tm.default_reference().sample_iid(tk)))
    for form, (want, have) in zip(("initial", "reference"), pairs):
        n_diff = _n_differ(have.numpy(), want)
        print(f"{name}, {form} draws: {n_diff} of {want.size} coordinates not bitwise equal")
        if name == "eight_schools_centered":
            np.testing.assert_allclose(have.numpy(), want, rtol=1e-5, atol=1e-5)
        else:
            assert n_diff == 0


def test_uniform_sample_is_jaxs():
    """``jax.random.uniform(key, (), lo, hi)``: the affine map one fused
    multiply-add (mRNA's priors)."""
    jk = jrng.keys_for(jax.random.key(2), jnp.arange(4096))
    tk = trng.keys_for(trng.key(2), torch.arange(4096))
    for lo, hi in ((-5.0, 5.0), (-2.0, 1.0), (-2.0, 2.0)):
        want = np.asarray(jax.vmap(JD.Uniform(lo, hi).sample)(jk))
        assert _n_differ(TD.Uniform(lo, hi).sample(tk).numpy(), want) == 0


@pytest.mark.parametrize("name", MODELS)
def test_value_and_grad_matches_jax(name):
    jm, tm = _models(name)
    jp, tp = jm.create_path(jm.default_reference()), tm.create_path(tm.default_reference())

    def jld(x, beta):
        lp = jp.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    x = _u((256, jm.dim), 11, 1.0)
    beta = np.random.RandomState(12).uniform(size=256).astype(np.float32)
    beta[8:16], beta[16:24] = 0.0, 1.0
    jl, jg = (np.asarray(a) for a in jax.jit(jax.vmap(jax.value_and_grad(jld)))(x, beta))
    xt, bt = torch.tensor(x), torch.tensor(beta)
    tl, tg = (a.numpy() for a in paths.value_and_grad(tp, xt, bt))
    assert np.array_equal(tl, paths.lane_log_density(tp, xt, bt).numpy())
    fin = np.isfinite(jl) & np.isfinite(jg).all(1)
    assert np.array_equal(fin, np.isfinite(tl) & np.isfinite(tg).all(1))
    lane_scale = np.maximum(np.abs(jg).max(1), np.finfo(np.float32).tiny)[fin]
    gerr = (np.abs(tg - jg).max(1)[fin] / lane_scale).max()
    lerr = (np.abs(tl - jl) / np.maximum(np.abs(jl), 1e-30))[fin].max()
    print(f"{name}: {int(fin.sum())} finite lanes; values max rel {lerr:.3g}, gradients "
          f"max err / lane max|g| {gerr:.3g}")
    assert lerr <= 1e-6 and gerr <= 1e-5


@pytest.mark.parametrize("name", MODELS)
def test_path_describes_itself_to_the_kernel(name):
    _, tm = _models(name)
    path = tm.create_path(tm.default_reference())
    density = path.device_density()
    kinds = {"bernoulli_target": paths.BERNOULLI,
             "eight_schools_centered": paths.EIGHT_SCHOOLS_CENTERED, "mrna_target": paths.MRNA}
    assert density is not None and density.kind == kinds[name]
    assert sum(row[1] for row in density.prior) == tm.dim
    assert all(a.dtype == torch.float32 and a.dim() == 1 for a in density.arrays)
    SliceSamplerCUDA().check_path(path)
    # N(0, 3^2 I): the same kind with the reference's 1 / sigma in params[0]
    normal = tm.create_path(T.StandardNormalReference(tm.dim, 3.0).as_reference())
    assert normal.device_density().params == (np.float32(1.0) / np.float32(3.0),
                                              *density.params[1:])
    # any other reference: no device density
    other = T.models.Reference(log_density=lambda x: -(x**4).sum(-1))
    assert tm.create_path(other).device_density() is None


# ---------------------------------------------------------------------------
# (d) K2's twin against the Pallas kernel


def _jax_sweep(jpath, xs, betas, key_seed, n_passes):
    def ld(x, beta, isvar, rp):
        lp = jpath.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    B = len(xs)
    keys = jrng.keys_for(jax.random.key(key_seed), jnp.arange(B))
    out = SliceSamplerPallas(interpret=True, n_passes=n_passes).step_batched(
        keys, jnp.asarray(xs), jnp.zeros(B), ld, jnp.asarray(betas), jnp.zeros(B), (), (), 1,
        ld_coord=None)
    return {k: np.asarray(getattr(out, k)) for k in ("x", "lp", "accept_sum", "accept_n", "n_steps")}


def _fast_decay_states(B, rs):
    """mRNA states where beta is about 5 and delta about 20, so that the
    level ``km0 (e^{-beta (t - t0)} - e^{-delta (t - t0)}) / (delta - beta)``
    of the observations near t - t0 = 18 is subnormal (XLA's code flushes
    it to 0, the port keeps it: neither moves the term)."""
    xs = rs.normal(size=(B, 5)).astype(np.float32) * 0.05
    xs[:, 0] -= 2.0  # t0 = 10^(-2 + 3 sigmoid(u)): about 0.02
    xs[:, 2] += 0.28  # lbeta = -5 + 10 sigmoid(u): about 0.7
    xs[:, 3] += 0.53  # ldelta about 1.3
    return xs


# The lane at which the 16-ladder mRNA run (32 chains, seed 1, rounds of 2,
# 4, ... scans) first left the JAX package's run before the kernel's terms
# fused their residuals as XLA does (tools/torch_mrna_divergence.py): round
# 3, scan 6, ladder 8, chain 30; its state, beta and key. The JAX kernel
# takes its lsigma to 0.38328347, the unfused terms to 0.37713006.
PARTING_LANE = {"x": (0.9055174589157104, 0.4279673397541046, -0.31143495440483093,
                      -1.1911488771438599, 0.44949644804000854),
                "beta": 0.9935380220413208, "key": (1467162574, 920604853)}


def _posterior_states(B, rs):
    """mRNA states about the parting lane's, inside the posterior's bulk:
    there the level km0 (e^{-beta (t - t0)} - e^{-delta (t - t0)}) / (delta -
    beta) is of the observations' size, and whether its product with km0 is
    rounded before the subtraction shows in a term's last bits."""
    return (np.asarray(PARTING_LANE["x"], np.float32)
            + rs.normal(size=(B, 5)).astype(np.float32) * 0.01).astype(np.float32)


@pytest.mark.parametrize("n_passes", [1, 3])
@pytest.mark.parametrize("name", MODELS + ["mrna_fast_decay", "mrna_posterior"])
def test_twin_matches_pallas_kernel(name, n_passes):
    """Bitwise: states, returned densities, accept_sum, accept_n, n_evals."""
    fast_decay, posterior = name == "mrna_fast_decay", name == "mrna_posterior"
    jm, tm = _models("mrna_target" if fast_decay or posterior else name)
    B = 24
    rs = np.random.RandomState(n_passes)
    xs = (_fast_decay_states(B, rs) if fast_decay else _posterior_states(B, rs) if posterior
          else rs.normal(size=(B, jm.dim)).astype(np.float32))
    betas = rs.uniform(0.0, 1.0, B).astype(np.float32)
    betas[[0, 1, -2, -1]] = 0.0, 1.0, 0.0, 1.0
    ref = _jax_sweep(jm.create_path(jm.default_reference()), xs, betas, 7, n_passes)
    tpath = tm.create_path(tm.default_reference())
    before = dict(SliceSamplerCUDA.launches)
    out = SliceSamplerCUDA(n_passes=n_passes).step_batched(
        trng.keys_for(trng.key(7), torch.arange(B)), torch.from_numpy(xs), torch.from_numpy(betas),
        tpath)
    assert SliceSamplerCUDA.launches == before  # CPU tensors: the twin
    got = {"x": out.x, "lp": out.lp, "accept_sum": out.accept_sum, "accept_n": out.accept_n,
           "n_steps": out.n_steps}
    for key, want in ref.items():
        assert _n_differ(got[key].numpy(), want) == 0, key
    assert not np.array_equal(out.x.numpy(), xs)
    assert torch.equal(out.lp, cuda_slice.sweep_density(tpath)(out.x, torch.from_numpy(betas)))


def test_mrna_kernel_terms_fuse_as_xla_does():
    """ROADMAP §3 item 4: the one lane, one pass at which the runs parted.
    The JAX kernel's queries fuse the residual of the first n - n mod 8
    observations, as the runtime's pass does; with the terms rounded first
    the twin (and kernel K2) took lsigma elsewhere."""
    jm, tm = _models("mrna_target")
    xs = np.asarray([PARTING_LANE["x"]], np.float32)
    betas = np.asarray([PARTING_LANE["beta"]], np.float32)
    key = np.asarray([PARTING_LANE["key"]], np.uint32)
    ld = lambda x, beta, isvar, rp: (lambda lp: jnp.where(jnp.isnan(lp), -jnp.inf, lp))(
        jm.create_path(jm.default_reference()).log_density(x, beta))
    want = SliceSamplerPallas(interpret=True, n_passes=1).step_batched(
        jnp.asarray(key), jnp.asarray(xs), jnp.zeros(1), ld, jnp.asarray(betas), jnp.zeros(1), (),
        (), 6, ld_coord=None)
    got = SliceSamplerCUDA(n_passes=1).step_batched(
        torch.from_numpy(key.astype(np.int64)), torch.from_numpy(xs), torch.from_numpy(betas),
        tm.create_path(tm.default_reference()))
    assert _n_differ(got.x.numpy(), np.asarray(want.x)) == 0
    assert got.x[0, 4].item() == np.float32(0.38328346610069275)
    assert _n_differ(got.n_steps.numpy(), np.asarray(want.n_steps)) == 0


# ---------------------------------------------------------------------------
# (e) runs


def _prior_with_jax_draws(jm, tm):
    """The port model's own prior (so that the kernel path stays), with its
    iid draws taken from the JAX model for the same keys: the half-Cauchy
    differs in last bits (tested above), so that with the port's own draws
    the reference chain's regenerations could part the two runs."""
    draw = jax.jit(jax.vmap(jm.default_reference().sample_iid))

    def sample_iid(keys):
        data = keys.reshape(-1, 2).numpy().astype(np.uint32)
        out = np.asarray(draw(jax.random.wrap_key_data(data)))
        return torch.from_numpy(out.copy()).reshape(keys.shape[:-1] + (tm.dim,))

    return T.models.Reference(log_density=tm.log_prior, sample_iid=sample_iid, prior_of=tm)


@pytest.mark.parametrize("name", MODELS)
def test_three_round_run_matches_jax(name):
    """From the JAX run's state after round 1, the reference chain's iid
    draws the port's own (``rng.beta`` is JAX's stream, mRNA's uniforms
    bitwise); centred eight schools' half-Cauchy draws differ in last bits
    (above), so there they are the JAX package's (:func:`_prior_with_jax_draws`)."""
    jm, tm = _models(name)
    kw = dict(seed=3, n_rounds=3, show_report=False, n_chains=4, n_replicates=2)
    ja = J.PT(J.Inputs(target=jm, explorer=SliceSamplerPallas(interpret=True, n_passes=1), **kw))
    reference = (_prior_with_jax_draws(jm, tm) if name == "eight_schools_centered"
                 else tm.default_reference())
    ta = T.PT(T.Inputs(target=tm, reference=reference,
                       explorer=SliceSamplerCUDA(n_passes=1), device="cpu", **kw))
    assert ta.path.device_density() is not None  # the kernel path
    ja.run_round()
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states), "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": np.asarray(ja.schedule.grids)}, round_idx=1)
    for _ in range(2):
        ja.run_round()
        ta.run_round()
        rj, rt = ja.reports[-1], ta.reports[-1]
        assert rj.n_tempered_restarts == rt.n_tempered_restarts
        assert rj.n_round_trips == rt.n_round_trips
        assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
        assert np.array_equal(np.asarray(ja.replica_of), ta.replica_of.numpy())
        assert np.array_equal(ja.reduced.exp_steps, ta.reduced.exp_steps)
        np.testing.assert_allclose(ta.schedule.grids, ja.schedule.grids, atol=1e-6)
        assert abs(rj.global_barrier - rt.global_barrier) < 1e-3
        assert abs(rj.log_z_estimate - rt.log_z_estimate) < 1e-3 * max(1.0, abs(rj.log_z_estimate))
    sj, st = np.asarray(ja.states), ta.states.numpy()
    print(f"{name}: {int((sj != st).sum())} of {sj.size} state elements not bitwise equal")
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)
    jq, tq = jm.constrained_samples(ja), tm.constrained_samples(ta)
    for key in jq:
        np.testing.assert_allclose(tq[key], jq[key], rtol=1e-4, atol=1e-4)


def test_seeded_bernoulli_run_is_the_jax_run():
    """``pigeons(target=bernoulli_target(), seed=3)`` in both packages, from
    their own initial states and reference draws (``rng.beta``): every
    round's restarts, logZ and barrier, and the states and permutations at
    the end, the same bits."""
    kw = dict(seed=3, n_rounds=3, show_report=False, n_chains=4, n_replicates=2)
    ja = J.pigeons(target=J.bernoulli_target(),
                   explorer=SliceSamplerPallas(interpret=True, n_passes=1), **kw)
    ta = T.pigeons(target=T.bernoulli_target(), explorer=SliceSamplerCUDA(n_passes=1),
                   device="cpu", **kw)
    assert len(ja.reports) == len(ta.reports) == 3
    for rj, rt in zip(ja.reports, ta.reports):
        assert rj.n_tempered_restarts == rt.n_tempered_restarts
        assert rj.log_z_estimate == rt.log_z_estimate
        assert rj.global_barrier == rt.global_barrier
    assert sum(r.n_tempered_restarts for r in ta.reports) > 0
    assert np.array_equal(np.asarray(ja.states), ta.states.numpy())
    assert np.array_equal(np.asarray(ja.chain_of), ta.chain_of.numpy())
