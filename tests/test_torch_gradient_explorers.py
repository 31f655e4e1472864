"""The port's gradient path (``ops/hamiltonian.py``, ``ops/mala.py``,
``ops/automala.py``) against the JAX package's, on the CPU.

* ``rng.split`` and the three preconditioners: bitwise, from the same keys.
* ``leapfrog`` is involutive (``tests/test_gradient_explorers.py``), and
  ``leapfrog`` / ``leapfrog1_cached`` from the same state match the JAX ones
  within 2e-5 absolute in states and 1e-5 relative in densities (float32
  gradients in another order, over several steps).
* One refreshment of MALA and of AutoMALA from the same keys, state and
  chain params, for 512 lanes of the logistic regression (bench config 2's
  target, on the JAX model's data): the JAX refreshment is composed of the
  JAX package's own pieces (and checked to be its ``step`` with one
  refreshment), the port's of its own. Every decision that differs (forward
  exponent, reversibility exponent, MH accept) is counted: at most 1 % of
  them, and each a near tie, within ``TIE`` = 1e-4 of its threshold (a trial's
  log-joint difference against a bound, or ``h1 - h0`` against ``log u``).
  Where every decision agrees the states are within 2e-5.
* A whole MALA / AutoMALA explore (default refreshments) against JAX's
  vmapped ``step``: at most 1 % of the lanes end elsewhere (a lane with a
  differing decision); the others agree within 1e-4, with the same step-size
  factors, reversibility counts and evaluation counts.
* ``window`` and ``queued`` (with and without a tail queue) bitwise equal to
  the port's sequential search, one explore of the logistic regression and
  whole runs on the toy MVN (``tests/test_gradient_explorers.py:206-270``).
* A JAX AutoMALA run's state and ``exp_state`` carried into the port
  (``convert.state_from_numpy``, ``convert.explorer_state_from_numpy``): the
  next round in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu.ops import hamiltonian as JH
from pigeons_tpu_torch import convert, f32math, paths
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.ops import hamiltonian as TH

TIE = 1e-4
B = 512

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run thousands of small torch ops,
    which the thread pool slows when several test workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _keys(seed, n):
    return (jrng.keys_for(jax.random.key(seed), jnp.arange(n)),
            trng.keys_for(trng.key(seed), torch.arange(n)))


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _logistic_regression():
    """JAX ``ld(x, beta)`` and the port's path, on the JAX model's data."""
    jm = J.logistic_regression()
    fn = jm.log_likelihood_fn
    tm = convert.bayesian_model_from_numpy("logistic_regression", X=_closure(fn, "X"),
                                           y=_closure(fn, "y"))
    jp = jm.create_path(jm.default_reference())

    def jld(x, beta):
        lp = jp.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    return jld, tm.create_path(tm.default_reference()), tm.dim


def _lanes(n, d, seed=0):
    r = np.random.RandomState(seed)
    x = (r.normal(size=(n, d)) * 0.5).astype(np.float32)
    beta = r.uniform(size=n).astype(np.float32)
    std = np.abs(r.normal(size=(n, d)) * 0.3 + 0.5).astype(np.float32)
    step = (0.3 * np.exp(r.normal(size=n) * 0.5)).astype(np.float32)
    return x, beta, std, step


@pytest.mark.parametrize("n", [2, 3, 5])
def test_split_bitwise(n):
    jk, tk = _keys(4, 64)
    j = np.asarray(jax.vmap(lambda k: jax.random.key_data(jax.random.split(k, n)))(jk))
    assert np.array_equal(trng.split(tk, n).numpy(), j.astype(np.int64))


PRECONDITIONERS = {
    "identity": (JH.IdentityPreconditioner(), TH.IdentityPreconditioner()),
    "diagonal": (JH.DiagonalPreconditioner(), TH.DiagonalPreconditioner()),
    "mix": (JH.MixDiagonalPreconditioner(), TH.MixDiagonalPreconditioner()),
    "mix 0.1/0.6": (JH.MixDiagonalPreconditioner(0.1, 0.6), TH.MixDiagonalPreconditioner(0.1, 0.6)),
}


@pytest.mark.parametrize("name", sorted(PRECONDITIONERS))
def test_preconditioners_bitwise(name):
    jp, tp = PRECONDITIONERS[name]
    _, _, std, _ = _lanes(256, 7, seed=1)
    std[::9, 3] = 0.0
    jk, tk = _keys(5, 256)
    j = np.asarray(jax.vmap(jp.build)(jk, std))
    assert np.array_equal(tp.build(tk, torch.tensor(std)).numpy(), j)


def _torch_vg(fn):
    """``vg(x) -> (lp, grad)`` of a batched torch function."""
    def vg(x):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            lp = fn(xg)
            return lp.detach(), torch.autograd.grad(lp.sum(), xg)[0]

    return vg


def test_leapfrog_involutive():
    """Reversed, momentum-flipped leapfrog returns to the start
    (``tests/test_gradient_explorers.py:56-69``), for 64 lanes."""
    w = torch.arange(1.0, 5.0)
    vg = _torch_vg(lambda x: -0.5 * torch.sum(x * x * w, dim=-1))
    r = np.random.RandomState(0)
    x = torch.tensor(r.normal(size=(64, 4)).astype(np.float32))
    v = torch.tensor(r.normal(size=(64, 4)).astype(np.float32))
    precond = torch.full((64, 4), 1.3)
    x1, v1, _, ok = TH.leapfrog(vg, precond, x, v, 0.1, n_steps=5)
    x2, v2, _, _ = TH.leapfrog(vg, precond, x1, -v1, 0.1, n_steps=5)
    assert bool(ok.all())
    np.testing.assert_allclose(x2.numpy(), x.numpy(), atol=1e-4)
    np.testing.assert_allclose(v2.numpy(), -v.numpy(), atol=1e-4)


def test_leapfrog_matches_jax():
    jld, tpath, d = _logistic_regression()
    x, beta, std, step = _lanes(64, d, seed=2)
    r = np.random.RandomState(3)
    v = r.normal(size=(64, d)).astype(np.float32)
    precond = (1.0 / std).astype(np.float32)

    def jleap(x, v, beta, p, eps):
        lp_fn = lambda xx: jld(xx, beta)  # noqa: E731
        _, g = jax.value_and_grad(lp_fn)(x)
        return JH.leapfrog(lp_fn, p, x, v, eps, n_steps=5), \
            JH.leapfrog1_cached(lp_fn, p, x, v, eps, g / p)

    (jx, jv, jl, jok), (cx, cv, cl, cg, cok) = jax.jit(jax.vmap(jleap))(x, v, beta, precond, step)
    vg = TH.LaneGradient(tpath, torch.tensor(beta))
    xt, vt, pt_, st = (torch.tensor(a) for a in (x, v, precond, step))
    tx, tv, tl, tok = TH.leapfrog(vg, pt_, xt, vt, st, n_steps=5)
    _, g = vg(xt)
    ux, uv, ul, ug, uok = TH.leapfrog1_cached(vg, pt_, xt, vt, st, g / pt_)
    for have, want in ((tx, jx), (tv, jv), (ux, cx), (uv, cv), (ug, cg)):
        np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    for have, want in ((tl, jl), (ul, cl)):
        np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-5)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert np.array_equal(uok.numpy(), np.asarray(cok))


# ---------------------------------------------------------------------------
# one refreshment, decision by decision


def _jax_refresh(explorer, jld, auto):
    """One refreshment of the JAX explorer's ``step`` for one lane (``i =
    0``), composed of the JAX package's pieces, with what decides it."""
    n_split = 5 if auto else 3

    def refresh(key, x, beta, std, step):
        lp_fn = lambda xx: jld(xx, beta)  # noqa: E731
        lp, raw_grad = jax.value_and_grad(lp_fn)(x)
        ks = jax.random.split(jax.random.fold_in(key, 0), n_split)
        precond = explorer.preconditioner.build(ks[1], std)
        cgrad = raw_grad / precond
        v = jax.random.normal(ks[0], x.shape, x.dtype)
        h0 = JH.log_joint(lp, v)
        u_mh = jax.random.uniform(ks[-1])
        if not auto:
            cand = JH.leapfrog1_cached(lp_fn, precond, x, v, step, cgrad)
            h1 = JH.log_joint(cand[2], cand[1])
            pr = jnp.where(cand[4], jnp.minimum(1.0, jnp.exp(h1 - h0)), 0.0)
            return dict(x=jnp.where(u_mh < pr, cand[0], x), accept=u_mh < pr, h1_h0=h1 - h0,
                        log_u=jnp.log(u_mh))
        a, b = jax.random.uniform(ks[2]), jax.random.uniform(ks[3])
        lower, upper = jnp.log(jnp.minimum(a, b)), jnp.log(jnp.maximum(a, b))
        exp_f, _, cand = explorer._auto_step_size(lp_fn, precond, x, v, lp, cgrad, step, lower,
                                                  upper)
        exp_r, _, _ = explorer._auto_step_size(lp_fn, precond, cand[0], -cand[1], cand[2],
                                               cand[3], step, lower, upper)
        h1 = JH.log_joint(cand[2], cand[1])
        reversible = (exp_r == exp_f) & cand[4]
        pr = jnp.where(reversible, jnp.minimum(1.0, jnp.exp(h1 - h0)), 0.0)

        def diffs(xs, vs, lps, cgs):  # log-joint difference of the trial at each exponent
            h = JH.log_joint(lps, vs)
            out = []
            for e in range(-8, 9):
                c = JH.leapfrog1_cached(lp_fn, precond, xs, vs, step * 2.0**e, cgs)
                out.append(jnp.where(c[4], JH.log_joint(c[2], c[1]) - h, jnp.nan))
            return jnp.stack(out)

        return dict(x=jnp.where(u_mh < pr, cand[0], x), accept=u_mh < pr, h1_h0=h1 - h0,
                    log_u=jnp.log(u_mh), exp_f=exp_f, exp_r=exp_r, lower=lower, upper=upper,
                    diffs_f=diffs(x, v, lp, cgrad),
                    diffs_r=diffs(cand[0], -cand[1], cand[2], cand[3]))

    return jax.jit(jax.vmap(refresh))


def _port_refresh(explorer, vg, keys, x, std, step):
    """The same refreshment from the port's pieces."""
    lp, raw_grad = vg(x)
    ks = trng.split(trng.fold_in(keys, 0), 5 if isinstance(explorer, T.AutoMALA) else 3)
    precond = explorer.preconditioner.build(ks[:, 1], std)
    cgrad = raw_grad / precond
    v = trng.normal(ks[:, 0], (x.shape[1],))
    h0 = TH.log_joint(lp, v)
    u_mh = trng.uniform(ks[:, -1])
    if not isinstance(explorer, T.AutoMALA):
        cand = TH.leapfrog1_cached(vg, precond, x, v, step, cgrad)
        h1 = TH.log_joint(cand[2], cand[1])
        pr = torch.where(cand[4], torch.clamp_max(f32math.exp(h1 - h0), 1.0), 0.0)
        return dict(x=torch.where((u_mh < pr)[:, None], cand[0], x), accept=u_mh < pr)
    a, b = trng.uniform(ks[:, 2]), trng.uniform(ks[:, 3])
    lower, upper = f32math.log(torch.stack([torch.minimum(a, b), torch.maximum(a, b)]))
    exp_f, _, cand = explorer._search(vg, precond, x, v, lp, cgrad, step, lower, upper)
    exp_r, _, _ = explorer._search(vg, precond, cand[0], -cand[1], cand[2], cand[3], step,
                                   lower, upper)
    h1 = TH.log_joint(cand[2], cand[1])
    reversible = (exp_r == exp_f) & cand[4]
    pr = torch.where(reversible, torch.clamp_max(f32math.exp(h1 - h0), 1.0), 0.0)
    return dict(x=torch.where((u_mh < pr)[:, None], cand[0], x), accept=u_mh < pr, exp_f=exp_f,
                exp_r=exp_r)


def _near_tie(diffs, lower, upper, e1, e2):
    """Whether a trial between exponents ``e1`` and ``e2`` (one beyond each)
    lies within ``TIE`` of a bound: the two searches then read a comparison
    differently."""
    lo, hi = max(min(e1, e2) - 1, -8), min(max(e1, e2) + 1, 8)
    d = diffs[lo + 8: hi + 9]
    return bool(np.nanmin(np.minimum(np.abs(d - lower), np.abs(d - upper))) < TIE)


@pytest.mark.parametrize("name", ["MALA", "AutoMALA"])
def test_refresh_decisions_match_jax(name):
    auto = name == "AutoMALA"
    jex, tex = (J.AutoMALA(), T.AutoMALA()) if auto else (J.MALA(step_size=0.3),
                                                          T.MALA(step_size=0.3))
    jld, tpath, d = _logistic_regression()
    x, beta, std, step = _lanes(B, d)
    jk, tk = _keys(6, B)
    j = {k: np.asarray(v) for k, v in _jax_refresh(jex, jld, auto)(jk, x, beta, std, step).items()}
    vg = TH.LaneGradient(tpath, torch.tensor(beta))
    xt, st, stp = torch.tensor(x), torch.tensor(std), torch.tensor(step)
    t = {k: v.numpy() for k, v in _port_refresh(tex, vg, tk, xt, st, stp).items()}
    # each composition is its package's step with one refreshment, bit for bit
    one = type(tex)(step_size=0.3, base_n_refresh=1, exponent_n_refresh=0.0)
    out = one.step_batched(tk, xt, torch.tensor(beta), tpath, chain_params={
        "step_size": stp, "std_devs": st}, scan_idx=2)
    assert np.array_equal(out.x.numpy(), t["x"])
    jone = type(jex)(step_size=0.3, base_n_refresh=1, exponent_n_refresh=0.0)

    def jstep(key, x, beta, std, step):
        lp_fn = lambda xx: jld(xx, beta)  # noqa: E731
        return jone.step(key, x, lp_fn(x), lp_fn, beta, {"step_size": step, "std_devs": std},
                         2).x

    assert np.array_equal(np.asarray(jax.jit(jax.vmap(jstep))(jk, x, beta, std, step)), j["x"])
    names = ("exp_f", "exp_r", "accept") if auto else ("accept",)
    differ = np.zeros(B, bool)
    n_decisions = n_differ = 0
    for lane in range(B):
        for k in names:
            n_decisions += 1
            if t[k][lane] == j[k][lane]:
                continue
            n_differ += 1
            differ[lane] = True
            if k == "accept":
                tie = abs(j["h1_h0"][lane] - j["log_u"][lane]) < TIE
            else:
                tie = _near_tie(j["diffs_f" if k == "exp_f" else "diffs_r"][lane],
                                j["lower"][lane], j["upper"][lane], int(t[k][lane]),
                                int(j[k][lane]))
            assert tie, f"lane {lane}: {k} differs and is no near tie"
            break  # the later decisions follow from a different earlier one
    print(f"{name}: {n_differ} of {n_decisions} decisions differ from JAX's "
          f"({n_differ / n_decisions:.3%}), all near ties")
    assert n_differ <= 0.01 * n_decisions
    np.testing.assert_allclose(t["x"][~differ], j["x"][~differ], rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", ["MALA", "AutoMALA"])
@pytest.mark.parametrize("scan_idx", [1, 2])
def test_explore_matches_jax(name, scan_idx):
    """A whole explore (9 refreshments at d = 11) against the JAX package's
    vmapped ``step``."""
    jex, tex = (J.AutoMALA(), T.AutoMALA()) if name == "AutoMALA" else (
        J.MALA(step_size=0.3), T.MALA(step_size=0.3))
    jld, tpath, d = _logistic_regression()
    n = 256
    x, beta, std, step = _lanes(n, d, seed=7)
    jk, tk = _keys(8, n)

    def one(key, x, beta, std, step):
        lp_fn = lambda xx: jld(xx, beta)  # noqa: E731
        return jex.step(key, x, lp_fn(x), lp_fn, beta, {"step_size": step, "std_devs": std},
                        scan_idx)

    jo = jax.jit(jax.vmap(one))(jk, x, beta, std, step)
    to = tex.step_batched(tk, torch.tensor(x), torch.tensor(beta), tpath,
                          chain_params={"step_size": torch.tensor(step),
                                        "std_devs": torch.tensor(std)}, scan_idx=scan_idx)
    jx, tx = np.asarray(jo.x), to.x.numpy()
    same = np.abs(jx - tx).max(1) <= 1e-4
    same &= np.asarray(jo.n_steps) == to.n_steps.numpy()
    if name == "AutoMALA":
        same &= (np.asarray(jo.extras_sum) == to.extras_sum.numpy()).all(1)
        assert np.array_equal(np.asarray(jo.extras_n), to.extras_n.numpy())
    print(f"{name}, scan {scan_idx}: {int((~same).sum())} of {n} lanes end elsewhere")
    assert (~same).sum() <= 0.01 * n
    np.testing.assert_allclose(to.accept_sum.numpy()[same], np.asarray(jo.accept_sum)[same],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(to.lp.numpy()[same], np.asarray(jo.lp)[same], rtol=1e-5)
    assert np.array_equal(to.accept_n.numpy(), np.asarray(jo.accept_n))


# ---------------------------------------------------------------------------
# the search variants, bitwise against the sequential search

VARIANTS = [dict(window=3), dict(window=1), dict(queued=True, queue_width=8),
            dict(queued=True, queue_width=16, window=3),
            dict(queued=True, queue_width=32, queue_tail_width=4),
            dict(queued=True, queue_tail_width=-1, window=2)]


@pytest.fixture(scope="module")
def one_explore():
    """One refreshment of 64 lanes of the logistic regression, every fifth
    lane with a step 64 times too long, so that the searches run long: the
    sequential search's result and a function that runs a variant."""
    _, tpath, d = _logistic_regression()
    x, beta, std, step = _lanes(64, d, seed=9)
    step[::5] *= 64.0
    _, tk = _keys(10, 64)
    args = (tk, torch.tensor(x), torch.tensor(beta), tpath)
    cp = {"step_size": torch.tensor(step), "std_devs": torch.tensor(std)}

    def run(**kw):
        return T.AutoMALA(base_n_refresh=1, **kw).step_batched(*args, chain_params=cp,
                                                               scan_idx=2)

    return run(), run


@pytest.mark.parametrize("kw", VARIANTS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_search_variants_bitwise_one_explore(kw, one_explore):
    a, run = one_explore
    b = run(**kw)
    for f in ("x", "lp", "accept_sum", "accept_n", "extras_sum", "extras_n"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.n_steps, b.n_steps)  # the variants spend other evaluations


def _toy_run(**kw):
    return T.PT(T.Inputs(target=T.toy_mvn_target(8), n_chains=6, n_rounds=4, seed=3,
                         explorer=T.AutoMALA(**kw), show_report=False, device="cpu")).run()


def test_search_variants_bitwise_runs():
    """``tests/test_gradient_explorers.py:206-270``: whole runs agree bitwise."""
    a = _toy_run()
    for kw in (dict(queued=True, queue_width=4), dict(queued=True, queue_width=8, window=3)):
        b = _toy_run(**kw)
        assert torch.equal(a.states, b.states), kw
        assert np.array_equal(a.sample_array(), b.sample_array()), kw
        assert torch.equal(a.exp_state["step_size"], b.exp_state["step_size"]), kw
        assert a.reports[-1].log_z_estimate == b.reports[-1].log_z_estimate, kw


# ---------------------------------------------------------------------------
# a JAX run carried across


def test_automala_run_carried_over_from_jax():
    kw = dict(target=None, n_chains=4, n_replicates=4, seed=5, show_report=False)
    ja = J.PT(J.Inputs(**{**kw, "target": J.toy_mvn_target(3)}, explorer=J.AutoMALA()))
    for _ in range(3):
        ja.run_round()
    ta = T.PT(T.Inputs(**{**kw, "target": T.toy_mvn_target(3)}, explorer=T.AutoMALA(),
                       device="cpu"))
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states),
                                  "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": ja.schedule.grids}, ja.round_idx)
    convert.explorer_state_from_numpy(ta, {k: np.asarray(v) for k, v in ja.exp_state.items()})
    for k in ("step_size", "std_devs"):
        assert np.array_equal(ta.exp_state[k].numpy(), np.asarray(ja.exp_state[k]))
    ja.run_round(), ta.run_round()
    moved = np.abs(np.asarray(ja.states) - ta.states.numpy()).max(-1) > 1e-4
    print(f"round 4 carried over: {int(moved.sum())} of {moved.size} lanes end elsewhere; "
          f"step sizes {np.asarray(ja.exp_state['step_size'])[0]} (JAX) "
          f"{float(ta.exp_state['step_size'][0])} (port)")
    assert moved.sum() <= 0.01 * moved.size + 1
    np.testing.assert_allclose(ta.exp_state["step_size"].numpy(),
                               np.asarray(ja.exp_state["step_size"]), rtol=1e-3)
    np.testing.assert_allclose(ta.exp_state["std_devs"].numpy(),
                               np.asarray(ja.exp_state["std_devs"]), rtol=1e-3)
    with pytest.raises(ValueError, match="no adapted state"):
        convert.explorer_state_from_numpy(
            T.PT(T.Inputs(target=T.toy_mvn_target(3), device="cpu", show_report=False)), {})


def test_value_and_grad_is_the_explorers_density():
    """The explorers evaluate the runtime's density through
    ``paths.value_and_grad``."""
    _, tpath, d = _logistic_regression()
    x, beta, _, _ = _lanes(32, d)
    lp, g = TH.LaneGradient(tpath, torch.tensor(beta))(torch.tensor(x))
    assert torch.equal(lp, paths.lane_log_density(tpath, torch.tensor(x), torch.tensor(beta)))
    assert g.shape == (32, d)
