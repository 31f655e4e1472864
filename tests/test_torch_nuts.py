"""The port's NUTS (``ops/nuts.py``) against the JAX package's, on the CPU.

* One step of 256 lanes from the same keys, states, step sizes and std
  deviations, on the toy MVN (d = 3) and the logistic regression (d = 11, on
  the JAX model's data), against ``jax.vmap`` of the JAX ``step``. The JAX
  step is also run as a copy of its code that records, for each lane, the
  margin of every decision it takes (a leaf's divergence and multinomial
  pick, the subtree's and the trajectory's U-turn tests, the merge of a
  subtree), each scaled by the size of what it compares; the copy is
  checked to be the JAX step bit for bit. A lane whose depth, leaves or
  proposal differs from JAX's is a differing decision: at most 1 % of the
  lanes, each a near tie, within ``TIE`` = 1e-4 of its threshold (named).
  The other lanes agree within 1e-4 in state, 1e-5 relative in density
  (plus 1e-6), with the same depth and leaves.
* A JAX NUTS run's state and ``exp_state`` carried into the port
  (``convert``): the next round in both packages.
* ``adapt`` against the JAX ``adapt`` on the same recorder means.
* ``tests/test_gradient_explorers.py::test_nuts_moments_and_adaptation``
  with the JAX test's bounds, fewer rounds and more ladders; ``slow``, as
  the JAX test is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu.ops.hamiltonian import log_joint, value_and_cond_grad
from pigeons_tpu_torch import convert
from pigeons_tpu_torch import rng as trng

TIE = 1e-4
B = 256
KINDS = ("divergence", "multinomial pick", "subtree U-turn", "merge", "trajectory U-turn")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _closure(fn, name):
    return np.asarray(fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents)


def _target(name):
    """JAX ``ld(x, beta)`` and the port's path of the same target."""
    if name == "toy_mvn":
        jm, tm = J.toy_mvn_target(3), T.toy_mvn_target(3)
        jp = jm.path
    else:
        jm = J.logistic_regression()
        fn = jm.log_likelihood_fn
        tm = convert.bayesian_model_from_numpy("logistic_regression", X=_closure(fn, "X"),
                                               y=_closure(fn, "y"))
        jp = jm.create_path(jm.default_reference())

    def jld(x, beta):
        lp = jp.log_density(x, beta)
        return jnp.where(jnp.isnan(lp), -jnp.inf, lp)

    return jld, tm.create_path(tm.default_reference()), tm.dim


def _lanes(n, d, step, seed=0):
    r = np.random.RandomState(seed)
    x = (r.normal(size=(n, d)) * 0.5).astype(np.float32)
    beta = r.uniform(size=n).astype(np.float32)
    std = np.abs(r.normal(size=(n, d)) * 0.3 + 0.5).astype(np.float32)
    return x, beta, std, np.full(n, step, np.float32)


def _margin(a, b, scale):
    """|a - b| / scale, +inf where it is not finite."""
    m = jnp.abs(a - b) / scale
    return jnp.where(jnp.isfinite(m), m, jnp.inf)


def _recorded_step(ex):
    """``NUTS.step`` of the JAX package (``pigeons_tpu/ops/nuts.py``), line for
    line, with the smallest scaled margin of the lane's decisions and its
    kind (an index into ``KINDS``)."""
    D = ex.max_depth

    def step(key, x, lp_fn, chain_params):
        eps = chain_params["step_size"].astype(x.dtype)
        k_prec, k_mom, k_tree = jax.random.split(jax.random.fold_in(key, 0), 3)
        precond = ex.preconditioner.build(k_prec, chain_params["std_devs"])

        def dots(x_s, v_s, x_e, v_e):
            dx = x_e - x_s
            a, b = jnp.dot(dx, v_s / precond), jnp.dot(dx, v_e / precond)
            sa, sb = jnp.sum(jnp.abs(dx * v_s / precond)), jnp.sum(jnp.abs(dx * v_e / precond))
            return (a < 0.0) | (b < 0.0), jnp.minimum(_margin(a, 0.0, sa), _margin(b, 0.0, sb))

        def leaf_step(xc, vc, gc):
            v_half = vc + 0.5 * eps * gc
            x_n = xc + eps * (v_half / precond)
            lp_n, g_n = value_and_cond_grad(lp_fn, x_n, precond)
            v_n = v_half + 0.5 * eps * g_n
            return x_n, v_n, lp_n, g_n

        v0 = jax.random.normal(k_mom, x.shape, x.dtype)
        lp_init, g0 = value_and_cond_grad(lp_fn, x, precond)
        h0 = log_joint(lp_init, v0)
        fz = jnp.zeros((), jnp.float32)
        inf = jnp.asarray(jnp.inf, jnp.float32)

        def keep(best, m, kind):
            return jnp.where(m < best[0], m, best[0]), jnp.where(m < best[0], kind, best[1])

        def build_subtree(k_sub, x_end, v_end, g_end, lp_end, depth, best):
            d = x.shape[0]
            init = (x_end, v_end, lp_end, g_end, -jnp.inf, x_end, lp_end, jnp.asarray(False),
                    jnp.asarray(False), jnp.zeros((D, d), x.dtype), jnp.zeros((D, d), x.dtype),
                    fz, fz, best)

            def leaf(j, carry):
                (xc, vc, lpc, gc, lsw_sub, xp, lpp, turned, diverged, ckpt_x, ckpt_v, acc_sum,
                 n_leaps, best) = carry
                stop = turned | diverged
                x_n, v_n, lp_n, g_n = leaf_step(xc, vc, gc)
                w = log_joint(lp_n, v_n) - h0
                div_n = ~jnp.isfinite(w) | (w < -ex.divergence_threshold)
                w_safe = jnp.where(div_n, -jnp.inf, w)
                lsw_new = jnp.logaddexp(lsw_sub, w_safe)
                u = jax.random.uniform(jax.random.fold_in(k_sub, j))
                take = jnp.log(u) < (w_safe - lsw_new)
                scale = 1.0 + jnp.abs(lp_n) + jnp.abs(h0)
                b2 = keep(best, _margin(w, -ex.divergence_threshold, scale), 0)
                b2 = keep(b2, _margin(jnp.log(u), w_safe - lsw_new, scale), 1)
                i = j + 1
                turn_new = jnp.asarray(False)
                for m in range(1, D + 1):
                    period = 2**m
                    starts = (i % period) == 1
                    ends = (i % period) == 0
                    ckpt_x = ckpt_x.at[m - 1].set(jnp.where(starts, x_n, ckpt_x[m - 1]))
                    ckpt_v = ckpt_v.at[m - 1].set(jnp.where(starts, v_n, ckpt_v[m - 1]))
                    turn, mm = dots(ckpt_x[m - 1], ckpt_v[m - 1], x_n, v_n)
                    turn_new = turn_new | (ends & turn)
                    b2 = keep(b2, jnp.where(ends, mm, inf), 2)
                acc_leaf = jnp.exp(jnp.minimum(w_safe, 0.0))
                new = (x_n, v_n, lp_n, g_n, lsw_new, jnp.where(take, x_n, xp),
                       jnp.where(take, lp_n, lpp), turned | turn_new, diverged | div_n, ckpt_x,
                       ckpt_v, acc_sum + acc_leaf, n_leaps + 1.0, b2)
                return jax.tree.map(lambda a, b: jnp.where(stop, a, b), carry, new)

            out = lax.fori_loop(0, jnp.int32(1) << depth, leaf, init)
            (xc, vc, lpc, gc, lsw_sub, xp, lpp, turned, diverged, _, _, acc_sum, n_leaps,
             best) = out
            return (xc, vc, lpc, gc, lsw_sub, xp, lpp, turned | diverged, acc_sum, n_leaps,
                    best)

        init = (x, v0, g0, x, v0, g0, lp_init, lp_init, x, lp_init, fz, jnp.zeros((), jnp.int32),
                jnp.asarray(False), fz, fz, (inf, jnp.int32(-1)))

        def cond(st):
            return (~st[12]) & (st[11] < D)

        def body(st):
            (x_l, v_l, g_l, x_r, v_r, g_r, lp_l, lp_r, x_prop, lp_prop, lsw, depth, done,
             acc_sum, n_leaps, best) = st
            k_d = jax.random.fold_in(k_tree, depth)
            k_dir, k_take, k_sub = jax.random.split(k_d, 3)
            go_right = jax.random.bernoulli(k_dir)
            xe = jnp.where(go_right, x_r, x_l)
            ve = jnp.where(go_right, v_r, -v_l)
            ge = jnp.where(go_right, g_r, g_l)
            lpe = jnp.where(go_right, lp_r, lp_l)
            (xn, vn, lpn, gn, lsw_sub, xp_sub, lpp_sub, stopped_sub, acc_add, leaps_add,
             best) = build_subtree(k_sub, xe, ve, ge, lpe, depth, best)
            valid = ~stopped_sub
            take_pr = jnp.exp(jnp.minimum(lsw_sub - lsw, 0.0))
            u = jax.random.uniform(k_take)
            take = valid & (u < take_pr)
            best = keep(best, jnp.where(valid, _margin(jnp.log(u), lsw_sub - lsw,
                                                       1.0 + jnp.abs(lpn) + jnp.abs(h0)), inf), 3)
            x_prop = jnp.where(take, xp_sub, x_prop)
            lp_prop = jnp.where(take, lpp_sub, lp_prop)
            lsw = jnp.where(valid, jnp.logaddexp(lsw, lsw_sub), lsw)
            upd_r = valid & go_right
            upd_l = valid & ~go_right
            x_r = jnp.where(upd_r, xn, x_r)
            v_r = jnp.where(upd_r, vn, v_r)
            g_r = jnp.where(upd_r, gn, g_r)
            lp_r = jnp.where(upd_r, lpn, lp_r)
            x_l = jnp.where(upd_l, xn, x_l)
            v_l = jnp.where(upd_l, -vn, v_l)
            g_l = jnp.where(upd_l, gn, g_l)
            lp_l = jnp.where(upd_l, lpn, lp_l)
            turn_full, mm = dots(x_l, v_l, x_r, v_r)
            best = keep(best, jnp.where(valid, mm, inf), 4)
            done = ~valid | turn_full
            return (x_l, v_l, g_l, x_r, v_r, g_r, lp_l, lp_r, x_prop, lp_prop, lsw, depth + 1,
                    done, acc_sum + acc_add, n_leaps + leaps_add, best)

        st = lax.while_loop(cond, body, init)
        return dict(x=st[8], lp=st[9], depth=st[11], acc=st[13], n=st[14], margin=st[15][0],
                    kind=st[15][1])

    return step


def _jax_runs(ex, jld, x, beta, std, step, keys):
    cp = lambda sd, st: {"std_devs": sd, "step_size": st}  # noqa: E731

    def plain(key, x, b, sd, st):
        f = lambda xx: jld(xx, b)  # noqa: E731
        return ex.step(key, x, f(x), f, b, cp(sd, st), 2)

    def recorded(key, x, b, sd, st):
        return _recorded_step(ex)(key, x, lambda xx: jld(xx, b), cp(sd, st))

    args = (keys, x, beta, std, step)
    return jax.jit(jax.vmap(plain))(*args), {
        k: np.asarray(v) for k, v in jax.jit(jax.vmap(recorded))(*args).items()}


@pytest.mark.parametrize("name,step", [("toy_mvn", 0.5), ("logistic_regression", 0.1)])
def test_one_step_matches_jax(name, step):
    jld, tpath, d = _target(name)
    x, beta, std, steps = _lanes(B, d, step)
    jk = jrng.keys_for(jax.random.key(8), jnp.arange(B))
    tk = trng.keys_for(trng.key(8), torch.arange(B))
    jo, rec = _jax_runs(J.NUTS(step_size=step), jld, x, beta, std, steps, jk)
    # the recording copy is the JAX step, bit for bit
    assert np.array_equal(rec["x"], np.asarray(jo.x))
    assert np.array_equal(rec["n"], np.asarray(jo.accept_n))
    assert np.array_equal(rec["depth"].astype(np.float32), np.asarray(jo.extras_sum)[:, 1])
    to = T.NUTS(step_size=step).step_batched(
        tk, torch.tensor(x), torch.tensor(beta), tpath,
        chain_params={"std_devs": torch.tensor(std), "step_size": torch.tensor(steps)},
        scan_idx=2)
    tx, jx = to.x.numpy(), np.asarray(jo.x)
    ext, exj = to.extras_sum.numpy(), np.asarray(jo.extras_sum)
    differ = ((ext[:, 1] != exj[:, 1]) | (to.accept_n.numpy() != np.asarray(jo.accept_n))
              | (np.abs(tx - jx).max(1) > 1e-4))
    for lane in np.flatnonzero(differ):
        kind = KINDS[int(rec["kind"][lane])]
        print(f"lane {lane}: differs, nearest decision a {kind} at {rec['margin'][lane]:.3g}")
        assert rec["margin"][lane] < TIE, f"lane {lane} differs and is no near tie"
    print(f"{name}: {int(differ.sum())} of {B} lanes differ from JAX's; depth "
          f"{exj[:, 1].mean():.3f}, leaves {np.asarray(jo.accept_n).mean():.2f} a lane; "
          f"nearest decision {rec['margin'].min():.3g}")
    assert differ.sum() <= 0.01 * B
    same = ~differ
    np.testing.assert_allclose(tx[same], jx[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to.lp.numpy()[same], np.asarray(jo.lp)[same], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ext[same], exj[same], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to.accept_sum.numpy()[same], np.asarray(jo.accept_sum)[same],
                               rtol=1e-4)
    assert np.array_equal(to.n_steps.numpy(), np.asarray(jo.n_steps))
    assert np.array_equal(to.extras_n.numpy(), np.asarray(jo.extras_n))


def test_adapt_is_jaxs():
    """The step size's factor and the std deviations, from the same
    recorder means (one chain's acceptance not observed)."""
    from pigeons_tpu.recorders import ReducedRecorders as JR
    from pigeons_tpu_torch.recorders import ReducedRecorders as TR

    r = np.random.RandomState(3)
    n, d = 5, 4
    extra = np.stack([r.uniform(0.3, 1.0, n), r.uniform(1, 6, n)], 1)
    extra[2, 0] = np.nan
    var = np.concatenate([r.uniform(0.01, 2.0, d), [5.0]])
    for adapts in (J.MixDiagonalPreconditioner(), J.IdentityPreconditioner()):
        jex = J.NUTS(step_size=0.7, preconditioner=adapts)
        tex = T.NUTS(step_size=0.7, preconditioner=getattr(T, type(adapts).__name__)())
        fields = {f: None for f in JR._fields}
        fields.update(extra_mean=extra, extra_n=np.ones_like(extra), online_var=var)
        js = jex.adapt(jex.init_state(n, d), JR(**fields), 2)
        ts = tex.adapt(tex.init_state(n, d), TR(**{k: fields[k] for k in TR._fields}), 2)
        for k in ("step_size", "std_devs"):
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k])), k


def test_nuts_run_carried_over_from_jax():
    kw = dict(target=None, n_chains=4, n_replicates=4, seed=5, show_report=False)
    ja = J.PT(J.Inputs(**{**kw, "target": J.toy_mvn_target(3)}, explorer=J.NUTS(step_size=0.5)))
    for _ in range(3):
        ja.run_round()
    ta = T.PT(T.Inputs(**{**kw, "target": T.toy_mvn_target(3)}, explorer=T.NUTS(step_size=0.5),
                       device="cpu"))
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states),
                                  "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": ja.schedule.grids}, ja.round_idx)
    convert.explorer_state_from_numpy(ta, {k: np.asarray(v) for k, v in ja.exp_state.items()})
    ja.run_round(), ta.run_round()
    moved = np.abs(np.asarray(ja.states) - ta.states.numpy()).max(-1) > 1e-4
    print(f"round 4 carried over: {int(moved.sum())} of {moved.size} lanes end elsewhere; "
          f"step sizes {np.asarray(ja.exp_state['step_size'])} (JAX) "
          f"{ta.exp_state['step_size'].numpy()} (port)")
    assert moved.sum() <= 0.01 * moved.size + 1
    np.testing.assert_allclose(ta.reduced.extra_mean, ja.reduced.extra_mean, rtol=1e-4)
    for k in ("step_size", "std_devs"):
        np.testing.assert_allclose(ta.exp_state[k].numpy(), np.asarray(ja.exp_state[k]),
                                   rtol=1e-3)


@pytest.mark.slow
def test_nuts_moments_and_adaptation():
    """``tests/test_gradient_explorers.py:141-163``, 6 rounds of 8 ladders
    (the JAX test: 9 rounds of one), with its bounds."""
    pt = T.PT(T.Inputs(target=T.toy_mvn_target(10), n_chains=8, n_rounds=6, n_replicates=8,
                       seed=1, explorer=T.NUTS(step_size=0.5), show_report=False,
                       device="cpu")).run()
    assert np.abs(pt.mean()).max() < 0.08
    assert np.abs(pt.var() - 0.1).max() < 0.05
    assert abs(pt.reports[-1].log_z_estimate - pt.path.analytic_lognormalization()) < 0.5
    assert pt.n_round_trips > 5
    acc = pt.reduced.extra_mean[:, 0]
    assert 0.5 < np.nanmean(acc) <= 1.0
    depth = pt.reduced.extra_mean[:, 1]
    assert 1.0 <= np.nanmean(depth) < 8.0
