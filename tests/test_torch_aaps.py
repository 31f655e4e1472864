"""The port's AAPS (``ops/aaps.py``) against the JAX package's, on the CPU.

* One step of 256 lanes from the same keys, states and std deviations, on
  the toy MVN (d = 3) and the logistic regression (d = 11, on the JAX
  model's data), against ``jax.vmap`` of the JAX ``step``. The JAX step is
  also run as a copy of its code that records, for each lane, the margin of
  every decision it takes (an apogee test's ``v . grad``, a segment's
  running Gumbel argmax, the merge of a segment's best state), each scaled
  by the size of what it compares; the copy is checked to be the JAX step
  bit for bit. A lane whose leapfrog count (its apogees and bails) or
  proposal differs from JAX's is a differing decision: at most 1 % of the
  lanes, each a near tie, within ``TIE`` = 1e-4 of its threshold (named).
  The other lanes agree within 1e-4 in state and 1e-5 relative in density
  (plus 1e-6).
* A JAX AAPS run's state and ``exp_state`` carried into the port: the next
  round in both packages.
* ``adapt`` against the JAX ``adapt``.

The moment test is ``tests/test_torch_aaps_laws.py``.
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

from test_torch_nuts import _lanes, _margin, _target

TIE = 1e-4
B = 256
KINDS = ("apogee", "segment argmax", "merge")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keep(best, m, kind):
    return jnp.where(m < best[0], m, best[0]), jnp.where(m < best[0], kind, best[1])


def _recorded_step(ex):
    """``AAPS.step`` of the JAX package (``pigeons_tpu/ops/aaps.py``), line for
    line, with the smallest scaled margin of the lane's decisions and its
    kind (an index into ``KINDS``)."""
    inf = jnp.asarray(jnp.inf, jnp.float32)

    def sign_margin(v, cg):
        return _margin(jnp.sum(v * cg), 0.0, jnp.sum(jnp.abs(v * cg)))

    def segment(key, lp_fn, precond, x, v, skip_first, best):
        eps = ex.step_size
        lp, cgrad = value_and_cond_grad(lp_fn, x, precond)
        w0 = jnp.where(skip_first, -jnp.inf,
                       log_joint(lp, v) + jax.random.gumbel(jax.random.fold_in(key, 0)))
        best = _keep(best, sign_margin(v, cgrad), 0)

        def cond(carry):
            return ~carry[8] & (carry[0] < ex.max_segment_steps)

        def body(carry):
            i, x, v, lp, cgrad, old_sign, wmax, xmax, done, ok, best = carry
            v_half = v + 0.5 * eps * cgrad
            x_n = x + eps * (v_half / precond)
            lp_n, cgrad_n = value_and_cond_grad(lp_fn, x_n, precond)
            v_n = v_half + 0.5 * eps * cgrad_n
            ok_n = ok & jnp.isfinite(log_joint(lp_n, v_n))
            new_sign = jnp.sign(jnp.sum(v_n * cgrad_n))
            apogee = (old_sign < 0) & (new_sign > 0)
            w = log_joint(lp_n, v_n) + jax.random.gumbel(jax.random.fold_in(key, i + 1))
            better = ok_n & ~apogee & (w > wmax)
            best = _keep(best, sign_margin(v_n, cgrad_n), 0)
            best = _keep(best, jnp.where(ok_n & ~apogee, _margin(
                w, wmax, 1.0 + jnp.abs(log_joint(lp_n, v_n))), inf), 1)
            return (i + 1, x_n, v_n, lp_n, cgrad_n, new_sign, jnp.where(better, w, wmax),
                    jnp.where(better, x_n, xmax), apogee | ~ok_n, ok_n, best)

        init_sign = jnp.sign(jnp.sum(v * cgrad))
        i, x_e, v_e, _, _, _, wmax, xmax, _, ok, best = lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), x, v, lp, cgrad, init_sign, w0, x,
                         jnp.asarray(False), jnp.asarray(True), best))
        ok = ok & (i < ex.max_segment_steps)
        return x_e, v_e, wmax, xmax, i.astype(jnp.float32), ok, best

    def step(key, x, lp_fn, chain_params):
        best = (inf, jnp.int32(-1))
        precond = ex.preconditioner.build(jax.random.fold_in(key, 1000003),
                                          chain_params["std_devs"])
        v0 = jax.random.normal(jax.random.fold_in(key, 1000004), x.shape, x.dtype)
        fx, fv, fw, fxmax, n1, ok1, best = segment(jax.random.fold_in(key, 0), lp_fn, precond,
                                                   x, v0, False, best)
        bx, bv, bw, bxmax, n2, ok2, best = segment(jax.random.fold_in(key, 1), lp_fn, precond,
                                                   x, -v0, True, best)
        scale = 1.0 + jnp.abs(lp_fn(x))
        best = _keep(best, _margin(fw, bw, scale), 2)
        wmax = jnp.maximum(fw, bw)
        pos = jnp.where(fw > bw, fxmax, bxmax)
        valid = ok1 & ok2
        n_steps = n1 + n2
        for k_idx in range(ex.K):
            kk = jax.random.fold_in(key, 2 + k_idx)
            go_fwd = jax.random.bernoulli(jax.random.fold_in(kk, 1000005))
            sx = jnp.where(go_fwd, fx, bx)
            sv = jnp.where(go_fwd, fv, bv)
            ex_, ev, w, xm, n, ok, best = segment(kk, lp_fn, precond, sx, sv, False, best)
            best = _keep(best, jnp.where(valid & ok, _margin(w, wmax, scale), inf), 2)
            better = valid & ok & (w > wmax)
            wmax = jnp.where(better, w, wmax)
            pos = jnp.where(better, xm, pos)
            fx = jnp.where(go_fwd & ok, ex_, fx)
            fv = jnp.where(go_fwd & ok, ev, fv)
            bx = jnp.where(~go_fwd & ok, ex_, bx)
            bv = jnp.where(~go_fwd & ok, ev, bv)
            valid = valid & ok
            n_steps = n_steps + n
        return dict(x=jnp.where(valid, pos, x), n=n_steps, valid=valid, margin=best[0],
                    kind=best[1])

    return step


@pytest.mark.parametrize("name,step", [("toy_mvn", 0.3), ("logistic_regression", 0.3)])
def test_one_step_matches_jax(name, step):
    jld, tpath, d = _target(name)
    x, beta, std, _ = _lanes(B, d, step)
    jk = jrng.keys_for(jax.random.key(8), jnp.arange(B))
    tk = trng.keys_for(trng.key(8), torch.arange(B))
    jex = J.AAPS(step_size=step)

    def plain(key, x, b, sd):
        f = lambda xx: jld(xx, b)  # noqa: E731
        return jex.step(key, x, f(x), f, b, {"std_devs": sd}, 2)

    def recorded(key, x, b, sd):
        return _recorded_step(jex)(key, x, lambda xx: jld(xx, b), {"std_devs": sd})

    jo = jax.jit(jax.vmap(plain))(jk, x, beta, std)
    rec = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(recorded))(jk, x, beta, std).items()}
    assert np.array_equal(rec["x"], np.asarray(jo.x))
    assert np.array_equal(rec["n"], np.asarray(jo.n_steps))
    to = T.AAPS(step_size=step).step_batched(tk, torch.tensor(x), torch.tensor(beta), tpath,
                                             chain_params={"std_devs": torch.tensor(std)},
                                             scan_idx=2)
    tx, jx = to.x.numpy(), np.asarray(jo.x)
    differ = (to.n_steps.numpy() != np.asarray(jo.n_steps)) | (np.abs(tx - jx).max(1) > 1e-4)
    for lane in np.flatnonzero(differ):
        kind = KINDS[int(rec["kind"][lane])]
        print(f"lane {lane}: differs, nearest decision a {kind} at {rec['margin'][lane]:.3g}")
        assert rec["margin"][lane] < TIE, f"lane {lane} differs and is no near tie"
    print(f"{name}: {int(differ.sum())} of {B} lanes differ from JAX's; "
          f"{np.asarray(jo.n_steps).mean():.2f} leapfrogs a lane, {int((~rec['valid']).sum())} "
          f"bailed; nearest decision {rec['margin'].min():.3g}")
    assert differ.sum() <= 0.01 * B
    same = ~differ
    np.testing.assert_allclose(tx[same], jx[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to.lp.numpy()[same], np.asarray(jo.lp)[same], rtol=1e-5,
                               atol=1e-6)
    assert not to.accept_sum.any() and not to.accept_n.any()


def test_adapt_is_jaxs():
    from pigeons_tpu.recorders import ReducedRecorders as JR
    from pigeons_tpu_torch.recorders import ReducedRecorders as TR

    var = np.array([0.3, 1.7, 0.02, -1e-9, 4.0])
    fields = {f: None for f in JR._fields}
    fields.update(online_var=var)
    for name in ("MixDiagonalPreconditioner", "IdentityPreconditioner"):
        jex = J.AAPS(preconditioner=getattr(J, name)())
        tex = T.AAPS(preconditioner=getattr(T, name)())
        js = jex.adapt(jex.init_state(3, 4), JR(**fields), 2)
        ts = tex.adapt(tex.init_state(3, 4), TR(**{k: fields[k] for k in TR._fields}), 2)
        assert np.array_equal(ts["std_devs"].numpy(), np.asarray(js["std_devs"])), name


def test_aaps_run_carried_over_from_jax():
    kw = dict(target=None, n_chains=4, n_replicates=4, seed=5, show_report=False)
    ja = J.PT(J.Inputs(**{**kw, "target": J.toy_mvn_target(3)}, explorer=J.AAPS(step_size=0.3)))
    for _ in range(3):
        ja.run_round()
    ta = T.PT(T.Inputs(**{**kw, "target": T.toy_mvn_target(3)}, explorer=T.AAPS(step_size=0.3),
                       device="cpu"))
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states),
                                  "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": ja.schedule.grids}, ja.round_idx)
    convert.explorer_state_from_numpy(ta, {k: np.asarray(v) for k, v in ja.exp_state.items()})
    ja.run_round(), ta.run_round()
    moved = np.abs(np.asarray(ja.states) - ta.states.numpy()).max(-1) > 1e-4
    print(f"round 4 carried over: {int(moved.sum())} of {moved.size} lanes end elsewhere")
    assert moved.sum() <= 0.01 * moved.size + 1
    np.testing.assert_allclose(ta.reduced.exp_steps, ja.reduced.exp_steps, rtol=0.01)
    np.testing.assert_allclose(ta.exp_state["std_devs"].numpy(),
                               np.asarray(ja.exp_state["std_devs"]), rtol=1e-3)

