"""The port's combinators (``ops/combinators.py``) against the JAX package's,
on the CPU. Their laws (``tests/test_combinators.py``) are in
``tests/test_torch_combinator_laws.py``.

* One explore of ``Compose``, ``Mix`` and ``ScanMix`` (at scans 1 and 2)
  of 256 lanes of the toy MVN (d = 3), from the same keys, states, betas
  and chain params, against ``jax.vmap`` of the JAX ``step``: ``Mix``'s
  per-lane choices bit for bit (``randint`` of the first half of
  ``split(key)``), ``ScanMix``'s component ``scan_idx % K``; at most 1 % of
  the lanes end elsewhere (a lane whose gradient explorer takes another
  decision, as in ``tests/test_torch_gradient_explorers.py``), the others
  within 1e-4 in state, 1e-5 relative in density (plus 1e-6), with the
  same evaluations and statistic slots.
* ``Mix`` hands each component only its lanes: bit for bit what the full
  batch with selection gives.
* A ``Compose(SliceSampler(n_passes=1), AutoMALA())`` run checkpointed,
  stopped and resumed is the uninterrupted run bit for bit, its adapted
  state a tuple written as leaves and structure; a JAX ``Compose`` run's
  tuple state carried into the port.
* A combinator refuses a ``SliceSamplerCUDA`` component and names the
  torch ``SliceSampler`` with its ``w``, ``p``, ``n_passes``, ``max_iter``
  (what the JAX package runs for ``SliceSamplerPallas.step``), which takes
  any path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu import rng as jrng
from pigeons_tpu_torch import convert, tree
from pigeons_tpu_torch import rng as trng
from pigeons_tpu_torch.checkpoint import increment_n_rounds, latest_checkpoint_round, load_pt

B, D = 256, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(kind, *components):
    """The combinator ``kind`` of ``components`` (names and keywords) in
    both packages."""
    return tuple(getattr(P, kind)(*(getattr(P, c)(**kw) for c, kw in components))
                 for P in (J, T))


CASES = {
    "compose": (("Compose", ("SliceSampler", dict(n_passes=1)), ("MALA", dict(step_size=0.3))),
                2),
    "mix": (("Mix", ("MALA", dict(step_size=0.3)), ("AutoMALA", {})), 2),
    "mix_slice": (("Mix", ("SliceSampler", dict(n_passes=1)), ("AutoMALA", {})), 2),
    "scanmix_1": (("ScanMix", ("SliceSampler", dict(n_passes=1)), ("AutoMALA", {})), 1),
    "scanmix_2": (("ScanMix", ("SliceSampler", dict(n_passes=1)), ("AutoMALA", {})), 2),
}


def _inputs(explorer, seed=0):
    """States, betas, keys and per-lane chain params (a tuple of the
    components' dicts) in numpy."""
    r = np.random.RandomState(seed)
    x = (r.normal(size=(B, D)) * 0.5).astype(np.float32)
    beta = r.uniform(size=B).astype(np.float32)
    params = []
    for e in explorer.explorers:
        st = e.init_state(B, D)
        if st:
            st = {"step_size": (0.3 * np.exp(r.normal(size=B) * 0.5)).astype(np.float32),
                  "std_devs": np.abs(r.normal(size=(B, D)) * 0.3 + 0.5).astype(np.float32)}
        params.append(st)
    return x, beta, tuple(params)


def _path():
    jt, tt = J.toy_mvn_target(D), T.toy_mvn_target(D)
    return jt.path, tt.create_path(tt.default_reference())


@pytest.mark.parametrize("name", list(CASES))
def test_explore_matches_jax(name):
    spec, scan_idx = CASES[name]
    jex, tex = _both(*spec)
    x, beta, params = _inputs(tex)
    jpath, tpath = _path()
    jk = jrng.keys_for(jax.random.key(11), jnp.arange(B))
    tk = trng.keys_for(trng.key(11), torch.arange(B))

    def one(key, x, b, cp):
        f = lambda xx: jpath.log_density(xx, b)  # noqa: E731
        return jex.step(key, x, f(x), f, b, cp, scan_idx)

    jo = jax.jit(jax.vmap(one))(jk, x, beta, params)
    tparams = tree.tree_map(torch.tensor, params)
    to = tex.step_batched(tk, torch.tensor(x), torch.tensor(beta), tpath,
                          lp=tpath.log_density(torch.tensor(x), torch.tensor(beta)),
                          chain_params=tparams, scan_idx=scan_idx)
    if spec[0] == "Mix":
        jpick = jax.vmap(lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, 2))(jk)
        choice = tex.choices(tk)[0]
        assert np.array_equal(choice.numpy(), np.asarray(jpick))
        print(f"{name}: {int((choice == 0).sum())} lanes chose component 0")
    jx, tx = np.asarray(jo.x), to.x.numpy()
    same = (np.abs(jx - tx).max(1) <= 1e-4) & (np.asarray(jo.n_steps) == to.n_steps.numpy())
    if tex.extra_names:
        assert to.extras_sum.shape == (B, len(tex.extra_names))
        same &= (np.asarray(jo.extras_sum) == to.extras_sum.numpy()).all(1)
        assert np.array_equal(np.asarray(jo.extras_n), to.extras_n.numpy())
    print(f"{name}: {int((~same).sum())} of {B} lanes end elsewhere")
    assert (~same).sum() <= 0.01 * B
    np.testing.assert_allclose(to.lp.numpy()[same], np.asarray(jo.lp)[same], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(to.accept_sum.numpy()[same], np.asarray(jo.accept_sum)[same],
                               rtol=0, atol=1e-4)
    assert np.array_equal(to.accept_n.numpy(), np.asarray(jo.accept_n))


def test_extra_names_and_slots_are_jaxs():
    for spec, _ in CASES.values():
        jex, tex = _both(*spec)
        assert tex.extra_names == jex.extra_names
        assert tex._extra_slices == jex._extra_slices


def test_scanmix_component_is_the_scan_index_mod_k():
    """Component ``scan_idx % K``, with the lane's key: each scan is that
    component's own step."""
    tex = T.ScanMix(T.MALA(step_size=0.3), T.SliceSampler(n_passes=1), T.AutoMALA())
    x, beta, params = _inputs(tex)
    _, tpath = _path()
    tk = trng.keys_for(trng.key(12), torch.arange(B))
    args = (tk, torch.tensor(x), torch.tensor(beta), tpath)
    tparams = tree.tree_map(torch.tensor, params)
    for scan_idx in range(1, 7):
        i = scan_idx % 3
        out = tex.step_batched(*args, chain_params=tparams, scan_idx=scan_idx)
        own = tex.explorers[i].step_batched(*args, chain_params=tparams[i] or None,
                                            scan_idx=scan_idx)
        assert torch.equal(out.x, own.x) and torch.equal(out.n_steps, own.n_steps), scan_idx
        off, k = tex._extra_slices[i]
        others = torch.ones(len(tex.extra_names), dtype=torch.bool)
        others[off:off + k] = False
        assert not out.extras_n[:, others].any()
        if k:
            assert torch.equal(out.extras_sum[:, off:off + k], own.extras_sum)
    with pytest.raises(ValueError, match="scan_idx"):
        tex.step_batched(*args, chain_params=tparams)


def test_mix_hands_out_lanes_as_the_full_batch_with_selection():
    mix = T.Mix(T.SliceSampler(n_passes=1), T.AutoMALA(), T.MALA(step_size=0.2))
    x, beta, params = _inputs(mix, seed=3)
    _, tpath = _path()
    tk = trng.keys_for(trng.key(13), torch.arange(B))
    xt, bt = torch.tensor(x), torch.tensor(beta)
    lp = tpath.log_density(xt, bt)
    tparams = tree.tree_map(torch.tensor, params)
    out = mix.step_batched(tk, xt, bt, tpath, lp=lp, chain_params=tparams, scan_idx=2)
    choice, k_step = mix.choices(tk)
    assert all((choice == i).any() for i in range(3))
    want = {f: getattr(out, f).clone() for f in ("x", "lp", "accept_sum", "accept_n", "n_steps")}
    es = torch.zeros_like(out.extras_sum)
    en = torch.zeros_like(out.extras_n)
    for i, e in enumerate(mix.explorers):
        full = e.step_batched(k_step, xt, bt, tpath, lp=lp, chain_params=tparams[i] or None,
                              scan_idx=2)
        sel = choice == i
        for f in want:
            want[f][sel] = getattr(full, f)[sel]
        off, k = mix._extra_slices[i]
        if k:
            es[sel, off:off + k] = full.extras_sum[sel]
            en[sel, off:off + k] = full.extras_n[sel]
    for f, v in want.items():
        assert torch.equal(getattr(out, f), v), f
    assert torch.equal(out.extras_sum, es) and torch.equal(out.extras_n, en)


def test_compose_run_resumes_bit_for_bit(tmp_path):
    kw = dict(target=T.toy_mvn_target(2), n_chains=4, n_replicates=2, seed=3,
              explorer=T.Compose(T.SliceSampler(n_passes=1), T.AutoMALA()), show_report=False,
              device="cpu")
    full = T.PT(T.Inputs(n_rounds=3, **kw)).run()
    folder = str(tmp_path / "run")
    T.PT(T.Inputs(n_rounds=2, checkpoint=True, checkpoint_folder=folder, **kw)).run()
    arrays = np.load(f"{folder}/round=2/checkpoint/checkpoint.npz")
    assert {"exp_state_0", "exp_state_1"} <= set(arrays.files)
    increment_n_rounds(folder, 1)
    resumed = T.pigeons(folder)
    assert latest_checkpoint_round(folder) == 3
    assert torch.equal(full.states, resumed.states)
    assert torch.equal(full.chain_of, resumed.chain_of)
    assert np.array_equal(full.sample_array(), resumed.sample_array())
    assert full.reports[-1].log_z_estimate == resumed.reports[-1].log_z_estimate
    assert tree.structure(resumed.exp_state) == ((), {"step_size": None, "std_devs": None})
    for a, b in zip(tree.leaves(full.exp_state), tree.leaves(resumed.exp_state), strict=True):
        assert torch.equal(a, b)
    again = load_pt(folder, round_idx=2).run()
    assert torch.equal(full.states, again.states)


def test_compose_state_carried_over_from_jax():
    kw = dict(target=None, n_chains=4, seed=5, show_report=False)
    ja = J.PT(J.Inputs(**{**kw, "target": J.toy_mvn_target(2)},
                       explorer=J.Compose(J.SliceSampler(n_passes=1), J.AutoMALA())))
    for _ in range(2):
        ja.run_round()
    ta = T.PT(T.Inputs(**{**kw, "target": T.toy_mvn_target(2)},
                       explorer=T.Compose(T.SliceSampler(n_passes=1), T.AutoMALA()),
                       device="cpu"))
    convert.state_from_numpy(ta, {"states": np.asarray(ja.states),
                                  "chain_of": np.asarray(ja.chain_of),
                                  "replica_of": np.asarray(ja.replica_of),
                                  "schedule": ja.schedule.grids}, ja.round_idx)
    convert.explorer_state_from_numpy(ta, jax.tree.map(np.asarray, ja.exp_state))
    assert ta.exp_state[0] == ()
    for k in ("step_size", "std_devs"):
        assert np.array_equal(ta.exp_state[1][k].numpy(), np.asarray(ja.exp_state[1][k]))
    ja.run_round(), ta.run_round()
    moved = np.abs(np.asarray(ja.states) - ta.states.numpy()).max(-1) > 1e-4
    print(f"round 3 carried over: {int(moved.sum())} of {moved.size} lanes end elsewhere")
    assert moved.sum() <= 1
    np.testing.assert_allclose(ta.exp_state[1]["step_size"].numpy(),
                               np.asarray(ja.exp_state[1]["step_size"]), rtol=1e-3)


@pytest.mark.parametrize("kind", ["Compose", "Mix", "ScanMix"])
def test_cuda_slice_sampler_component_is_refused(kind):
    combinator = getattr(T, kind)
    kw = dict(w=4.0, p=7, n_passes=2, max_iter=64)
    with pytest.raises(ValueError, match=r"SliceSampler\(w=4.0, p=7, n_passes=2, max_iter=64\)"):
        combinator(T.SliceSamplerCUDA(**kw), T.MALA(step_size=0.3))
    # the sampler the message names takes a path without a device density,
    # which SliceSamplerCUDA refuses
    path = T.CustomPath(lambda x, beta: -0.5 * (1.0 + 9.0 * beta) * torch.sum(x * x, dim=-1))
    with pytest.raises(NotImplementedError):
        T.SliceSamplerCUDA().check_path(path)
    combinator(T.SliceSampler(**kw), T.MALA(step_size=0.3)).check_path(path)
