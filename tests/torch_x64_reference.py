"""The JAX package's float64 runs, for the port's float64 tests.

JAX's x64 mode is process-global, so ``tests/test_torch_dtype.py`` runs this
script once in a subprocess (``JAX_ENABLE_X64=1``) and reads back numpy
arrays: ``python tests/torch_x64_reference.py OUT.npz``. It runs, on the CPU:

* ``funnel_lp``: funnel(2)'s density at ``y = -100`` in float64 (finite);
* ``deep_*``: funnel(2), 4 chains, 5 rounds, ``SliceSampler(n_passes=1)``,
  seed 1, float64, ``tests/test_dtype.py``'s run;
* ``toy_*``: the toy MVN (d = 2), 4 chains, the default explorer, seed 1,
  float64, the same file's second run, cut from 9 rounds to 4;
* ``slice_*``: the toy MVN (d = 3), 4 chains x 2 replicates, seed 4, float64,
  ``SliceSampler(n_passes=2)``: the state after round 2 and after round 3
  (a run that the port continues from round 2's state);
* ``aaps_*``: the same with ``AAPS(step_size=0.3)``, and its ``std_devs``;
* ``ising_*``: ``ising_target(0.4, 3)`` (``BinaryGibbs``), 4 chains, 2 rounds;
* ``compose_*``: ``Compose(SliceSampler(n_passes=1), AAPS(step_size=0.3))``,
  toy MVN (d = 2), 2 rounds;
* ``draw_*``: float64 uniforms, normals, exponentials and Gumbel draws
  (8 each) for 1,024 keys ``draw_keys``;
* ``math_*``: the float64 ``fma``, ``exp``, ``log``, ``log1p``, ``expm1``,
  ``erf_inv``, ``lgamma``, ``logaddexp`` and ``sqrt`` of XLA's CPU code on
  sweeps of their arguments;
* ``dtypes_*``: the dtype of every leaf after one round of a SliceSampler
  run and of an AAPS run (states, permutations, betas, grids, the explorer's
  state, the recorders' reduction, traces);
* ``fails_*``: the error class and message of the float64 runs that the JAX
  runtime refuses (``MALA``, ``AutoMALA``, ``NUTS``: their loops carry a
  float32 statistic that a float64 acceptance promotes).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import pigeons_tpu as J  # noqa: E402
from pigeons_tpu.models import funnel, ising_target  # noqa: E402
from pigeons_tpu.ops import combinators  # noqa: E402

F64 = jnp.float64


def run_arrays(pt, prefix, out):
    out[prefix + "states"] = np.asarray(pt.states)
    out[prefix + "chain_of"] = np.asarray(pt.chain_of)
    out[prefix + "replica_of"] = np.asarray(pt.replica_of)
    out[prefix + "schedule"] = np.asarray(pt.schedule.grids)
    out[prefix + "samples"] = np.asarray(pt.sample_array())
    out[prefix + "logz"] = np.array([r.log_z_estimate for r in pt.reports])
    out[prefix + "barrier"] = np.array([r.global_barrier for r in pt.reports])
    out[prefix + "trips"] = np.array([r.n_round_trips for r in pt.reports])
    out[prefix + "restarts"] = np.array([r.n_tempered_restarts for r in pt.reports])


def leaf_dtypes(pt):
    """``name -> dtype name`` for every leaf of the run after a round."""
    leaves = {"states": pt.states, "chain_of": pt.chain_of, "replica_of": pt.replica_of,
              "betas": pt.betas, "schedule": pt.schedule.grids, "traces": pt.traces}
    for k, v in (pt.exp_state or {}).items():
        leaves["exp_state." + k] = v
    for k, v in pt.reduced._asdict().items():
        leaves["reduced." + k] = v
    return {k: np.asarray(v).dtype.name for k, v in leaves.items()}


def draws(out):
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(7), i))(jnp.arange(1024))
    out["draw_keys"] = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    for name in ("uniform", "normal", "exponential", "gumbel"):
        fn = getattr(jax.random, name)
        out["draw_" + name] = np.asarray(jax.jit(jax.vmap(lambda k: fn(k, (8,), F64)))(keys))


def math_sweeps(out):
    rng = np.random.default_rng(0)
    n = 20000
    pos = np.concatenate([rng.uniform(0, 3, n), np.exp(rng.uniform(-745, 709, n)),
                          rng.uniform(0.93, 1.07, n), [0.0, -1.0, np.inf, np.nan, 1.0, 5e-324]])
    wide = np.concatenate([rng.uniform(-750, 720, n), rng.uniform(-2, 2, n), [np.inf, -np.inf]])
    sweeps = {
        "fma": ((rng.normal(0, 1, n) * 10.0 ** rng.integers(-12, 3, n), rng.uniform(-5, 5, n),
                 rng.normal(0, 1, n) * 10.0 ** rng.integers(-12, 3, n)), lambda a, b, c: a * b + c),
        "exp": ((wide,), jnp.exp),
        "log": ((pos,), jnp.log),
        "log1p": ((np.concatenate([rng.uniform(-0.999, 3, n), rng.uniform(-1e-3, 1e-3, n)]),),
                  jnp.log1p),
        "expm1": ((wide,), jnp.expm1),
        "erfinv": ((np.concatenate([rng.uniform(-1, 1, n), 1 - np.exp(rng.uniform(-36, -1, n))]),),
                   jax.lax.erf_inv),
        "lgamma": ((np.concatenate([rng.uniform(0.5, 30, n), np.exp(rng.uniform(0, 50, n))]),),
                   jax.lax.lgamma),
        "logaddexp": ((rng.normal(0, 30, n), rng.normal(0, 30, n)), jnp.logaddexp),
        "sqrt": ((pos[np.isfinite(pos) & (pos >= 0)],), jnp.sqrt),
    }
    for name, (args, fn) in sweeps.items():
        for i, a in enumerate(args):
            out[f"math_{name}_in{i}"] = np.asarray(a, np.float64)
        out[f"math_{name}_out"] = np.asarray(jax.jit(fn)(*args))


def main(path):
    out = {}
    t = funnel(2)
    out["funnel_lp"] = np.asarray(t.log_density(jnp.asarray([-100.0, 1.0, 1.0], F64)))

    deep = J.PT(J.Inputs(target=t, n_chains=4, n_rounds=5, seed=1, dtype=F64,
                         explorer=J.SliceSampler(n_passes=1), show_report=False))
    deep.run()
    run_arrays(deep, "deep_", out)
    out["deep_mean"], out["deep_var"] = np.asarray(deep.mean()), np.asarray(deep.var())

    toy = J.PT(J.Inputs(target=J.toy_mvn_target(2), n_chains=4, n_rounds=4, seed=1, dtype=F64,
                        show_report=False))
    toy.run()
    run_arrays(toy, "toy_", out)
    out["toy_mean"], out["toy_var"] = np.asarray(toy.mean()), np.asarray(toy.var())

    kw = dict(target=J.toy_mvn_target(3), n_chains=4, n_replicates=2, seed=4, dtype=F64,
              show_report=False)
    for name, ex in (("slice", J.SliceSampler(n_passes=2)), ("aaps", J.AAPS(step_size=0.3))):
        pt = J.PT(J.Inputs(explorer=ex, **kw))
        pt.run_round()
        if name == "slice":
            out.update({"dtypes_slice_" + k: v for k, v in leaf_dtypes(pt).items()})
        else:
            out.update({"dtypes_aaps_" + k: v for k, v in leaf_dtypes(pt).items()})
        pt.run_round()
        run_arrays(pt, f"{name}2_", out)
        if pt.exp_state:
            out[f"{name}2_std_devs"] = np.asarray(pt.exp_state["std_devs"])
        pt.run_round()
        run_arrays(pt, f"{name}3_", out)

    ising = J.PT(J.Inputs(target=ising_target(0.4, 3), n_chains=4, n_rounds=2, seed=2, dtype=F64,
                          show_report=False))
    ising.run()
    run_arrays(ising, "ising_", out)

    pt = J.PT(J.Inputs(target=J.toy_mvn_target(2), n_chains=4, n_rounds=2, seed=3, dtype=F64,
                       explorer=combinators.Compose(J.SliceSampler(n_passes=1),
                                                    J.AAPS(step_size=0.3)),
                       show_report=False))
    pt.run()
    run_arrays(pt, "compose_", out)
    draws(out)
    math_sweeps(out)

    for name, ex in (("mala", J.MALA()), ("automala", J.AutoMALA()), ("nuts", J.NUTS())):
        try:
            J.PT(J.Inputs(target=J.toy_mvn_target(2), n_chains=4, n_rounds=1, seed=1, dtype=F64,
                          explorer=ex, show_report=False)).run()
            out["fails_" + name] = np.array(["", ""])
        except Exception as e:  # the kind of error is the record
            out["fails_" + name] = np.array([type(e).__name__, str(e).splitlines()[0]])
    np.savez(path, **out)
    print("X64-REFERENCE-OK")


if __name__ == "__main__":
    main(sys.argv[1])
