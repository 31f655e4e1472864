"""One rank of the port's multi-process tests on the CPU (gloo).

    python tests/torch_mesh_worker.py RANK WORLD INIT OUTDIR STEP [STEP ...]

``INIT`` is the group's ``init_method`` (``file://...``). The ranks join
one group through ``MultiHostLauncher`` and run the steps in turn, each
writing every rank's results to ``OUTDIR/<name>.rank<k>.npz``:

* ``CASE``: the case of :data:`CASES` of that name, sharded over the ranks
  (``pigeons(inputs, on=MultiHostLauncher(...))``); a case whose Inputs the
  mesh must refuse writes the error's message instead;
* ``resume=FOLDER:ROUNDS:NAME``: the checkpoint in ``FOLDER`` loaded under
  the ranks (``load_pt(..., mesh=replica_mesh())``, elastic resume) and run
  to ``ROUNDS`` rounds;
* ``host_main=INPUTS:NAME``: the per-host entry point on the Inputs that
  ``checkpoint.dump_object`` wrote to ``INPUTS``, checkpointing into
  ``OUTDIR/NAME`` (with ``checked_round``, rank 0 runs the serial check).

Before the steps, each rank writes the launcher's view of it to
``OUTDIR/launcher.rank<k>.npz``: its place among its host's ranks and the
group's backend.

:data:`CASES` are the JAX package's own inputs (``tests/test_sharded.py``,
``tests/test_multihost.py``), built for either package by :func:`inputs_for`.
"""

from __future__ import annotations

import sys

# case -> Inputs keywords; the target and explorer by name and arguments
CASES = {
    # tests/test_sharded.py:18-31 (toy_mvn_target's default explorer)
    "layout": dict(target=("toy_mvn_target", 3), n_chains=8, n_rounds=4, seed=5),
    # :55, the torch SliceSampler
    "slice": dict(target=("toy_mvn_target", 3), n_chains=8, n_rounds=4, seed=5,
                  explorer=("SliceSampler", 1)),
    # :62 and :99: counts the mesh must refuse
    "indivisible_chains": dict(target=("toy_mvn_target", 3), n_chains=6, n_rounds=4, seed=5),
    "indivisible_ladders": dict(target=("toy_mvn_target", 3), n_chains=4, n_rounds=4, seed=9,
                                n_replicates=6, explorer=("SliceSampler", 1)),
    # :70-83, replicate sharding
    "ladders": dict(target=("toy_mvn_target", 3), n_chains=4, n_rounds=4, seed=9, n_replicates=4,
                    explorer=("SliceSampler", 1)),
    # :106 and :142 with SliceSamplerCUDA (K1's twin on the CPU)
    "k1_chains": dict(target=("toy_mvn_target", 2), n_chains=8, n_rounds=6, seed=11,
                      explorer=("SliceSamplerCUDA", 1)),
    "k1_ladders": dict(target=("toy_mvn_target", 2), n_chains=4, n_rounds=5, seed=13,
                       n_replicates=4, explorer=("SliceSamplerCUDA", 1)),
    # config 5's target, chain-sharded: K2's twin on every rank's lanes
    "k2_chains": dict(target=("hierarchical_normal",), n_chains=4, n_rounds=2, seed=1,
                      explorer=("SliceSamplerCUDA", 1)),
    # tests/test_multihost.py:108 (the smoke run) and :87-101 (the fuller one)
    "smoke": dict(target=("toy_mvn_target", 2), n_chains=4, n_rounds=2, seed=7,
                  explorer=("SliceSampler", 1)),
    "fresh": dict(target=("toy_mvn_target", 3), n_chains=8, n_rounds=3, seed=5,
                  explorer=("SliceSampler", 1)),
}


def inputs_for(pkg, case, **extra):
    """The Inputs of ``case`` for ``pkg`` (``pigeons_tpu`` or
    ``pigeons_tpu_torch``): the JAX package's ``SliceSamplerPallas`` in the
    Pallas interpreter where the port runs ``SliceSamplerCUDA``, every
    recorder and the extended traces."""
    kw = dict(CASES[case])
    name, *args = kw.pop("target")
    kw["target"] = getattr(pkg, name)(*args)
    if "explorer" in kw:
        name, n_passes = kw.pop("explorer")
        jax_kernel = name == "SliceSamplerCUDA" and pkg.__name__ == "pigeons_tpu"
        kw["explorer"] = (pkg.SliceSamplerPallas(interpret=True, n_passes=n_passes) if jax_kernel
                          else getattr(pkg, name)(n_passes=n_passes))
    kw.update(record=pkg.inputs.RECORD_ALL, extended_traces=True, show_report=False)
    if pkg.__name__ == "pigeons_tpu_torch":
        kw["device"] = "cpu"
    kw.update(extra)
    return pkg.Inputs(**kw)


def results(pt):
    """What the tests compare, as host arrays (``pt.states`` gathers: every
    rank calls this)."""
    import numpy as np

    return dict(
        traces=pt.sample_array(),
        chain_of=np.asarray(pt.chain_of.cpu()),
        replica_of=np.asarray(pt.replica_of.cpu()),
        states=np.asarray(pt.states.cpu()),
        extended_traces=pt.extended_traces,
        index_process=pt.index_process,
        round_trips=pt.n_round_trips,
        restarts=pt.n_tempered_restarts,
        logz=np.array([r.log_z_estimate for r in pt.reports]),
        barrier=pt.global_barrier,
        accept_mean=pt.reduced.accept_mean,
        energy_ac1=pt.reduced.energy_ac1,
        online_mean=pt.reduced.online_mean,
        online_var=pt.reduced.online_var,
        exp_steps=pt.reduced.exp_steps,
        schedule=np.asarray(pt.schedule.grids),
        local_lanes=pt._states.shape[0],
    )


def main():
    import numpy as np
    import torch

    torch.set_num_threads(1)
    rank, world, init, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import pigeons_tpu_torch as T
    from pigeons_tpu_torch.parallel import replica_mesh
    from pigeons_tpu_torch.submission import host_main

    launcher = T.MultiHostLauncher(coordinator_address=init, num_processes=world,
                                   process_id=rank, timeout_s=120.0)
    launcher.init("cpu")
    from pigeons_tpu_torch.parallel import sharding

    np.savez(f"{outdir}/launcher.rank{rank}.npz", host_rank=sharding.host_rank,
             backend=replica_mesh().backend)
    for step in sys.argv[5:]:
        kind, _, arg = step.partition("=")
        if kind == "resume":
            folder, rounds, name = arg.split(":")
            pt = T.load_pt(folder, mesh=replica_mesh())
            while pt.round_idx < int(rounds):
                pt.run_round()
        elif kind == "host_main":
            path, name = arg.split(":")
            pt = host_main.main(["--inputs", path, "--exec-folder", f"{outdir}/{name}",
                                 "--n-hosts", str(world), "--coordinator", init,
                                 "--process-id", str(rank)])
        else:
            name = kind
            try:
                pt = T.pigeons(inputs_for(T, name), on=launcher)
            except ValueError as e:
                np.savez(f"{outdir}/{name}.rank{rank}.npz", error=str(e))
                continue
        np.savez(f"{outdir}/{name}.rank{rank}.npz", **results(pt))
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    main()
