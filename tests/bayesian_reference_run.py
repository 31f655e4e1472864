"""The ``BayesianModel`` phases of ``chip_smoke.py`` as runs of their own, by
either package, at a ladder count of choice.

    JAX_PLATFORMS=cpu python tests/bayesian_reference_run.py [--model NAME] [--ladders 16]
    python tests/bayesian_reference_run.py --port cuda [--model NAME] [--ladders 256]

NRPT from the prior to the posterior of ``hierarchical_normal()`` (the
default; 20 groups x 10 observations, d = 23, the target of bench config 5),
``eight_schools()`` or ``unid_target()``: 32 chains, seed 1, one slice pass
per scan, rounds of 2, 4, 8, 16, 32 and 64 scans, each adapting the schedule
for the next. Without ``--port`` the JAX package runs it on the CPU with
``SliceSamplerPallas(interpret=True)`` (hierarchical normal at 16 ladders:
about a quarter of an hour; ``chip_smoke.py``'s 256 are out of the
interpreter's reach); with ``--port DEVICE`` the port runs it with
``SliceSamplerCUDA`` on ``cuda`` or ``cpu``. Each round prints the pooled
posterior means and standard deviations of the model's scalar parameters
(constrained), the barrier, logZ, round trips and restarts; the line of the
64-scan round of the JAX package's run gives the numbers that
``chip_smoke.py`` holds the card's runs to (``H_JAX_*`` there).

The two packages run the same law, not the same trajectory: the prior's
half-Cauchy draws go through a tangent that the packages round differently
in the last bits, and a slice sampler's decisions amplify that. So the
numbers agree within Monte Carlo error (``chip_smoke.py`` states its
tolerances), while permutations and counts differ. ``tests/
test_torch_sweep_bayesian.py`` starts both packages from one state and holds
them exactly.

Not a test: pytest does not collect it, because it is too slow for the suite.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ROUNDS = (2, 4, 8, 16, 32, 64)
MODELS = {"hierarchical_normal": ("hierarchical_normal", ("mu", "tau", "sigma")),
          "eight_schools": ("eight_schools", ("mu", "tau")),
          "unid": ("unid_target", ("p1", "p2"))}


def main():
    args = sys.argv[1:]
    ladders = int(args[args.index("--ladders") + 1]) if "--ladders" in args else 16
    name = args[args.index("--model") + 1] if "--model" in args else "hierarchical_normal"
    factory, scalars = MODELS[name]
    common = dict(n_chains=32, n_replicates=ladders, seed=1, show_report=False)
    if "--port" in args:
        import pigeons_tpu_torch as P

        target = getattr(P, factory)()
        pt = P.PT(P.Inputs(target=target, explorer=P.SliceSamplerCUDA(n_passes=1),
                           device=args[args.index("--port") + 1], **common))
    else:
        import pigeons_tpu as P

        target = getattr(P, factory)()
        pt = P.PT(P.Inputs(target=target,
                           explorer=P.SliceSamplerPallas(interpret=True, n_passes=1), **common))
    print(f"{name}, 32 chains x {ladders} ladders, seed 1, "
          f"{'port on ' + args[args.index('--port') + 1] if '--port' in args else 'JAX package'}")
    for n_scans in ROUNDS:
        pt.run_round(n_scans=n_scans)
        q = target.constrained_samples(pt)
        moments = ", ".join(f"{s} {np.mean(q[s]):.6f} (sd {np.std(q[s]):.6f})" for s in scalars)
        rep = pt.reports[-1]
        print(f"round of {n_scans} scans: {moments}, barrier {pt.global_barrier:.6f}, logZ "
              f"{rep.log_z_estimate:.6f}, round trips {pt.n_round_trips}, restarts "
              f"{pt.n_tempered_restarts}, swap accept mean {rep.mean_swap_accept:.6f}, "
              f"{rep.wall_time_s:.1f} s", flush=True)
    if name == "unid":
        print(f"analytic logZ {P.models.unid_analytic_log_z():.6f}")


if __name__ == "__main__":
    main()
