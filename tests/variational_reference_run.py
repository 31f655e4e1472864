"""The config 4 phase of ``chip_smoke.py`` as a run of its own, by either
package, at a ladder count of choice.

    JAX_PLATFORMS=cpu python tests/variational_reference_run.py [--ladders 8]
    python tests/variational_reference_run.py --port cuda [--ladders 256]

Two-leg stabilized variational PT on the d=100 toy MVN (10 + 10 chains, seed
1, banded slice sampler, three passes): 6 rounds of 8 scans, then the round
of 64 scans that ``chip_smoke.py`` times, the first under the Gaussian
reference fitted after round 6. Without ``--port`` the JAX package runs it on
the CPU with ``SliceSamplerPallas(interpret=True)`` (a few minutes at 8
ladders; ``chip_smoke.py``'s 256 are out of reach of the interpreter); with
``--port DEVICE`` the port runs it with ``SliceSamplerCUDA`` on ``cuda`` or
``cpu``. Each round prints both barriers, logZ (exact: 50 log(2 pi / 10) =
-23.2354), restarts, round trips and the reference's flag. Both runs are
deterministic; at equal ladder counts they agree in permutations and counts
and differ in the last digits of the statistics.

Not a test: pytest does not collect it, because it is too slow for the suite.
``tests/test_torch_variational.py`` holds the port against the JAX package on
small two-leg runs instead.
"""

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    args = sys.argv[1:]
    ladders = int(args[args.index("--ladders") + 1]) if "--ladders" in args else 8
    common = dict(n_chains=10, n_chains_variational=10, n_replicates=ladders, seed=1,
                  show_report=False)
    if "--port" in args:
        import pigeons_tpu_torch as P

        pt = P.PT(P.Inputs(target=P.toy_mvn_target(100), explorer=P.SliceSamplerCUDA(),
                           device=args[args.index("--port") + 1], **common))
    else:
        import pigeons_tpu as P

        pt = P.PT(P.Inputs(target=P.toy_mvn_target(100),
                           explorer=P.SliceSamplerPallas(interpret=True), **common))
    print(f"{ladders} ladders; exact logZ {50 * math.log(2 * math.pi / 10):.4f}")
    for n_scans in [8] * 6 + [64]:
        pt.run_round(n_scans=n_scans)
        rep = pt.reports[-1]
        print(f"round {rep.round_idx} of {n_scans} scans: barrier {rep.global_barrier:.6f}, "
              f"variational barrier {rep.global_barrier_variational:.6f}, logZ "
              f"{rep.log_z_estimate:.6f}, restarts {rep.n_tempered_restarts}, round trips "
              f"{rep.n_round_trips}, swap accept mean {rep.mean_swap_accept:.6f}, reference "
              f"active after it {float(pt._ref_params['active'])}", flush=True)


if __name__ == "__main__":
    main()
