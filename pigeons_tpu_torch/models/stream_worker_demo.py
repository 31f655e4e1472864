"""Demo stream worker: the worker side of the Pigeons stream protocol.

The port's own copy of ``pigeons_tpu/models/stream_worker_demo.py`` (the
port imports nothing of the JAX package), line for line the same worker, so
that a run through either package's bridge asks the same questions of the
same workers.

Runnable as ``python -m pigeons_tpu_torch.models.stream_worker_demo --seed S
--dim D``. Implements the same toy model as ``toy_mvn_target``: the
scaled-precision Gaussian path with precision interpolating 1 -> 10, so runs
through the stream bridge can be checked against the analytic oracles.

Protocol (reference ``src/targets/StreamTarget.jl:16-23``): read one command
per line from stdin —

  * ``log_potential(<beta>)``  -> print ``response(<joint log density>)``
  * ``call_sampler!(<beta>)``  -> run one sweep of local exploration at beta
    (iid regeneration when beta == 0, since the path is a Gaussian whose
    precision is known at every beta — here ANY beta regenerates iid, like
    the reference's toy path), then print ``response()``

Deliberately dependency-light (stdlib only) so worker startup is ~50 ms.
"""

from __future__ import annotations

import argparse
import math
import random
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--precision0", type=float, default=1.0)
    ap.add_argument("--precision1", type=float, default=10.0)
    ap.add_argument("--iid", action="store_true", default=False,
                    help="regenerate iid at every beta (toy path)")
    args = ap.parse_args()

    rng = random.Random(args.seed)
    x = [rng.gauss(0.0, 1.0) for _ in range(args.dim)]

    def precision(beta: float) -> float:
        return (1.0 - beta) * args.precision0 + beta * args.precision1

    def log_potential(beta: float) -> float:
        return -0.5 * precision(beta) * sum(v * v for v in x)

    def call_sampler(beta: float) -> None:
        nonlocal x
        prec = precision(beta)
        if args.iid or beta == 0.0:
            sd = 1.0 / math.sqrt(prec)
            x = [rng.gauss(0.0, sd) for _ in range(args.dim)]
            return
        # random-walk Metropolis sweep (several passes keep mixing decent)
        for _ in range(10):
            lp0 = log_potential(beta)
            prop = [v + rng.gauss(0.0, 1.0 / math.sqrt(prec)) for v in x]
            lp1 = -0.5 * prec * sum(v * v for v in prop)
            if math.log(rng.random() + 1e-300) < lp1 - lp0:
                x = prop

    print("demo worker ready", flush=True)  # informational noise the bridge
    # must tolerate before/between responses (expect-style scanning)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        if line.startswith("log_potential(") and line.endswith(")"):
            beta = float(line[len("log_potential(") : -1])
            print(f"response({log_potential(beta)!r})", flush=True)
        elif line.startswith("call_sampler!(") and line.endswith(")"):
            beta = float(line[len("call_sampler!(") : -1])
            call_sampler(beta)
            print("response()", flush=True)
        else:
            print(f"response(nan)", flush=True)


if __name__ == "__main__":
    main()
