"""AAPS's share of bailed moves at config 2a's cell, for a few step sizes.

    python tools/torch_aaps_step.py [--ladders 64] [--device cpu] STEP [STEP ...]

Runs ``logistic_regression(200, 10, seed=0)`` with ``AAPS(step_size=STEP)``,
10 chains x ``--ladders`` ladders, seed 1, through ``chip_smoke.py``'s
warm-up (4 rounds of 4 scans) and its timed round (``N_MEASURE_SCANS``
scans), and prints for
each round the share of moves that bailed (a segment that diverged or
reached ``max_segment_steps``), the leapfrogs per lane and scan, and the
largest gap of the pooled posterior mean of the weights to the weights that
made the data. ``chip_smoke.py`` phase 3n runs AAPS at the step fixed in
``N_AAPS_STEP``, chosen with this script so that under 5% of the moves bail.
On the CPU at 64 ladders (two torch threads), 4 to 13 minutes a step size;
run several in parallel processes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke  # noqa: E402
from pigeons_tpu_torch import PT, Inputs, logistic_regression, rng  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("steps", type=float, nargs="+")
    parser.add_argument("--ladders", type=int, default=64)
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()
    target = logistic_regression(200, 10, seed=0)
    w_true = rng.normal(rng.fold_in(rng.key(0), 1), (10,)).numpy()
    lanes = chip_smoke.A_CHAINS * args.ladders
    for step in args.steps:
        explorer = chip_smoke.counting_aaps(step)
        pt = PT(Inputs(target=target, n_chains=chip_smoke.A_CHAINS, n_replicates=args.ladders,
                       seed=chip_smoke.SEED, explorer=explorer, show_report=False,
                       device=args.device))
        rounds = [chip_smoke.A_WARMUP_SCANS] * chip_smoke.A_WARMUP_ROUNDS + [
            chip_smoke.N_MEASURE_SCANS]
        for n_scans in rounds:
            moves, bailed = explorer.moves, float(explorer.bailed)
            pt.run_round(n_scans=n_scans)
            share = (float(explorer.bailed) - bailed) / (explorer.moves - moves)
            w = target.constrained_samples(pt)["w"].mean(0)
            print(f"step {step}: round {pt.round_idx} ({n_scans} scans): bailed {share:.4%} of "
                  f"moves, {float(np.sum(pt.reduced.exp_steps)) / (n_scans * lanes):.2f} "
                  f"leapfrogs per lane and scan, largest gap of the mean of w "
                  f"{np.abs(w - w_true).max():.4f}, {pt.reports[-1].wall_time_s:.2f} s",
                  flush=True)
        print(f"step {step}: bailed {float(explorer.bailed) / explorer.moves:.4%} of all "
              f"{explorer.moves} moves", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    main()
