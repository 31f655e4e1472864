"""The funnel phase of ``chip_smoke.py`` as a run of its own, by either package.

    JAX_PLATFORMS=cpu python tests/funnel_reference_run.py [--long]
    python tests/funnel_reference_run.py --port cuda [--long]

NRPT on Neal's funnel (``funnel(9)``, 12 chains x 256 ladders, seed 1, one
slice pass per scan): 6 rounds of 8 scans, then the round of 64 scans that
``chip_smoke.py`` times. Without ``--port`` the JAX package runs it on the
CPU with ``SliceSamplerPallas(interpret=True)`` (about 4 minutes); the line
of the 64-scan round gives the numbers that ``chip_smoke.py`` holds the
port's run on the card to (``F_JAX_*`` there). With ``--port DEVICE`` the
port runs it with ``SliceSamplerCUDA`` on ``cuda`` or ``cpu``. Both runs are
deterministic; they agree bit for bit at first and drift apart in the last
digits later (the reference chains' normal draws differ by up to 2 ulp).

``--long`` continues with rounds of 128, 256 and 512 scans (half an hour
more for the JAX package, about a minute on a card). It shows how long the y
marginal takes to leave the transient of the initial states, and each
round's forward and backward stepping-stone sums, whose mean is logZ. With
``--port`` every round also prints its schedule, the forward sum's terms by
pair and the largest log-ratio a lane offered to a swap, with its scan, its
chain and its state: one such term can carry the whole sum.

Not a test: pytest does not collect it, because it is far too slow for the
suite. ``tests/test_torch_pt.py`` holds the port against the JAX package on a
small funnel run instead.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def watch_log_ratios(pt_module):
    """Wrap the port's ``PT._post_one`` so that each round remembers the
    largest finite log-ratio of its scans; returns the dict it is kept in."""
    import torch

    worst = {}
    post_one = pt_module.PT._post_one

    def watched(self, scan_idx, x_after, lp_after, lp_partner, lp_cur, out, chain_of, *rest):
        ratio = lp_partner - lp_after
        value, lane = torch.max(torch.where(torch.isfinite(ratio), ratio, -torch.inf), 0)
        if float(value) > worst.get("log_ratio", -float("inf")):
            worst.update(log_ratio=float(value), scan=scan_idx,
                         chain=int(chain_of.reshape(-1)[lane]),
                         lp_own=float(lp_after[lane]), lp_partner=float(lp_partner[lane]),
                         state=[round(float(v), 3) for v in x_after[lane]])
        return post_one(self, scan_idx, x_after, lp_after, lp_partner, lp_cur, out, chain_of,
                        *rest)

    pt_module.PT._post_one = watched
    return worst


def main():
    args = sys.argv[1:]
    worst = None
    common = dict(n_chains=12, n_replicates=256, seed=1, show_report=False)
    if "--port" in args:
        import pigeons_tpu_torch as P
        from pigeons_tpu_torch.evidence import stepping_stone_pair_from_reduced

        worst = watch_log_ratios(P.pt)
        pt = P.PT(P.Inputs(target=P.funnel(9), explorer=P.SliceSamplerCUDA(n_passes=1),
                           device=args[args.index("--port") + 1], **common))
    else:
        import pigeons_tpu as P
        from pigeons_tpu.evidence import stepping_stone_pair_from_reduced

        pt = P.PT(P.Inputs(target=P.funnel(9),
                           explorer=P.SliceSamplerPallas(interpret=True, n_passes=1), **common))
    for n_scans in [8] * 6 + [64] + ([128, 256, 512] if "--long" in args else []):
        betas = np.asarray(pt.schedule.grids)
        pt.run_round(n_scans=n_scans)
        y = np.asarray(pt.sample_array())[:, 0]
        rep = pt.reports[-1]
        fwd, bwd = stepping_stone_pair_from_reduced(pt.reduced)
        print(f"round of {n_scans} scans: y mean {y.mean():.6f}, variance {y.var():.6f}, "
              f"barrier {pt.global_barrier:.6f}, logZ {rep.log_z_estimate:.6f} (forward "
              f"{fwd:.6f}, backward {bwd:.6f}), round trips {pt.n_round_trips}, restarts "
              f"{pt.n_tempered_restarts}, swap accept mean {rep.mean_swap_accept:.6f}", flush=True)
        if worst is not None:
            r = pt.reduced
            print(f"  schedule {np.array2string(betas, precision=7)}\n  forward terms by pair "
                  f"{np.array2string(r.lsr_fwd - np.log(np.maximum(r.lsr_fwd_n, 1)), precision=4)}"
                  f"\n  largest log-ratio {worst}", flush=True)
            worst.clear()


if __name__ == "__main__":
    main()
