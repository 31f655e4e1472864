"""Times the torch ``SliceSampler`` (the eager explorer of paths without a
device density) on the card in two versions of ``pigeons_tpu_torch``, in
turns: earlier, this, this, earlier. Each run is a process of its own that
imports the package from its tree, builds a ``PT`` of the funnel with
``SliceSampler(n_passes=1)``, runs one round of one scan (a warm-up) and
times a round of ``--scans`` scans. Both versions must end in the same
states, bit for bit: they draw the same numbers however they batch them.

    python tools/torch_slice_sampler_time.py --parent DIR [--scans N] [--device cpu]

``DIR`` holds the earlier tree (``git archive <commit> pigeons_tpu_torch |
tar -x -C DIR``). Prints the card's name and power limit, then one line a
shape and version with its ms per scan, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

# name -> (funnel dimension, chains, ladders): chip_smoke.py phase 7's small
# run and the funnel cell's width
SHAPES = {"small funnel (d 4, 5 x 8)": (3, 5, 8), "funnel cell (d 10, 12 x 256)": (9, 12, 256)}


def worker(root: str, out: str, scans: int, device: str) -> None:
    sys.path.insert(0, root)
    import torch

    from pigeons_tpu_torch import PT, Inputs, SliceSampler
    from pigeons_tpu_torch.models import funnel

    found = {}
    for name, (d, chains, ladders) in SHAPES.items():
        pt = PT(Inputs(target=funnel(d), n_chains=chains, n_replicates=ladders, seed=1,
                       explorer=SliceSampler(n_passes=1), show_report=False, device=device))
        pt.run_round(1)
        pt.run_round(scans)
        if device == "cuda":
            torch.cuda.synchronize()
        rep = pt.reports[-1]
        found[name] = (rep.wall_time_s / rep.n_scans * 1e3, pt.states.cpu().numpy())
    np.savez(out, **{f"ms{i}": v[0] for i, v in enumerate(found.values())},
             **{f"x{i}": v[1] for i, v in enumerate(found.values())})


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", required=True)
    parser.add_argument("--scans", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--worker", nargs=2)
    args = parser.parse_args()
    if args.worker:
        worker(args.worker[0], args.worker[1], args.scans, args.device)
        return
    card = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    here = str(Path(__file__).resolve().parents[1])
    trees = [("parent", args.parent), ("this", here), ("this", here), ("parent", args.parent)]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (label, root) in enumerate(trees):
            out = f"{tmp}/run{i}.npz"
            subprocess.run([sys.executable, __file__, "--parent", args.parent, "--scans",
                            str(args.scans), "--device", args.device, "--worker", str(Path(root).resolve()), out],
                           check=True)
            with np.load(out) as z:
                runs.append((label, {k: z[k] for k in z.files}))
    result = {}
    for i, name in enumerate(SHAPES):
        same = all(np.array_equal(r[f"x{i}"], runs[0][1][f"x{i}"]) for _, r in runs)
        for label, r in runs:
            print(f"{name}, {label}: {float(r[f'ms{i}']):.1f} ms per scan ({card})")
        print(f"{name}: states of every run bitwise equal: {same}")
        if not same:
            raise SystemExit(f"{name}: the versions' states differ")
        result[name] = {label: [float(r[f"ms{i}"]) for lb, r in runs if lb == label]
                        for label in ("parent", "this")}
    print(json.dumps({"card": card, "ms_per_scan": result}))


if __name__ == "__main__":
    main()
