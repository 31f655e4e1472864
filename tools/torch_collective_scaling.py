"""The cost of chain sharding's per-scan gather, the port's counterpart of
``tools/collective_scaling.py``.

It runs one chain-sharded program (the toy MVN at d = 8, 32 chains, one
ladder, ``SliceSamplerCUDA(n_passes=1)``: K1, or its twin on the CPU) over
1, 2 and 4 gloo processes on the CPU, then over 1 and 2 gloo processes on the
card, and prints each layout's wall time a scan (one round of ``N_SCANS``
scans on the CPU, where K1's twin takes about 0.1 s a scan, the best of
``REPEATS`` on the card, each after a warm-up round of ``WARMUP_SCANS``)
beside the same program run in one process without a mesh, and the median
time of the scan's gather alone on the same rows. Every layout computes the same bits (the layout
invariance tests), so what changes is how the scan's one gather crosses
processes. On one card the ranks share the device: these are the gather's
cost there, not scaling across cards. The JAX tool keeps 8 virtual devices
and varies the processes; here a rank is a device, so each rank's share of
the 32 lanes shrinks as the ranks grow.

    python tools/torch_collective_scaling.py [--cpu-only]

writes ``chiprun_out/torch_collective_scaling.json`` and prints one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N_CHAINS, DIM, N_SCANS, REPEATS, WARMUP_SCANS, GATHER_REPEATS = 32, 8, 256, 3, 4, 200
ROOT = Path(__file__).resolve().parents[1]


def worker(rank: int, world: int, init: str, device: str) -> None:
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    import datetime

    import torch.distributed as dist

    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target
    from pigeons_tpu_torch.parallel import replica_mesh

    mesh = None
    if world > 0:
        # gloo at every layout, so that one rank and two ranks on the card
        # gather the same way (NCCL refuses two ranks on one device)
        dist.init_process_group(backend="gloo", init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        mesh = replica_mesh()
    pt = PT(Inputs(target=toy_mvn_target(DIM), n_chains=N_CHAINS, seed=1,
                   explorer=SliceSamplerCUDA(n_passes=1), show_report=False, mesh=mesh,
                   device=device))
    pt.run_round(n_scans=WARMUP_SCANS)  # the kernel's first launch
    best = float("inf")
    for _ in range(REPEATS if device == "cuda" else 1):
        pt.run_round(n_scans=N_SCANS)
        best = min(best, pt.reports[-1].wall_time_s)
    launches = SliceSamplerCUDA.launches["banded_slice_sweep"]
    gather_ms = None
    if mesh is not None:
        # the scan's one collective alone: a gather of a scan's packed rows
        # (each lane's state and 6 floats), host clock around synchronizes
        rows = torch.zeros(N_CHAINS // world, DIM + 6, device=device)
        times = []
        for _ in range(GATHER_REPEATS):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            mesh.gather(rows)
            if device == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        gather_ms = sorted(times)[len(times) // 2] * 1e3
    if rank == 0:
        print(json.dumps({"ranks": world, "device": device, "ms_per_scan": best / N_SCANS * 1e3,
                          "gather_ms": gather_ms, "k1_launches": launches,
                          "logz": pt.reports[-1].log_z_estimate}), flush=True)


def layout(world: int, device: str) -> dict:
    """The program over ``world`` ranks (0: one process, no mesh)."""
    with tempfile.TemporaryDirectory(prefix="collective_") as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "worker", str(rank), str(world),
                                   f"file://{tmp}/pg", device],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in range(max(world, 1))]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise SystemExit(f"a rank of {world} on {device} failed:\n{out[-3000:]}")
    result = json.loads(outs[0].strip().splitlines()[-1])
    gather = (f"one gather {result['gather_ms']:.4f} ms (median of {GATHER_REPEATS}), "
              if result["gather_ms"] is not None else "")
    print(f"{device}, {world or 'one process, no mesh'}{' ranks' if world else ''}: "
          f"{result['ms_per_scan']:.4f} ms a scan (rounds of {N_SCANS}), {gather}"
          f"logZ {result['logz']:.6f}, K1 launches on rank 0 {result['k1_launches']}", flush=True)
    return result


def main() -> None:
    import torch

    layouts = [("cpu", w) for w in (0, 1, 2, 4)]
    if "--cpu-only" not in sys.argv[1:]:
        if not torch.cuda.is_available():
            raise SystemExit("torch sees no CUDA device (pass --cpu-only to run the CPU part)")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        print(smi)
        layouts += [("cuda", w) for w in (0, 1, 2)]
    results = [layout(w, dev) for dev, w in layouts]
    for dev in {dev for dev, _ in layouts}:
        logz = {r["logz"] for r in results if r["device"] == dev}
        if len(logz) != 1:
            raise SystemExit(f"{dev}: the layouts' logZ differ: {logz}")
    out = {"n_chains": N_CHAINS, "dim": DIM, "n_scans": N_SCANS, "runs": results}
    if "--cpu-only" not in sys.argv[1:]:
        out["card"] = smi
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "torch_collective_scaling.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        t0 = time.perf_counter()
        main()
        print(f"torch_collective_scaling: {time.perf_counter() - t0:.1f} s")
