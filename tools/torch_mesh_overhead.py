"""What a one-rank mesh costs config 1, the stand-in for bench's mesh cell
(``bench.py:298-328``) that ``chip_smoke.py`` phase 11a runs.

Phase 11a times config 1 on a one-rank NCCL mesh late in ``chip_smoke.py``
and phase 3 times it without a mesh early, so host drift between the two
reads as the mesh's cost. Here both run in one process, alternately (no
mesh, mesh, mesh, no mesh, ...: ``--pairs`` of each), each exactly as phase
3 runs it (4 warm-up rounds of 4 scans, a timed round of 32; the round's
wall time ends after the round-end gathers and a synchronize). The round-end
gathers are timed on their own as well (a synchronize before and after each
gather, which moves the round's one wait for the card earlier and adds
nothing to its wall time). Every mesh run must be its no-mesh run bit for
bit. Then one 8-scan round of each is traced with ``torch.profiler`` and
the ops whose host time differs most are listed.

    python tools/torch_mesh_overhead.py [--pairs N]

needs one card; writes ``chiprun_out/torch_mesh_overhead.json`` and the two
traces' op tables to ``chiprun_out/torch_mesh_overhead_ops.txt``, and prints
one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    MEASURE_SCANS,
    WARMUP_ROUNDS,
    WARMUP_SCANS,
    config1_inputs,
    eval_rate,
    run_arrays,
    same_run,
)

TRACE_SCANS, TOP_OPS = 8, 15


class GatherClock:
    """Wraps ``ReplicaMesh.gather``: each call between two synchronizes,
    its seconds summed into :attr:`seconds`."""

    def __init__(self, cls):
        self.cls, self.inner, self.seconds = cls, cls.gather, 0.0

        def timed(mesh, t, dim=0):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.inner(mesh, t, dim)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        cls.gather = timed


def config1_run(mesh, clock):
    """Config 1 as phase 3 runs it; the timed round's ms a scan (wall time,
    round-end gathers included), evals/s and the round-end gathers' ms."""
    from pigeons_tpu_torch import PT

    pt = PT(config1_inputs(mesh=mesh))
    for _ in range(WARMUP_ROUNDS):
        pt.run_round(n_scans=WARMUP_SCANS)
    clock.seconds = 0.0
    pt.run_round(n_scans=MEASURE_SCANS)
    row = {"mesh": mesh is not None,
           "ms_per_scan": pt.reports[-1].wall_time_s / MEASURE_SCANS * 1e3,
           "evals_per_s": eval_rate(pt), "gather_ms": clock.seconds * 1e3}
    return row, run_arrays(pt), pt


def op_table(pt):
    """One traced round of ``TRACE_SCANS`` scans: ``{op: (calls, host us,
    device us)}``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pt.run_round(n_scans=TRACE_SCANS)
    table = {}
    for e in prof.key_averages():
        device_us = getattr(e, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(e, "self_cuda_time_total", 0.0)
        table[e.key] = (e.count, e.self_cpu_time_total, device_us)
    return table


def main() -> None:
    from pigeons_tpu_torch import MultiHostLauncher
    from pigeons_tpu_torch.parallel import ReplicaMesh, replica_mesh

    pairs = int(sys.argv[sys.argv.index("--pairs") + 1]) if "--pairs" in sys.argv else 4
    if not torch.cuda.is_available():
        raise SystemExit("torch sees no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock = GatherClock(ReplicaMesh)
    with tempfile.TemporaryDirectory(prefix="mesh_overhead_") as tmp:
        MultiHostLauncher(coordinator_address=f"file://{tmp}/pg", num_processes=1,
                          process_id=0, timeout_s=300.0).init("cuda")
        mesh = replica_mesh()
        if mesh.backend != "nccl":
            raise SystemExit(f"a one-rank mesh on the card took {mesh.backend}, not NCCL")
        rows, want, last = [], None, {}
        for i in range(2 * pairs):
            with_mesh = i % 4 in (1, 2)  # no mesh, mesh, mesh, no mesh, ...
            row, arrays, pt = config1_run(mesh if with_mesh else None, clock)
            if want is None:
                want = arrays
            same_run(f"run {i}, {'one-rank mesh' if with_mesh else 'no mesh'}", arrays, want)
            print(f"run {i}: {'mesh   ' if with_mesh else 'no mesh'} {row['ms_per_scan']:.4f} ms "
                  f"a scan, {row['evals_per_s']:.6g} evals/s, round-end gathers "
                  f"{row['gather_ms']:.4f} ms", flush=True)
            rows.append(row)
            last[with_mesh] = pt
        tables = {m: op_table(last[m]) for m in (False, True)}
    torch.distributed.destroy_process_group()

    def mean(key, with_mesh):
        return float(np.mean([r[key] for r in rows if r["mesh"] == with_mesh]))

    plain, meshed = mean("ms_per_scan", False), mean("ms_per_scan", True)
    lines = []
    for with_mesh in (False, True):
        t = tables[with_mesh]
        lines.append(f"{'one-rank mesh' if with_mesh else 'no mesh'}: a round of {TRACE_SCANS} "
                     f"scans, host {sum(v[1] for v in t.values()) / 1e3:.3f} ms self, device "
                     f"{sum(v[2] for v in t.values()) / 1e3:.3f} ms self ({smi})")
        for key, (count, cpu, dev) in sorted(t.items(), key=lambda kv: -kv[1][1])[:TOP_OPS]:
            lines.append(f"  {key[:60]:60s} {count:8d} calls {cpu / 1e3:10.3f} ms host "
                         f"{dev / 1e3:10.3f} ms device")
    keys = set(tables[False]) | set(tables[True])
    diff = sorted(keys, key=lambda k: -abs(tables[True].get(k, (0, 0, 0))[1]
                                          - tables[False].get(k, (0, 0, 0))[1]))
    lines.append("ops whose host time differs most (mesh minus no mesh):")
    for key in diff[:TOP_OPS]:
        a, b = tables[False].get(key, (0, 0.0, 0.0)), tables[True].get(key, (0, 0.0, 0.0))
        lines.append(f"  {key[:60]:60s} calls {a[0]} -> {b[0]}, host {(b[1] - a[1]) / 1e3:+.3f} ms")
    print("\n".join(lines))
    out = {"card": smi, "pairs": pairs, "runs": rows, "no_mesh_ms_per_scan": plain,
           "mesh_ms_per_scan": meshed, "mesh_over_no_mesh": meshed / plain - 1.0,
           "mesh_gather_ms": mean("gather_ms", True)}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "torch_mesh_overhead.json").write_text(json.dumps(out, indent=1))
    (ROOT / "chiprun_out" / "torch_mesh_overhead_ops.txt").write_text("\n".join(lines) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"torch_mesh_overhead: {time.perf_counter() - t0:.1f} s")
