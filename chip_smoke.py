"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the repository root. It builds the port's CUDA kernels from
``pigeons_tpu_torch/csrc``, holds each against its plain torch twin at the
main path's shapes, drives bench config 1 (NRPT on the d=100 toy MVN, 10
chains x 2048 ladders, banded slice sampler) end to end through
``PT(Inputs(...))``, checks the run's laws and determinism, and runs the
README quick start. Every phase raises on failure. Without a CUDA device,
or without the repository beside it, it exits non-zero and prints no
result. The last line of its output is a JSON object naming the device.

``--profile`` also writes a ``torch.profiler`` table of one 4-scan round to
``chiprun_out/profile_config1.txt``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

D, N_CHAINS, N_REPLICATES, SEED = 100, 10, 2048, 1
WARMUP_ROUNDS, WARMUP_SCANS, MEASURE_SCANS = 4, 4, 32
# the JAX package's barrier estimate for this configuration and seed
# (BENCH_r05.json): a statistic of the run, not a speed
JAX_BARRIER = 7.18


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(fn, n):
    """Median of ``n`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def device_phase():
    phase("0 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")


def build_phase():
    phase("1 build")
    from pigeons_tpu_torch import _build

    path, seconds = _build.build(verbose=True)
    print(f"built {path.name} in {seconds:.3f} s (0 = already built)")
    _build.load_library()


def kernel_phase():
    """Kernel K1 against its twin at the main path's shape."""
    phase("2 kernel vs twin")
    from pigeons_tpu_torch import rng
    from pigeons_tpu_torch.ops import cuda_slice
    from pigeons_tpu_torch.paths import toy_mvn_path

    B = N_CHAINS * N_REPLICATES
    rs = np.random.RandomState(0)
    dev = torch.device("cuda")
    x = torch.tensor(rs.normal(size=(B, D)).astype(np.float32), device=dev)
    betas = torch.tensor(rs.uniform(0.0, 1.0, B).astype(np.float32), device=dev)
    a = toy_mvn_path(D).coord_factor(betas)
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(11, dev), torch.arange(B, device=dev)))

    xk, sk = cuda_slice.banded_sweep_cuda(x, a, seeds)
    xt, st = cuda_slice.banded_sweep_reference(x, a, seeds)
    torch.cuda.synchronize()
    bitwise = xk.view(torch.int32) != xt.view(torch.int32)
    rel = (xk - xt).abs() / xt.abs().clamp_min(1e-30)
    far = rel > 1e-6  # tolerance: 1e-6 relative, on at most 0.1% of elements
    n_far = int(far.sum())
    clean_lanes = ~bitwise.any(1)
    stats_bad = int(((sk != st).any(0) & clean_lanes).sum())
    max_abs = float((xk - xt).abs().max())
    print(f"elements {B * D}: bitwise-differing {int(bitwise.sum())}, "
          f"over 1e-6 relative {n_far}, max |diff| {max_abs}, "
          f"stats rows differing on clean lanes {stats_bad}")
    if n_far > 1e-3 * B * D or stats_bad:
        raise AssertionError("kernel K1 disagrees with its twin")
    ms = cuda_ms(lambda: cuda_slice.banded_sweep_cuda(x, a, seeds), 20)
    plain_ms = cuda_ms(lambda: cuda_slice.banded_sweep_reference(x, a, seeds), 3)
    print(f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms (medians, B={B}, d={D}, 3 passes)")
    return {"name": "banded_slice_sweep", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/banded_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:305",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}


def eval_rate(pt):
    """Density evaluations per second of the last round, counted as
    ``bench.py:_eval_rate`` counts them: explorer queries plus the runtime's
    2N fused evaluations per scan and ladder."""
    rep = pt.reports[-1]
    evals = float(np.sum(pt.reduced.exp_steps)) + 2.0 * N_CHAINS * rep.n_scans * N_REPLICATES
    return evals / rep.wall_time_s


def config1_phase():
    """Bench config 1 end to end; returns the kernel launches it made."""
    phase("3 config 1")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    SliceSamplerCUDA.n_kernel_launches = 0
    torch.cuda.reset_peak_memory_stats()
    pt = PT(Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                   seed=SEED, explorer=SliceSamplerCUDA(), show_report=False, device="cuda"))
    for _ in range(WARMUP_ROUNDS):
        pt.run_round(n_scans=WARMUP_SCANS)
    pt.run_round(n_scans=MEASURE_SCANS)
    launches = SliceSamplerCUDA.n_kernel_launches
    scans = WARMUP_ROUNDS * WARMUP_SCANS + MEASURE_SCANS
    rep = pt.reports[-1]
    mean, var = pt.mean(), pt.var()
    analytic_barrier = float(pt.path.analytic_cumulative_barrier(1.0))
    print(f"kernel launches {launches} for {scans} scans")
    print(f"timed round: {MEASURE_SCANS} scans in {rep.wall_time_s:.4f} s, "
          f"{eval_rate(pt):.6g} evals/s, peak device memory {rep.peak_memory_bytes} B")
    print(f"max|mean| {np.abs(mean).max():.5f}, max|var/0.1-1| {np.abs(var / 0.1 - 1).max():.5f}")
    print(f"barrier {pt.global_barrier:.4f} (JAX estimate {JAX_BARRIER}, analytic "
          f"{analytic_barrier:.4f}, unreachable with {N_CHAINS} chains)")
    print(f"logZ {rep.log_z_estimate:.4f} (analytic {pt.path.analytic_lognormalization():.4f})")
    print(f"round trips {pt.n_round_trips}, restarts {pt.n_tempered_restarts}, "
          f"swap accept mean {rep.mean_swap_accept:.4f}")
    if launches != scans:
        raise AssertionError(f"{launches} kernel launches for {scans} scans")
    if not (np.abs(mean).max() < 0.02 and np.abs(var / 0.1 - 1).max() < 0.05):
        raise AssertionError("target moments off")
    if not abs(pt.global_barrier - JAX_BARRIER) < 0.3:
        raise AssertionError("global barrier off")
    if not math.isfinite(rep.log_z_estimate):
        raise AssertionError("logZ not finite")
    return launches


def small_reference_phase():
    """A small run on the card (kernel) against the same run on the CPU
    (twin): same swaps, same states within 1e-6."""
    phase("6 small run, card vs CPU")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    runs = [PT(Inputs(target=toy_mvn_target(6), n_chains=5, n_replicates=8, seed=4,
                      n_rounds=4, explorer=SliceSamplerCUDA(), show_report=False,
                      device=dev)).run() for dev in ("cuda", "cpu")]
    g, c = runs
    same_perm = torch.equal(g.chain_of.cpu(), c.chain_of) and torch.equal(g.replica_of.cpu(), c.replica_of)
    diff = float((g.states.cpu() - c.states).abs().max())
    print(f"permutations equal {same_perm}, max |state diff| {diff}, "
          f"barrier {g.global_barrier:.6f} vs {c.global_barrier:.6f}")
    if not same_perm or diff > 1e-6 or not np.isfinite(g.sample_array()).all():
        raise AssertionError("card run disagrees with the CPU run")


def determinism_phase():
    phase("4 determinism")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    runs = [PT(Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                      seed=SEED, n_rounds=2, explorer=SliceSamplerCUDA(), show_report=False,
                      device="cuda")).run() for _ in range(2)]
    a, b = runs
    same = (torch.equal(a.chain_of, b.chain_of) and torch.equal(a.replica_of, b.replica_of)
            and torch.equal(a.states, b.states))
    print(f"two 2-round runs bitwise equal: {same}")
    if not same:
        raise AssertionError("same seed, different runs")


def quickstart_phase():
    phase("5 quick start")
    from pigeons_tpu_torch import pigeons, toy_mvn_target

    pt = pigeons(target=toy_mvn_target(D), n_chains=N_CHAINS, n_rounds=6, seed=SEED,
                 device="cuda", show_report=False)
    vals = [pt.mean(), pt.var(), pt.reports[-1].log_z_estimate, pt.global_barrier]
    print(f"max|mean| {np.abs(vals[0]).max():.4f}, mean var {vals[1].mean():.4f}, "
          f"logZ {vals[2]:.4f}, barrier {vals[3]:.4f}")
    if not all(np.isfinite(v).all() for v in vals):
        raise AssertionError("quick start gave non-finite results")


def profile_phase():
    """torch.profiler over one 4-scan round of config 1."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    pt = PT(Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                   seed=SEED, explorer=SliceSamplerCUDA(), show_report=False, device="cuda"))
    pt.run_round(n_scans=WARMUP_SCANS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pt.run_round(n_scans=WARMUP_SCANS)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_config1.txt", "w") as f:
        f.write(table)
    from torch.autograd import DeviceType

    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in dev_events)
    kernel_us = sum(e.self_device_time_total for e in dev_events if "banded_slice" in e.key)
    wall = pt.reports[-1].wall_time_s
    print(f"profile: {WARMUP_SCANS} scans, wall {wall:.4f} s, device busy "
          f"{device_us / 1e3:.3f} ms ({device_us / 1e6 / wall:.2%} of wall) over "
          f"{sum(e.count for e in dev_events)} device ops; kernel K1 {kernel_us / 1e3:.3f} ms")
    print(table[:6000])


def main():
    device_phase()
    build_phase()
    entry = kernel_phase()
    entry["launches"] = config1_phase()
    determinism_phase()
    quickstart_phase()
    small_reference_phase()
    if "--profile" in sys.argv[1:]:
        profile_phase()
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"chip_smoke finished in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
