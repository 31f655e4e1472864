"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the repository root. It builds the port's CUDA kernels from
``pigeons_tpu_torch/csrc`` (one ``nvcc`` call, the sources in parallel),
holds each against its plain torch twin at the main paths' shapes (no bit
may differ), and
drives two paths end to end through ``PT(Inputs(...))``:

* bench config 1: NRPT on the d=100 toy MVN, 10 chains x 2048 ladders, banded
  slice sampler (kernel K1);
* Neal's funnel, the target of bench config 3: 12 chains x 256 ladders, d=10,
  general slice sampler (kernel K2, full mode). K2's delta mode is held
  against its twin at config 1's shape.

It checks each run's laws and determinism, runs the README quick start, and
compares small runs on the card with the same runs on the CPU. Every phase
raises on failure. Without a CUDA device, or without the repository beside
it, it exits non-zero and prints no result. The line before the last is a
JSON object describing every kernel (time, twin's time, launches on its main
path, bound); the last line is a JSON object naming the device.

A kernel's bound is the least time the card could take for the same work:
the larger of the bytes it must move (inputs read once, outputs written
once) over the H100's 3.35 TB/s and the operations this run's data needs
over the card's rates for their types (``bound``). The operations are
counted from the run's own data: the twin, run on the same inputs, counts
the loop iterations spent in each phase of the slice machine, and each phase
is charged what it uses (the tables below ``HBM_BYTES_PER_S``, read off the
CUDA sources): an ENTER iteration two uniform draws and the log, a DOUBLE or
SHRINK iteration one draw, INIT_R and CHECK none, each its density queries.

``--profile`` also writes ``torch.profiler`` tables of one round of each
path to ``chiprun_out/profile_config1.txt`` and ``profile_funnel.txt``.
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

# the funnel path: bench config 3's target and width (bench.py:232-263)
F_NX, F_CHAINS, F_REPLICATES, F_PASSES = 9, 12, 256, 1
F_WARMUP_ROUNDS, F_WARMUP_SCANS, F_MEASURE_SCANS, F_CONFIG3_SCANS = 6, 8, 64, 256
# the JAX package's adapted barrier for this configuration (README.md,
# Benchmarks): a statistic of the run, not a speed
F_JAX_BARRIER = 3.0
# The timed round as the JAX package runs it on the CPU at the same seed and
# rounds: printed by ``python tests/funnel_reference_run.py``
# (SliceSamplerPallas(interpret=True, n_passes=1), about 4 minutes). The port
# is the same deterministic run, so it is held to these within 1e-3 relative.
# y is not the funnel's N(0, 3) yet: after 112 scans both packages are still
# in the transient of their initial states, which the first sweeps throw far
# up the funnel's mouth (y near 17 in a tenth of the ladders); the mean falls
# to 1.3 by a 256-scan round. The kernel itself keeps N(0, 3)
# (tests/test_torch_sweep_slice.py, tests/test_torch_cuda.py).
F_JAX_Y_MEAN, F_JAX_Y_VAR = 5.402001, 38.623566
F_JAX_RUN_BARRIER, F_JAX_LOG_Z, F_JAX_ROUND_TRIPS = 3.122683, -20.181302, 105

# Published peaks of one H100 SXM at 700 W: 3.35 TB/s of device memory, and
# 67 TFLOP/s in float32 = 132 SMs x 128 lanes x 2 (a fused multiply-add) x
# 1.98 GHz. An SM has 64 int32 lanes of one operation each: a quarter of that.
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 4


def ops(n_float, n_int=0):
    """An operation count by type: ``[float32, int32]``."""
    return np.array([n_float, n_int], dtype=np.float64)


# What each step of the kernels needs, as (float32, int32) operations counted
# off csrc/*.cu and csrc/*.cuh line by line. A fused multiply-add is 2
# operations, every other arithmetic instruction, comparison, select,
# conversion or division 1; moves and bit casts are free.
# One uniform draw: the counter (1) and its xor (1), fmix32 (3 shifts, 3 xors,
# 2 multiplies), the shift by 8; a conversion, a multiply and an add.
DRAW = ops(3, 11)
# cephes_logf: 2 shifts/masks each for exponent and mantissa; the subnormal
# and FLT_MIN guards (5), exponent (2), sqrt(1/2) fold (6), z and x^3 (2),
# eleven fused multiply-adds (22), 2 multiplies, a subtract, an add, and the
# three special cases (7).
LOG = ops(46, 4)
# cephes_expf: four clamps (8), the rounded multiple of log 2 (fma, floor),
# two reductions (2 fma, a negation), a degree-5 polynomial (5 fma), x * x, an
# fma, + 1, 2^n (add and shift; a conversion), the scaling and the flush (3).
EXP = ops(34, 2)
# Every loop iteration: the counter, the DONE test, the coordinate's address.
LOOP = ops(0, 3)
# The machine's own work by phase, without draws, log and density queries.
# ENTER: z = lp - e (2), L by fma (2), R (1). Leaving a coordinate (once per
# ENTER): the accept count, the step count and the coordinate's wrap.
M_ENTER = ops(5) + ops(1, 3)
# whether to double on: K > 0, two comparisons with z, two logical operations
MORE_DBL = ops(2, 3)
# DOUBLE: the side (1), the span (1), the new end (1), K - 1, and MORE_DBL
M_DOUBLE = ops(3, 1) + MORE_DBL
# SHRINK: the candidate (a subtract and an fma), the shrink count, z < lp, the
# narrow test (2), the considered count
M_SHRINK = ops(7, 1)
# a rejected candidate: which end (1), the degenerate test (three fabs, two
# isnan, max, subtract, multiply, compare), the shrink limit
M_REJECT = ops(10, 1)
# CHECK: the midpoint (2), its side (1), crossed (a comparison and an xor),
# the rejection test (2 comparisons, 2 ands), the width left (2)
M_CHECK = ops(8, 3)
# a coordinate term (a v) v with its NaN guard; the toy path's factor a(beta)
COORD_TERM, TOY_FACTOR = ops(4), ops(5)
# interpolate() with its two guarded products (8) and the NaN guard (2)
INTERPOLATE = ops(10)
ENTER, INIT_R, DOUBLE, SHRINK, CHECK = range(5)  # the machines' phase codes


def sum_squares_ops(d):
    """d scalings, one square and d - 1 fused multiply-adds."""
    return ops(3 * d - 1)


def funnel_density_ops(d):
    """One evaluation of the funnel path's density: the reference (sum of
    squares, one multiply), the y term (4), u (1), the exp, for each of the
    d - 1 x coordinates a division, a square, an fma and an add, the d - 2
    adds of their sum, the final add, and the interpolation."""
    return (sum_squares_ops(d) + ops(1) + ops(5) + EXP + ops(5 * (d - 1) + (d - 2) + 1)
            + INTERPOLATE)


def toy_density_ops(d):
    """One full evaluation of the toy path's density: the factor, the sum of
    squares, one multiply and the NaN guard."""
    return TOY_FACTOR + sum_squares_ops(d) + ops(3)


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
    print(f"built {path.name} in {seconds:.3f} s (0 = already built), one nvcc over both sources")
    _build.load_library()


def bound(bytes_moved, operations):
    """``(bound_ms, bound_by)`` for work that moves ``bytes_moved`` and does
    ``operations = [float32, int32]``. An SM issues 128 lanes of instructions
    per clock, so at best the float32 operations pair up into fused
    multiply-adds and share those slots with the int32 operations, which in
    turn have only 64 lanes of their own: the time for the operations is the
    larger of the two."""
    n_float, n_int = operations
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(n_float / FP32_OPS_PER_S + n_int / (FP32_OPS_PER_S / 2), n_int / INT32_OPS_PER_S)
    return float(max(t_bytes, t_ops)) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, lp_fresh=None):
    """Hold a kernel's ``(x, [lp,] stats)`` against its twin's: no bit may
    differ (the twin repeats the kernel's arithmetic operation for operation,
    and how the kernel maps its work to threads does not enter it), and a
    returned density lies within 1e-5 of a fresh evaluation of the returned
    state. Returns the largest absolute difference of the states."""
    differing = [int((g.view(torch.int32) != w.view(torch.int32)).sum())
                 for g, w in zip(got, want, strict=True)]
    max_abs = float((got[0] - want[0]).abs().max())
    print(f"{name}: elements {got[0].numel()}: bitwise-differing in x, [lp,] stats {differing}, "
          f"max |diff| of x {max_abs}")
    if any(differing):
        raise AssertionError(f"{name} disagrees with its twin")
    if lp_fresh is not None:
        lp_err = float((got[1] - lp_fresh).abs().max())
        print(f"{name}: max |lp - fresh density| {lp_err}")
        if not lp_err <= 1e-5:
            raise AssertionError(f"{name}: returned density is not the state's density")
    return max_abs


def timed_once(fn):
    """``(result, ms)`` of one call, by CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def lane_inputs(B, d, scale, key_seed):
    """States and betas from numpy seed 0, lane seeds from ``key_seed``."""
    from pigeons_tpu_torch import rng
    from pigeons_tpu_torch.ops import cuda_slice

    rs = np.random.RandomState(0)
    dev = torch.device("cuda")
    x = torch.tensor((rs.normal(size=(B, d)) * scale).astype(np.float32), device=dev)
    betas = torch.tensor(rs.uniform(0.0, 1.0, B).astype(np.float32), device=dev)
    seeds = cuda_slice.lane_seeds(rng.keys_for(rng.key(key_seed, dev), torch.arange(B, device=dev)))
    return x, betas, seeds


def k1_phase():
    """Kernel K1 against its twin at config 1's shape."""
    phase("2 kernel K1 vs twin")
    from pigeons_tpu_torch.ops import cuda_slice
    from pigeons_tpu_torch.paths import toy_mvn_path

    B = N_CHAINS * N_REPLICATES
    x, betas, seeds = lane_inputs(B, D, 1.0, 11)
    a = toy_mvn_path(D).coord_factor(betas)
    got = cuda_slice.banded_sweep_cuda(x, a, seeds)
    counts = torch.zeros(6, dtype=torch.int64, device=x.device)
    want = cuda_slice.banded_sweep_reference(x, a, seeds, phase_counts=counts)
    torch.cuda.synchronize()
    max_abs = compare("K1", got, want)
    ms = cuda_ms(lambda: cuda_slice.banded_sweep_cuda(x, a, seeds), 20)
    plain_ms = cuda_ms(lambda: cuda_slice.banded_sweep_reference(x, a, seeds), 3)
    n = [float(v) for v in counts[:5]]
    iterations, considered = sum(n), float(got[1][1].double().sum())
    # the kernel's n_evals counts an ENTER iteration twice
    n_evals = float(got[1][2].double().sum())
    if n_evals != iterations + n[ENTER] or n[ENTER] != 3 * B * D or n[INIT_R]:
        raise AssertionError(f"K1: phase counts {n} do not add up to the kernel's n_evals")
    # per element: its index pair (2) and its hash state (2 fmix32, a
    # multiply, 2 xors). ENTER queries the terms at R, the old point and L and
    # decides whether to double; every other iteration queries one term.
    need = (B * D * ops(0, 21) + iterations * LOOP
            + n[ENTER] * (2 * DRAW + LOG + M_ENTER + MORE_DBL + 3 * COORD_TERM)
            + n[DOUBLE] * (DRAW + M_DOUBLE + COORD_TERM)
            + n[SHRINK] * (DRAW + M_SHRINK + COORD_TERM) + (n[SHRINK] - considered) * M_REJECT
            + n[CHECK] * (M_CHECK + COORD_TERM))
    bound_ms, bound_by = bound(2 * 4 * B * D + (4 + 8 + 12) * B, need)
    print(f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms (medians, B={B}, d={D}, 3 passes); "
          f"{iterations:.0f} iterations: ENTER {n[ENTER]:.0f}, DOUBLE {n[DOUBLE]:.0f}, SHRINK "
          f"{n[SHRINK]:.0f} ({considered:.0f} considered), CHECK {n[CHECK]:.0f}; needs "
          f"{need[0]:.4g} float32 and {need[1]:.4g} int32 operations, "
          f"bound {bound_ms:.6f} ms by {bound_by}")
    return {"name": "banded_slice_sweep", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/banded_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:305",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def k2_mode(name, path, coord_deltas, B, d, scale, query_ops, enter_ops, lane_ops):
    """Kernel K2 against its twin for one path and mode, one pass. A density
    query needs ``query_ops``, an ENTER iteration ``enter_ops`` besides, a
    lane ``lane_ops`` once. Returns the timings and the bound of this run's
    work."""
    from pigeons_tpu_torch.ops import cuda_slice

    x, betas, seeds = lane_inputs(B, d, scale, 11)
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas, n_passes=F_PASSES)
    counts = torch.zeros(6, dtype=torch.int64, device=x.device)
    want, plain_ms = timed_once(
        lambda: cuda_slice.sweep_reference(x, betas, seeds, path, coord_deltas,
                                           n_passes=F_PASSES, phase_counts=counts))
    max_abs = compare(name, got, want, lp_fresh=cuda_slice.sweep_density(path)(got[0], betas))
    ms = cuda_ms(lambda: cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas,
                                               n_passes=F_PASSES), 20)
    n = [float(v) for v in counts[:5]]
    iterations, considered = sum(n), float(got[2][1].double().sum())
    n_evals = float(got[2][2].double().sum())
    if n_evals != iterations or n[ENTER] != F_PASSES * B * d or n[INIT_R] != n[ENTER]:
        raise AssertionError(f"{name}: phase counts {n} do not add up to the kernel's n_evals")
    # per lane: its hash state (an xor and fmix32) and what the mode needs
    need = (B * (ops(0, 9) + lane_ops) + iterations * (LOOP + query_ops)
            + n[ENTER] * (2 * DRAW + LOG + M_ENTER + enter_ops) + n[INIT_R] * MORE_DBL
            + n[DOUBLE] * (DRAW + M_DOUBLE)
            + n[SHRINK] * (DRAW + M_SHRINK) + (n[SHRINK] - considered) * M_REJECT
            + n[CHECK] * M_CHECK)
    bound_ms, bound_by = bound(2 * 4 * B * d + (4 + 8 + 4 + 12) * B, need)
    print(f"{name}: kernel {ms:.4f} ms (median of 20), twin {plain_ms:.4f} ms (one run, counting "
          f"phases), B={B}, d={d}, {F_PASSES} pass; {iterations:.0f} iterations, slowest lane "
          f"{float(got[2][2].max()):.0f}: ENTER {n[ENTER]:.0f}, INIT_R {n[INIT_R]:.0f}, DOUBLE "
          f"{n[DOUBLE]:.0f}, SHRINK {n[SHRINK]:.0f} ({considered:.0f} considered), CHECK "
          f"{n[CHECK]:.0f}; needs {need[0]:.4g} float32 and {need[1]:.4g} int32 operations, "
          f"bound {bound_ms:.6f} ms by {bound_by}")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def k2_phase():
    """Kernel K2 against its twin: full mode at the funnel path's shape (its
    main path), delta mode at config 1's shape."""
    phase("2b kernel K2 vs twin")
    from pigeons_tpu_torch import funnel
    from pigeons_tpu_torch.paths import toy_mvn_path

    target = funnel(F_NX)
    d = F_NX + 1
    # full mode: every query is one evaluation of the density, and so is the
    # lane's starting density
    full = k2_mode("K2 full (funnel)", target.create_path(target.default_reference()), False,
                   F_CHAINS * F_REPLICATES, d, 2.0, funnel_density_ops(d), ops(0),
                   funnel_density_ops(d))
    # delta mode: a query is base + term (5), ENTER also forms base = lp - term
    # (5); a lane needs the factor once and the full density twice
    delta = k2_mode("K2 delta (toy MVN)", toy_mvn_path(D), True, N_CHAINS * N_REPLICATES, D, 1.0,
                    COORD_TERM + ops(1), COORD_TERM + ops(1),
                    TOY_FACTOR + 2 * toy_density_ops(D))
    return {"name": "slice_sweep", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/sweep_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:94", **full, "delta_mode": delta}


def eval_rate(pt):
    """Density evaluations per second of the last round, counted as
    ``bench.py:_eval_rate`` counts them: explorer queries plus the runtime's
    2N fused evaluations per scan and ladder."""
    rep = pt.reports[-1]
    evals = float(np.sum(pt.reduced.exp_steps)) + 2.0 * pt.n_chains * rep.n_scans * pt.n_replicates
    return evals / rep.wall_time_s


def config1_phase():
    """Bench config 1 end to end; returns the kernel launches it made."""
    phase("3 config 1")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pt = PT(Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                   seed=SEED, explorer=SliceSamplerCUDA(), show_report=False, device="cuda"))
    for _ in range(WARMUP_ROUNDS):
        pt.run_round(n_scans=WARMUP_SCANS)
    pt.run_round(n_scans=MEASURE_SCANS)
    launches = dict(SliceSamplerCUDA.launches)
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
    if launches != {"banded_slice_sweep": scans, "slice_sweep": 0}:
        raise AssertionError(f"kernel launches {launches} for {scans} scans of K1")
    if not (np.abs(mean).max() < 0.02 and np.abs(var / 0.1 - 1).max() < 0.05):
        raise AssertionError("target moments off")
    if not abs(pt.global_barrier - JAX_BARRIER) < 0.3:
        raise AssertionError("global barrier off")
    if not math.isfinite(rep.log_z_estimate):
        raise AssertionError("logZ not finite")
    return launches["banded_slice_sweep"]


def funnel_inputs(**kw):
    from pigeons_tpu_torch import Inputs, SliceSamplerCUDA, funnel

    return Inputs(target=funnel(F_NX), n_chains=F_CHAINS, n_replicates=F_REPLICATES, seed=SEED,
                  explorer=SliceSamplerCUDA(n_passes=F_PASSES), show_report=False, device="cuda",
                  **kw)


def funnel_phase():
    """Neal's funnel end to end at config 3's width; returns the launches of
    K2 it made."""
    phase("3b funnel")
    from pigeons_tpu_torch import PT, SliceSamplerCUDA

    print(f"timed round cut from config 3's {F_CONFIG3_SCANS} scans to {F_MEASURE_SCANS}: "
          "the port's scan is still bound by eager launches")
    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pt = PT(funnel_inputs())
    for _ in range(F_WARMUP_ROUNDS):
        pt.run_round(n_scans=F_WARMUP_SCANS)
    pt.run_round(n_scans=F_MEASURE_SCANS)
    launches = dict(SliceSamplerCUDA.launches)
    scans = F_WARMUP_ROUNDS * F_WARMUP_SCANS + F_MEASURE_SCANS
    rep = pt.reports[-1]
    y = pt.sample_array()[:, 0]  # the target chains' y over the timed round, all ladders
    print(f"kernel launches {launches} for {scans} scans")
    print(f"timed round: {F_MEASURE_SCANS} scans in {rep.wall_time_s:.4f} s "
          f"({rep.wall_time_s / F_MEASURE_SCANS * 1e3:.3f} ms per scan), {eval_rate(pt):.6g} evals/s, "
          f"{float(np.sum(pt.reduced.exp_steps)) / (F_MEASURE_SCANS * F_CHAINS * F_REPLICATES):.2f} "
          f"queries per lane and scan, peak device memory {rep.peak_memory_bytes} B")
    exact_log_z = -0.5 * (F_NX + 1) * math.log(2 * math.pi * 9.0)  # the reference is unnormalized
    print(f"y over {y.size} pooled draws: mean {y.mean():.6f}, variance {y.var():.6f} "
          f"(JAX package, same seed: {F_JAX_Y_MEAN}, {F_JAX_Y_VAR}; in equilibrium 0, 9)")
    print(f"barrier {pt.global_barrier:.6f} (JAX package: this run {F_JAX_RUN_BARRIER}, adapted "
          f"{F_JAX_BARRIER}), logZ {rep.log_z_estimate:.6f} (JAX package {F_JAX_LOG_Z}, exact "
          f"{exact_log_z:.4f})")
    print(f"round trips {pt.n_round_trips}, restarts {pt.n_tempered_restarts}, "
          f"swap accept mean {rep.mean_swap_accept:.4f}")
    if launches != {"banded_slice_sweep": 0, "slice_sweep": scans}:
        raise AssertionError(f"kernel launches {launches} for {scans} scans of K2")
    if not abs(rep.log_z_estimate - exact_log_z) < 0.1:
        raise AssertionError("logZ off")
    if not abs(pt.global_barrier - F_JAX_BARRIER) < 0.5:
        raise AssertionError("global barrier off")
    for name, got, want in (("y mean", y.mean(), F_JAX_Y_MEAN),
                            ("y variance", y.var(), F_JAX_Y_VAR),
                            ("barrier", pt.global_barrier, F_JAX_RUN_BARRIER),
                            ("logZ", rep.log_z_estimate, F_JAX_LOG_Z)):
        if not abs(got / want - 1.0) < 1e-3:
            raise AssertionError(f"{name} {got} is off the JAX package's {want} for this run")
    if pt.n_round_trips != F_JAX_ROUND_TRIPS:
        raise AssertionError(f"{pt.n_round_trips} round trips, the JAX package's run has "
                             f"{F_JAX_ROUND_TRIPS}")
    return launches["slice_sweep"]


def small_reference_phase():
    """Small runs on the card (kernels) against the same runs on the CPU
    (twins), for the toy path (K1) and the funnel path (K2): same swaps, same
    states within 1e-6."""
    phase("6 small runs, card vs CPU")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, funnel, toy_mvn_target

    for name, target, explorer in (("toy MVN", toy_mvn_target(6), SliceSamplerCUDA()),
                                   ("funnel", funnel(3), SliceSamplerCUDA(n_passes=F_PASSES))):
        g, c = (PT(Inputs(target=target, n_chains=5, n_replicates=8, seed=4, n_rounds=4,
                          explorer=explorer, show_report=False, device=dev)).run()
                for dev in ("cuda", "cpu"))
        same_perm = (torch.equal(g.chain_of.cpu(), c.chain_of)
                     and torch.equal(g.replica_of.cpu(), c.replica_of))
        diff = float((g.states.cpu() - c.states).abs().max())
        print(f"{name}: permutations equal {same_perm}, max |state diff| {diff}, "
              f"barrier {g.global_barrier:.6f} vs {c.global_barrier:.6f}")
        if not same_perm or diff > 1e-6 or not np.isfinite(g.sample_array()).all():
            raise AssertionError(f"{name}: card run disagrees with the CPU run")


def determinism_phase():
    phase("4 determinism")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    def config1():
        return Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                      seed=SEED, n_rounds=2, explorer=SliceSamplerCUDA(), show_report=False,
                      device="cuda")

    for name, make in (("config 1", config1), ("funnel", lambda: funnel_inputs(n_rounds=3))):
        a, b = (PT(make()).run() for _ in range(2))
        same = (torch.equal(a.chain_of, b.chain_of) and torch.equal(a.replica_of, b.replica_of)
                and torch.equal(a.states, b.states))
        print(f"{name}: two {a.round_idx}-round runs bitwise equal: {same}")
        if not same:
            raise AssertionError(f"{name}: same seed, different runs")


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
    """torch.profiler over one round of each path."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    config1 = Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                     seed=SEED, explorer=SliceSamplerCUDA(), show_report=False, device="cuda")
    os.makedirs("chiprun_out", exist_ok=True)
    for name, inputs, n_scans, kernel in (("config1", config1, WARMUP_SCANS, "banded_slice"),
                                          ("funnel", funnel_inputs(), F_WARMUP_SCANS, "slice_sweep")):
        pt = PT(inputs)
        pt.run_round(n_scans=n_scans)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pt.run_round(n_scans=n_scans)
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(f"chiprun_out/profile_{name}.txt", "w") as f:
            f.write(table)
        dev_events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        device_us = sum(e.self_device_time_total for e in dev_events)
        kernel_us = sum(e.self_device_time_total for e in dev_events if kernel in e.key)
        wall = pt.reports[-1].wall_time_s
        print(f"profile {name}: {n_scans} scans, wall {wall:.4f} s, device busy "
              f"{device_us / 1e3:.3f} ms ({device_us / 1e6 / wall:.2%} of wall) over "
              f"{sum(e.count for e in dev_events)} device ops; {kernel} kernel "
              f"{kernel_us / 1e3:.3f} ms")
        print(table[:5000])


def main():
    device_phase()
    build_phase()
    k1, k2 = k1_phase(), k2_phase()
    k1["launches"] = config1_phase()
    k2["launches"] = funnel_phase()
    determinism_phase()
    quickstart_phase()
    small_reference_phase()
    if "--profile" in sys.argv[1:]:
        profile_phase()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - T0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


T0 = time.perf_counter()

if __name__ == "__main__":
    main()
