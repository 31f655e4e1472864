"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--parent-csrc DIR]

Run from the repository root. It builds the port's CUDA kernels from
``pigeons_tpu_torch/csrc`` (one ``nvcc`` call, the sources in parallel),
holds each against its plain torch twin at the main paths' shapes (no bit
may differ; K1 with each of its two coordinate terms, K2 in both modes, with
each ``BayesianModel`` density for 1, 8, 16 and 32 threads per lane, and under
a variational reference, each at the batch of the path that launches it), and
drives these paths end to end through
``PT(Inputs(...))``:

* bench config 1: NRPT on the d=100 toy MVN, 10 chains x 2048 ladders, banded
  slice sampler (kernel K1);
* Neal's funnel, the target of bench config 3: 12 chains x 256 ladders, d=10,
  general slice sampler (kernel K2, full mode). K2's delta mode is held
  against its twin at config 1's shape;
* bench config 4: stabilized variational PT on the d=100 toy MVN, 10 + 10
  chains x 256 ladders, K1 with its variational coordinate term; the timed
  round is the first that runs under the fitted reference;
* the hierarchical normal model of bench config 5 (20 groups x 10
  observations, d=23) from its prior to its posterior: 32 chains x 256
  ladders, K2 reading the observations and the prior table from device
  arrays; the same at 16 ladders, held to the JAX package's numbers;
* the unidentifiable binomial (logZ against its exact value), the
  non-centred eight schools, logistic regression on 200 observations (bench
  config 2's target), and the funnel under a fitted Gaussian reference on two
  legs (K2 with ``isvar``, ``mean``, ``std`` and ``active`` as arrays).

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
path to ``chiprun_out/profile_config1.txt``, ``profile_funnel.txt``,
``profile_config4.txt`` and ``profile_hierarchical.txt``. ``--parent-csrc
DIR`` builds an earlier version of the CUDA sources (with this tree's entry
points) from ``DIR`` and times its K2 beside this tree's on the same inputs,
as ``parent_ms`` in the kernels line; its outputs must be this tree's, bit
for bit.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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

# bench config 4 (bench.py:266-295): two legs of 10 chains, 256 ladders; six
# warm-up rounds, so that the reference fitted after round 6 is first used in
# the timed round
V_CHAINS, V_REPLICATES, V_WARMUP_ROUNDS, V_WARMUP_SCANS = 10, 256, 6, 8
V_MEASURE_SCANS, V_CONFIG4_SCANS = 64, 1024
# log of the integral of exp(-5 |x|^2) over R^100: the variational leg's
# stepping stone starts from a normalized reference, so it estimates this
V_LOG_Z = 0.5 * D * math.log(2.0 * math.pi / 10.0)

# the hierarchical normal path: bench config 5's target (BASELINE.json: "30+
# chains"; pigeons_tpu/models/library.py:409-430) at the funnel cell's ladder
# count; rounds of doubling length, the last one timed
H_CHAINS, H_REPLICATES, H_PASSES, H_ROUNDS = 32, 256, 1, (2, 4, 8, 16, 32, 64)
# The same rounds at 16 ladders as the JAX package runs them on the CPU
# (``JAX_PLATFORMS=cpu python tests/bayesian_reference_run.py --ladders 16``,
# the line of the 64-scan round): pooled posterior means of the scalar
# parameters, barrier and logZ. The packages run the same law from initial
# states that differ in last bits (the prior's half-Cauchy draws), so the
# card's runs are held to these within Monte Carlo error, as stated beside
# each tolerance in hierarchical_phase.
H_JAX_LADDERS = 16
H_JAX = {"mu": 0.667063, "tau": 1.017755, "sigma": 0.477138, "barrier": 7.937929,
         "logZ": -176.510125}
# the smaller BayesianModel paths (unid, eight schools): 10 chains x 64
# ladders; the funnel on two legs: 6 + 6 chains x 64 ladders
S_CHAINS, S_REPLICATES, S_ROUNDS = 10, 64, (2, 4, 8, 16, 32)
VF_CHAINS, VF_REPLICATES = 6, 64
# logistic regression at bench config 2's width (bench.py:335-344: 10 chains x
# 1,024 ladders, seed 1), rounds of 2..16 scans, then a timed 32-scan round
LR_CHAINS, LR_REPLICATES, LR_ROUNDS = 10, 1024, (2, 4, 8, 16, 32)

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
# the variational term of a lane that follows the fitted reference: the
# branch (1), q (a subtract and a division), its square and half of it (2),
# l_ref (1), the target's term (2), two guarded products (a comparison, a
# select and a multiply each), their sum and the NaN guard (2)
VARIATIONAL_TERM = ops(17)
# interpolate() with its two guarded products (8) and the NaN guard (2)
INTERPOLATE = ops(10)
# cephes_log1pf below sqrt(2) - 1 (the branch a prior's z^2 mostly takes is
# charged for all): x^2, six and five fused multiply-adds and an add for the
# two polynomials, a division, two multiplies, an fma, an add, the branch (3)
LOG1P = ops(33)
# softplus: max (2), |x| and its negation (2), exp, log1p, the add, the NaN
# select (2); sigmoid: a negation, exp, an add, a division
SOFTPLUS, SIGMOID = EXP + LOG1P + ops(7), EXP + ops(3)
# one observation's normal term with a scale that is no constant: the mean by
# fma (2), z (a subtract and a division), two fused multiply-adds, and the
# index of the observation's group
OBSERVATION = ops(8, 1)
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
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


PARENT = []  # the library built from --parent-csrc, if any


@contextlib.contextmanager
def parent_library():
    """The port's wrappers call the parent's library inside this block."""
    from pigeons_tpu_torch import _build

    saved = _build.load_library
    _build.load_library = lambda: PARENT[0]
    try:
        yield
    finally:
        _build.load_library = saved


def parent_phase():
    """Builds the sources of ``--parent-csrc DIR``, if given."""
    if "--parent-csrc" not in sys.argv[1:]:
        return
    phase("1b build the parent's sources")
    from pigeons_tpu_torch import _build

    csrc = Path(sys.argv[sys.argv.index("--parent-csrc") + 1]).resolve()
    path, seconds = _build.build(csrc=csrc)
    print(f"built {path.name} from {csrc} in {seconds:.3f} s")
    PARENT.append(_build.open_library(path))


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


def parent_ms(name, fn, got, ms):
    """With --parent-csrc: ``fn`` on the parent's library must give ``got``;
    its time, the mean of its two turns in parent, this tree, this tree,
    parent (each the median of 20), beside this tree's ``ms`` (None without a
    parent)."""
    if not PARENT:
        return None

    def parent():
        with parent_library():
            return fn()

    compare(f"{name}, the parent's sources", parent(), got)
    turns = {"parent": [], "this tree": []}
    for who in ("parent", "this tree", "this tree", "parent"):
        turns[who].append(cuda_ms(parent if who == "parent" else fn, 20))
    t_parent = float(np.mean(turns["parent"]))
    print(f"{name}: this tree {ms:.4f} ms, in turns "
          + ", ".join(f"{who} {' / '.join(f'{t:.4f}' for t in ts)}" for who, ts in turns.items())
          + f" ms; the parent's mean {t_parent:.4f} ms")
    return t_parent


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
    parent = parent_ms("K1", lambda: cuda_slice.banded_sweep_cuda(x, a, seeds), got, ms)
    plain_ms = cuda_ms(lambda: cuda_slice.banded_sweep_reference(x, a, seeds), 3)
    n = [float(v) for v in counts[:5]]
    iterations, considered = sum(n), float(got[1][1].double().sum())
    # the kernel's n_evals counts an ENTER iteration twice
    n_evals = float(got[1][2].double().sum())
    if n_evals != iterations + n[ENTER] or n[ENTER] != 3 * B * D or n[INIT_R]:
        raise AssertionError(f"K1: phase counts {n} do not add up to the kernel's n_evals")
    need = k1_need(B * D, n, considered, COORD_TERM)
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
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "parent_ms": parent}


def k1_need(elements, n, considered, term):
    """Operations of K1 for ``elements`` elements whose machines spent ``n``
    iterations in each phase, ``considered`` of the SHRINK ones passing the
    vertical test, with ``term`` operations to a query. Per element: its index
    pair (2) and its hash state (2 fmix32, a multiply, 2 xors). ENTER queries
    the terms at R, the old point and L and decides whether to double; every
    other iteration queries one term."""
    return (elements * ops(0, 21) + sum(n) * LOOP
            + n[ENTER] * (2 * DRAW + LOG + M_ENTER + MORE_DBL + 3 * term)
            + n[DOUBLE] * (DRAW + M_DOUBLE + term)
            + n[SHRINK] * (DRAW + M_SHRINK + term) + (n[SHRINK] - considered) * M_REJECT
            + n[CHECK] * (M_CHECK + term))


def k1_variational_phase():
    """Kernel K1 with its variational term against the twin at config 4's
    shape: lanes of both legs, the reference active with a mean and std that
    differ by coordinate; and, with the reference not active yet, against the
    toy term's launch."""
    phase("2c kernel K1, variational term, vs twin")
    from pigeons_tpu_torch.ops import cuda_slice
    from pigeons_tpu_torch.paths import toy_mvn_path

    B = 2 * V_CHAINS * V_REPLICATES
    x, betas, seeds = lane_inputs(B, D, 0.5, 13)
    dev = x.device
    path = toy_mvn_path(D)
    a = path.coord_factor(betas)
    rs = np.random.RandomState(4)
    # each ladder's first V_CHAINS lanes are its variational leg
    is_var = (torch.arange(B, device=dev) % (2 * V_CHAINS)) < V_CHAINS
    mean = torch.tensor((rs.normal(size=D) * 0.05).astype(np.float32), device=dev)
    std = torch.tensor((np.sqrt(0.1) * np.exp(rs.normal(size=D) * 0.2)).astype(np.float32),
                       device=dev)
    a_target = float(path.coord_factor(torch.ones(())))

    def term(active, lanes=slice(None)):
        return cuda_slice.VariationalTerm(betas[lanes], is_var.float()[lanes],
                                          torch.tensor([active], device=dev), a_target, mean, std)

    term_on = term(1.0)
    got = cuda_slice.banded_sweep_cuda(x, a, seeds, variational=term_on)
    # the twin leg by leg (elements are independent), so that each leg's
    # iterations are counted by phase for the bound
    want_x, want_stats = torch.empty_like(x), torch.empty((3, B), device=dev)
    counts = {}
    for leg, lanes in (("variational", is_var), ("fixed", ~is_var)):
        counts[leg] = torch.zeros(6, dtype=torch.int64, device=dev)
        want_x[lanes], want_stats[:, lanes] = cuda_slice.banded_sweep_reference(
            x[lanes], a[lanes], seeds[lanes], phase_counts=counts[leg],
            variational=term(1.0, lanes))
    torch.cuda.synchronize()
    max_abs = compare("K1 variational", got, (want_x, want_stats))
    toy = cuda_slice.banded_sweep_cuda(x, a, seeds)
    compare("K1 variational, reference not active, vs the toy term's launch",
            cuda_slice.banded_sweep_cuda(x, a, seeds, variational=term(0.0)), toy)
    if torch.equal(got[0], toy[0]):
        raise AssertionError("K1 variational: the active reference changed nothing")
    ms = cuda_ms(lambda: cuda_slice.banded_sweep_cuda(x, a, seeds, variational=term_on), 20)
    parent = parent_ms("K1 variational",
                       lambda: cuda_slice.banded_sweep_cuda(x, a, seeds, variational=term_on), got,
                       ms)
    toy_ms = cuda_ms(lambda: cuda_slice.banded_sweep_cuda(x, a, seeds), 20)
    _, plain_ms = timed_once(lambda: cuda_slice.banded_sweep_reference(x, a, seeds,
                                                                       variational=term_on))
    need, iterations = ops(0), 0.0
    for leg, lanes, term_ops in (("variational", is_var, VARIATIONAL_TERM),
                                 ("fixed", ~is_var, COORD_TERM)):
        n = [float(v) for v in counts[leg][:5]]
        stats = got[1][:, lanes].double().sum(1)
        n_lanes = int(lanes.sum())
        if float(stats[2]) != sum(n) + n[ENTER] or n[ENTER] != 3 * n_lanes * D or n[INIT_R]:
            raise AssertionError(f"K1 variational: {leg} leg's phase counts {n} do not add up")
        need = need + k1_need(n_lanes * D, n, float(stats[1]), term_ops)
        iterations += sum(n)
        print(f"{leg} leg: {n_lanes} lanes, {sum(n):.0f} iterations: ENTER {n[ENTER]:.0f}, DOUBLE "
              f"{n[DOUBLE]:.0f}, SHRINK {n[SHRINK]:.0f} ({float(stats[1]):.0f} considered), CHECK "
              f"{n[CHECK]:.0f}")
    # once for a coordinate its log_norm (a log, two multiplies and the half);
    # once for a variational lane 1 - beta and the flag
    need = need + D * (LOG + ops(3)) + B * ops(1, 2)
    bound_ms, bound_by = bound(2 * 4 * B * D + (4 + 8 + 12 + 4 + 4) * B + 8 * D + 4, need)
    print(f"kernel {ms:.4f} ms, the toy term on the same inputs {toy_ms:.4f} ms (medians of 20), "
          f"twin {plain_ms:.4f} ms (one run), B={B}, d={D}, 3 passes; {iterations:.0f} iterations; "
          f"needs {need[0]:.4g} float32 and {need[1]:.4g} int32 operations, "
          f"bound {bound_ms:.6f} ms by {bound_by}")
    return {"name": "banded_slice_sweep (variational term)", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/banded_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:305",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "toy_term_ms": toy_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "parent_ms": parent}


def k2_mode(name, path, coord_deltas, B, d, scale, query_ops, enter_ops, lane_ops,
            prepare_ops=ops(0), prepare_coords=(), variational=None, variational_ops=ops(0),
            extra_bytes=0, groups=()):
    """Kernel K2 against its twin for one path and mode, one pass. A density
    query needs ``query_ops`` (a query of a coordinate in ``prepare_coords``
    ``prepare_ops`` besides; a query of a lane that follows the variational
    reference ``variational_ops`` instead), an ENTER iteration ``enter_ops``
    besides, a lane ``lane_ops`` once. ``variational`` is ``None`` or the
    keywords ``isvar`` and ``ref_params`` of a variational launch. ``groups``:
    numbers of threads per lane that must give the same bits as the
    launcher's own choice. Returns the timings and the bound of this run's
    work."""
    from pigeons_tpu_torch.ops import cuda_slice

    kw = variational or {}
    x, betas, seeds = lane_inputs(B, d, scale, 11)
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas, n_passes=F_PASSES, **kw)
    counts = torch.zeros(6, dtype=torch.int64, device=x.device)
    by_coord = torch.zeros(d, dtype=torch.int64, device=x.device)
    want, plain_ms = timed_once(
        lambda: cuda_slice.sweep_reference(x, betas, seeds, path, coord_deltas, n_passes=F_PASSES,
                                           phase_counts=counts, coord_counts=by_coord, **kw))
    max_abs = compare(name, got, want,
                      lp_fresh=cuda_slice.sweep_density(path, **kw)(got[0], betas))
    for group in groups:
        compare(f"{name}, {group} threads per lane",
                cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas, n_passes=F_PASSES,
                                      group=group, **kw), want)
    ms = cuda_ms(lambda: cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas,
                                               n_passes=F_PASSES, **kw), 20)
    parent = parent_ms(name, lambda: cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas,
                                                           n_passes=F_PASSES, **kw), got, ms)
    n = [float(v) for v in counts[:5]]
    iterations, considered = sum(n), float(got[2][1].double().sum())
    n_evals = float(got[2][2].double().sum())
    if n_evals != iterations or n[ENTER] != F_PASSES * B * d or n[INIT_R] != n[ENTER]:
        raise AssertionError(f"{name}: phase counts {n} do not add up to the kernel's n_evals")
    # a lane's queries are its n_evals; its starting density is one more
    follows = torch.zeros(B, dtype=torch.bool, device=x.device)
    if variational is not None and float(kw["ref_params"]["active"]) > 0:
        follows = kw["isvar"] > 0
    q_var = float(got[2][2][follows].double().sum()) + float(follows.sum())
    q_prepare = float(by_coord[list(prepare_coords)].sum()) if prepare_coords else 0.0
    # per lane: its hash state (an xor and fmix32) and what the mode needs
    need = (B * (ops(0, 9) + lane_ops) + iterations * LOOP + (iterations - (q_var - float(follows.sum()))) * query_ops
            + q_var * variational_ops + q_prepare * prepare_ops
            + n[ENTER] * (2 * DRAW + LOG + M_ENTER + enter_ops) + n[INIT_R] * MORE_DBL
            + n[DOUBLE] * (DRAW + M_DOUBLE)
            + n[SHRINK] * (DRAW + M_SHRINK) + (n[SHRINK] - considered) * M_REJECT
            + n[CHECK] * M_CHECK)
    bound_ms, bound_by = bound(2 * 4 * B * d + (4 + 8 + 4 + 12) * B + extra_bytes, need)
    print(f"{name}: kernel {ms:.4f} ms (median of 20), twin {plain_ms:.4f} ms (one run, counting "
          f"phases), B={B}, d={d}, {F_PASSES} pass; {iterations:.0f} iterations, slowest lane "
          f"{float(got[2][2].max()):.0f}: ENTER {n[ENTER]:.0f}, INIT_R {n[INIT_R]:.0f}, DOUBLE "
          f"{n[DOUBLE]:.0f}, SHRINK {n[SHRINK]:.0f} ({considered:.0f} considered), CHECK "
          f"{n[CHECK]:.0f}; {q_prepare:.0f} queries of coordinates that prepare reads, {q_var:.0f} "
          f"of lanes under the variational reference; needs {need[0]:.4g} float32 and "
          f"{need[1]:.4g} int32 operations, bound {bound_ms:.6f} ms by {bound_by}, "
          f"{bound_ms / ms:.2%} of the kernel's time")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "parent_ms": parent}


def prior_ops(prior):
    """One evaluation of a prior table (densities.cuh: log_prior): a row's
    log-Jacobian (positive: the sum of its coordinates; interval: two
    softplus, a negation each and two adds a coordinate), its density (normal:
    six operations a coordinate; half-Cauchy: exp, a multiply, a square,
    log1p and a subtract; uniform: a constant) and their adds."""
    from pigeons_tpu_torch.models import distributions as D_

    total = ops(0)
    for _, size, dist, bijector, *_ in prior:
        if bijector == D_.POSITIVE:
            total = total + ops(size)
        elif bijector == D_.INTERVAL:
            total = total + size * (2 * SOFTPLUS + ops(5))
        if dist == D_.NORMAL:
            total = total + ops(6 * size + 1)
        elif dist == D_.HALF_CAUCHY:
            total = total + size * (EXP + LOG1P + ops(4)) + ops(1)
    return total


def k2_bayesian_phase():
    """Kernel K2 with each ``BayesianModel`` density against its twin at the
    batch of the model's own path below (the hierarchical cell's 8,192 lanes,
    the logistic regression's 10,240, 640 for the others), for the launcher's
    choice of threads per lane and for 1, 8, 16 and 32. Returns the kernels'
    entries by name."""
    phase("2d kernel K2, BayesianModel densities, vs twin")
    from pigeons_tpu_torch import (eight_schools, hierarchical_normal, logistic_regression,
                                   unid_target)

    B, B_small = H_CHAINS * H_REPLICATES, S_CHAINS * S_REPLICATES
    dev = torch.device("cuda")
    out = {}
    # hierarchical normal: 200 observation terms and their 199 + 3 adds, the
    # prior, prior + likelihood and the interpolation; prepare (two exp and a
    # negation) for a query of mu, log tau or log sigma
    model = hierarchical_normal().to(dev)
    path = model.create_path(model.default_reference())
    density = path.device_density()
    n_obs = density.arrays[0].numel()
    query = n_obs * OBSERVATION + ops(n_obs + 2) + prior_ops(density.prior) + ops(1) + INTERPOLATE
    d = model.dim
    out["hierarchical_normal"] = k2_mode(
        "K2 full (hierarchical normal)", path, False, B, d, 1.0, query, ops(0),
        query + 2 * EXP + ops(1), prepare_ops=2 * EXP + ops(1), prepare_coords=(d - 3, d - 2, d - 1),
        extra_bytes=4 * n_obs, groups=(1, 8, 16, 32))
    # eight schools: 8 observation terms (their scale's log is read, not
    # computed: one negation more) and 7 adds; prepare is one exp
    model = eight_schools().to(dev)
    path = model.create_path(model.default_reference())
    density = path.device_density()
    d = model.dim
    query = 8 * (OBSERVATION + ops(1)) + ops(7) + prior_ops(density.prior) + ops(1) + INTERPOLATE
    out["eight_schools"] = k2_mode(
        "K2 full (eight schools)", path, False, B_small, d, 1.0, query, ops(0), query + EXP,
        prepare_ops=EXP, prepare_coords=(d - 2, d - 1), extra_bytes=4 * 3 * 8,
        groups=(1, 8, 16, 32))
    # unid: two sigmoids and their product for every query, then log, log1p of
    # the negation and two fused multiply-adds
    model = unid_target()
    path = model.create_path(model.default_reference())
    density = path.device_density()
    query = (2 * SIGMOID + ops(1) + LOG + LOG1P + ops(5) + prior_ops(density.prior) + ops(1)
             + INTERPOLATE)
    out["unid"] = k2_mode("K2 full (unid)", path, False, B_small, 2, 1.0, query, ops(0), query,
                          groups=(1,))
    # logistic regression: for each observation a row of the design matrix
    # times w (a multiply and d - 2 fused multiply-adds), + b, y z - softplus(z)
    # (a multiply, softplus, a subtract); their sum by windows (n + 7 adds)
    model = logistic_regression().to(dev)
    path = model.create_path(model.default_reference())
    density = path.device_density()
    d, n_obs = model.dim, density.arrays[1].numel()
    query = (n_obs * (ops(2 * (d - 2) + 1 + 3) + SOFTPLUS) + ops(n_obs + 7)
             + prior_ops(density.prior) + ops(1) + INTERPOLATE)
    out["logistic_regression"] = k2_mode(
        "K2 full (logistic regression)", path, False, LR_CHAINS * LR_REPLICATES, d, 1.0, query,
        ops(0), query, extra_bytes=4 * n_obs * d, groups=(1, 8, 16, 32))
    return {name: {"name": f"slice_sweep ({name})", "route": "cuda",
                   "source": "pigeons_tpu_torch/csrc/sweep_slice.cu",
                   "replaces": "pigeons_tpu/ops/pallas_slice.py:94", **entry}
            for name, entry in out.items()}


def k2_variational_phase():
    """Kernel K2 under a variational reference at the shape of the funnel's
    two-leg path below (6 + 6 chains x 64 ladders): lanes of both legs, the reference active with a mean and std that differ
    by coordinate; and, with the reference not active yet, against the plain
    funnel launch."""
    phase("2e kernel K2 under a variational reference vs twin")
    from pigeons_tpu_torch import GaussianReference, VariationalPath, funnel
    from pigeons_tpu_torch.ops import cuda_slice

    target = funnel(F_NX)
    d, B = F_NX + 1, 2 * VF_CHAINS * VF_REPLICATES
    fixed = target.create_path(target.default_reference())
    path = VariationalPath(fixed, GaussianReference())
    dev = torch.device("cuda")
    rs = np.random.RandomState(4)
    # each ladder's first half is its variational leg
    isvar = ((torch.arange(B, device=dev) % (2 * VF_CHAINS)) < VF_CHAINS).float()

    mean = torch.tensor((rs.normal(size=d) * 0.3).astype(np.float32), device=dev)
    std = torch.tensor((2.0 * np.exp(rs.normal(size=d) * 0.3)).astype(np.float32), device=dev)

    def reference(active):
        return {"isvar": isvar, "ref_params": {"mean": mean, "std": std,
                                               "active": torch.tensor(active, device=dev)}}

    # a variational lane's query: the target as before, the reference's sum of
    # squares replaced by d terms of five operations and their adds, one add
    # for 0 + target
    var_query = funnel_density_ops(d) - sum_squares_ops(d) - ops(1) + ops(6 * d)
    entry = k2_mode("K2 full (funnel, variational reference)", path, False, B, d, 2.0,
                    funnel_density_ops(d), ops(0), funnel_density_ops(d),
                    variational=reference(1.0), variational_ops=var_query,
                    extra_bytes=4 * B + 8 * d + 4, groups=(1, 8, 16, 32))
    x, betas, seeds = lane_inputs(B, d, 2.0, 11)
    plain = cuda_slice.sweep_cuda(x, betas, seeds, fixed, n_passes=F_PASSES)
    off = reference(0.0)
    compare("K2 variational, reference not active, vs the plain funnel launch",
            cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=F_PASSES, **off), plain)
    on = reference(1.0)
    if torch.equal(cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=F_PASSES, **on)[0], plain[0]):
        raise AssertionError("K2 variational: the active reference changed nothing")
    entry["fixed_path_ms"] = cuda_ms(
        lambda: cuda_slice.sweep_cuda(x, betas, seeds, fixed, n_passes=F_PASSES), 20)
    print(f"the plain funnel launch on the same inputs {entry['fixed_path_ms']:.4f} ms")
    return {"name": "slice_sweep (funnel, variational reference)", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/sweep_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:94", **entry}


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
    if launches != {"banded_slice_sweep": scans, "banded_slice_sweep_variational": 0,
                    "slice_sweep": 0}:
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
    if launches != {"banded_slice_sweep": 0, "banded_slice_sweep_variational": 0,
                    "slice_sweep": scans}:
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


def config4_inputs(**kw):
    from pigeons_tpu_torch import Inputs, SliceSamplerCUDA, toy_mvn_target

    return Inputs(target=toy_mvn_target(D), n_chains=V_CHAINS, n_chains_variational=V_CHAINS,
                  n_replicates=V_REPLICATES, seed=SEED, explorer=SliceSamplerCUDA(),
                  show_report=False, device="cuda", **kw)


def config4_phase():
    """Bench config 4 end to end: two-leg stabilized variational PT at full
    width; returns the launches of K1's variational term it made."""
    phase("3c config 4")
    from pigeons_tpu_torch import PT, SliceSamplerCUDA

    print(f"timed round cut from config 4's {V_CONFIG4_SCANS} scans to {V_MEASURE_SCANS}: "
          "the port's scan is still bound by eager launches")
    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pt = PT(config4_inputs())
    for _ in range(V_WARMUP_ROUNDS):
        pt.run_round(n_scans=V_WARMUP_SCANS)
    fitted_from = pt.reduced.online_n
    pt.run_round(n_scans=V_MEASURE_SCANS)  # round 7: the first under the fitted reference
    launches = dict(SliceSamplerCUDA.launches)
    scans = V_WARMUP_ROUNDS * V_WARMUP_SCANS + V_MEASURE_SCANS
    rep = pt.reports[-1]
    mean, var = pt.mean(), pt.var()
    var_barriers = [round(float(r.global_barrier_variational), 4) for r in pt.reports]
    active = float(pt._ref_params["active"])
    print(f"kernel launches {launches} for {scans} scans")
    print(f"timed round: {V_MEASURE_SCANS} scans in {rep.wall_time_s:.4f} s "
          f"({rep.wall_time_s / V_MEASURE_SCANS * 1e3:.3f} ms per scan), {eval_rate(pt):.6g} evals/s, "
          f"peak device memory {rep.peak_memory_bytes} B")
    print(f"reference active {active}, fitted after round {V_WARMUP_ROUNDS} from {fitted_from:.0f} "
          f"pooled target samples; variational barrier by round {var_barriers}")
    print(f"restarts {pt.n_tempered_restarts} ({pt.n_tempered_restarts / rep.wall_time_s * 3600:.6g} "
          f"per hour), round trips {pt.n_round_trips}, swap accept mean {rep.mean_swap_accept:.4f}")
    print(f"max|mean| {np.abs(mean).max():.5f}, max|var/0.1-1| {np.abs(var / 0.1 - 1).max():.5f}")
    print(f"variational barrier {pt.global_barrier_variational:.4f}, fixed-leg barrier "
          f"{pt.global_barrier:.4f} (config 1: {JAX_BARRIER})")
    print(f"logZ {rep.log_z_estimate:.4f} (exact {V_LOG_Z:.4f})")
    if launches != {"banded_slice_sweep": 0, "banded_slice_sweep_variational": scans,
                    "slice_sweep": 0}:
        raise AssertionError(f"kernel launches {launches} for {scans} scans of K1's variational term")
    if active != 1.0 or pt.round_idx != V_WARMUP_ROUNDS + 1:
        raise AssertionError("the timed round did not run under the fitted reference")
    if not (np.abs(mean).max() < 0.02 and np.abs(var / 0.1 - 1).max() < 0.05):
        raise AssertionError("target moments off")
    if not pt.global_barrier_variational <= 0.5:
        raise AssertionError("variational barrier did not collapse")
    if not abs(pt.global_barrier - JAX_BARRIER) < 0.5:
        raise AssertionError("fixed-leg barrier off")
    if not abs(rep.log_z_estimate - V_LOG_Z) < 0.5:
        raise AssertionError("logZ off")
    if not pt.n_tempered_restarts > 0:
        raise AssertionError("no tempered restart")
    return launches["banded_slice_sweep_variational"]


def bayesian_run(target, n_chains, n_replicates, rounds, **kw):
    """NRPT from a ``BayesianModel``'s prior to its posterior on the card with
    kernel K2, one slice pass per scan, rounds of the given lengths; returns
    the run and the launches it made (K2's must equal the scans, K1's be 0)."""
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA

    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pt = PT(Inputs(target=target, n_chains=n_chains, n_replicates=n_replicates, seed=SEED,
                   explorer=SliceSamplerCUDA(n_passes=H_PASSES), show_report=False, device="cuda",
                   **kw))
    for n_scans in rounds:
        pt.run_round(n_scans=n_scans)
    launches = dict(SliceSamplerCUDA.launches)
    scans = sum(rounds)
    print(f"kernel launches {launches} for {scans} scans")
    if launches["slice_sweep"] != scans or launches["banded_slice_sweep"] or \
            launches["banded_slice_sweep_variational"]:
        raise AssertionError(f"kernel launches {launches} for {scans} scans of K2")
    return pt, launches["slice_sweep"]


def print_round(pt, n_lanes):
    rep = pt.reports[-1]
    print(f"timed round: {rep.n_scans} scans in {rep.wall_time_s:.4f} s "
          f"({rep.wall_time_s / rep.n_scans * 1e3:.3f} ms per scan), {eval_rate(pt):.6g} evals/s, "
          f"{float(np.sum(pt.reduced.exp_steps)) / (rep.n_scans * n_lanes):.2f} queries per lane "
          f"and scan, peak device memory {rep.peak_memory_bytes} B")
    print(f"barrier {pt.global_barrier:.6f}, logZ {rep.log_z_estimate:.6f}, round trips "
          f"{pt.n_round_trips}, restarts {pt.n_tempered_restarts}, swap accept mean "
          f"{rep.mean_swap_accept:.4f}")


def hierarchical_phase():
    """The hierarchical normal model (bench config 5's target) end to end at
    32 chains x 256 ladders, and the same rounds at the ladder count of the
    JAX package's reference run; returns the launches of K2 the full-width
    run made. At the JAX run's ladder count the port's run is that run
    (the same permutations and, to the last digits, the same statistics; only
    the reference chains' draws differ, by up to 2 ulp), so it is held within
    1e-3 relative. The full-width run is 256 other ladders of the same law:
    it is held within three standard errors of the JAX run's pooled mean,
    taking its 16 ladders as 16 independent draws (mu 3 x 1.264 / 4, tau
    3 x 1.231 / 4, sigma 3 x 0.0255 / 4), the barrier within 1 and logZ
    within 3 (after 126 scans both still move by that much from round to
    round: the run is inside its initial transient, mu's pooled deviation is
    1.26 where the posterior's is about 0.2)."""
    phase("3d hierarchical normal")
    from pigeons_tpu_torch import hierarchical_normal

    wide = {"mu": 0.95, "tau": 0.92, "sigma": 0.019, "barrier": 1.0, "logZ": 3.0}
    launches = None
    for ladders in (H_REPLICATES, H_JAX_LADDERS):
        tolerance = wide if ladders != H_JAX_LADDERS else {k: 1e-3 * abs(v) for k, v in H_JAX.items()}
        print(f"{H_CHAINS} chains x {ladders} ladders, rounds of {H_ROUNDS} scans")
        target = hierarchical_normal()
        pt, n_launches = bayesian_run(target, H_CHAINS, ladders, H_ROUNDS)
        launches = launches or n_launches
        print_round(pt, H_CHAINS * ladders)
        q = target.constrained_samples(pt)
        got = {name: float(np.mean(q[name])) for name in ("mu", "tau", "sigma")}
        got.update(barrier=pt.global_barrier, logZ=pt.reports[-1].log_z_estimate)
        print("pooled over the timed round: " + ", ".join(
            f"{k} {v:.6f} (JAX package at {H_JAX_LADDERS} ladders {H_JAX[k]}, tolerance "
            f"{tolerance[k]:.4g})" for k, v in got.items()))
        if not np.isfinite(pt.sample_array()).all():
            raise AssertionError("hierarchical normal: non-finite samples")
        for k, v in got.items():
            if not abs(v - H_JAX[k]) <= tolerance[k]:
                raise AssertionError(f"hierarchical normal, {ladders} ladders: {k} {v} is off the "
                                     f"JAX package's {H_JAX[k]}")
    return launches


def unid_phase():
    """The unidentifiable binomial, the one ``BayesianModel`` here whose logZ
    is known exactly: 10 chains x 64 ladders, rounds doubling to 32 scans."""
    phase("3e unid")
    from pigeons_tpu_torch import unid_target
    from pigeons_tpu_torch.models import unid_analytic_log_z

    pt, launches = bayesian_run(unid_target(), S_CHAINS, S_REPLICATES, S_ROUNDS)
    print_round(pt, S_CHAINS * S_REPLICATES)
    exact = unid_analytic_log_z()
    by_round = [round(r.log_z_estimate, 4) for r in pt.reports]
    print(f"logZ by round {by_round}, exact {exact:.6f}")
    if not abs(pt.reports[-1].log_z_estimate - exact) < 0.1:
        raise AssertionError("unid: logZ off its exact value")
    if not pt.n_tempered_restarts > 0:
        raise AssertionError("unid: no tempered restart")
    return launches


def eight_schools_phase():
    """Non-centred eight schools: 10 chains x 64 ladders. The posterior means
    of mu and tau are about 4.4 and 3.6 (Gelman et al., Bayesian Data Analysis,
    section 5.5, under this model's half-Cauchy(5) prior on tau); the pooled
    means of the last round are held within 1 of them."""
    phase("3f eight schools")
    from pigeons_tpu_torch import eight_schools

    target = eight_schools()
    pt, launches = bayesian_run(target, S_CHAINS, S_REPLICATES, S_ROUNDS)
    print_round(pt, S_CHAINS * S_REPLICATES)
    q = target.constrained_samples(pt)
    mu, tau = float(np.mean(q["mu"])), float(np.mean(q["tau"]))
    print(f"pooled over the timed round: mu {mu:.4f} (sd {np.std(q['mu']):.4f}), tau {tau:.4f} "
          f"(sd {np.std(q['tau']):.4f})")
    if not (abs(mu - 4.4) < 1.0 and abs(tau - 3.6) < 1.0):
        raise AssertionError("eight schools: posterior means off")
    if not (math.isfinite(pt.reports[-1].log_z_estimate) and pt.n_tempered_restarts > 0):
        raise AssertionError("eight schools: no finite logZ or no tempered restart")
    return launches


def logistic_regression_phase():
    """Bayesian logistic regression on 200 synthetic observations, d=11, at
    bench config 2's width: 10 chains x 1,024 ladders, one slice pass (config
    2 itself times AutoMALA, not ported yet). The posterior mean of
    the weights is held to the sign of every true weight it can resolve: the
    data come from ``w_true`` drawn with the model's seed, and the pooled
    mean of a coordinate must lie within 1 of it (the posterior's deviation
    is about 0.3 per weight at 200 observations)."""
    phase("3h logistic regression")
    from pigeons_tpu_torch import logistic_regression, rng

    target = logistic_regression()
    pt, launches = bayesian_run(target, LR_CHAINS, LR_REPLICATES, LR_ROUNDS)
    print_round(pt, LR_CHAINS * LR_REPLICATES)
    w_true = rng.normal(rng.fold_in(rng.key(0), 1), (10,)).numpy()
    w = target.constrained_samples(pt)["w"].mean(0)
    print(f"pooled posterior mean of w {[round(float(v), 3) for v in w]}, the weights that made "
          f"the data {[round(float(v), 3) for v in w_true]}, largest gap "
          f"{np.abs(w - w_true).max():.4f}")
    if not np.abs(w - w_true).max() < 1.0:
        raise AssertionError("logistic regression: posterior mean of the weights off")
    if not (math.isfinite(pt.reports[-1].log_z_estimate) and pt.n_tempered_restarts > 0):
        raise AssertionError("logistic regression: no finite logZ or no tempered restart")
    return launches


def variational_funnel_phase():
    """The funnel on two legs, 6 + 6 chains x 64 ladders: not separable, so
    K2 runs under the Gaussian reference fitted after round 6 (config 4's
    rounds). The funnel's density is normalized, so the variational leg's stepping
    stone estimates logZ = 0 once the chains have forgotten the states they
    inherited from the fixed reference's rounds: a replica that carries one
    far out in the fitted reference's tails gives a swap ratio that alone
    carries the estimate (it is printed by round, not gated), as in the JAX
    package, whose run this is (tests/test_torch_sweep_bayesian.py)."""
    phase("3g funnel under a variational reference")
    from pigeons_tpu_torch import funnel

    rounds = (V_WARMUP_SCANS,) * V_WARMUP_ROUNDS + (V_MEASURE_SCANS,)
    pt, launches = bayesian_run(funnel(F_NX), VF_CHAINS, VF_REPLICATES, rounds,
                                n_chains_variational=VF_CHAINS)
    print_round(pt, 2 * VF_CHAINS * VF_REPLICATES)
    active = float(pt._ref_params["active"])
    var_barriers = [round(float(r.global_barrier_variational), 4) for r in pt.reports]
    print(f"reference active {active}; variational barrier by round {var_barriers}; logZ by round "
          f"{[round(r.log_z_estimate, 4) for r in pt.reports]} (exact 0 under the fitted "
          f"reference); fitted std of y {float(pt._ref_params['std'][0]):.4f}")
    if active != 1.0:
        raise AssertionError("the timed round did not run under the fitted reference")
    if not (math.isfinite(pt.reports[-1].log_z_estimate)
            and math.isfinite(pt.global_barrier_variational) and pt.n_tempered_restarts > 0):
        raise AssertionError("variational funnel: no finite logZ or barrier, or no tempered restart")
    if not np.isfinite(pt.sample_array()).all():
        raise AssertionError("variational funnel: non-finite samples")
    return launches


def small_reference_phase():
    """Small runs on the card (kernels) against the same runs on the CPU
    (twins), for the toy path (K1), the funnel path (K2), two-leg variational
    runs whose last round uses the fitted reference (K1's variational term on
    the toy path, K2 on the funnel) and three ``BayesianModel`` targets
    (K2 with array inputs): same swaps and restarts, same states within 1e-6."""
    phase("6 small runs, card vs CPU")
    from pigeons_tpu_torch import (PT, GaussianReference, Inputs, SliceSamplerCUDA, eight_schools,
                                   funnel, hierarchical_normal, toy_mvn_target, unid_target)

    two_leg = dict(n_chains=4, n_chains_variational=4,
                   variational=GaussianReference(first_tuning_round=3))
    one_pass = SliceSamplerCUDA(n_passes=F_PASSES)
    # the BayesianModel runs are smaller: their twins are slow on a CPU
    small = dict(n_chains=3, n_replicates=1, n_rounds=2)
    for name, target, explorer, kw in (
            ("toy MVN", toy_mvn_target(6), SliceSamplerCUDA(), dict(n_chains=5)),
            ("funnel", funnel(3), one_pass, dict(n_chains=5, n_rounds=3)),
            ("two legs", toy_mvn_target(6), SliceSamplerCUDA(), two_leg),
            ("funnel on two legs (K2)", funnel(3), one_pass,
             dict(two_leg, variational=GaussianReference(first_tuning_round=2), n_replicates=2,
                  n_rounds=3)),
            ("hierarchical normal", hierarchical_normal(), one_pass, small),
            ("eight schools", eight_schools(), one_pass, small),
            ("unid", unid_target(), one_pass, small)):
        kw = {"n_replicates": 8, "n_rounds": 4, **kw}
        t0 = time.perf_counter()
        g, c = (PT(Inputs(target=target, seed=4, explorer=explorer,
                          show_report=False, device=dev, **kw)).run()
                for dev in ("cuda", "cpu"))
        same_perm = (torch.equal(g.chain_of.cpu(), c.chain_of)
                     and torch.equal(g.replica_of.cpu(), c.replica_of)
                     and g.n_tempered_restarts == c.n_tempered_restarts)
        diff = float((g.states.cpu() - c.states).abs().max())
        print(f"{name}: permutations and restarts equal {same_perm}, max |state diff| {diff}, "
              f"barrier {g.global_barrier:.6f} vs {c.global_barrier:.6f} "
              f"({time.perf_counter() - t0:.1f} s for both runs)")
        if not same_perm or diff > 1e-6 or not np.isfinite(g.sample_array()).all():
            raise AssertionError(f"{name}: card run disagrees with the CPU run")
        if g.variational is not None and float(g._ref_params["active"]) != 1.0:
            raise AssertionError(f"{name}: the reference was never fitted")


def torch_sampler_phase():
    """The torch ``SliceSampler`` (a torch module, not a kernel: the explorer
    for paths without a device density) on the small funnel run, card against
    CPU, with its time per scan. It must launch none of the port's kernels."""
    phase("7 torch SliceSampler on the small funnel run")
    from pigeons_tpu_torch import PT, Inputs, SliceSampler, SliceSamplerCUDA, funnel

    SliceSamplerCUDA.reset_launches()
    # one round, 2 scans: a scan is some 10^5 eager launches on the card
    g, c = (PT(Inputs(target=funnel(3), n_chains=5, n_replicates=8, seed=4, n_rounds=1,
                      explorer=SliceSampler(n_passes=F_PASSES), show_report=False,
                      device=dev)).run() for dev in ("cuda", "cpu"))
    same = (torch.equal(g.chain_of.cpu(), c.chain_of) and torch.equal(g.states.cpu(), c.states)
            and np.array_equal(g.reduced.exp_steps, c.reduced.exp_steps))
    rep = g.reports[-1]
    print(f"card and CPU runs bitwise equal: {same}; last round on the card: {rep.n_scans} scans "
          f"of 40 lanes, d=4, in {rep.wall_time_s:.4f} s ({rep.wall_time_s / rep.n_scans * 1e3:.1f} "
          f"ms per scan, {float(np.sum(g.reduced.exp_steps)) / (rep.n_scans * 40):.2f} queries per "
          f"lane and scan); on the CPU {c.reports[-1].wall_time_s / rep.n_scans * 1e3:.1f} ms per scan")
    if not same or any(SliceSamplerCUDA.launches.values()):
        raise AssertionError("torch SliceSampler: card run disagrees with the CPU run")


def determinism_phase():
    phase("4 determinism")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, toy_mvn_target

    def config1():
        return Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                      seed=SEED, n_rounds=2, explorer=SliceSamplerCUDA(), show_report=False,
                      device="cuda")

    from pigeons_tpu_torch import GaussianReference

    def config4():  # three rounds, the last under the reference fitted after the second
        return config4_inputs(n_rounds=3, variational=GaussianReference(first_tuning_round=2))

    from pigeons_tpu_torch import hierarchical_normal

    def hierarchical():
        return Inputs(target=hierarchical_normal(), n_chains=H_CHAINS, n_replicates=H_REPLICATES,
                      seed=SEED, n_rounds=3, explorer=SliceSamplerCUDA(n_passes=H_PASSES),
                      show_report=False, device="cuda")

    for name, make in (("config 1", config1), ("funnel", lambda: funnel_inputs(n_rounds=3)),
                       ("config 4", config4), ("hierarchical normal", hierarchical)):
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
    from pigeons_tpu_torch import GaussianReference

    # config 4's profiled round runs under a reference fitted after the first
    config4 = config4_inputs(variational=GaussianReference(first_tuning_round=1))
    from pigeons_tpu_torch import hierarchical_normal

    hierarchical = Inputs(target=hierarchical_normal(), n_chains=H_CHAINS,
                          n_replicates=H_REPLICATES, seed=SEED,
                          explorer=SliceSamplerCUDA(n_passes=H_PASSES), show_report=False,
                          device="cuda")
    for name, inputs, n_scans, kernel in (("config1", config1, WARMUP_SCANS, "banded_slice"),
                                          ("funnel", funnel_inputs(), F_WARMUP_SCANS, "slice_sweep"),
                                          ("config4", config4, V_WARMUP_SCANS, "banded_slice"),
                                          ("hierarchical", hierarchical, 8, "slice_sweep")):
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
    parent_phase()
    k1, k2, k1v = k1_phase(), k2_phase(), k1_variational_phase()
    bayesian, k2v = k2_bayesian_phase(), k2_variational_phase()
    k1["launches"] = config1_phase()
    k2["launches"] = funnel_phase()
    k1v["launches"] = config4_phase()
    bayesian["hierarchical_normal"]["launches"] = hierarchical_phase()
    bayesian["unid"]["launches"] = unid_phase()
    bayesian["eight_schools"]["launches"] = eight_schools_phase()
    bayesian["logistic_regression"]["launches"] = logistic_regression_phase()
    k2v["launches"] = variational_funnel_phase()
    determinism_phase()
    quickstart_phase()
    small_reference_phase()
    torch_sampler_phase()
    if "--profile" in sys.argv[1:]:
        profile_phase()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - T0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": [k1, k2, k1v, *bayesian.values(), k2v]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


T0 = time.perf_counter()

if __name__ == "__main__":
    main()
