"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--parent-csrc DIR]
    python3 chip_smoke.py --side-phases   # phases 3n-7b and 13 alone (the script starts it)

Run from the repository root. It builds the port's CUDA kernels from
``pigeons_tpu_torch/csrc`` (``nvcc`` processes started together: K1, and K2
in ``_build.K2_PARTS`` parts),
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
  against its twin at the shape of its one path, phase 10's invariance test;
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
  legs (K2 with ``isvar``, ``mean``, ``std`` and ``active`` as arrays);
* bench config 2a: the same logistic regression with ``AutoMALA()``, 10
  chains x 1,024 ladders: the gradient path, torch ops and no kernel, with
  its rate beside a dense-leapfrog rate (no search) at the same lanes;
* bench config 2b: logistic regression on 4,096 observations of 256
  covariates with the queued AutoMALA, 10 chains x 819 ladders, the
  likelihood's ``X @ w`` one float32 product (cuBLAS, no TF32), with
  bench.py's rates, control and floor beside it and the dense form held to
  float64;
* the mRNA transfection model (150 observations, d=5) at the hierarchical
  cell's width, K2 with ``expm1`` and glibc's ``powf`` inside, held to the
  JAX package's run at 16 ladders; the Bernoulli model (logZ against log
  B(3, 9), its Beta prior as a block of the kernel's table) and centred eight
  schools (mu against the non-centred run's) at 10 chains x 64 ladders;
* the ordinal and Bool targets (Ising with ``BinaryGibbs``, the Poisson
  count and the binary mixture with the masked torch ``SliceSampler``), card
  against CPU, no kernel launched, and the Ising model against its
  enumeration;
* config 2a's cell with ``NUTS()`` and with ``AAPS(step_size=0.8)`` in place
  of AutoMALA (phase 3n: the dynamic trajectories of the gradient path, no
  kernel), each held to config 2a's law and an explore of 640 of its lanes
  held card against CPU; and the combinators ``Compose``, ``Mix`` and
  ``ScanMix`` on the toy MVN, card against CPU (phase 6c: the slice
  sampler inside them is the torch ``SliceSampler``, which the JAX
  package's combinators run for ``SliceSamplerPallas``; no kernel
  launches);
* densities a user supplies as CUDA source beside their torch form (phase
  12, ``pigeons_tpu_torch/models/source_examples.py``), each compiled at
  first use into a library of its own (one ``nvcc`` a source, started
  together): config 5's hierarchical normal with its likelihood as a source
  at phase 3d's width (K2's user instance, held bit for bit to its twin at
  B = 8,192 at the launcher's group and at 1, 8, 16 and 32 threads a lane,
  each timed, launched once a scan, its posterior means within three
  standard errors of phase 3d's); a product of 100 normals as coordinate
  terms at config 1's width (K1's user term, bit for bit at B = 20,480, with
  the ``clock64()`` split of a ``-DPIGEONS_K1_CLOCKS`` build, its moments and
  logZ = 0); ``unid_target()`` under N(0, 2^2 I) (the library's K2 with the
  reference's 1 / sigma), model U with Cauchy, LogNormal and Exponential
  priors and a ``CustomPath`` with a source at 10 chains x 64 ladders (each
  group bit for bit at 640 lanes);
* Stan models (phase 14, ``pigeons_tpu_torch/models/stan.py``): eight
  schools non-centred and Bernoulli through the CUDA source their models
  are compiled to (``models/stan_cuda.py``), each a library of its own, on
  K2's user instance bit for bit at every group, eight schools timed beside
  the compiled ``kEightSchools`` at 640 and 8,192 lanes, their runs at the
  eight-schools cell (logZ against the library run's less log 2; Bernoulli
  against log B(3, 9)), and the invariance test of K2 on the eight-schools
  source at beta = 0.3 (draws by rejection); the varying-slopes model
  (matrices, ``cholesky_factor_corr``) on its default AutoMALA, card against
  CPU, beside the side process (14c);
* float64 runs (phase 13a) and the host-evaluated targets (13b-d), in the
  side process, no kernel:
  ``tests/test_dtype.py``'s three runs in float64 with its thresholds, the
  funnel cell's target and width with the torch ``SliceSampler`` in float64
  and float32 in turns (each one's scan time), ``SliceSamplerCUDA`` refusing
  a float64 run; ``NativeTarget`` (``examples/native/het_normal.cpp``, built
  with ``g++``) at 10 chains x 256 ladders with its default ``AutoMALA``,
  held to the JAX slow test's law, with the density's host round trips a
  scan; ``StreamTarget`` over the compiled C++ worker
  (``examples/native/stream_worker.cpp``) at 10 chains; ``ExternalTarget``
  and ``LazyTarget`` as ``tests/test_extensions.py`` runs them.

It checks each run's laws and determinism, runs the README quick start, and
compares small runs on the card with the same runs on the CPU (and one
AutoMALA explore of 640 lanes of config 2a and one queued explore of 64
lanes of config 2b, decision by decision, phase 6d). Then checkpoints and
checks: config 1 at full width, checkpointed every round, stopped after round 3 and
resumed (``increment_n_rounds``, ``pigeons(folder)``) must be the
uninterrupted run bit for bit, and so must config 4 stopped after its first
fitted round and config 2a at 64 ladders (phase 9, with each checkpoint
write's seconds and bytes); a card checkpoint resumes on the CPU (9b); a
one-ladder K1 run passes ``checked_round``'s serial check in a child process
on the card, a corrupted copy of its round fails it, and ``profile_round``
writes a trace of K1's launches (9c); the exact invariance test at N =
10,000 of K1 with each term, K2 in each mode (its delta mode's only path,
that launch held against the twin) and under the variational blend, MALA,
AutoMALA, AAPS, NUTS, ``Mix`` and ``ScanMix`` (the last four on the toy MVN
at d = 3, the JAX test's cases) pass, each kernel launched once, the
variational term at beta = 0.3, where the reference weighs in, K2 with the Bernoulli density on
its posterior Beta(3, 9); a kernel that drifts and a step that reads a
wrong reference fail (10). Phases 3n, 4, 5, 6, 6c, 7, 7b and 13 read nothing of
the other runs: a second process (``--side-phases``), started once phases
2-2e have timed the kernel rows, runs them beside phases 3-11, and its
output is printed after phase 11; so the wall times of phases 3-11 and of
the side phases are taken with the card and the host shared, while the
kernel rows (phases 2-2e, and 12 after the side process has ended) are
not. Every phase raises on failure. Without a CUDA device, or without the repository beside
it, it exits non-zero and prints no result. The line before the last is a
JSON object describing every kernel (time, twin's time, launches on its main
path, bound; K2's user instance, K1's user term and a Stan model's source on
K2 last); the last line is a JSON object naming the device.

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
``profile_config4.txt``, ``profile_hierarchical.txt``,
``profile_config2a.txt``, ``profile_config2b.txt``,
``profile_config2a_nuts.txt`` (config 2a's cell with ``NUTS()``) and
``profile_stan_varying_slopes.txt`` (phase 14c's model, one scan of its
AutoMALA), each sorted by device time and by count, and prints each
round's device ops, busy share, host syncs and explorer evaluations per
scan. ``--parent-csrc
DIR`` builds an earlier version of the CUDA sources (with this tree's entry
points) from ``DIR``, and phase 12's user sources from it, and times its
kernels beside this tree's on the same inputs, as ``parent_ms`` in the
kernels line; its outputs must be this tree's, bit for bit.
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
# the mRNA path (PR 10): mrna_target() (150 observations, d = 5) at the
# hierarchical cell's width and rounds. The same rounds at 16 ladders as the
# JAX package runs them on the CPU (``JAX_PLATFORMS=cpu python
# tests/bayesian_reference_run.py --model mrna_target --ladders 16``), the
# line of every round (2, 4, ..., 64 scans; the last is M_JAX): pooled
# posterior means of the five log10-scale parameters, barrier and logZ, and
# the pooled deviations of the last round (three standard errors of 16
# ladders: the tolerance of the full-width run).
_M_NAMES = ("lt0", "lkm0", "lbeta", "ldelta", "lsigma", "barrier", "logZ")
M_JAX_ROUNDS = [dict(zip(_M_NAMES, v)) for v in (
    (-0.291734, 1.039604, -0.505033, -2.241624, 1.901108, 6.079096, -784.344481),
    (-0.198050, 0.977340, -0.624946, -0.427771, 1.567400, 3.679385, -13039.858088),
    (0.015603, 2.841221, -1.018447, -1.858639, 1.062483, 4.038112, -120851.989142),
    (-0.349320, 1.796502, -1.268918, -2.044482, 0.726091, 5.450694, -649.618894),
    (-0.239119, 1.008174, -1.451108, -1.776715, 0.476409, 7.873853, -498.367941),
    (0.096173, 1.036174, -1.295894, -1.746246, 0.410640, 8.545976, -488.366605))]
M_JAX = M_JAX_ROUNDS[-1]
M_JAX_SD = {"lt0": 0.106800, "lkm0": 0.053797, "lbeta": 0.924310, "ldelta": 0.730853,
            "lsigma": 0.029144}
# the Bernoulli model's evidence: log B(3, 9)
BERNOULLI_LOG_Z = math.lgamma(3.0) + math.lgamma(9.0) - math.lgamma(12.0)
# the discrete targets' runs, card against CPU (phase 7b), and the Ising
# model against its enumeration on the card
DISCRETE_CHAINS, DISCRETE_REPLICATES, ISING_REPLICATES, ISING_ROUNDS = 4, 4, 16, 6
# the smaller BayesianModel paths (unid, eight schools): 10 chains x 64
# ladders; the funnel on two legs: 6 + 6 chains x 64 ladders
S_CHAINS, S_REPLICATES, S_ROUNDS = 10, 64, (2, 4, 8, 16, 32)
VF_CHAINS, VF_REPLICATES = 6, 64
# logistic regression at bench config 2's width (bench.py:335-344: 10 chains x
# 1,024 ladders, seed 1), rounds of 2..16 scans, then a timed 32-scan round
LR_CHAINS, LR_REPLICATES, LR_ROUNDS = 10, 1024, (2, 4, 8, 16, 32)

# bench config 2a (bench.py:330-355): logistic regression 200 x 10 (d=11) with
# AutoMALA(), 10 chains x 1,024 ladders, seed 1, 4 warm-up rounds of 4 scans.
# bench.py times the best of 3 rounds of 32 scans; phase 3i warms up for
# A_AUTOMALA_WARMUP_ROUNDS of the rounds and times one round of 16 (a scan is
# a second or two of eager launches on the card, and the script has 1,200 s;
# with 8 the run has made no tempered restart yet, and a restart needs
# N_CHAINS - 1 = 9 scans inside one round). Phase 3n's NUTS and AAPS keep the
# 4 warm-up rounds: after 2, NUTS's pooled weights were 1.17 from the weights
# that made the data (PERF.md §6)
A_CHAINS, A_REPLICATES, A_WARMUP_ROUNDS, A_WARMUP_SCANS, A_MEASURE_SCANS = 10, 1024, 4, 4, 16
A_AUTOMALA_WARMUP_ROUNDS = 2
A_DENSE_ITERS, A_COMPARE_LADDERS, A_PROFILE_SCANS = 16, 64, 2
# phase 3n: config 2a's cell with NUTS() at its defaults and with AAPS at a
# fixed step, its warm-up, then a timed round of N_MEASURE_SCANS scans: 16,
# not 8, since a tempered restart needs at least N_CHAINS - 1 = 9 scans inside
# one round (the round-trip machine starts again each round), and the gate
# asks for one. On the CPU at 64 ladders no step from 0.2 to 1.5 bailed a
# move, 0.1 bailed 0.77% and 0.05 up to 15% a round (``python
# tools/torch_aaps_step.py``; PERF.md §6); a scan's leapfrogs fall with the
# step, and at 0.8 the run's largest weight gap (0.82) was still within 0.15
# of the small steps' (0.67-0.70)
N_MEASURE_SCANS, N_AAPS_STEP = 16, 0.8
# phase 6c: the combinators on the toy MVN, 4 chains, 3 rounds, card and CPU
C_DIM, C_CHAINS, C_ROUNDS = 2, 4, 3
# phase 12: the CustomPath source's dimension, and the funnel source's,
# which (d) holds under a variational reference (its other cells use the
# widths above)
U_CUSTOM_DIM, U_FUNNEL_DIM = 4, 10

# phase 14: Stan models (pigeons_tpu_torch/models/stan.py). Eight schools
# non-centred as examples/stan_model.py writes it (J = 8, d = 10) and the
# Bernoulli model with its beta(1, 1) prior on kernel K2 through their
# emitted CUDA source (models/stan_cuda.py), at the eight-schools cell
# (S_CHAINS x S_REPLICATES, S_ROUNDS) and at 8,192 lanes; the varying-slopes
# model of examples/stan_hierarchical.py (N = 160, J = 4, P = 2,
# cholesky_factor_corr) on its default AutoMALA, the torch path: 8 chains x
# 128 ladders, ST_AUTOMALA_ROUNDS rounds, its density and gradient card
# against CPU on those 1,024 states. The eight-schools logZ gate: the
# library's kEightSchools run of phase 3f less log 2 (Stan's cauchy(0, 5) on
# tau >= 0 is not renormalized under propto=false), within ST_LOG_Z_TOL.
STAN_EIGHT_SCHOOLS = """
data {
  int<lower=0> J;
  array[J] real y;
  array[J] real<lower=0> sigma;
}
parameters {
  vector[J] theta_trans;
  real mu;
  real<lower=0> tau;
}
transformed parameters {
  vector[J] theta;
  theta = theta_trans * tau + mu;
}
model {
  theta_trans ~ normal(0, 1);
  y ~ normal(theta, sigma);
  mu ~ normal(0, 5);
  tau ~ cauchy(0, 5);
}
"""
STAN_EIGHT_SCHOOLS_DATA = {"J": 8, "y": [28, 8, -3, 7, -1, 1, 18, 12],
                           "sigma": [15, 10, 16, 11, 9, 11, 10, 18]}
STAN_BERNOULLI = """
data { int<lower=0> N; array[N] int<lower=0, upper=1> y; }
parameters { real<lower=0, upper=1> theta; }
model { theta ~ beta(1, 1); y ~ bernoulli(theta); }
"""
STAN_BERNOULLI_DATA = {"N": 10, "y": [0, 1, 0, 0, 0, 0, 0, 0, 0, 1]}
STAN_VARYING_SLOPES = """
data {
  int<lower=0> N;
  int<lower=1> J;
  int<lower=1> P;
  array[N] int<lower=1, upper=J> g;
  matrix[N, P] x;
  vector[N] y;
}
parameters {
  matrix[P, J] z;
  cholesky_factor_corr[P] L_Omega;
  vector<lower=0>[P] tau;
  real<lower=0> sigma;
}
transformed parameters {
  matrix[J, P] beta = (diag_pre_multiply(tau, L_Omega) * z)';
}
model {
  to_vector(z) ~ std_normal();
  L_Omega ~ lkj_corr_cholesky(2);
  tau ~ cauchy(0, 2.5);
  sigma ~ exponential(1);
  y ~ normal(rows_dot_product(beta[g], x), sigma);
}
"""
ST_WIDE_LANES, ST_LOG_Z_TOL, ST_THETA_TOL, ST_BERNOULLI_LOG_Z_TOL = 8192, 0.3, 0.04, 0.2
ST_VS_CHAINS, ST_VS_REPLICATES, ST_AUTOMALA_ROUNDS = 8, 128, 3
# the invariance test's beta for the emitted source, and how many proposals
# each of its draws may take (its rejection sampler's acceptance is about 5%)
ST_INVARIANCE_BETA, ST_REJECTION_TRIES = 0.3, 400


def varying_slopes_data():
    """examples/stan_hierarchical.py's data, from numpy seed 0."""
    rs = np.random.default_rng(0)
    N, J, P = 160, 4, 2
    x = rs.normal(size=(N, P))
    g = rs.integers(1, J + 1, size=N)
    beta_true = rs.normal(size=(J, P))
    y = np.sum(beta_true[g - 1] * x, axis=1) + 0.3 * rs.normal(size=N)
    return {"N": N, "J": J, "P": P, "g": g, "x": x, "y": y}, beta_true


# bench config 2b (bench.py:421-483): logistic regression 4,096 x 256 (d=257)
# with the queued AutoMALA (queue 512, window 2), 10 chains x 819 ladders =
# 8,190 lanes, seed 1; bench.py warms up for 4 rounds of 4 scans, the port for
# 1 round of 2 (the script's time: PERF.md §6). bench.py times the best
# of 3 rounds of 8 scans; the port times one round of 2. Its control (sequential
# AutoMALA(), 2 + 2 scans), dense leapfrog (64 chained steps) and host serial
# rate (bench.py:363-418) are bench.py's; the column form's leapfrog (the
# likelihood before the dense form) runs at 1,024 of the lanes.
B_N, B_D, B_CHAINS, B_REPLICATES = 4096, 256, 10, 819
B_WARMUP_ROUNDS, B_WARMUP_SCANS, B_MEASURE_SCANS, B_CONTROL_SCANS = 1, 2, 2, 2
B_BENCH_SCANS = 8
B_QUEUE_WIDTH, B_WINDOW, B_DENSE_ITERS, B_COLUMN_LANES, B_COLUMN_ITERS = 512, 2, 64, 1024, 4
B_CHECK_LANES, B_COMPARE_LANES, B_PROFILE_SCANS, B_HOST_SECONDS = 256, 64, 2, 3.0
# bench.py's count of a density-and-gradient evaluation: 4 n (d + 1) operations
B_FLOP_PER_EVAL = 4.0 * B_N * (B_D + 1)

# Published peaks of one H100 SXM at 700 W: 3.35 TB/s of device memory, and
# 67 TFLOP/s in float32 = 132 SMs x 128 lanes x 2 (a fused multiply-add) x
# 1.98 GHz. An SM has 64 int32 lanes of one operation each: a quarter of that.
# phase 9: rounds of 2^r scans, each run stopped after CK_*STOP rounds and
# resumed; config 1 at its full width, config 4 at its own, config 2a at
# A_COMPARE_LADDERS ladders (2 rounds, stopped after the first: its scans
# are seconds of eager launches); 9c's one-ladder run checked at its last round
CK_ROUNDS, CK_STOP, CK_V_ROUNDS, CK_V_STOP, CK_A_ROUNDS, CK_A_STOP = 5, 3, 4, 2, 2, 1
CK_S_ROUNDS = 3
# phase 10: the reference's sample count and seed; MALA's step for the toy MVN
# (sd 0.32); the beta of the variational blend's tests, where the reference's
# half weighs 0.7 (at beta = 1 it weighs nothing); SliceSamplerCUDA's passes
I_SAMPLES, I_SEED, I_MALA_STEP, I_BLEND_BETA, I_DELTA_PASSES = 10_000, 1, 0.1, 0.3, 3
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
# XLA's expm1 (common.cuh): the exp, the tanh's clamp (4), square, eleven
# fused multiply-adds, two multiplies, a division, three selects, the halving
# and two adds; glibc's 10^q: about twenty double operations (each charged as
# two float32 ones: the H100's float64 rate is half its float32 rate), the
# table index, shifts and the power of two (6 int), the conversion, flush and
# three special-case selects
EXPM1_EXTRA = ops(34)
POW10 = ops(2 * 20 + 6, 6)
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


PARENT = []  # the library built from --parent-csrc, if any, and that directory
LIBRARY_RUNS = {}  # what phase 14 reads of the library kinds' runs (phase 3f's logZ)


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
    PARENT.extend((_build.open_library(path), csrc))


def parent_has(name):
    """Whether the sources of ``--parent-csrc`` (if given) name ``name``."""
    return bool(PARENT) and any(name in f.read_text() for f in PARENT[1].glob("*.cu*"))


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
    print(f"built {path.name} in {seconds:.3f} s (0 = already built), {len(_build.units())} "
          f"nvcc processes at once (K1, and K2 in {_build.K2_PARTS} parts), then one link")
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


def parent_ms(name, fn, got, ms, same=True, parent=None):
    """With --parent-csrc: ``fn`` on the parent's library (or ``parent()``,
    the parent's own call, where given) must give ``got`` (unless not
    ``same``: the parent computes another function, and the differing bits
    are only counted); its time, the mean of its two turns in parent, this
    tree, this tree, parent (each the median of 20), beside this tree's
    ``ms`` (None without a parent)."""
    if not PARENT:
        return None

    if parent is None:
        def parent():
            with parent_library():
                return fn()

    if same:
        compare(f"{name}, the parent's sources", parent(), got)
    else:
        print(f"{name}, the parent's sources (another function): bitwise-differing in x, "
              f"[lp,] stats " + str([int((p.view(torch.int32) != g.view(torch.int32)).sum())
                                     for p, g in zip(parent(), got, strict=True)]))
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
    # the twin runs once a call: timed while it counts the phases
    want, plain_ms = timed_once(
        lambda: cuda_slice.banded_sweep_reference(x, a, seeds, phase_counts=counts))
    max_abs = compare("K1", got, want)
    ms = cuda_ms(lambda: cuda_slice.banded_sweep_cuda(x, a, seeds), 20)
    parent = parent_ms("K1", lambda: cuda_slice.banded_sweep_cuda(x, a, seeds), got, ms)
    n = [float(v) for v in counts[:5]]
    iterations, considered = sum(n), float(got[1][1].double().sum())
    # the kernel's n_evals counts an ENTER iteration twice
    n_evals = float(got[1][2].double().sum())
    if n_evals != iterations + n[ENTER] or n[ENTER] != 3 * B * D or n[INIT_R]:
        raise AssertionError(f"K1: phase counts {n} do not add up to the kernel's n_evals")
    need = k1_need(B * D, n, considered, COORD_TERM)
    bound_ms, bound_by = bound(2 * 4 * B * D + (4 + 8 + 12) * B, need)
    print(f"kernel {ms:.4f} ms (median of 20), twin {plain_ms:.4f} ms (one run, counting "
          f"phases), B={B}, "
          f"d={D}, 3 passes; "
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
    toy term's launch. Timed also at config 1's width, 20,480 lanes, beside
    the toy term on the same inputs."""
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

    def twin():  # runs once a call: timed while it counts the phases
        for leg, lanes in (("variational", is_var), ("fixed", ~is_var)):
            counts[leg] = torch.zeros(6, dtype=torch.int64, device=dev)
            want_x[lanes], want_stats[:, lanes] = cuda_slice.banded_sweep_reference(
                x[lanes], a[lanes], seeds[lanes], phase_counts=counts[leg],
                variational=term(1.0, lanes))

    _, plain_ms = timed_once(twin)
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
          f"twin {plain_ms:.4f} ms (one run leg by leg, counting phases), B={B}, d={D}, 3 "
          f"passes; {iterations:.0f} iterations; "
          f"needs {need[0]:.4g} float32 and {need[1]:.4g} int32 operations, "
          f"bound {bound_ms:.6f} ms by {bound_by}")
    # config 1's width, timed only (tests/test_torch_cuda.py holds it to the twin)
    wide = 2 * V_CHAINS * V_REPLICATES * 4
    wx, wb, ws = lane_inputs(wide, D, 0.5, 13)
    wvar = ((torch.arange(wide, device=dev) % (2 * V_CHAINS)) < V_CHAINS).float()
    wterm = cuda_slice.VariationalTerm(wb, wvar, torch.tensor([1.0], device=dev), a_target, mean,
                                       std)
    wa = path.coord_factor(wb)
    wide_got = cuda_slice.banded_sweep_cuda(wx, wa, ws, variational=wterm)
    wide_ms = cuda_ms(lambda: cuda_slice.banded_sweep_cuda(wx, wa, ws, variational=wterm), 20)
    wide_parent = parent_ms(f"K1 variational, B={wide}",
                            lambda: cuda_slice.banded_sweep_cuda(wx, wa, ws, variational=wterm),
                            wide_got, wide_ms)
    wide_toy_ms = cuda_ms(lambda: cuda_slice.banded_sweep_cuda(wx, wa, ws), 20)
    print(f"B={wide}: kernel {wide_ms:.4f} ms, the toy term on the same inputs {wide_toy_ms:.4f} ms")
    return {"name": "banded_slice_sweep (variational term)", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/banded_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:305",
            "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "toy_term_ms": toy_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "parent_ms": parent,
            f"ms_at_{wide}": wide_ms, f"parent_ms_at_{wide}": wide_parent,
            f"toy_term_ms_at_{wide}": wide_toy_ms}


def k2_mode(name, path, coord_deltas, B, d, scale, query_ops, enter_ops, lane_ops,
            prepare_ops=ops(0), prepare_coords=(), variational=None, variational_ops=ops(0),
            extra_bytes=0, groups=(), inputs=None, n_passes=F_PASSES, keep=None, coord_ops=None,
            full_query_ops=None, parent_same=True, parent_call=None):
    """Kernel K2 against its twin for one path and mode, ``n_passes`` passes
    over ``inputs`` (states, betas, lane seeds; by default
    :func:`lane_inputs`), and ``keep`` (a dict) given the inputs and the
    twin's result. A density
    query needs ``query_ops`` (a query of a coordinate in ``prepare_coords``
    ``prepare_ops`` besides, one of coordinate c ``coord_ops[c]`` besides; a
    query of a lane that follows the variational
    reference ``variational_ops`` instead), an ENTER iteration ``enter_ops``
    besides, a lane ``lane_ops`` once. ``variational`` is ``None`` or the
    keywords ``isvar`` and ``ref_params`` of a variational launch. ``groups``:
    numbers of threads per lane that must give the same bits as the
    launcher's own choice. Returns the timings and the bound of this run's
    work. Where ``full_query_ops`` is given (a row whose queries recompute
    only what they change), the bound with one full evaluation of the
    density a query instead, as the other rows count it, is printed
    beside. ``parent_same``: whether ``--parent-csrc``'s sources compute the
    same function (held bit for bit) or another one (timed only);
    ``parent_call(x, betas, seeds)``: the parent's launch, where the
    library's wrapper cannot make it (a user's library)."""
    from pigeons_tpu_torch.ops import cuda_slice

    kw = variational or {}
    x, betas, seeds = inputs or lane_inputs(B, d, scale, 11)
    got = cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas, n_passes=n_passes, **kw)
    counts = torch.zeros(6, dtype=torch.int64, device=x.device)
    by_coord = torch.zeros(d, dtype=torch.int64, device=x.device)
    want, plain_ms = timed_once(
        lambda: cuda_slice.sweep_reference(x, betas, seeds, path, coord_deltas, n_passes=n_passes,
                                           phase_counts=counts, coord_counts=by_coord, **kw))
    if keep is not None:
        keep.update(inputs=(x, betas, seeds), want=want)
    max_abs = compare(name, got, want,
                      lp_fresh=cuda_slice.sweep_density(path, **kw)(got[0], betas))
    for group in groups:
        compare(f"{name}, {group} threads per lane",
                cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas, n_passes=n_passes,
                                      group=group, **kw), want)
    ms = cuda_ms(lambda: cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas,
                                               n_passes=n_passes, **kw), 20)
    parent = parent_ms(name, lambda: cuda_slice.sweep_cuda(x, betas, seeds, path, coord_deltas,
                                                           n_passes=n_passes, **kw), got, ms,
                       same=parent_same,
                       parent=parent_call and (lambda: parent_call(x, betas, seeds)))
    n = [float(v) for v in counts[:5]]
    iterations, considered = sum(n), float(got[2][1].double().sum())
    n_evals = float(got[2][2].double().sum())
    if n_evals != iterations or n[ENTER] != n_passes * B * d or n[INIT_R] != n[ENTER]:
        raise AssertionError(f"{name}: phase counts {n} do not add up to the kernel's n_evals")
    # a lane's queries are its n_evals; its starting density is one more
    follows = torch.zeros(B, dtype=torch.bool, device=x.device)
    if variational is not None and float(kw["ref_params"]["active"]) > 0:
        follows = kw["isvar"] > 0
    q_var = float(got[2][2][follows].double().sum()) + float(follows.sum())
    q_prepare = float(by_coord[list(prepare_coords)].sum()) if prepare_coords else 0.0
    by_coord_ops = sum((float(by_coord[c]) * v for c, v in (coord_ops or {}).items()), ops(0))
    # per lane: its hash state (an xor and fmix32) and what the mode needs
    def need_of(query_ops, by_query):
        return (B * (ops(0, 9) + lane_ops) + iterations * LOOP
                + (iterations - (q_var - float(follows.sum()))) * query_ops
                + q_var * variational_ops + by_query
                + n[ENTER] * (2 * DRAW + LOG + M_ENTER + enter_ops) + n[INIT_R] * MORE_DBL
                + n[DOUBLE] * (DRAW + M_DOUBLE)
                + n[SHRINK] * (DRAW + M_SHRINK) + (n[SHRINK] - considered) * M_REJECT
                + n[CHECK] * M_CHECK)

    n_bytes = 2 * 4 * B * d + (4 + 8 + 4 + 12) * B + extra_bytes
    need = need_of(query_ops, q_prepare * prepare_ops + by_coord_ops)
    bound_ms, bound_by = bound(n_bytes, need)
    if full_query_ops is not None:
        full_ms, full_by = bound(n_bytes, need_of(full_query_ops, q_prepare * prepare_ops))
        print(f"{name}: bound with one full evaluation a query {full_ms:.6f} ms by {full_by}, "
              f"{full_ms / ms:.2%} of the kernel's time")
    print(f"{name}: kernel {ms:.4f} ms (median of 20), twin {plain_ms:.4f} ms (one run, counting "
          f"phases), B={B}, d={d}, {n_passes} pass{'es' * (n_passes > 1)}; {iterations:.0f} "
          f"iterations, slowest lane "
          f"{float(got[2][2].max()):.0f}: ENTER {n[ENTER]:.0f}, INIT_R {n[INIT_R]:.0f}, DOUBLE "
          f"{n[DOUBLE]:.0f}, SHRINK {n[SHRINK]:.0f} ({considered:.0f} considered), CHECK "
          f"{n[CHECK]:.0f}; {q_prepare:.0f} queries of coordinates that prepare reads, {q_var:.0f} "
          f"of lanes under the variational reference; needs {need[0]:.4g} float32 and "
          f"{need[1]:.4g} int32 operations, bound {bound_ms:.6f} ms by {bound_by}, "
          f"{bound_ms / ms:.2%} of the kernel's time")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "parent_ms": parent,
            "slowest_lane_iterations": float(want[2][2].max())}


def prior_ops(prior):
    """One evaluation of a prior table (densities.cuh: log_prior): a row's
    log-Jacobian (positive: the sum of its coordinates; interval: two
    softplus, a negation each and two adds a coordinate), its density (normal:
    six operations a coordinate; half-Cauchy: exp, a multiply, a square,
    log1p and a subtract; uniform: a constant; Beta, Cauchy, Exponential and
    LogNormal as noted) and their adds."""
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
        elif dist == D_.BETA:  # sigmoid, log, log1p of the negation, fma, multiply, add
            total = total + size * (SIGMOID + LOG + LOG1P + ops(5)) + ops(1)
        elif dist == D_.CAUCHY:  # a subtract, a multiply, a square, log1p, a subtract
            total = total + size * (LOG1P + ops(4)) + ops(1)
        elif dist == D_.EXPONENTIAL:  # exp and an fma
            total = total + size * (EXP + ops(2)) + ops(1)
        elif dist == D_.LOG_NORMAL:  # exp, log, a subtract, a multiply, two fma, a subtract
            total = total + size * (EXP + LOG + ops(7)) + ops(1)
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
                          groups=(1, 8, 16, 32))
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
    out.update(k2_new_models_rows(B, B_small, dev))
    return {name: {"name": f"slice_sweep ({name})", "route": "cuda",
                   "source": "pigeons_tpu_torch/csrc/sweep_slice.cu",
                   "replaces": "pigeons_tpu/ops/pallas_slice.py:94", **entry}
            for name, entry in out.items()}


def k2_new_models_rows(B, B_small, dev):
    """Phase 2d's rows of PR 10: mRNA at its path's 8,192 lanes, Bernoulli and
    centred eight schools at 640."""
    from pigeons_tpu_torch import bernoulli_target, eight_schools, mrna_target

    out = {}
    # mRNA, as ManyTerms computes it: a query recomputes its
    # coordinate's parameter (a sigmoid, the fused map, 10^q, for beta or
    # delta the near test, for sigma its log) and its prior block (two
    # softplus), the sum by windows (n + 5 adds), the prior's sum and the
    # interpolation. Its terms by coordinate: t0, beta, delta: t - t0, two
    # products, the larger and the smaller (4), one exp and one expm1, the
    # sign, their product, a division, km0's product and the select, the
    # normal term; km0 (each term's shape kept): t - t0, the product, the
    # select and the normal term; sigma (each level kept): the normal term.
    # The exp and the expm1 are charged only to the terms with t past t0's
    # largest value, 10 (lt0 < 1): a term at t <= t0 skips them. The lane's
    # first evaluation: all five parameters, blocks and terms. Printed
    # beside: the bound at PR 10's count, one full evaluation a query
    # (prepare's five parameters, every term with its exp and expm1)
    model = mrna_target().to(dev)
    path = model.create_path(model.default_reference())
    density = path.device_density()
    n_obs = density.arrays[0].numel()
    n_late = int((density.arrays[0] > 10.0).sum())
    terms = n_obs * (ops(11) + OBSERVATION) + n_late * (EXP + EXP + EXPM1_EXTRA)
    query = (SIGMOID + ops(5) + POW10 + 2 * SOFTPLUS + ops(5) + ops(n_obs + 5) + ops(6)
             + INTERPOLATE)
    by_coord = {0: terms, 1: n_obs * (ops(3) + OBSERVATION), 2: terms, 3: terms,
                4: n_obs * OBSERVATION}
    lane = (5 * (SIGMOID + ops(2) + POW10) + ops(8) + terms + ops(n_obs + 5)
            + prior_ops(density.prior) + ops(2) + INTERPOLATE)
    full = (5 * (SIGMOID + ops(2) + POW10) + ops(8)
            + n_obs * (ops(8) + EXP + EXP + EXPM1_EXTRA + OBSERVATION) + ops(n_obs + 5)
            + prior_ops(density.prior) + ops(2) + INTERPOLATE)
    # (sources without mrna_residual round km0 * shape before the residual and
    # compute another function: such a --parent-csrc is timed beside, not held to it)
    out["mrna"] = k2_mode("K2 full (mRNA)", path, False, B, model.dim, 1.0, query, ops(0), lane,
                          extra_bytes=4 * 2 * n_obs, groups=(1, 8, 16, 32), coord_ops=by_coord,
                          full_query_ops=full, parent_same=parent_has("mrna_residual"))
    # Bernoulli: prepare (sigmoid, log, log1p) for every query; a term is a
    # compare and a select, 9 adds; the Beta block
    model = bernoulli_target().to(dev)
    path = model.create_path(model.default_reference())
    density = path.device_density()
    n_obs = density.arrays[0].numel()
    query = (SIGMOID + LOG + LOG1P + ops(1) + ops(3 * n_obs - 1) + prior_ops(density.prior)
             + ops(1) + INTERPOLATE)
    out["bernoulli"] = k2_mode("K2 full (Bernoulli)", path, False, B_small, model.dim, 1.0, query,
                               ops(0), query, extra_bytes=4 * n_obs, groups=(1, 8, 16, 32))
    # centred eight schools, as ManyTerms computes it: a query
    # of theta_j recomputes its three terms (theta's normal term under mu and
    # tau, the observation's, the pseudo-prior's: seven operations, C's also
    # the pseudo-prior block's) and resumes the three sums at j (an add for
    # the running value, J - 1 - j adds each); one of mu or log tau
    # recomputes A's 8 terms and 7 adds and its prior block (normal; the
    # half-Cauchy's exp and log1p), prepare one exp; every query (A + B) - C,
    # the prior's sum and the interpolation. The lane's first evaluation: all
    # 24 terms, their 23 adds and the subtract, the prior. Printed beside:
    # the bound at PR 10's count, one full evaluation a query
    model = eight_schools(centered=True).to(dev)
    path = model.create_path(model.default_reference())
    density = path.device_density()
    d = model.dim
    J = d - 2
    term = OBSERVATION + ops(1)
    by_coord = {j: 2 * term + ops(7) + ops(3 * (J - 1 - j) + 3 * (j > 0)) for j in range(J)}
    by_coord[J] = J * term + ops(J - 1) + ops(7)
    by_coord[J + 1] = J * term + ops(J - 1) + EXP + LOG1P + ops(5)
    lane = (J * (2 * term + ops(7)) + ops(3 * J) + prior_ops(density.prior) + ops(1)
            + INTERPOLATE + EXP)
    out["eight_schools_centered"] = k2_mode(
        "K2 full (eight schools, centred)", path, False, B_small, d, 1.0,
        ops(2 + 3) + INTERPOLATE, ops(0), lane, prepare_ops=EXP, prepare_coords=(d - 2, d - 1),
        extra_bytes=4 * 3 * 8, groups=(1, 8, 16, 32), coord_ops=by_coord,
        full_query_ops=(J * (2 * OBSERVATION + ops(1) + ops(7)) + ops(3 * J)
                        + prior_ops(density.prior) + ops(1) + INTERPOLATE))
    return out


def k2_variational_phase():
    """Kernel K2 under a variational reference at the shape of the funnel's
    two-leg path below (6 + 6 chains x 64 ladders): lanes of both legs, the
    reference active with a mean and std that differ by coordinate; and, with
    the reference not active yet, against the plain funnel launch. Timed also
    at 12 + 12 chains x 256 ladders (6,144 lanes: bench config 3's width with
    an equal variational leg)."""
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
    print(f"the plain funnel launch on the same inputs {entry['fixed_path_ms']:.4f} ms; the "
          f"launch's time over the slowest lane's {entry['slowest_lane_iterations']:.0f} "
          f"iterations: {entry['ms'] / entry['slowest_lane_iterations'] * 1e3:.3f} us each")
    # bench config 3's width with an equal variational leg, timed only
    # (tests/test_torch_cuda.py holds it to the twin at every group)
    wide = 2 * F_CHAINS * F_REPLICATES
    wx, wb, ws = lane_inputs(wide, d, 2.0, 11)
    wkw = {"isvar": ((torch.arange(wide, device=dev) % (2 * F_CHAINS)) < F_CHAINS).float(),
           "ref_params": on["ref_params"]}
    wide_got = cuda_slice.sweep_cuda(wx, wb, ws, path, n_passes=F_PASSES, **wkw)
    entry[f"ms_at_{wide}"] = cuda_ms(
        lambda: cuda_slice.sweep_cuda(wx, wb, ws, path, n_passes=F_PASSES, **wkw), 20)
    entry[f"parent_ms_at_{wide}"] = parent_ms(
        f"K2 variational, B={wide}",
        lambda: cuda_slice.sweep_cuda(wx, wb, ws, path, n_passes=F_PASSES, **wkw), wide_got,
        entry[f"ms_at_{wide}"])
    print(f"B={wide}: kernel {entry[f'ms_at_{wide}']:.4f} ms")
    return {"name": "slice_sweep (funnel, variational reference)", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/sweep_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:94", **entry}


def delta_inputs():
    """The states, betas and lane seeds of phase 10's K2 delta-mode launch:
    the invariance test's second batch of iid toy MVN draws, at beta = 1."""
    from pigeons_tpu_torch import toy_mvn_target
    from pigeons_tpu_torch.invariance_test import iid_draws
    from pigeons_tpu_torch.ops import cuda_slice

    dev = torch.device("cuda")
    _, xs, keys = iid_draws(toy_mvn_target(D), I_SEED, I_SAMPLES, dev)
    return xs, torch.ones(I_SAMPLES, dtype=torch.float32, device=dev), cuda_slice.lane_seeds(keys)


def k2_phase():
    """Kernel K2 against its twin: full mode at the funnel path's shape (its
    main path), delta mode at its path's, phase 10's invariance test (its
    default of 3 passes). Returns the kernels line's entry and, for phase
    10, the delta twin's inputs and result."""
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
    delta_twin = {}
    delta = k2_mode("K2 delta (toy MVN)", toy_mvn_path(D), True, I_SAMPLES, D, 1.0,
                    COORD_TERM + ops(1), COORD_TERM + ops(1),
                    TOY_FACTOR + 2 * toy_density_ops(D), inputs=delta_inputs(),
                    n_passes=I_DELTA_PASSES, keep=delta_twin)
    return {"name": "slice_sweep", "route": "cuda",
            "source": "pigeons_tpu_torch/csrc/sweep_slice.cu",
            "replaces": "pigeons_tpu/ops/pallas_slice.py:94", **full,
            "delta_mode": delta}, delta_twin


def launched_only(launches, name, n):
    """Whether the launch counts show ``n`` launches of ``name`` and none of
    any other kernel."""
    return launches == {k: n if k == name else 0 for k in launches}


def eval_rate(pt):
    """Density evaluations per second of the last round, counted as
    ``bench.py:_eval_rate`` counts them: explorer queries plus the runtime's
    2N fused evaluations per scan and ladder."""
    rep = pt.reports[-1]
    evals = float(np.sum(pt.reduced.exp_steps)) + 2.0 * pt.n_chains * rep.n_scans * pt.n_replicates
    return evals / rep.wall_time_s


def config1_phase():
    """Bench config 1 end to end; returns the kernel launches it made and the
    run (phase 11 holds its one-rank mesh run to it)."""
    phase("3 config 1")
    from pigeons_tpu_torch import PT, SliceSamplerCUDA

    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pt = PT(config1_inputs())
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
    if not launched_only(launches, "banded_slice_sweep", scans):
        raise AssertionError(f"kernel launches {launches} for {scans} scans of K1")
    if not (np.abs(mean).max() < 0.02 and np.abs(var / 0.1 - 1).max() < 0.05):
        raise AssertionError("target moments off")
    if not abs(pt.global_barrier - JAX_BARRIER) < 0.3:
        raise AssertionError("global barrier off")
    if not math.isfinite(rep.log_z_estimate):
        raise AssertionError("logZ not finite")
    return launches["banded_slice_sweep"], pt


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
    if not launched_only(launches, "slice_sweep", scans):
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
    if not launched_only(launches, "banded_slice_sweep_variational", scans):
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


def bayesian_run(target, n_chains, n_replicates, rounds, on_round=None, kernel="slice_sweep",
                 **kw):
    """NRPT from a ``BayesianModel``'s prior to its posterior on the card with
    kernel K2, one slice pass per scan, rounds of the given lengths, calling
    ``on_round(pt)`` after each if given; returns the run and the launches it
    made (``kernel``'s, K2 or a user's instance of it, must equal the scans,
    every other kernel's be 0)."""
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA

    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pt = PT(Inputs(target=target, n_chains=n_chains, n_replicates=n_replicates, seed=SEED,
                   explorer=SliceSamplerCUDA(n_passes=H_PASSES), show_report=False, device="cuda",
                   **kw))
    for n_scans in rounds:
        pt.run_round(n_scans=n_scans)
        if on_round is not None:
            on_round(pt)
    launches = dict(SliceSamplerCUDA.launches)
    scans = sum(rounds)
    print(f"kernel launches {launches} for {scans} scans")
    if not launched_only(launches, kernel, scans):
        raise AssertionError(f"kernel launches {launches} for {scans} scans of {kernel}")
    return pt, launches[kernel]


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
    1.26 where the posterior's is about 0.2). Also returns the full-width
    run: phase 11 holds its two-rank run to it."""
    phase("3d hierarchical normal")
    from pigeons_tpu_torch import hierarchical_normal

    wide = {"mu": 0.95, "tau": 0.92, "sigma": 0.019, "barrier": 1.0, "logZ": 3.0}
    launches = full_width = None
    for ladders in (H_REPLICATES, H_JAX_LADDERS):
        tolerance = wide if ladders != H_JAX_LADDERS else {k: 1e-3 * abs(v) for k, v in H_JAX.items()}
        print(f"{H_CHAINS} chains x {ladders} ladders, rounds of {H_ROUNDS} scans")
        target = hierarchical_normal()
        pt, n_launches = bayesian_run(target, H_CHAINS, ladders, H_ROUNDS)
        launches = launches or n_launches
        full_width = full_width or pt
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
    return launches, full_width


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
    return launches, mu, pt.reports[-1].log_z_estimate


def mrna_phase():
    """The mRNA transfection model end to end at the hierarchical cell's
    width (32 chains x 256 ladders, rounds of 2..64 scans), and the same
    rounds at the JAX package's ladder count; returns the launches of K2 the
    full-width run made. At 16 ladders the port's run on the CPU is the JAX
    run bit for bit through all six rounds, since the kernel's terms fuse
    their residuals as XLA's loop does in the runtime's pass and inside the
    JAX kernel alike (``library.MrnaLikelihood``, ROADMAP §3 item 4,
    ``tools/torch_mrna_divergence.py``), and the card's run is too, as far
    as ``M_JAX_ROUNDS``'s six printed decimals show (on an H100).
    So every round is held within 1e-5 relative of ``M_JAX_ROUNDS`` (pooled
    means, barrier, logZ) plus half the last printed digit, and the largest
    relative difference of each round is printed. The last round
    at 256 ladders is held within three standard errors of the JAX run's
    pooled means, taking its 16 ladders as 16 independent draws; barrier
    and logZ (inside the run's transient) printed beside the JAX run's. The
    share of target-chain samples with lbeta > ldelta, the model's two
    modes, is printed, not gated."""
    phase("3k mRNA")
    from pigeons_tpu_torch import mrna_target

    names = ("lt0", "lkm0", "lbeta", "ldelta", "lsigma")

    def stats(pt, target):
        q = target.constrained_samples(pt)
        got = {name: float(np.mean(q[name])) for name in names}
        got.update(barrier=pt.global_barrier, logZ=pt.reports[-1].log_z_estimate)
        return got, float(np.mean(q["lbeta"] > q["ldelta"]))

    def gate(label, got, want, tolerance):
        print(f"{label}: " + ", ".join(
            f"{k} {v:.6f} (JAX package {want[k]}"
            + (f", tolerance {tolerance[k]:.4g})" if k in tolerance else ", printed)")
            for k, v in got.items()))
        for k, tol in tolerance.items():
            if not abs(got[k] - want[k]) <= tol:
                raise AssertionError(f"mRNA, {label}: {k} {got[k]} is off the JAX package's "
                                     f"{want[k]}")

    wide = {k: 3.0 * M_JAX_SD[k] / math.sqrt(H_JAX_LADDERS) for k in names}
    launches = None
    for ladders in (H_REPLICATES, H_JAX_LADDERS):
        print(f"{H_CHAINS} chains x {ladders} ladders, rounds of {H_ROUNDS} scans")
        target = mrna_target()

        def check_round(pt):
            if ladders == H_JAX_LADDERS:
                want = M_JAX_ROUNDS[pt.round_idx - 1]
                got = stats(pt, target)[0]
                # 1e-5 relative, and half of the last printed digit of M_JAX_ROUNDS
                gate(f"16 ladders, round {pt.round_idx}", got, want,
                     {k: 1e-5 * abs(v) + 5e-7 for k, v in want.items()})
                print(f"round {pt.round_idx}: largest relative difference from the JAX run "
                      f"{max(abs(got[k] - v) / abs(v) for k, v in want.items()):.3g}")

        pt, n_launches = bayesian_run(target, H_CHAINS, ladders, H_ROUNDS, on_round=check_round)
        launches = launches or n_launches
        print_round(pt, H_CHAINS * ladders)
        got, modes = stats(pt, target)
        gate(f"{ladders} ladders, the timed round", got, M_JAX, wide)
        print(f"share of the timed round's samples with lbeta > ldelta {modes:.4f}")
        if not np.isfinite(pt.sample_array()).all() or not math.isfinite(got["logZ"]):
            raise AssertionError("mRNA: non-finite samples or logZ")
        if not pt.n_tempered_restarts > 0 and ladders == H_REPLICATES:
            raise AssertionError("mRNA: no tempered restart")
    return launches


def bernoulli_phase():
    """The Bernoulli model (Beta(1, 1) prior, ten observations, two of them
    1), whose evidence is log B(3, 9): 10 chains x 64 ladders, rounds
    doubling to 32 scans; logZ within 0.1 of it. Printed beside it: whether
    the prior's draws (``rng.beta``, ``jax.random.beta``'s stream), the
    reference chain's and the initial states', are on the card the CPU's
    bits."""
    phase("3l Bernoulli")
    from pigeons_tpu_torch import bernoulli_target, rng

    model = bernoulli_target()
    keys = rng.keys_for(rng.key(SEED), torch.arange(S_CHAINS * S_REPLICATES))
    for form, draw in (("reference", lambda k: model.default_reference().sample_iid(k)),
                       ("initial", model.initialization)):
        card, cpu = draw(keys.cuda()).cpu(), draw(keys)
        print(f"Beta(1, 1) {form} draws of {keys.shape[0]} keys: card and CPU bitwise equal "
              f"{torch.equal(card.view(torch.int32), cpu.view(torch.int32))}")
    pt, launches = bayesian_run(model, S_CHAINS, S_REPLICATES, S_ROUNDS)
    print_round(pt, S_CHAINS * S_REPLICATES)
    print(f"logZ by round {[round(r.log_z_estimate, 4) for r in pt.reports]}, exact "
          f"{BERNOULLI_LOG_Z:.6f}")
    if not abs(pt.reports[-1].log_z_estimate - BERNOULLI_LOG_Z) < 0.1:
        raise AssertionError("Bernoulli: logZ off log B(3, 9)")
    if not pt.n_tempered_restarts > 0:
        raise AssertionError("Bernoulli: no tempered restart")
    return launches


def centered_eight_schools_phase(mu_noncentred, log_z_noncentred):
    """Centred eight schools at the non-centred run's width: the same
    posterior in another parameterisation (theta given tau is Neal's
    funnel, so it mixes slowly). The reference's own check: pooled mu
    within 2 of the non-centred run's (phase 3f); logZ printed beside that
    run's (both estimate log p(y); the pseudo-prior cancels)."""
    phase("3m eight schools, centred")
    from pigeons_tpu_torch import eight_schools

    target = eight_schools(centered=True)
    pt, launches = bayesian_run(target, S_CHAINS, S_REPLICATES, S_ROUNDS)
    print_round(pt, S_CHAINS * S_REPLICATES)
    q = target.constrained_samples(pt)
    mu, tau = float(np.mean(q["mu"])), float(np.mean(q["tau"]))
    log_z = pt.reports[-1].log_z_estimate
    print(f"pooled over the timed round: mu {mu:.4f} (non-centred {mu_noncentred:.4f}), tau "
          f"{tau:.4f}; logZ {log_z:.4f} (non-centred {log_z_noncentred:.4f})")
    if not abs(mu - mu_noncentred) < 2.0:
        raise AssertionError("centred eight schools: mu off the non-centred run's")
    if not (math.isfinite(log_z) and np.isfinite(pt.sample_array()).all()):
        raise AssertionError("centred eight schools: non-finite logZ or samples")
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


def config2a_phase():
    """Bench config 2a end to end on the card: the gradient path (the torch
    ``AutoMALA`` on ``paths.value_and_grad``; no kernel of the port is on it).
    Gated on the law as the slice path of this target is (every pooled
    posterior weight within 1 of the weight that made the data), finite logZ,
    restarts, the explorer's acceptance above 0.4 (reference
    ``test_auto_mala.jl:44-48``) and its reversibility rate recorded at every
    chain; K1 and K2 must not launch. Returns the run."""
    phase("3i config 2a (AutoMALA)")
    from pigeons_tpu_torch import PT, AutoMALA, Inputs, SliceSamplerCUDA, logistic_regression, rng

    print(f"timed round cut from bench.py's best of 3 rounds of {A_MEASURE_SCANS} scans to one")
    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    target = logistic_regression(200, 10, seed=0)
    pt = PT(Inputs(target=target, n_chains=A_CHAINS, n_replicates=A_REPLICATES, seed=SEED,
                   explorer=AutoMALA(), show_report=False, device="cuda"))
    for _ in range(A_AUTOMALA_WARMUP_ROUNDS):
        pt.run_round(n_scans=A_WARMUP_SCANS)
    pt.run_round(n_scans=A_MEASURE_SCANS)
    launches = dict(SliceSamplerCUDA.launches)
    lanes = A_CHAINS * A_REPLICATES
    rep = pt.reports[-1]
    red = pt.reduced
    factor, rev = red.extra_mean[:, 0], red.extra_mean[:, 1]
    accept = float(np.nanmean(red.exp_accept))
    print(f"timed round: {A_MEASURE_SCANS} scans of {lanes} lanes in {rep.wall_time_s:.4f} s "
          f"({rep.wall_time_s / A_MEASURE_SCANS * 1e3:.3f} ms per scan), {eval_rate(pt):.6g} "
          f"evals/s (an eval is one leapfrog: a density and its gradient), "
          f"{float(np.sum(red.exp_steps)) / (A_MEASURE_SCANS * lanes):.2f} leapfrogs per lane and "
          f"scan, peak device memory {rep.peak_memory_bytes} B")
    print(f"mean step-size factor 2^exponent {float(np.nanmean(factor)):.4f} (by chain "
          f"{np.round(factor, 3).tolist()}), adapted base step {float(pt.exp_state['step_size'][0]):.6f}; "
          f"explorer acceptance {accept:.4f}; reversibility rate {float(np.nanmean(rev)):.4f}")
    print(f"barrier {pt.global_barrier:.6f}, logZ {rep.log_z_estimate:.6f}, round trips "
          f"{pt.n_round_trips}, restarts {pt.n_tempered_restarts}, swap accept mean "
          f"{rep.mean_swap_accept:.4f}; kernel launches {launches}")
    w_true = rng.normal(rng.fold_in(rng.key(0), 1), (10,)).numpy()
    w = target.constrained_samples(pt)["w"].mean(0)
    print(f"pooled posterior mean of w {[round(float(v), 3) for v in w]}, largest gap to the "
          f"weights that made the data {np.abs(w - w_true).max():.4f}")
    if any(launches.values()):
        raise AssertionError(f"config 2a launched slice kernels: {launches}")
    if not np.abs(w - w_true).max() < 1.0:
        raise AssertionError("config 2a: posterior mean of the weights off")
    if not (math.isfinite(rep.log_z_estimate) and pt.n_tempered_restarts > 0):
        raise AssertionError("config 2a: no finite logZ or no tempered restart")
    if not accept > 0.4:
        raise AssertionError(f"config 2a: explorer acceptance {accept} <= 0.4")
    if not (red.extra_n[:, 1] > 0).all():
        raise AssertionError("config 2a: reversibility rate not recorded at every chain")
    dense_leapfrog_rate(pt)
    return pt, target


def dense_leapfrog_rate(pt, n_iters=A_DENSE_ITERS, path=None, lanes=None, label="dense leapfrog"):
    """Leapfrogs per second with no search: every lane of the run (the first
    ``lanes``), at its own beta, takes ``n_iters`` chained steps of a density
    and its gradient (the counterpart of ``bench.py:385-418``) on the run's
    path or on ``path``. Beside the achieved rate it says what the search
    costs. Returns the rate."""
    from pigeons_tpu_torch.ops.hamiltonian import LaneGradient

    lanes = lanes or pt._states.shape[0]
    chain_flat = pt._chain_of.reshape(-1)[:lanes]
    vg = LaneGradient(path or pt._density_path, pt.betas[chain_flat])
    x0 = pt._states[:lanes].clone()
    v0 = torch.randn(x0.shape, generator=torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")

    def run():
        x, v = x0, v0
        for _ in range(n_iters):
            lp, g = vg(x)
            v = v + (0.5 * 0.01) * g
            x = x + 0.01 * v
        return lp

    run()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    rate = lanes * n_iters / best
    print(f"{label}: {lanes} lanes x {n_iters} steps in {best:.4f} s (best of 3), "
          f"{rate:.6g} leapfrogs/s, {best / n_iters * 1e3:.3f} ms per leapfrog; AutoMALA's "
          f"timed round above {eval_rate(pt):.6g} evals/s")
    return rate


def host_serial_rate(seconds=B_HOST_SECONDS):
    """Density-and-gradient evaluations per second of a logistic regression
    of config 2b's shape in float64 numpy on the host, one state at a time
    (``bench.py:363-382``, on its own random data): the serial denominator
    beside the card's rates."""
    rs = np.random.default_rng(0)
    X = rs.normal(size=(B_N, B_D))
    y = (rs.random(B_N) < 0.5).astype(np.float64)
    w = rs.normal(size=B_D) * 0.05
    evals = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        z = X @ w
        p = 1.0 / (1.0 + np.exp(-z))
        lp = float(np.sum(y * z - np.logaddexp(0.0, z))) - 0.125 * float(w @ w)
        g = X.T @ (y - p) - 0.25 * w
        w = w + 1e-7 * g  # the state moves, so nothing is cached
        evals += 1
        del lp
    return evals / (time.perf_counter() - t0)


def logistic_float64(X, y, theta):
    """The logistic regression's log posterior (``N(0, 2^2)`` priors on every
    weight and the intercept) and its gradient in float64 numpy, for states
    ``theta [L, d + 1]``."""
    z = theta[:, :-1] @ X.T + theta[:, -1:]
    resid = y - 0.5 * (1.0 + np.tanh(0.5 * z))  # y - sigmoid(z)
    lp = np.sum(y * z - np.logaddexp(0.0, z), 1) + np.sum(
        -0.5 * (math.log(2.0 * math.pi) + (theta / 2.0) ** 2) - math.log(2.0), 1)
    grad = np.concatenate([resid @ X, resid.sum(1, keepdims=True)], 1) - theta / 4.0
    return lp, grad


def logistic_map(X, y):
    """The float64 MAP of the logistic regression by Newton's method, and its
    Laplace standard deviations (the inverse Hessian's diagonal)."""
    Xa = np.hstack([X, np.ones((X.shape[0], 1))])
    theta = np.zeros(Xa.shape[1])
    for _ in range(100):
        p = 0.5 * (1.0 + np.tanh(0.5 * (Xa @ theta)))
        hess = -(Xa.T * (p * (1.0 - p))) @ Xa - np.eye(Xa.shape[1]) / 4.0
        step = np.linalg.solve(hess, Xa.T @ (y - p) - theta / 4.0)
        theta = theta - step
        if np.abs(step).max() < 1e-12:
            break
    return theta, np.sqrt(np.diag(np.linalg.inv(-hess)))


def config2b_phase():
    """Bench config 2b end to end on the card: the queued AutoMALA on the
    logistic regression's dense form (one float32 product per evaluation,
    cuBLAS; no kernel of the port is on the path). Gated on finite logZ,
    the explorer's acceptance above 0.4 (reference ``test_auto_mala.jl:44-48``,
    as config 2a), its reversibility rate recorded at every chain, no K1 or
    K2 launch, float32 products without TF32, and the dense form's value and
    gradient at 256 of the run's states within 1e-5 relative and 1e-4 of the
    lane's largest gradient component of a float64 evaluation. Prints the
    rates of bench.py's config 2b beside the dense leapfrog's, the column
    form's and the host's, and the target chain's mean against the float64
    MAP. Returns the run and its target."""
    phase("3j config 2b (queued AutoMALA)")
    from pigeons_tpu_torch import PT, AutoMALA, Inputs, SliceSamplerCUDA, logistic_regression, paths
    from pigeons_tpu_torch.models.bayesian import BayesianModel

    precision = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    print(f"float32 products: allow_tf32 {precision[0]}, precision {precision[1]!r}")
    if precision != (False, "highest"):
        raise AssertionError("config 2b: float32 products would run in TF32")
    print(f"timed round cut from bench.py's best of 3 rounds of {B_BENCH_SCANS} scans to one "
          f"of {B_MEASURE_SCANS}")
    target = logistic_regression(B_N, B_D, seed=0)
    if not target.log_likelihood_fn.uses_dense:
        raise AssertionError("config 2b: the likelihood is not in its dense form")
    lanes = B_CHAINS * B_REPLICATES

    def inputs(explorer):
        return Inputs(target=target, n_chains=B_CHAINS, n_replicates=B_REPLICATES, seed=SEED,
                      explorer=explorer, show_report=False, device="cuda")

    like = target.log_likelihood_fn
    X, y = like.X.double().numpy(), like.y.double().numpy()
    theta, sd = logistic_map(X, y)

    def gap():
        """The target chain's pooled mean of w over the last round, in Laplace
        standard deviations from the float64 MAP."""
        return np.abs(target.constrained_samples(pt)["w"].mean(0) - theta[:B_D]) / sd[:B_D]

    SliceSamplerCUDA.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pt = PT(inputs(AutoMALA(queued=True, queue_width=B_QUEUE_WIDTH, window=B_WINDOW)))
    for _ in range(B_WARMUP_ROUNDS):
        pt.run_round(n_scans=B_WARMUP_SCANS)
        rep = pt.reports[-1]
        print(f"warm-up round {pt.round_idx}: {rep.wall_time_s:.4f} s, "
              f"{float(np.sum(pt.reduced.exp_steps)) / (rep.n_scans * lanes):.2f} leapfrogs per "
              f"lane and scan, step size {float(pt.exp_state['step_size'][0]):.6f}, barrier "
              f"{pt.global_barrier:.4f}, largest gap of the mean of w to the MAP "
              f"{gap().max():.4f} Laplace standard deviations")
    pt.run_round(n_scans=B_MEASURE_SCANS)
    launches = dict(SliceSamplerCUDA.launches)
    rep, red = pt.reports[-1], pt.reduced
    rate = eval_rate(pt)
    factor, rev = red.extra_mean[:, 0], red.extra_mean[:, 1]
    accept = float(np.nanmean(red.exp_accept))
    print(f"timed round: {B_MEASURE_SCANS} scans of {lanes} lanes in {rep.wall_time_s:.4f} s "
          f"({rep.wall_time_s / B_MEASURE_SCANS * 1e3:.3f} ms per scan), {rate:.6g} evals/s, "
          f"{rate * B_FLOP_PER_EVAL / 1e12:.6g} TFLOP/s at 4 n (d + 1) per eval "
          f"({rate * B_FLOP_PER_EVAL / FP32_OPS_PER_S:.4%} of 67 TFLOP/s float32), "
          f"{float(np.sum(red.exp_steps)) / (B_MEASURE_SCANS * lanes):.2f} leapfrogs per lane and "
          f"scan, peak device memory {rep.peak_memory_bytes} B")
    print(f"mean step-size factor 2^exponent {float(np.nanmean(factor)):.4f}, adapted base step "
          f"{float(pt.exp_state['step_size'][0]):.6f}; explorer acceptance {accept:.4f}; "
          f"reversibility rate {float(np.nanmean(rev)):.4f} (by chain {np.round(rev, 3).tolist()})")
    print(f"barrier {pt.global_barrier:.6f}, logZ {rep.log_z_estimate:.6f}, round trips "
          f"{pt.n_round_trips}, restarts {pt.n_tempered_restarts}, swap accept mean "
          f"{rep.mean_swap_accept:.4f}; kernel launches {launches}")
    if any(launches.values()):
        raise AssertionError(f"config 2b launched slice kernels: {launches}")
    if not math.isfinite(rep.log_z_estimate):
        raise AssertionError("config 2b: no finite logZ")
    if not accept > 0.4:
        raise AssertionError(f"config 2b: explorer acceptance {accept} <= 0.4")
    if not (red.extra_n[:, 1] > 0).all():
        raise AssertionError("config 2b: reversibility rate not recorded at every chain")

    x = pt._states[:B_CHECK_LANES]
    lp, grad = paths.value_and_grad(pt.path, x, torch.ones(B_CHECK_LANES, device="cuda"))
    want_lp, want_grad = logistic_float64(X, y, x.double().cpu().numpy())
    lp_err = float(np.max(np.abs(lp.double().cpu().numpy() - want_lp) / np.abs(want_lp)))
    grad_err = float(np.max(np.abs(grad.double().cpu().numpy() - want_grad).max(1)
                            / np.abs(want_grad).max(1)))
    print(f"dense form on the card at {B_CHECK_LANES} of the run's states, against float64: "
          f"density within {lp_err:.3g} relative, gradient within {grad_err:.3g} of the lane's "
          f"largest component")
    if not (lp_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError("config 2b: the dense form is off its float64 value")
    gaps = gap()
    print(f"target chain's pooled mean of w against the float64 MAP: largest gap "
          f"{gaps.max():.4f} Laplace standard deviations (w[{int(gaps.argmax())}]), mean gap "
          f"{gaps.mean():.4f}; Laplace standard deviations {sd[:B_D].min():.4f} to "
          f"{sd[:B_D].max():.4f}. Not gated: after "
          f"{B_WARMUP_ROUNDS * B_WARMUP_SCANS + B_MEASURE_SCANS} scans the run is inside its "
          f"transient")

    ctrl = PT(inputs(AutoMALA()))
    ctrl.run_round(n_scans=B_CONTROL_SCANS)
    ctrl_red = ctrl.run_round(n_scans=B_CONTROL_SCANS)
    alg_per_scan = float(np.sum(ctrl_red.exp_steps)) / B_CONTROL_SCANS
    alg_per_round = alg_per_scan * B_MEASURE_SCANS + 2.0 * lanes * B_MEASURE_SCANS
    dense_rate = dense_leapfrog_rate(pt, B_DENSE_ITERS)
    model = target.to("cuda")
    column = BayesianModel(model.priors, model.log_likelihood_fn.sweep)
    column_rate = dense_leapfrog_rate(pt, B_COLUMN_ITERS,
                                      path=column.create_path(column.default_reference()),
                                      lanes=B_COLUMN_LANES, label="column form's leapfrog (before)")
    floor_wall = alg_per_round / dense_rate
    host = host_serial_rate()
    print(f"sequential AutoMALA() control ({B_CONTROL_SCANS} + {B_CONTROL_SCANS} scans): "
          f"{alg_per_scan:.6g} algorithmic evaluations per scan ({alg_per_scan / lanes:.2f} per "
          f"lane), {ctrl.reports[-1].wall_time_s / B_CONTROL_SCANS * 1e3:.3f} ms per scan; "
          f"floor of the timed round {floor_wall:.4f} s at the dense rate, pct_of_floor "
          f"{100.0 * floor_wall / rep.wall_time_s:.4f} %, algorithmic rate "
          f"{alg_per_round / rep.wall_time_s:.6g} evals/s")
    print(f"rates (evals/s): queued round {rate:.6g}, dense leapfrog {dense_rate:.6g} "
          f"({dense_rate * B_FLOP_PER_EVAL / 1e12:.6g} TFLOP/s), column form {column_rate:.6g}, "
          f"host numpy serial {host:.6g}")
    return pt, target


def counting_aaps(step_size):
    """``AAPS(step_size)`` that also counts, on the device, its moves and
    the moves it bailed (a segment that diverged or reached
    ``max_segment_steps``): ``moves``, ``bailed``. The explorer's own
    statistics say nothing of a bail (the JAX explorer's do not either)."""
    from pigeons_tpu_torch import AAPS

    class CountingAAPS(AAPS):
        moves, bailed = 0, 0

        def _segment(self, *args):
            out = super()._segment(*args)
            self._oks.append(out[5])
            return out

        def step_batched(self, keys, xs, *args, **kw):
            self._oks = []
            out = super().step_batched(keys, xs, *args, **kw)
            self.bailed = self.bailed + (~torch.stack(self._oks).all(0)).sum()
            self.moves += xs.shape[0]
            return out

    return CountingAAPS(step_size=step_size)


@contextlib.contextmanager
def host_reads():
    """Counts the reads of device values on the host inside the block (the
    synchronizing calls torch's sync debug mode warns of): the list it
    yields holds the count after the block."""
    import warnings

    count = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode("default")
    count.append(sum("synchroniz" in str(w.message) for w in caught))


def nuts_aaps_phase():
    """NUTS and AAPS at config 2a's width end to end on the card: the
    gradient path with dynamic trajectories (torch ops, no kernel of the
    port on it). Gated as config 2a is on the law (every pooled posterior
    weight within 1 of the weight that made the data), finite logZ,
    restarts and no K1 / K2 launch; NUTS also on its step size having moved
    from 1.0, its acceptance finite in (0, 1] and its depth recorded at every
    chain. Prints each timed round's scan time, leapfrogs per lane and scan,
    host reads per scan and evals/s (a leapfrog is an eval, as
    ``bench.py:152-158`` counts them), and AAPS's share of bailed moves.
    Returns the two runs and the target."""
    phase("3n NUTS and AAPS at config 2's width")
    from pigeons_tpu_torch import NUTS, PT, Inputs, SliceSamplerCUDA, logistic_regression, rng

    target = logistic_regression(200, 10, seed=0)
    w_true = rng.normal(rng.fold_in(rng.key(0), 1), (10,)).numpy()
    lanes = A_CHAINS * A_REPLICATES
    runs = {}
    for name, explorer in (("NUTS", NUTS()), ("AAPS", counting_aaps(N_AAPS_STEP))):
        t0 = time.perf_counter()
        SliceSamplerCUDA.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        pt = PT(Inputs(target=target, n_chains=A_CHAINS, n_replicates=A_REPLICATES, seed=SEED,
                       explorer=explorer, show_report=False, device="cuda"))
        for _ in range(A_WARMUP_ROUNDS):
            pt.run_round(n_scans=A_WARMUP_SCANS)
        moves, bailed = getattr(explorer, "moves", 0), getattr(explorer, "bailed", 0)
        with host_reads() as reads:
            pt.run_round(n_scans=N_MEASURE_SCANS)
        launches = dict(SliceSamplerCUDA.launches)
        rep, red = pt.reports[-1], pt.reduced
        print(f"{name}: {A_WARMUP_ROUNDS} warm-up rounds of {A_WARMUP_SCANS} scans, then "
              f"{N_MEASURE_SCANS} scans of {lanes} lanes in {rep.wall_time_s:.4f} s "
              f"({rep.wall_time_s / N_MEASURE_SCANS * 1e3:.3f} ms per scan), {eval_rate(pt):.6g} "
              f"evals/s (an eval is one leapfrog: a density and its gradient), "
              f"{float(np.sum(red.exp_steps)) / (N_MEASURE_SCANS * lanes):.2f} leapfrogs per lane "
              f"and scan, {reads[0] / N_MEASURE_SCANS:.1f} synchronizing calls (host reads) per "
              f"scan, peak device "
              f"memory {rep.peak_memory_bytes} B; phase {time.perf_counter() - t0:.1f} s")
        print(f"{name}: barrier {pt.global_barrier:.6f}, logZ {rep.log_z_estimate:.6f}, round "
              f"trips {pt.n_round_trips}, restarts {pt.n_tempered_restarts}, swap accept mean "
              f"{rep.mean_swap_accept:.4f}; kernel launches {launches}")
        w = target.constrained_samples(pt)["w"].mean(0)
        print(f"{name}: pooled posterior mean of w {[round(float(v), 3) for v in w]}, largest "
              f"gap to the weights that made the data {np.abs(w - w_true).max():.4f}")
        if any(launches.values()):
            raise AssertionError(f"{name} launched slice kernels: {launches}")
        if not np.abs(w - w_true).max() < 1.0:
            raise AssertionError(f"{name}: posterior mean of the weights off")
        if not (math.isfinite(rep.log_z_estimate) and pt.n_tempered_restarts > 0):
            raise AssertionError(f"{name}: no finite logZ or no tempered restart")
        if name == "NUTS":
            acc, depth = red.extra_mean[:, 0], red.extra_mean[:, 1]
            step = pt.exp_state["step_size"].cpu().numpy()
            print(f"NUTS: adapted step size {float(step[0]):.6f}; leaf acceptance by chain "
                  f"{np.round(acc, 4).tolist()}; depth by chain {np.round(depth, 3).tolist()}")
            if np.all(step == 1.0):
                raise AssertionError("NUTS: the step size did not move from 1.0")
            if not (np.all(np.isfinite(acc)) and np.all((acc > 0.0) & (acc <= 1.0))):
                raise AssertionError(f"NUTS: leaf acceptance {acc} not finite in (0, 1]")
            if not (red.extra_n[:, 1] > 0).all():
                raise AssertionError("NUTS: tree depth not recorded at every chain")
        else:
            warm = float(bailed) / moves
            timed = float(explorer.bailed - bailed) / (explorer.moves - moves)
            print(f"AAPS(step_size={N_AAPS_STEP}): bailed moves {warm:.4%} of the warm-up's, "
                  f"{timed:.4%} of the timed round's")
        runs[name] = pt
    return runs, target


def explore_card_vs_cpu(pt, target, explorer, label, lanes=A_COMPARE_LADDERS * A_CHAINS):
    """One explore (``explorer.step_batched``) of the first ``lanes`` lanes of
    a run, from the same states, keys and chain params, on the card and on
    the CPU. A lane's decisions are its leapfrog count, its depth (NUTS,
    the second statistic) and whether it moved; at most 1 % of the lanes
    may differ in one, and the others must agree within 1e-4 in state."""
    from pigeons_tpu_torch import rng
    from pigeons_tpu_torch.tree import tree_map

    n = pt.n_chains
    R = -(-lanes // n)
    chain_flat = pt._chain_of[:R].reshape(-1)[:lanes]
    k = rng.scan_key(pt._key[:R], pt.round_idx + 1, 2, rng.EXPLORE)
    keys = rng.keys_for(k, torch.arange(n, device="cuda")).reshape(R * n, 2)[:lanes]
    inputs = dict(keys=keys, xs=pt._states[:lanes], betas=pt.betas[chain_flat])
    params = tree_map(lambda v: v[chain_flat], pt.exp_state)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = target.to(dev)
        out[dev] = explorer.step_batched(
            **{key: v.to(dev) for key, v in inputs.items()},
            path=model.create_path(model.default_reference()),
            chain_params=tree_map(lambda v: v.to(dev), params), scan_idx=2)
        print(f"{label} on {dev}: {time.perf_counter() - t0:.3f} s")
    g, c = out["cuda"], out["cpu"]
    x0 = inputs["xs"].cpu()
    agree = (g.n_steps.cpu() == c.n_steps) & ((g.x.cpu() != x0).any(1) == (c.x != x0).any(1))
    if g.extras_sum is not None:
        agree &= g.extras_sum[:, 1].cpu() == c.extras_sum[:, 1]
    diff = float((g.x.cpu() - c.x)[agree].abs().max())
    print(f"{label}: {int((~agree).sum())} of {lanes} lanes differ in a decision; lanes that "
          f"agree: max |state diff| {diff}; {float(c.n_steps.mean()):.2f} leapfrogs a lane")
    if (~agree).sum() > 0.01 * lanes or diff > 1e-4:
        raise AssertionError(f"{label}: card and CPU disagree")


def nuts_aaps_card_vs_cpu_phase(runs, target):
    """Phase 3n's card-against-CPU check: one NUTS and one AAPS explore of
    640 of each run's lanes."""
    phase("3n NUTS and AAPS, card vs CPU")
    from pigeons_tpu_torch import AAPS, NUTS

    explore_card_vs_cpu(runs["NUTS"], target, NUTS(), "NUTS explore")
    explore_card_vs_cpu(runs["AAPS"], target, AAPS(step_size=N_AAPS_STEP), "AAPS explore")


def combinators_phase():
    """The combinators card against CPU: 4 chains of the toy MVN (d=2), 3
    rounds, for each combinator on the card and on the CPU. ``Mix``'s
    per-lane choices for every scan's keys must be the CPU's bit for bit;
    the runs' states must agree within 1e-4 at all but 1 % of the lanes,
    and their swaps exactly; no slice kernel launches (the slice sampler in
    them is the torch ``SliceSampler``, as the JAX package's combinators run
    the XLA sampler for ``SliceSamplerPallas``)."""
    phase("6c combinators, card vs CPU")
    from pigeons_tpu_torch import (MALA, PT, AutoMALA, Compose, Inputs, Mix, ScanMix,
                                   SliceSampler, SliceSamplerCUDA, rng, toy_mvn_target)

    cases = (("Compose(SliceSampler(n_passes=1), MALA(0.3))",
              lambda: Compose(SliceSampler(n_passes=1), MALA(step_size=0.3))),
             ("Mix(MALA(0.3), AutoMALA())", lambda: Mix(MALA(step_size=0.3), AutoMALA())),
             ("ScanMix(SliceSampler(n_passes=1), AutoMALA())",
              lambda: ScanMix(SliceSampler(n_passes=1), AutoMALA())))
    for name, make in cases:
        t0 = time.perf_counter()
        runs = {}
        SliceSamplerCUDA.reset_launches()
        for dev in ("cuda", "cpu"):
            runs[dev] = PT(Inputs(target=toy_mvn_target(C_DIM), n_chains=C_CHAINS,
                                  n_rounds=C_ROUNDS, seed=SEED, explorer=make(),
                                  show_report=False, device=dev)).run()
        launches = dict(SliceSamplerCUDA.launches)
        g, c = runs["cuda"], runs["cpu"]
        close = (g.states.cpu() - c.states).abs().max(-1).values <= 1e-4
        swaps = torch.equal(g.chain_of.cpu(), c.chain_of)
        print(f"{name}: {int((~close).sum())} of {close.numel()} lanes differ card against CPU, "
              f"permutations equal {swaps}, restarts {g.n_tempered_restarts} / "
              f"{c.n_tempered_restarts}, kernel launches {launches}; "
              f"{time.perf_counter() - t0:.1f} s")
        if isinstance(g.explorer, Mix):
            picks = []
            for r in range(1, C_ROUNDS + 1):
                for scan in range(1, 2**r + 1):
                    keys = {}
                    for dev, pt in runs.items():
                        k = rng.scan_key(pt._key, r, scan, rng.EXPLORE)
                        keys[dev] = pt.explorer.choices(
                            rng.keys_for(k, torch.arange(C_CHAINS, device=pt.device))
                            .reshape(-1, 2))[0]
                    picks.append(torch.equal(keys["cuda"].cpu(), keys["cpu"]))
            print(f"{name}: per-lane choices of {len(picks)} scans bit for bit card against "
                  f"CPU: {all(picks)}")
            if not all(picks):
                raise AssertionError(f"{name}: Mix's choices differ card against CPU")
        if any(launches.values()):
            raise AssertionError(f"{name}: slice kernels launched: {launches}")
        if (~close).sum() > 0.01 * close.numel() or not swaps:
            raise AssertionError(f"{name}: card and CPU runs disagree")


def automala_card_vs_cpu_phase(pt, target, title="6b AutoMALA, card vs CPU",
                               lanes=A_COMPARE_LADDERS * A_CHAINS, max_differ=None, **explorer_kw):
    """One AutoMALA (``explorer_kw``) explore of the first ``lanes`` lanes of
    a run, from the same states, keys and chain params, on the card and on
    the CPU: one refreshment, whose step-size factors and accept decisions
    are compared lane by lane, then a whole explore; lanes whose decisions
    all agree must agree in state within 1e-4, and at most ``max_differ``
    lanes (1 % by default) may differ in a decision."""
    phase(title)
    from pigeons_tpu_torch import AutoMALA, rng

    n = pt.n_chains
    R = -(-lanes // n)
    chain_flat = pt._chain_of[:R].reshape(-1)[:lanes]
    k = rng.scan_key(pt._key[:R], pt.round_idx + 1, 2, rng.EXPLORE)
    keys = rng.keys_for(k, torch.arange(n, device="cuda")).reshape(R * n, 2)[:lanes]
    inputs = dict(keys=keys, xs=pt._states[:lanes], betas=pt.betas[chain_flat])
    params = {name: v[chain_flat] for name, v in pt.exp_state.items()}
    max_differ = 0.01 * lanes if max_differ is None else max_differ
    for label, explorer in (("one refreshment", AutoMALA(base_n_refresh=1, exponent_n_refresh=0.0,
                                                         **explorer_kw)),
                            ("whole explore", AutoMALA(**explorer_kw))):
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            model = target.to(dev)
            out[dev] = explorer.step_batched(
                **{key: v.to(dev) for key, v in inputs.items()},
                path=model.create_path(model.default_reference()),
                chain_params={name: v.to(dev) for name, v in params.items()}, scan_idx=2)
            print(f"{label} on {dev}: {time.perf_counter() - t0:.3f} s")
        g, c = (out[dev] for dev in ("cuda", "cpu"))
        factors = (g.extras_sum.cpu() == c.extras_sum).all(1)
        moved_g = (g.x.cpu() != inputs["xs"].cpu()).any(1)
        moved_c = (c.x != inputs["xs"].cpu()).any(1)
        agree = factors & (moved_g == moved_c) & (g.n_steps.cpu() == c.n_steps)
        diff = float((g.x.cpu() - c.x)[agree].abs().max())
        print(f"{label}: step-size factors differ in {int((~factors).sum())} of {lanes} lanes, "
              f"accept decisions in {int((moved_g != moved_c).sum())}; lanes whose decisions all "
              f"agree: {int(agree.sum())}, max |state diff| there {diff} (at most "
              f"{max_differ:g} lanes may differ)")
        if (~agree).sum() > max_differ or diff > 1e-4:
            raise AssertionError(f"AutoMALA {label}: card and CPU disagree")


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


def discrete_phase():
    """The ordinal and Bool targets through their default explorers, card
    against CPU: ``ising_target(0.4, 3)`` with ``BinaryGibbs``, the Poisson
    count and the binary mixture with the masked torch ``SliceSampler`` (no
    kernel takes them: 0 launches), one round each, bitwise equal; then the
    Ising model on the card against its enumeration (logZ within 0.2, mean
    |M| within 0.05, states exactly binary)."""
    phase("7b ordinal and Bool targets, card vs CPU")
    from pigeons_tpu_torch import (PT, Inputs, SliceSamplerCUDA, binary_mixture_target,
                                   ising_target, poisson_count_target)

    SliceSamplerCUDA.reset_launches()
    for name, target in (("Ising 3 x 3", ising_target(0.4, 3)),
                         ("Poisson count", poisson_count_target(5.0, 1)),
                         ("binary mixture", binary_mixture_target())):
        t0 = time.perf_counter()
        g, c = (PT(Inputs(target=target, n_chains=DISCRETE_CHAINS, n_replicates=DISCRETE_REPLICATES,
                          seed=4, n_rounds=1, show_report=False, device=dev)).run()
                for dev in ("cuda", "cpu"))
        same = (torch.equal(g.chain_of.cpu(), c.chain_of) and torch.equal(g.states.cpu(), c.states)
                and np.array_equal(g.reduced.exp_steps, c.reduced.exp_steps))
        print(f"{name} ({type(g.explorer).__name__}): card and CPU runs bitwise equal {same} "
              f"({time.perf_counter() - t0:.1f} s for both)")
        if not same:
            raise AssertionError(f"{name}: card run disagrees with the CPU run")
    if any(SliceSamplerCUDA.launches.values()):
        raise AssertionError(f"the discrete targets launched {SliceSamplerCUDA.launches}")
    target = ising_target(0.4, 3)
    lz, mag = target.enumerate_oracle()
    pt = PT(Inputs(target=target, n_chains=6, n_replicates=ISING_REPLICATES, seed=1,
                   n_rounds=ISING_ROUNDS, show_report=False, device="cuda")).run()
    samples = pt.sample_array()[:, :-1]
    est_mag = float(np.abs((2.0 * samples - 1.0).mean(axis=1)).mean())
    print(f"Ising on the card: logZ {pt.reports[-1].log_z_estimate:.4f} (exact {lz:.4f}), |M| "
          f"{est_mag:.4f} (exact {mag:.4f}), round trips {pt.n_round_trips}")
    if not (abs(pt.reports[-1].log_z_estimate - lz) < 0.2 and abs(est_mag - mag) < 0.05
            and set(np.unique(samples)) <= {0.0, 1.0}):
        raise AssertionError("Ising: off its enumeration")


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


def profile_phase(only=None):
    """torch.profiler over one round of each path (of those named in
    ``only``, where given)."""
    phase("8 profile")
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
    from pigeons_tpu_torch import AutoMALA, logistic_regression

    config2a = Inputs(target=logistic_regression(), n_chains=A_CHAINS, n_replicates=A_REPLICATES,
                      seed=SEED, explorer=AutoMALA(), show_report=False, device="cuda")
    config2b = Inputs(target=logistic_regression(B_N, B_D), n_chains=B_CHAINS,
                      n_replicates=B_REPLICATES, seed=SEED, show_report=False, device="cuda",
                      explorer=AutoMALA(queued=True, queue_width=B_QUEUE_WIDTH, window=B_WINDOW))
    from pigeons_tpu_torch import NUTS

    nuts = Inputs(target=logistic_regression(), n_chains=A_CHAINS, n_replicates=A_REPLICATES,
                  seed=SEED, explorer=NUTS(), show_report=False, device="cuda")
    from pigeons_tpu_torch import stan_target

    # phase 14c's varying-slopes model on its default AutoMALA, one scan
    slopes = Inputs(target=stan_target(source=STAN_VARYING_SLOPES, data=varying_slopes_data()[0]),
                    n_chains=ST_VS_CHAINS, n_replicates=ST_VS_REPLICATES, seed=SEED,
                    show_report=False, device="cuda")
    for name, inputs, n_scans, kernel in (("config1", config1, WARMUP_SCANS, "banded_slice"),
                                          ("funnel", funnel_inputs(), F_WARMUP_SCANS, "slice_sweep"),
                                          ("config4", config4, V_WARMUP_SCANS, "banded_slice"),
                                          ("hierarchical", hierarchical, 8, "slice_sweep"),
                                          ("config2a", config2a, A_PROFILE_SCANS, None),
                                          ("config2b", config2b, B_PROFILE_SCANS, None),
                                          ("config2a_nuts", nuts, A_WARMUP_SCANS, None),
                                          ("stan_varying_slopes", slopes, 1, None)):
        if only is not None and name not in only:
            continue
        pt = PT(inputs)
        pt.run_round(n_scans=n_scans)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pt.run_round(n_scans=n_scans)
        averages = prof.key_averages()  # slow over a config 2a round: once
        table = averages.table(sort_by="cuda_time_total", row_limit=40)
        with open(f"chiprun_out/profile_{name}.txt", "w") as f:
            f.write(table)
            f.write("\nby count\n" + averages.table(sort_by="count", row_limit=40))
        dev_events = [e for e in averages
                      if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        device_us = sum(e.self_device_time_total for e in dev_events)
        kernel_us = sum(e.self_device_time_total for e in dev_events
                        if kernel is not None and kernel in e.key)
        # a host sync reads a device value: bool(), int() or float() of a
        # tensor, or the length of nonzero()'s answer
        syncs = sum(e.count for e in averages
                    if e.key in ("aten::_local_scalar_dense", "aten::nonzero"))
        wall = pt.reports[-1].wall_time_s
        n_ops = sum(e.count for e in dev_events)
        evals = float(np.sum(pt.reduced.exp_steps)) / n_scans
        print(f"profile {name}: {n_scans} scans, wall {wall:.4f} s, device busy "
              f"{device_us / 1e3:.3f} ms ({device_us / 1e6 / wall:.2%} of wall) over "
              f"{n_ops} device ops ({n_ops / n_scans:.0f} per scan); {syncs / n_scans:.1f} host "
              f"syncs per scan; {evals:.6g} explorer evaluations per scan; {kernel or 'no'} "
              f"kernel {kernel_us / 1e3:.3f} ms")
        print(table[:5000])


@contextlib.contextmanager
def timed_checkpoints():
    """Times every ``write_checkpoint`` inside the block and measures what
    it leaves on disk: yields the list of ``(round, seconds, bytes)``."""
    from pigeons_tpu_torch import checkpoint

    writes, write = [], checkpoint.write_checkpoint

    def timed(pt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folder = write(pt)
        seconds = time.perf_counter() - t0
        writes.append((pt.round_idx, seconds, sum(f.stat().st_size for f in
                                                  Path(folder).iterdir())))
        return folder

    checkpoint.write_checkpoint = timed
    try:
        yield writes
    finally:
        checkpoint.write_checkpoint = write


def stop_and_resume(name, make_inputs, n_rounds, stop, folder, kernel=None):
    """Runs ``make_inputs()`` for ``n_rounds`` with checkpoints, and again
    stopped after round ``stop`` and resumed with ``increment_n_rounds`` and
    ``pigeons(folder)``; the two must agree bit for bit. With ``kernel``, its
    launches must equal the scans in each. Returns both runs."""
    from pigeons_tpu_torch import PT, SliceSamplerCUDA, increment_n_rounds, pigeons

    scans = sum(2**r for r in range(1, n_rounds + 1))
    runs = []
    for label, rounds in (("uninterrupted", n_rounds), ("stopped", stop)):
        SliceSamplerCUDA.reset_launches()
        with timed_checkpoints() as writes:
            t0 = time.perf_counter()
            pt = PT(make_inputs(n_rounds=rounds, checkpoint=True,
                                checkpoint_folder=str(folder / label))).run()
            if label == "stopped":
                increment_n_rounds(pt.exec_folder, n_rounds - stop)
                pt = pigeons(pt.exec_folder)
            seconds = time.perf_counter() - t0
        runs.append(pt)
        launches = dict(SliceSamplerCUDA.launches)
        print(f"{name}, {label}: {pt.round_idx} rounds in {seconds:.3f} s, kernel launches "
              f"{launches}; checkpoint writes (round, s, bytes): "
              + ", ".join(f"({r}, {t:.4f}, {b})" for r, t, b in writes))
        if kernel is not None and launches[kernel] != scans:
            raise AssertionError(f"{name}, {label}: {launches[kernel]} launches of {kernel} "
                                 f"for {scans} scans")
    full, resumed = runs
    checks = {"states": torch.equal(full.states, resumed.states),
              "chain_of": torch.equal(full.chain_of, resumed.chain_of),
              "replica_of": torch.equal(full.replica_of, resumed.replica_of),
              "sample_array": np.array_equal(full.sample_array(), resumed.sample_array()),
              "logZ": full.reports[-1].log_z_estimate == resumed.reports[-1].log_z_estimate}
    if full._ref_params is not None:
        checks.update({f"ref_params[{k}]": torch.equal(v, resumed._ref_params[k])
                       for k, v in full._ref_params.items()})
        checks["schedule_var"] = np.array_equal(full.schedule_var.grids,
                                                resumed.schedule_var.grids)
    checks.update({f"exp_state[{k}]": torch.equal(v, resumed.exp_state[k])
                   for k, v in (full.exp_state or {}).items()})
    print(f"{name}: resumed after round {stop} == uninterrupted, bit for bit: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{name}: the resumed run differs from the uninterrupted one")
    return full, resumed


def checkpoint_phase(folder):
    """Config 1 at full width checkpointed every round, 5 rounds uninterrupted
    and stopped after round 3 then resumed; the same at a small depth for
    config 4 (stopped after the first round that fits the reference) and
    config 2a (64 ladders: AutoMALA's adapted state). Returns config 4's
    fitted reference."""
    phase("9 checkpoint")
    from pigeons_tpu_torch import (AutoMALA, GaussianReference, Inputs, SliceSamplerCUDA,
                                   logistic_regression, toy_mvn_target)

    def config1(**kw):
        return Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                      seed=SEED, explorer=SliceSamplerCUDA(), show_report=False, device="cuda",
                      **kw)

    stop_and_resume("config 1", config1, CK_ROUNDS, CK_STOP, folder / "config1",
                    "banded_slice_sweep")

    def config4(**kw):
        return config4_inputs(variational=GaussianReference(first_tuning_round=CK_V_STOP), **kw)

    _, resumed = stop_and_resume("config 4", config4, CK_V_ROUNDS, CK_V_STOP,
                                 folder / "config4", "banded_slice_sweep_variational")
    if float(resumed._ref_params["active"]) != 1.0:
        raise AssertionError("config 4: the reference was never fitted")

    def config2a(**kw):
        return Inputs(target=logistic_regression(200, 10, seed=0), n_chains=A_CHAINS,
                      n_replicates=A_COMPARE_LADDERS, seed=SEED, explorer=AutoMALA(),
                      show_report=False, device="cuda", **kw)

    stop_and_resume("config 2a, 64 ladders", config2a, CK_A_ROUNDS, CK_A_STOP,
                    folder / "config2a")
    return resumed._ref_params


def card_to_cpu_phase(folder):
    """A toy MVN run of phase 6's size checkpointed on the card and resumed on
    the CPU (``load_pt(folder, device="cpu")``), against the card's
    uninterrupted run: phase 6's gate."""
    phase("9b card to CPU")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, load_pt, toy_mvn_target

    def inputs(**kw):
        return Inputs(target=toy_mvn_target(6), n_chains=5, n_replicates=8, seed=4, n_rounds=4,
                      explorer=SliceSamplerCUDA(), show_report=False, device="cuda", **kw)

    g = PT(inputs()).run()
    part = PT(inputs(checkpoint=True, checkpoint_folder=str(folder / "card_to_cpu")))
    part.run_round()
    part.run_round()
    c = load_pt(part.exec_folder, device="cpu")
    if c.device.type != "cpu" or c._states.device.type != "cpu":
        raise AssertionError("load_pt(device='cpu') left the run on the card")
    c.run()
    same_perm = (torch.equal(g.chain_of.cpu(), c.chain_of)
                 and torch.equal(g.replica_of.cpu(), c.replica_of)
                 and g.n_tempered_restarts == c.n_tempered_restarts)
    diff = float((g.states.cpu() - c.states).abs().max())
    print(f"resumed on the CPU after round 2 of 4: permutations and restarts equal {same_perm}, "
          f"max |state diff| {diff}")
    if not same_perm or diff > 1e-6:
        raise AssertionError("the run resumed on the CPU disagrees with the card's")


def serial_check_phase(folder):
    """``checked_round``: a one-ladder K1 run re-executed in a child process
    on the card, which must load the kernel library built here; a corrupted
    copy of its round must be caught; ``profile_round`` writes a trace that
    names K1's launch."""
    phase("9c serial check")
    import shutil

    from pigeons_tpu_torch import PT, Inputs, ParallelismInvarianceError, SliceSamplerCUDA
    from pigeons_tpu_torch import _build, toy_mvn_target
    from pigeons_tpu_torch.checkpoint import immutables_dir, round_folder
    from pigeons_tpu_torch.checks import check_checkpoint_folders

    built = sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.iterdir())
    t0 = time.perf_counter()
    pt = PT(Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, seed=SEED, n_rounds=CK_S_ROUNDS,
                   checked_round=CK_S_ROUNDS, checkpoint=True, explorer=SliceSamplerCUDA(),
                   checkpoint_folder=str(folder / "serial"), show_report=False,
                   device="cuda")).run()
    child = pt.serial_check
    with open(Path(child.exec_folder) / "info" / "stdout.txt") as f:
        said = f.read().strip()
    print(f"{CK_S_ROUNDS} rounds of {N_CHAINS} chains, d={D}, checked against a child process in "
          f"{time.perf_counter() - t0:.3f} s; the child's wall time {child.wall_time_s:.3f} s "
          f"(it says: {said})")
    if sorted((p.name, p.stat().st_mtime_ns) for p in _build.BUILD_DIR.iterdir()) != built:
        raise AssertionError("the child process built the kernels again")
    copy = folder / "corrupted"
    shutil.copytree(pt.exec_folder, copy, ignore=shutil.ignore_patterns("serial_check"))
    npz = Path(round_folder(str(copy), CK_S_ROUNDS)) / "checkpoint.npz"
    arrays = dict(np.load(npz))
    arrays["states"] = arrays["states"] + 1.0
    np.savez(npz, **arrays)
    try:
        check_checkpoint_folders(round_folder(str(copy), CK_S_ROUNDS),
                                 round_folder(child.exec_folder, CK_S_ROUNDS),
                                 immutables_dir(str(copy)), immutables_dir(child.exec_folder))
    except ParallelismInvarianceError as e:
        print(f"the corrupted copy is caught: {e}")
        if "states" not in str(e):
            raise AssertionError("the check did not name states") from e
    else:
        raise AssertionError("the check passed a copy with states + 1")

    pt = PT(Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=64, seed=SEED,
                   n_rounds=1, profile_round=1, checkpoint=True, explorer=SliceSamplerCUDA(),
                   checkpoint_folder=str(folder / "profile"), show_report=False,
                   device="cuda")).run()
    trace = Path(pt.exec_folder) / "profile" / "round=1" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events]
    ranges = sum(n == "banded_slice_sweep" for n in names)
    kernels = sum("banded_slice_kernel" in n for n in names)
    print(f"profile_round: {trace.stat().st_size} B trace, {len(events)} events, "
          f"{ranges} ranges named banded_slice_sweep, {kernels} events of banded_slice_kernel")
    if ranges < 2 or kernels < 2:
        raise AssertionError("the profile trace does not show K1's launches")


def invariance_phase(ref_params, delta_twin):
    """The exact invariance test at the reference's N = 10,000, one
    ``step_batched`` of every draw: K1 with each term, K2 in each mode (each
    kernel launched exactly once), MALA and AutoMALA, at beta = 1; K1's
    toy term, and the variational blend under config 4's fitted reference
    and under one far from the target, through K1 and K2, at beta = 0.3.
    Two controls must fail: a kernel that drifts, and a step that reads a
    wrong reference. K2's delta-mode launch is held bit for bit against its
    twin's result on the same inputs (``delta_twin``, from phase 2b).
    Returns its launches."""
    phase("10 invariance")
    from pigeons_tpu_torch import (AAPS, MALA, NUTS, AutoMALA, GaussianReference,
                                   IdentityPreconditioner, Mix, ScanMix, SliceSampler,
                                   SliceSamplerCUDA, funnel, invariance_test, toy_mvn_target)
    from pigeons_tpu_torch.ops import cuda_slice
    from pigeons_tpu_torch.ops.base import Explorer, StepOut

    class BrokenKernel(Explorer):
        def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                         chain_params=None, scan_idx=None):
            z = torch.zeros(xs.shape[0], device=xs.device)
            return StepOut(xs + 0.2, None, z, z, z)

    class WrongReference(Explorer):
        """The blend with the reference's std 1.5 times too large."""

        def __init__(self, inner):
            self.inner = inner

        def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, **kw):
            wrong = dict(ref_params, std=ref_params["std"] * 1.5)
            return self.inner.step_batched(keys, xs, betas, path, isvar=isvar,
                                           ref_params=wrong, **kw)

    class Recorded(SliceSamplerCUDA):
        def step_batched(self, keys, xs, betas, path, **kw):
            out = super().step_batched(keys, xs, betas, path, **kw)
            self.seen = (keys, xs, betas, out)
            return out

    from pigeons_tpu_torch import BayesianModel, bernoulli_target
    from pigeons_tpu_torch.models import distributions as D_

    class BernoulliPosterior(BayesianModel):
        """The Bernoulli model, whose posterior Beta(3, 9) is iid-sampleable:
        draws mapped to the logit coordinate."""

        def __init__(self, model):
            super().__init__(model.priors, model.log_likelihood_fn)

        def to(self, device):
            return BernoulliPosterior(super().to(device))

        def sample_iid_target(self, keys):
            theta = D_.Beta(3.0, 9.0).sample(keys)
            return self.unconstrain({"theta": theta})

    dev = torch.device("cuda")
    far = {"mean": torch.linspace(-1.0, 1.0, D, device=dev),
           "std": torch.linspace(0.5, 1.5, D, device=dev),
           "active": torch.ones((), device=dev)}
    fitted = dict(beta=I_BLEND_BETA, variational=GaussianReference(), ref_params=ref_params)
    blend = dict(beta=I_BLEND_BETA, variational=GaussianReference(), ref_params=far)
    k1v, k2 = "banded_slice_sweep_variational", "slice_sweep"
    delta = Recorded(n_passes=I_DELTA_PASSES, parallel_coords=False)
    cases = (  # name, target, explorer, keywords, kernel, must fail
        ("K1, toy term", toy_mvn_target(D), SliceSamplerCUDA(), {}, "banded_slice_sweep", False),
        (f"K1, toy term, beta {I_BLEND_BETA}", toy_mvn_target(D), SliceSamplerCUDA(),
         dict(beta=I_BLEND_BETA), "banded_slice_sweep", False),
        ("K1, variational term, fitted reference", toy_mvn_target(D), SliceSamplerCUDA(),
         fitted, k1v, False),
        ("K1, variational term, far reference", toy_mvn_target(D), SliceSamplerCUDA(), blend,
         k1v, False),
        ("K2 full (funnel)", funnel(F_NX), SliceSamplerCUDA(n_passes=F_PASSES), {}, k2, False),
        ("K2 full (Bernoulli, posterior Beta(3, 9))", BernoulliPosterior(bernoulli_target()),
         SliceSamplerCUDA(n_passes=F_PASSES), {}, k2, False),
        ("K2 full, variational blend (toy MVN), far reference", toy_mvn_target(D),
         SliceSamplerCUDA(parallel_coords=False), blend, k2, False),
        ("K2 delta (toy MVN)", toy_mvn_target(D), delta, {}, k2, False),
        ("MALA", toy_mvn_target(D),
         MALA(step_size=I_MALA_STEP, preconditioner=IdentityPreconditioner()), {}, None, False),
        ("AutoMALA", toy_mvn_target(D), AutoMALA(), {}, None, False),
        # the cases of AAPS, NUTS and the mixtures in tests/test_invariance.py:13-52
        ("AAPS(0.4), identity", toy_mvn_target(3),
         AAPS(step_size=0.4, preconditioner=IdentityPreconditioner()), {}, None, False),
        ("NUTS(0.5), identity", toy_mvn_target(3),
         NUTS(step_size=0.5, preconditioner=IdentityPreconditioner()), {}, None, False),
        ("Mix(SliceSampler, MALA(0.4))", toy_mvn_target(3),
         Mix(SliceSampler(n_passes=1), MALA(step_size=0.4,
                                            preconditioner=IdentityPreconditioner())),
         {}, None, False),
        ("ScanMix(SliceSampler, MALA(0.4))", toy_mvn_target(3),
         ScanMix(SliceSampler(n_passes=1), MALA(step_size=0.4,
                                                preconditioner=IdentityPreconditioner())),
         {}, None, False),
        ("BrokenKernel (must fail)", toy_mvn_target(D), BrokenKernel(), {}, None, True),
        ("K1, wrong reference (must fail)", toy_mvn_target(D),
         WrongReference(SliceSamplerCUDA()), blend, k1v, True),
        ("K2, wrong reference (must fail)", toy_mvn_target(D),
         WrongReference(SliceSamplerCUDA(parallel_coords=False)), blend, k2, True),
    )
    delta_launches = None
    for name, target, explorer, kw, kernel, must_fail in cases:
        SliceSamplerCUDA.reset_launches()
        t0 = time.perf_counter()
        res = invariance_test(target, explorer, seed=I_SEED, n_iid_samples=I_SAMPLES,
                              device="cuda", **kw)
        seconds = time.perf_counter() - t0
        launches = dict(SliceSamplerCUDA.launches)
        print(f"{name}: passed {res.passed}, smallest p-value {res.pvalues.min():.6g} over "
              f"{len(res.pvalues)} coordinates (threshold {0.005 / len(res.pvalues):.3g}), "
              f"failed {res.failed_dims.tolist()[:10]}, {seconds:.3f} s, launches {launches}")
        want = {k: int(k == kernel) for k in launches}
        if launches != want:
            raise AssertionError(f"{name}: launches {launches}, expected {want}")
        if res.passed == must_fail:
            raise AssertionError(f"{name}: invariance test verdict {res.passed}")
        if explorer is delta:
            delta_launches = launches[k2]
    keys, xs, betas, out = delta.seen
    if not all(torch.equal(a, b) for a, b in
               zip((xs, betas, cuda_slice.lane_seeds(keys)), delta_twin["inputs"], strict=True)):
        raise AssertionError("K2 delta: phase 10's launch had other inputs than phase 2b's row")
    stats = torch.stack([out.accept_sum, out.accept_n, out.n_steps])
    compare("K2 delta (toy MVN), phase 10's launch", (out.x, out.lp, stats), delta_twin["want"])
    return delta_launches


def config1_inputs(**kw):
    from pigeons_tpu_torch import Inputs, SliceSamplerCUDA, toy_mvn_target

    return Inputs(target=toy_mvn_target(D), n_chains=N_CHAINS, n_replicates=N_REPLICATES,
                  seed=SEED, explorer=SliceSamplerCUDA(), show_report=False, device="cuda", **kw)


def same_run(name, got, want):
    """Raise unless two runs' samples, ``chain_of``, states and every
    round's logZ are the same bits; ``got`` and ``want`` are dicts of host
    arrays."""
    differ = [k for k in want if not np.array_equal(got[k], want[k], equal_nan=True)
              or np.asarray(got[k]).dtype != np.asarray(want[k]).dtype]
    print(f"{name}: samples {got['samples'].shape}, states {got['states'].shape}, last logZ "
          f"{float(got['logz'][-1]):.6f} (one process {float(want['logz'][-1]):.6f}); "
          f"differing: {differ or 'none'}")
    if differ:
        raise AssertionError(f"{name}: {differ} differ from the one-process run")


def rounds_seconds(pt):
    """The wall time of a run's rounds, each ended by a synchronize."""
    return sum(r.wall_time_s for r in pt.reports)


def run_arrays(pt):
    """The arrays phase 11 compares (``pt.states`` gathers under a mesh)."""
    return {"samples": pt.sample_array(), "chain_of": pt.chain_of.cpu().numpy(),
            "states": pt.states.cpu().numpy(),
            "logz": np.array([r.log_z_estimate for r in pt.reports])}


def mesh_child(rank, folder):
    """One of phase 11b's two ranks: config 5's hierarchical normal, chain-
    sharded on 32 chains x 1 ladder, then replicate-sharded on 32 x 256, over
    a gloo group of two processes on the one card (NCCL refuses two ranks on
    one device); writes its results and K2's launches to ``folder``."""
    from pigeons_tpu_torch import MultiHostLauncher, hierarchical_normal
    from pigeons_tpu_torch.ops import cuda_slice
    from pigeons_tpu_torch.parallel import replica_mesh

    torch.set_num_threads(1)  # two ranks share the host's cores
    MultiHostLauncher(coordinator_address=f"file://{folder}/pg", num_processes=2,
                      process_id=rank, timeout_s=300.0).init("cuda")
    mesh = replica_mesh()
    for name, ladders in (("chains", 1), ("ladders", H_REPLICATES)):
        pt, launches = bayesian_run(hierarchical_normal(), H_CHAINS, ladders, H_ROUNDS, mesh=mesh)
        lanes = pt._states.shape[0]
        groups = [cuda_slice.launcher_group(pt._density_path, b, pt.dim)
                  for b in (lanes, H_CHAINS * ladders)]
        np.savez(f"{folder}/{name}.rank{rank}.npz", **run_arrays(pt), launches=launches,
                 lanes=lanes, groups=groups, seconds=rounds_seconds(pt), backend=mesh.backend)


def mesh_phase(config1, hierarchical):
    """Phase 11, the replica mesh on the card. (a) Bench's mesh stand-in
    (bench.py:298-328): config 1 at full width on a one-rank NCCL group,
    replicate-sharded, the same rounds as phase 3 and held to phase 3's run
    bit for bit. (b) Config 5 (BASELINE.json: chains sharded over processes,
    a hierarchical model) as two processes on the card: 32 chains x 1
    ladder chain-sharded (every swap crosses the ranks, K2 on 16 lanes a
    rank) and 32 x 256 replicate-sharded (phase 3d's width, K2 on 4,096 lanes
    a rank), each rank's results the one-process run's bits (phase 3d's run
    for the second), K2 launched once a scan on each rank. Returns K1's
    launches in (a) and K2's on each rank in (b)."""
    phase("11 mesh")
    import tempfile

    import torch.distributed as dist

    from pigeons_tpu_torch import PT, MultiHostLauncher, SliceSamplerCUDA, hierarchical_normal
    from pigeons_tpu_torch.parallel import replica_mesh

    t_phase = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        print("(a) config 1 on a one-rank mesh")
        MultiHostLauncher(coordinator_address=f"file://{tmp}/pg_one", num_processes=1,
                          process_id=0, timeout_s=300.0).init("cuda")
        mesh = replica_mesh()
        if mesh.backend != "nccl":
            raise AssertionError(f"a one-rank mesh on the card took {mesh.backend}, not NCCL")
        SliceSamplerCUDA.reset_launches()
        pt = PT(config1_inputs(mesh=mesh))
        for _ in range(WARMUP_ROUNDS):
            pt.run_round(n_scans=WARMUP_SCANS)
        pt.run_round(n_scans=MEASURE_SCANS)
        launches_a = SliceSamplerCUDA.launches["banded_slice_sweep"]
        scans = WARMUP_ROUNDS * WARMUP_SCANS + MEASURE_SCANS
        print(f"K1 launches {launches_a} for {scans} scans; timed round "
              f"{pt.reports[-1].wall_time_s / MEASURE_SCANS * 1e3:.3f} ms a scan (phase 3's "
              f"{config1.reports[-1].wall_time_s / MEASURE_SCANS * 1e3:.3f}), "
              f"{eval_rate(pt):.6g} evals/s on the mesh, phase 3's {eval_rate(config1):.6g} "
              f"({smi})")
        same_run("config 1, one-rank NCCL mesh", run_arrays(pt), run_arrays(config1))
        if launches_a != scans:
            raise AssertionError(f"K1 launched {launches_a} times for {scans} scans")
        dist.destroy_process_group()
        del pt

        print("(b) config 5: the one-process 32 x 1 run, then two ranks on the card")
        one, _ = bayesian_run(hierarchical_normal(), H_CHAINS, 1, H_ROUNDS)
        want = {"chains": run_arrays(one), "ladders": run_arrays(hierarchical)}
        alone = {"chains": rounds_seconds(one), "ladders": rounds_seconds(hierarchical)}
        children = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                      "--mesh-child", str(rank), tmp],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                    for rank in range(2)]
        try:
            outs = [c.communicate(timeout=600)[0] for c in children]
        finally:
            for c in children:
                c.kill()
        for rank, (c, out) in enumerate(zip(children, outs)):
            print(f"--- rank {rank} (exit {c.returncode}):\n{out[-3000:]}")
            if c.returncode != 0:
                raise AssertionError(f"phase 11b: rank {rank} failed")
        launches_b = {}
        for name, ladders in (("chains", 1), ("ladders", H_REPLICATES)):
            for rank in range(2):
                got = dict(np.load(f"{tmp}/{name}.rank{rank}.npz"))
                small, whole = (int(g) for g in got["groups"])
                print(f"{name}, rank {rank}: {int(got['lanes'])} lanes over {got['backend']}, "
                      f"rounds {float(got['seconds']):.3f} s (one process "
                      f"{alone[name]:.3f} s), K2 launches {int(got['launches'])} for "
                      f"{sum(H_ROUNDS)} scans, K2's group {small} threads a lane on the rank's "
                      f"lanes ({whole} on the whole batch's {H_CHAINS * ladders})")
                same_run(f"config 5, {H_CHAINS} chains x {ladders} ladder(s), rank {rank} of 2",
                         got, want[name])
                if int(got["launches"]) != sum(H_ROUNDS):
                    raise AssertionError(f"phase 11b: rank {rank} launched K2 "
                                         f"{int(got['launches'])} times")
                launches_b.setdefault(name, []).append(int(got["launches"]))
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return launches_a, launches_b


# csrc/banded_slice.cu: K1ClockPart
K1_CLOCK_PARTS = ("hand-out", "draw and query", "term", "step", "idle")


def k1_clock_split(lib, call):
    """Runs ``call`` (a launch of kernel K1 in ``lib``, a build with
    ``PIGEONS_K1_CLOCKS``) and returns its ``clock64()`` split: each part's
    share of the threads' loop cycles, the cycles a thread spends on an
    iteration of an element's machine, in all and by part, and the threads'
    iterations. The clock reads themselves cost cycles: compare splits of
    such builds with each other, not with an uninstrumented time."""
    import ctypes

    call()
    torch.cuda.synchronize()
    buf = np.zeros((132 * 8 * 256, len(K1_CLOCK_PARTS) + 2), np.uint64)
    lib.k1_clock_split.argtypes = [ctypes.c_void_p, ctypes.c_int]
    n = lib.k1_clock_split(buf.ctypes.data_as(ctypes.c_void_p), len(buf))
    if n <= 0:
        raise RuntimeError(f"k1_clock_split: {n}")
    rows = buf[:n].astype(np.float64)
    loop, iterations = rows[:, -2].sum(), rows[:, -1].sum()
    parts = rows[:, :len(K1_CLOCK_PARTS)].sum(0)
    return {"threads": int(n), "iterations": float(iterations),
            "cycles_per_iteration": float(loop / iterations),
            "share_by_part": {k: float(v / loop) for k, v in zip(K1_CLOCK_PARTS, parts)},
            "cycles_per_iteration_by_part": {k: float(v / iterations)
                                             for k, v in zip(K1_CLOCK_PARTS, parts)}}


def print_k1_clock_split(label, split):
    print(f"{label}: clock64 split over {split['threads']} threads, {split['iterations']:.0f} "
          f"iterations, {split['cycles_per_iteration']:.1f} cycles a thread's iteration: "
          + ", ".join(f"{k} {split['cycles_per_iteration_by_part'][k]:.1f} "
                      f"({split['share_by_part'][k]:.1%})" for k in K1_CLOCK_PARTS), flush=True)


def start_user_builds():
    """Phase 12's sources (``models/source_examples.py``) and their ``nvcc``
    builds, all started together in threads: they wait for nothing of phases
    3-11, so they run beside them. Returns the sources' targets, the builds
    and their futures."""
    from concurrent.futures import ThreadPoolExecutor

    from pigeons_tpu_torch import _build
    from pigeons_tpu_torch.models import source_examples as SE

    dev = torch.device("cuda")
    hier, coord = SE.hierarchical_normal_source().to(dev), SE.normal_product_source(D).to(dev)
    model_u, custom = SE.model_u().to(dev), SE.custom_path_source(U_CUSTOM_DIM).to(dev)
    funnel = SE.funnel_source(U_FUNNEL_DIM).to(dev)
    sources = {"likelihood (hierarchical normal, model U)": hier.log_likelihood_fn.source,
               "coordinate terms (product of normals)": coord.source,
               "CustomPath": custom.path.source}
    # this tree's libraries (and the funnel's target, which (d) holds under a
    # variational reference), K1's user term with its clock split, and with
    # --parent-csrc the parent's libraries of the timed sources: every nvcc at
    # once
    builds = {f"the {name} source": (src, (), _build.CSRC) for name, src in sources.items()}
    builds["the funnel's target source"] = (funnel.source, (), _build.CSRC)
    # phase 14's Stan models, emitted as sources when they are parsed
    from pigeons_tpu_torch import stan_target

    stan = {"eight schools": stan_target(source=STAN_EIGHT_SCHOOLS, data=STAN_EIGHT_SCHOOLS_DATA),
            "Bernoulli": stan_target(source=STAN_BERNOULLI, data=STAN_BERNOULLI_DATA)}
    for name, target in stan.items():
        builds[f"the Stan {name} source"] = (target.device_source, (), _build.CSRC)
    builds["the coordinate source, PIGEONS_K1_CLOCKS"] = (coord.source, ("PIGEONS_K1_CLOCKS",),
                                                          _build.CSRC)
    if PARENT:
        builds.update({f"the {name} source, the parent's sources": (src, (), PARENT[1])
                       for name, src in sources.items()})
    pool = ThreadPoolExecutor(len(builds))
    futures = {name: pool.submit(_build.build_user, b[0], defines=b[1], csrc=b[2])
               for name, b in builds.items()}
    pool.shutdown(wait=False)
    return (hier, coord, model_u, custom, funnel, stan), builds, futures


def user_density_phase(library_hierarchical, user_builds):
    """Phase 12: densities a user supplies as CUDA source
    (``pigeons_tpu_torch/models/source_examples.py``), each source compiled
    into a library of its own (one ``nvcc`` each, all started together, with
    K1's user term's ``-DPIGEONS_K1_CLOCKS`` build and, with
    ``--parent-csrc``, the parent's libraries; the hierarchical normal and
    model U share one text, hence one library). (a) Config 5's hierarchical
    normal with its likelihood as a source, at phase 3d's width, seed and
    rounds: K2's user instance against its twin at B = 8,192 at the
    launcher's group and at 1, 8, 16 and 32 threads a lane (no bit may
    differ; each group timed, and the parent's one thread a lane as
    ``parent_ms``), launched once a scan and the library's
    K1 and K2 never, the pooled mu, tau, sigma within three standard errors
    of phase 3d's library run (``library_hierarchical``: 0.95 / 0.92 / 0.019,
    those of phase 3d's full-width gate). (b) The product of 100 normals,
    means linspace(-1, 1.5), scales linspace(0.5, 2), from N(0, 3^2) per
    coordinate, as a coordinate source on K1's user term at config 1's width
    and rounds: the kernel against its twin at B = 20,480 (beside the
    parent's, and its clock split by part), launched once a scan, per
    coordinate |mean - mu_c| < 0.02 scale_c and |var / scale_c^2 - 1|
    < 0.05, |logZ| < 0.1 (both ends normalized). (c) At 10 chains x 64
    ladders: ``unid_target()`` under N(0, 2^2 I) (the library's K2 with
    params[0] = 1 / sigma), logZ plus the normal reference's log
    normalization, log(2 pi 4), within 0.1 of the exact -4.974552; model U
    (Cauchy, LogNormal and Exponential priors) and a ``CustomPath`` with a
    source, each on its user instance bit for bit the twin at the path's
    640 lanes at every group, launched once a scan, finite logZ, model U
    with restarts. (d) Model U and a funnel's target source under a
    ``VariationalPath`` with a ``GaussianReference`` (two of three lanes on
    the variational leg, the reference active): the user instance at the
    launcher's group and at 1, 8, 16 and 32 threads a lane against the twin,
    no bit may differ.
    Returns the kernels line's entries of K2's user instance and K1's user
    term."""
    phase("12 user densities as CUDA source")
    import functools

    from pigeons_tpu_torch import (PT, GaussianReference, Inputs, SliceSamplerCUDA,
                                   StandardNormalReference, VariationalPath, unid_target)
    from pigeons_tpu_torch import _build
    from pigeons_tpu_torch.models import unid_analytic_log_z
    from pigeons_tpu_torch.ops import cuda_slice

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    (hier, coord, model_u, custom, funnel, _), builds, futures = user_builds
    built = {name: f.result() for name, f in futures.items()}
    for name, (lib, seconds) in built.items():
        print(f"nvcc for {name}: {seconds:.3f} s ({lib.name}; 0 = already built)")
    print(f"the builds, at once and beside phases 3-11: {time.perf_counter() - t_phase:.1f} s "
          "waited for")
    libs = {name: _build.open_user(path, _build.USER_KERNELS[builds[name][0].hook])
            for name, (path, _) in built.items()}
    parent_lib = {src.key: libs[name] for name, (src, _, csrc) in builds.items()
                  if csrc != _build.CSRC}

    def user_groups(name, path, inputs, want):
        """Each group's time (median of 20) beside the launcher's choice,
        each group already held bit for bit to the twin."""
        x, betas, seeds = inputs
        group = cuda_slice.launcher_group(path, x.shape[0], x.shape[1])
        times = {g: cuda_ms(lambda g=g: cuda_slice.sweep_cuda(x, betas, seeds, path, group=g,
                                                               n_passes=F_PASSES), 20)
                 for g in (1, 8, 16, 32)}
        print(f"{name}: the launcher's group {group}; ms by threads a lane: "
              + ", ".join(f"{g}: {t:.4f}" for g, t in times.items()), flush=True)
        return group, times

    print("(a) the hierarchical normal, its likelihood as a source")
    path = hier.create_path(hier.default_reference())
    density = path.device_density()
    n_obs = density.arrays[0].numel()
    d = hier.dim
    # a query: the prior table, the constrained values (two exp, a select
    # chain a coordinate), each observation's term with its group's index
    # (a conversion), the in-order sum, prior + likelihood, the interpolation
    query = (prior_ops(density.prior) + 2 * EXP + ops(2 * d) + n_obs * (OBSERVATION + ops(1))
             + ops(n_obs) + INTERPOLATE)
    keep = {}
    parent_k2 = parent_lib.get(density.source.key)
    k2u = k2_mode("K2 user instance (hierarchical normal's likelihood as a source)", path, False,
                  H_CHAINS * H_REPLICATES, d, 1.0, query, ops(0), query,
                  extra_bytes=4 * sum(a.numel() for a in density.arrays), groups=(1, 8, 16, 32),
                  keep=keep, parent_call=parent_k2 and (
                      lambda x, b, sd: cuda_slice.sweep_cuda(x, b, sd, path, n_passes=F_PASSES,
                                                             lib=parent_k2)))
    k2u["group"], k2u["ms_by_group"] = user_groups("K2 user instance, B=8192", path,
                                                   keep["inputs"], keep["want"])
    pt, k2u["launches"] = bayesian_run(hier, H_CHAINS, H_REPLICATES, H_ROUNDS,
                                       kernel="slice_sweep_user")
    print_round(pt, H_CHAINS * H_REPLICATES)
    q, q_lib = hier.constrained_samples(pt), hier.constrained_samples(library_hierarchical)
    tolerance = {"mu": 0.95, "tau": 0.92, "sigma": 0.019}
    for k, tol in tolerance.items():
        got, want = float(np.mean(q[k])), float(np.mean(q_lib[k]))
        print(f"{k}: pooled {got:.6f}, phase 3d's library run {want:.6f}, tolerance {tol}")
        if not abs(got - want) <= tol:
            raise AssertionError(f"user hierarchical normal: {k} {got} is off phase 3d's {want}")
    if not np.isfinite(pt.sample_array()).all():
        raise AssertionError("user hierarchical normal: non-finite samples")
    del pt

    print("(b) a product of normals as coordinate terms, K1's user term at config 1's width")
    cpath = coord.create_path(coord.default_reference())
    B = N_CHAINS * N_REPLICATES
    x, betas, seeds = lane_inputs(B, D, 2.0, 11)
    term = cuda_slice.UserTerm(betas, cpath.coord_source)
    got = cuda_slice.banded_sweep_user_cuda(x, seeds, term)
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    want, plain_ms = timed_once(
        lambda: cuda_slice.banded_sweep_reference(x, betas, seeds, phase_counts=counts, user=term))
    max_abs = compare("K1 user term (product of normals)", got, want)
    ms = cuda_ms(lambda: cuda_slice.banded_sweep_user_cuda(x, seeds, term), 20)
    parent_k1 = parent_lib.get(coord.source.key)
    parent = parent_ms("K1 user term (product of normals)",
                       lambda: cuda_slice.banded_sweep_user_cuda(x, seeds, term), got, ms,
                       parent=parent_k1 and (lambda: cuda_slice.banded_sweep_user_cuda(
                           x, seeds, term, lib=parent_k1)))
    clocks = libs["the coordinate source, PIGEONS_K1_CLOCKS"]
    clocked = functools.partial(cuda_slice.banded_sweep_user_cuda, x, seeds, term, lib=clocks)
    compare("K1 user term, the PIGEONS_K1_CLOCKS build", clocked(), want)
    split = k1_clock_split(clocks, clocked)
    print_k1_clock_split("K1 user term", split)
    n = [float(v) for v in counts[:5]]
    considered = float(got[1][1].double().sum())
    # the user's two terms (the reference's: a multiply, a square, a
    # multiply, an add; the target's: a subtract, a division, a square, a
    # multiply, an add) and interpolate() with its guarded products
    need = k1_need(B * D, n, considered, ops(9) + INTERPOLATE)
    bound_ms, bound_by = bound(2 * 4 * B * D + (4 + 8 + 12) * B + 3 * 4 * D, need)
    print(f"kernel {ms:.4f} ms (median of 20), twin {plain_ms:.4f} ms, B={B}, d={D}, 3 passes; "
          f"{sum(n):.0f} iterations; bound {bound_ms:.6f} ms by {bound_by}, "
          f"{bound_ms / ms:.2%} of the kernel's time")
    k1u = {"name": "banded_slice_sweep_user (product of normals)", "route": "cuda",
           "source": "pigeons_tpu_torch/csrc/banded_slice.cu",
           "replaces": "pigeons_tpu/ops/pallas_slice.py:305", "max_abs_err": max_abs, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "parent_ms": parent, "clock_split": split}
    SliceSamplerCUDA.reset_launches()
    pt = PT(Inputs(target=coord, n_chains=N_CHAINS, n_replicates=N_REPLICATES, seed=SEED,
                   explorer=SliceSamplerCUDA(), show_report=False, device="cuda"))
    for _ in range(WARMUP_ROUNDS):
        pt.run_round(n_scans=WARMUP_SCANS)
    pt.run_round(n_scans=MEASURE_SCANS)
    launches = dict(SliceSamplerCUDA.launches)
    scans = WARMUP_ROUNDS * WARMUP_SCANS + MEASURE_SCANS
    print(f"kernel launches {launches} for {scans} scans")
    if not launched_only(launches, "banded_slice_sweep_user", scans):
        raise AssertionError(f"kernel launches {launches} for {scans} scans of K1's user term")
    k1u["launches"] = launches["banded_slice_sweep_user"]
    mu, scale = (a.double().cpu().numpy() for a in coord.source.arrays[:2])
    mean_off = float(np.max(np.abs(pt.mean() - mu) / scale))
    var_off = float(np.max(np.abs(pt.var() / scale**2 - 1.0)))
    log_z = pt.reports[-1].log_z_estimate
    print(f"timed round: {MEASURE_SCANS} scans in {pt.reports[-1].wall_time_s:.4f} s, "
          f"{eval_rate(pt):.6g} evals/s; max |mean - mu_c| / scale_c {mean_off:.5f}, "
          f"max |var / scale_c^2 - 1| {var_off:.5f}, logZ {log_z:.5f} (exact 0), barrier "
          f"{pt.global_barrier:.4f}, restarts {pt.n_tempered_restarts}")
    if not (mean_off < 0.02 and var_off < 0.05 and abs(log_z) < 0.1):
        raise AssertionError("product of normals on K1's user term: moments or logZ off")
    del pt

    print("(c) unid under N(0, 2^2 I); model U; a CustomPath with a source")
    ref = StandardNormalReference(2, 2.0).as_reference()
    pt, _ = bayesian_run(unid_target(), S_CHAINS, S_REPLICATES, S_ROUNDS, reference=ref)
    if pt.path.device_density().params[0] != 0.5:
        raise AssertionError("unid under N(0, 2^2 I): the kernel did not get 1 / sigma")
    # the stepping stone estimates log(Z / Z_ref) with the reference's own
    # unnormalized density: Z_ref = 2 pi sigma^2 in two coordinates
    evidence = pt.reports[-1].log_z_estimate + math.log(2.0 * math.pi * 4.0)
    print(f"logZ {pt.reports[-1].log_z_estimate:.6f}, + log(2 pi 4) = {evidence:.6f}, exact "
          f"{unid_analytic_log_z():.6f}, restarts {pt.n_tempered_restarts}")
    if not abs(evidence - unid_analytic_log_z()) < 0.1:
        raise AssertionError("unid under a normal reference: logZ off its exact value")
    lanes = S_CHAINS * S_REPLICATES
    for name, target in (("model U", model_u), ("CustomPath", custom)):
        upath = target.create_path(target.default_reference())
        x, betas, seeds = lane_inputs(lanes, target.dim, 1.0, 11)
        got = cuda_slice.sweep_cuda(x, betas, seeds, upath, n_passes=1)
        want = cuda_slice.sweep_reference(x, betas, seeds, upath, n_passes=1)
        compare(f"K2 user instance ({name}), B={lanes}", got, want,
                lp_fresh=cuda_slice.sweep_density(upath)(got[0], betas))
        for g in (1, 8, 16, 32):
            compare(f"K2 user instance ({name}), B={lanes}, {g} threads per lane",
                    cuda_slice.sweep_cuda(x, betas, seeds, upath, n_passes=1, group=g), want)
        user_groups(f"K2 user instance ({name}), B={lanes}", upath, (x, betas, seeds), want)
        usrc = upath.device_density().source
        if usrc.key in parent_lib:
            parent_ms(f"K2 user instance ({name}), B={lanes}",
                      lambda: cuda_slice.sweep_cuda(x, betas, seeds, upath, n_passes=1), got,
                      cuda_ms(lambda: cuda_slice.sweep_cuda(x, betas, seeds, upath, n_passes=1),
                              20),
                      parent=lambda: cuda_slice.sweep_cuda(x, betas, seeds, upath, n_passes=1,
                                                           lib=parent_lib[usrc.key]))
        pt, _ = bayesian_run(target, S_CHAINS, S_REPLICATES, S_ROUNDS, kernel="slice_sweep_user")
        rep = pt.reports[-1]
        print(f"{name}: logZ {rep.log_z_estimate:.6f}, barrier {pt.global_barrier:.4f}, "
              f"restarts {pt.n_tempered_restarts}")
        if not math.isfinite(rep.log_z_estimate):
            raise AssertionError(f"{name}: logZ not finite")
        if name == "model U":
            q = target.constrained_samples(pt)
            print("model U pooled: " + ", ".join(f"{k} {float(np.mean(q[k])):.4f}"
                                                 for k in ("mu", "sigma", "tau")))
            if not pt.n_tempered_restarts > 0:
                raise AssertionError("model U: no tempered restart")
        else:
            m = custom.path.source.arrays[0].double().cpu().numpy()
            s2 = (1.0 / custom.path.source.params[0]) ** 2
            exact = float(np.sum(0.5 * np.log(s2 / (1.0 + s2)) - m**2 / (2.0 * (1.0 + s2))))
            print(f"CustomPath: exact log(Z_1 / Z_0) {exact:.6f}")
        del pt

    print("(d) the likelihood and target hooks under a variational reference")
    for name, target in (("model U", model_u), ("the funnel's target", funnel)):
        fixed = target.create_path(target.default_reference())
        vpath = VariationalPath(fixed, GaussianReference())
        x, betas, seeds = lane_inputs(lanes, target.dim, 1.0, 13)
        # two of three lanes on the variational leg, the reference active
        isvar = (torch.arange(lanes, device=dev) % 3 != 1).float()
        rs = np.random.RandomState(5)
        ref_params = {
            "mean": torch.tensor((rs.normal(size=target.dim) * 0.3).astype(np.float32), device=dev),
            "std": torch.tensor(np.exp(rs.normal(size=target.dim) * 0.5).astype(np.float32),
                                device=dev),
            "active": torch.tensor(1.0, device=dev)}
        want = cuda_slice.sweep_reference(x, betas, seeds, vpath, n_passes=1, isvar=isvar,
                                          ref_params=ref_params)
        if torch.equal(want[0], cuda_slice.sweep_reference(x, betas, seeds, fixed, n_passes=1)[0]):
            raise AssertionError(f"{name}: the variational reference moved no lane")
        group = cuda_slice.launcher_group(vpath, lanes, target.dim)
        for g in (0, 1, 8, 16, 32):
            compare(f"K2 user instance ({name}) under a variational reference, B={lanes}, "
                    + (f"the launcher's {group}" if g == 0 else f"{g}") + " threads per lane",
                    cuda_slice.sweep_cuda(x, betas, seeds, vpath, n_passes=1, group=g,
                                          isvar=isvar, ref_params=ref_params), want)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    k2u.update(name="slice_sweep_user (hierarchical normal's likelihood as a source)",
               route="cuda", source="pigeons_tpu_torch/csrc/sweep_slice.cu",
               replaces="pigeons_tpu/ops/pallas_slice.py:94")
    return k2u, k1u


def ir_ops(stmts):
    """The operations of one evaluation of an emitted Stan source
    (``models/stan_cuda.py``'s statements, as ``csrc`` runs them): each
    arithmetic operation, comparison, select or conversion 1, a fused
    multiply-add 2, the device functions as the tables above charge them, a
    loop's body once an iteration, an ``if`` its condition and its larger
    branch. Every loop has constant bounds, so its counter, and an index of
    counters and constants, cost nothing: unrolled, such an index is an
    offset in the instruction. An index that reads a data int costs its
    arithmetic and the address's add."""
    from pigeons_tpu_torch.models.stan_cuda import INT_KINDS

    calls = {"log": LOG, "exp": EXP, "log1p": LOG1P, "softplus": SOFTPLUS,
             "sigmoid": SIGMOID, "expm1": EXP + EXPM1_EXTRA, "tanh": EXPM1_EXTRA - ops(6),
             "sqrt": ops(1), "fabs": ops(1)}

    def static(e):
        return e[0] in ("ic", "iv") or (e[0] in ("i+", "i-", "i*")
                                         and static(e[1]) and static(e[2]))

    def address(e):
        return ops(0) if static(e) else i_ops(e) + ops(0, 1)

    def i_ops(e):
        if static(e):
            return ops(0)
        if e[0] == "ia":
            return ops(1) + address(e[2])
        return ops(0, 1) + i_ops(e[1]) + i_ops(e[2])

    def f_ops(e):
        k = e[0]
        if k in ("c", "v"):
            return ops(0)
        if k in ("a", "x", "ve"):
            return address(e[2])
        if k == "i2f":
            return ops(1) + i_ops(e[1])
        if k == "neg":
            return ops(1) + f_ops(e[1])
        if k == "fma":
            return ops(2) + sum((f_ops(a) for a in e[1:]), ops(0))
        if k == "call":
            return calls[e[1]] + f_ops(e[2])
        if k == "sel":
            return ops(1) + c_ops(e[1]) + f_ops(e[2]) + f_ops(e[3])
        return ops(1) + f_ops(e[1]) + f_ops(e[2])

    def c_ops(e):
        if e[0] == "cmp":
            return ops(1) + sum(((i_ops(v) if v[0] in INT_KINDS else f_ops(v)) for v in e[2:]),
                                ops(0))
        if e[0] == "not":
            return ops(0, 1) + c_ops(e[1])
        return ops(0, 1) + c_ops(e[1]) + c_ops(e[2])

    total = ops(0)
    for st in stmts:
        k = st[0]
        if k == "set":
            total = total + f_ops(st[2])
        elif k == "sete":
            total = total + f_ops(st[3]) + i_ops(st[2])
        elif k == "ret":
            total = total + f_ops(st[1])
        elif k == "for":
            total = total + (st[3][1] - st[2][1] + 1) * ir_ops(st[4])
        elif k == "if":
            a, b = ir_ops(st[2]), ir_ops(st[3])
            total = total + c_ops(st[1]) + (a if a.sum() >= b.sum() else b)
    return total


def ir_coord_ops(stmts):
    """``(query, by_coord)``: the operations of one evaluation of an emitted
    Stan source (:func:`ir_ops`) less the element writes of its loops that
    read one coordinate an iteration, the loop counter's (a constrained
    parameter's transform), and those writes by the coordinate each reads: a
    query needs them only where it moves that coordinate, as the compiled
    kinds' ``prepare`` counts them. What such a loop adds into a scalar (the
    log-jacobian, a sum) stays in every query: an in-order sum is redone."""
    def x_reads(node, out):
        if isinstance(node, tuple) and node and node[0] == "x":
            out.add((node[1], node[2]))
        if isinstance(node, (tuple, list)):
            for a in node:
                x_reads(a, out)
        return out

    shared, by_coord = [], {}
    for st in stmts:
        reads = x_reads(st[4], set()) if st[0] == "for" else set()
        if len(reads) == 1 and next(iter(reads))[1] == ("iv", st[1]):
            off = next(iter(reads))[0]
            writes = [b for b in st[4] if b[0] == "sete"]
            shared.append(st[:4] + ([b for b in st[4] if b[0] != "sete"],))
            for i in range(st[2][1], st[3][1] + 1):
                by_coord[off + i] = by_coord.get(off + i, ops(0)) + ir_ops(writes)
        else:
            shared.append(st)
    return ir_ops(shared), by_coord


class TemperedDraws:
    """iid draws of a target's path at ``beta`` under K2's reference
    ``N(0, I)`` (unnormalized): ``exp(-(1 - beta) |x|^2 / 2) p(x)^beta`` by
    rejection from ``N(0, I / (1 - beta))``, accepting with probability
    ``(p(x) / M)^beta`` for a bound ``M >= p``: exact where the target's
    density is bounded (``log_bound``). ``log_density`` is the source's torch
    form, what the kernel evaluates. Each key takes the first of
    ``n_tries`` proposals that it accepts; a key with none raises."""

    def __init__(self, log_density, log_bound, dim, n_tries):
        self.log_density, self.log_bound = log_density, log_bound
        self.dim, self.n_tries = dim, n_tries

    def sample_at(self, keys, beta):
        from pigeons_tpu_torch import rng

        n, t = keys.shape[0], self.n_tries
        x = rng.normal(keys, (t, self.dim)) * float(np.float32(1.0 / math.sqrt(1.0 - beta)))
        u = rng.uniform(rng.fold_in(keys, 1), (t,))
        lp = torch.cat([self.log_density(c) for c in x.reshape(-1, self.dim).split(1 << 20)])
        accept = torch.log(u) < beta * (lp.reshape(n, t) - self.log_bound)
        if not bool(accept.any(-1).all()):
            raise AssertionError(f"TemperedDraws: a key accepted none of {t} proposals")
        first = accept.float().argmax(-1)
        share = float(accept.float().mean())
        print(f"rejection sampler at beta {beta}: acceptance {share:.4f}, {t} proposals a key")
        return x[torch.arange(n, device=x.device), first]


class TemperedStan:
    """A Stan target whose path the invariance test can draw from at
    ``beta`` (``path.sample_at``); its own path is the Stan model's (K2 on
    the emitted source)."""

    def __init__(self, stan, draws):
        self.stan, self.path, self.dim = stan, draws, stan.dim

    def to(self, device):
        return TemperedStan(self.stan.to(device), self.path)

    def default_reference(self):
        return self.stan.default_reference()

    def create_path(self, reference):
        return self.stan.create_path(reference)


def eight_schools_log_bound(data):
    """A bound of the Stan eight-schools density in its unconstrained
    coordinates: each normal term at its mode, and tau's Cauchy(0, 5) with
    its jacobian tau at tau = 5: log(1 / (2 pi))."""
    half = 0.5 * math.log(2.0 * math.pi)
    sigma = np.asarray(data["sigma"], np.float64)
    return (-len(sigma) * half + float(np.sum(-np.log(sigma) - half)) - math.log(5.0) - half
            - math.log(2.0 * math.pi) + 1e-4)


def stan_varying_slopes_phase():
    """Phase 14c: the varying-slopes model of examples/stan_hierarchical.py
    (``cholesky_factor_corr``, matrices: outside the emitter's subset, so no
    device source) on its default AutoMALA, the torch path with no kernel:
    density and gradient at 1,024 states on the card against the CPU within
    1e-5 (the gradient against each state's largest component, where the
    card is no further than the CPU from a float64 evaluation of the same
    states, component by component; the card's spread over two evaluations
    printed), and a
    three-round run whose law is printed (inside its transient, not
    gated). It reads nothing of the other phases and times no kernel, so
    it runs beside the side process (``main``)."""
    phase("14c Stan varying slopes on AutoMALA (beside the side process)")
    from pigeons_tpu_torch import PT, Inputs, SliceSamplerCUDA, stan_target

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    data, beta_true = varying_slopes_data()
    vs = stan_target(source=STAN_VARYING_SLOPES, data=data, name="varying_slopes")
    if vs.device_source is not None:
        raise AssertionError("varying slopes: a matrix model should have no device source")
    lanes = ST_VS_CHAINS * ST_VS_REPLICATES
    xs = (torch.from_numpy(np.random.default_rng(3).normal(size=(lanes, vs.dim))) * 0.3).float()
    out = {}
    cpu = torch.device("cpu")
    for name, where, dtype in (("card", dev, torch.float32), ("card again", dev, torch.float32),
                               ("CPU", cpu, torch.float32), ("float64", cpu, torch.float64)):
        xg = xs.to(where, dtype).requires_grad_(True)
        lp = vs.log_density(xg)
        (g,) = torch.autograd.grad(lp.sum(), xg)
        out[name] = (lp.detach().cpu().double().numpy(), g.cpu().double().numpy())

    def distance(a, b):
        """Density relative to max(1, |lp|); gradient component by component
        relative to max(1, |g|), and against the state's largest component."""
        (lp_a, g_a), (lp_b, g_b) = out[a], out[b]
        diff = np.abs(g_a - g_b)
        return (float(np.max(np.abs(lp_a - lp_b) / np.maximum(1.0, np.abs(lp_b)))),
                float(np.max(diff / np.maximum(1.0, np.abs(g_b)))),
                float(np.max(diff / np.maximum(1.0, np.abs(g_b).max(axis=1, keepdims=True)))))

    pairs = {(a, b): distance(a, b) for a, b in (("card", "CPU"), ("card again", "card"),
                                                 ("card", "float64"), ("CPU", "float64"))}
    for (a, b), (lp_e, g_each, g_state) in pairs.items():
        print(f"{lanes} states, {a} against {b}: density {lp_e:.3g}, gradient component by "
              f"component {g_each:.3g}, against the state's largest component {g_state:.3g}")
    # the card's float32 gradient is as exact as the CPU's or more: no
    # further from the float64 evaluation of the same states, component by
    # component. Where a component is the difference of large terms the CPU
    # carries their rounding (2.04e-5 from float64, the card 9.3e-6: PERF.md
    # §6), so the card is held to the CPU against each state's largest
    # component, the density relative to max(1, |lp|)
    lp_err, _, g_err = pairs[("card", "CPU")]
    to_f64 = pairs[("card", "float64")][1], pairs[("CPU", "float64")][1]
    print(f"tolerance 1e-5 card against CPU; component distances to float64, card "
          f"{to_f64[0]:.3g} against the CPU's {to_f64[1]:.3g} (at most)")
    if not (lp_err <= 1e-5 and g_err <= 1e-5 and to_f64[0] <= to_f64[1]):
        raise AssertionError("varying slopes: the card's density or gradient is off the CPU's")
    SliceSamplerCUDA.reset_launches()
    pt = PT(Inputs(target=vs, n_chains=ST_VS_CHAINS, n_replicates=ST_VS_REPLICATES,
                   n_rounds=ST_AUTOMALA_ROUNDS, seed=SEED, show_report=False, device="cuda"))
    pt.run()
    if any(SliceSamplerCUDA.launches.values()):
        raise AssertionError(f"varying slopes launched a kernel: {SliceSamplerCUDA.launches}")
    beta = vs.constrained_samples(pt)["beta"].mean(axis=0).astype(np.float64)
    print(f"{type(pt.explorer).__name__}, {ST_AUTOMALA_ROUNDS} rounds, "
          f"{pt.reports[-1].wall_time_s / pt.reports[-1].n_scans * 1e3:.1f} ms a scan; "
          f"logZ {pt.reports[-1].log_z_estimate:.4f}, barrier {pt.global_barrier:.4f}; pooled "
          f"beta {np.round(beta, 3).tolist()}, true {np.round(beta_true, 3).tolist()} (printed, "
          "not gated: the run is inside its transient)")
    del pt
    print(f"phase 14c: {time.perf_counter() - t_phase:.1f} s")


def stan_phase(library_eight_schools_log_z):
    """Phase 14: Stan models (``pigeons_tpu_torch/models/stan.py``). (a) The
    eight-schools model's emitted source on kernel K2 against its twin at
    the eight-schools cell's 640 lanes, at the launcher's group and at 1, 8,
    16 and 32 threads a lane (no bit may differ), timed beside the library's
    compiled kEightSchools on the same inputs, in turns; at 8,192 lanes both
    timed; its run at the cell (launched once a scan, no other kernel), logZ
    within ST_LOG_Z_TOL of phase 3f's library run less log 2. (b) Bernoulli
    (beta(1, 1), y[10] with 2 ones) the same at 640 lanes, its run's mean
    theta within ST_THETA_TOL of 0.25 and logZ within ST_BERNOULLI_LOG_Z_TOL
    of log B(3, 9) (``tests/test_stan.py``'s gates). (c) The varying-slopes
    model runs beside the side process (``stan_varying_slopes_phase``).
    (d) The exact invariance test (N = 10,000) of K2 on the eight-schools
    source at beta = ST_INVARIANCE_BETA, its draws by rejection
    (``TemperedDraws``), the kernel launched once. Returns the kernels
    line's entry of the Stan row."""
    phase("14 Stan models")
    from pigeons_tpu_torch import SliceSamplerCUDA, eight_schools, invariance_test, stan_target
    from pigeons_tpu_torch.ops import cuda_slice

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    B = S_CHAINS * S_REPLICATES

    print("(a) eight schools, non-centred, on its emitted source")
    es = stan_target(source=STAN_EIGHT_SCHOOLS, data=STAN_EIGHT_SCHOOLS_DATA).to(dev)
    path = es.create_path(es.default_reference())
    src = path.device_density().source
    d = es.dim
    # a query: the source's statements (less tau = exp(u), on queries of u),
    # the reference's sum of squares, the interpolation
    shared, by_coord = ir_coord_ops(src.torch_fn.stmts)
    query = shared + sum_squares_ops(d) + ops(1) + INTERPOLATE
    full = ir_ops(src.torch_fn.stmts) + sum_squares_ops(d) + ops(1) + INTERPOLATE
    print(f"the Stan source: {full[0]:.0f} float32 and {full[1]:.0f} int32 operations an "
          f"evaluation, {query[0]:.0f} and {query[1]:.0f} less the loops of coordinates "
          f"{sorted(by_coord)}")
    keep = {}
    row = k2_mode("K2 user instance (Stan eight schools)", path, False, B, d, 1.0, query, ops(0),
                  full, extra_bytes=4 * src.arrays[0].numel(), groups=(1, 8, 16, 32), keep=keep,
                  coord_ops=by_coord, full_query_ops=full)
    x, betas, seeds = keep["inputs"]
    library = eight_schools().to(dev)
    lib_path = library.create_path(library.default_reference())
    turns = []
    for _ in range(2):
        turns.append((cuda_ms(lambda: cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1),
                              20),
                      cuda_ms(lambda: cuda_slice.sweep_cuda(x, betas, seeds, lib_path,
                                                            n_passes=1), 20)))
    row["library_kind_ms"] = float(np.median([t[1] for t in turns]))
    print(f"B={B}: the Stan source / the compiled kEightSchools, ms (median of 20) in turns: "
          + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in turns) + f"; launcher's group "
          f"{cuda_slice.launcher_group(path, B, d)}")
    xw, bw, sw = lane_inputs(ST_WIDE_LANES, d, 1.0, 11)
    wide = (cuda_ms(lambda: cuda_slice.sweep_cuda(xw, bw, sw, path, n_passes=1), 20),
            cuda_ms(lambda: cuda_slice.sweep_cuda(xw, bw, sw, lib_path, n_passes=1), 20))
    row["ms_8192"], row["library_kind_ms_8192"] = wide
    print(f"B={ST_WIDE_LANES}: the Stan source {wide[0]:.4f} ms, kEightSchools {wide[1]:.4f} ms "
          f"(median of 20), launcher's group {cuda_slice.launcher_group(path, ST_WIDE_LANES, d)}")
    pt, row["launches"] = bayesian_run(es, S_CHAINS, S_REPLICATES, S_ROUNDS,
                                       kernel="slice_sweep_user")
    print_round(pt, B)
    q = es.constrained_samples(pt)
    log_z = pt.reports[-1].log_z_estimate
    want = library_eight_schools_log_z - math.log(2.0)
    print(f"pooled mu {float(np.mean(q['mu'])):.4f}, tau {float(np.mean(q['tau'])):.4f}; logZ "
          f"{log_z:.6f}, phase 3f's kEightSchools run less log 2 {want:.6f}, tolerance "
          f"{ST_LOG_Z_TOL}")
    if not abs(log_z - want) < ST_LOG_Z_TOL:
        raise AssertionError("Stan eight schools: logZ off the library kind's less log 2")
    del pt

    print("(b) Bernoulli, beta(1, 1), on its emitted source")
    bern = stan_target(source=STAN_BERNOULLI, data=STAN_BERNOULLI_DATA).to(dev)
    bpath = bern.create_path(bern.default_reference())
    xb, bb, sb = lane_inputs(B, 1, 1.0, 11)
    want_b = cuda_slice.sweep_reference(xb, bb, sb, bpath, n_passes=1)
    for g in (0, 1, 8, 16, 32):
        compare(f"K2 user instance (Stan Bernoulli), B={B}, "
                + ("the launcher's" if g == 0 else f"{g}") + " threads per lane",
                cuda_slice.sweep_cuda(xb, bb, sb, bpath, n_passes=1, group=g), want_b)
    print(f"B={B}: {cuda_ms(lambda: cuda_slice.sweep_cuda(xb, bb, sb, bpath, n_passes=1), 20):.4f}"
          " ms (median of 20)")
    pt, _ = bayesian_run(bern, S_CHAINS, S_REPLICATES, S_ROUNDS, kernel="slice_sweep_user")
    print_round(pt, B)
    theta = float(np.mean(bern.constrained_samples(pt)["theta"]))
    log_z = pt.reports[-1].log_z_estimate
    print(f"mean theta {theta:.4f} (0.25), logZ {log_z:.6f} (log B(3, 9) = {BERNOULLI_LOG_Z:.6f})")
    if not (abs(theta - 0.25) < ST_THETA_TOL and abs(log_z - BERNOULLI_LOG_Z) < ST_BERNOULLI_LOG_Z_TOL):
        raise AssertionError("Stan Bernoulli: mean theta or logZ off")
    del pt

    print(f"(d) invariance of K2 on the eight-schools source at beta = {ST_INVARIANCE_BETA}")
    draws = TemperedDraws(lambda v: src.target(v), eight_schools_log_bound(STAN_EIGHT_SCHOOLS_DATA),
                          d, ST_REJECTION_TRIES)
    SliceSamplerCUDA.reset_launches()
    res = invariance_test(TemperedStan(es, draws), SliceSamplerCUDA(), n_iid_samples=I_SAMPLES,
                          seed=I_SEED, device="cuda", beta=ST_INVARIANCE_BETA)
    print(f"invariance: passed {res.passed}, min p-value {float(np.min(res.pvalues)):.4g}, "
          f"launches {dict(SliceSamplerCUDA.launches)}")
    if not (res.passed and launched_only(dict(SliceSamplerCUDA.launches), "slice_sweep_user", 1)):
        raise AssertionError("K2 on the Stan eight-schools source: invariance test failed")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    row.update(name="slice_sweep_user (Stan eight schools, emitted source)", route="cuda",
               source="pigeons_tpu_torch/csrc/sweep_slice.cu",
               replaces="pigeons_tpu/ops/pallas_slice.py:94")
    return row


def main():
    device_phase()
    build_phase()
    parent_phase()
    k1, (k2, delta_twin), k1v = k1_phase(), k2_phase(), k1_variational_phase()
    bayesian, k2v = k2_bayesian_phase(), k2_variational_phase()
    side = start_side_phases()
    try:
        user_builds = start_user_builds()
        config1_run, hierarchical_run = main_phases(k1, k2, k1v, bayesian, k2v, delta_twin)
        stan_varying_slopes_phase()
        join_side_phases(side)
    finally:
        side[0].kill()
    k2u, k1u = user_density_phase(hierarchical_run, user_builds)
    k2s = stan_phase(LIBRARY_RUNS["eight_schools_log_z"])
    del config1_run, hierarchical_run
    if "--profile" in sys.argv[1:]:
        profile_phase()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - T0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": [k1, k2, k1v, *bayesian.values(), k2v, k2u, k1u, k2s]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def main_phases(k1, k2, k1v, bayesian, k2v, delta_twin):
    """The main process's paths from phase 3 to phase 11, beside the side
    process; fills in the kernel rows' launches. Returns the runs of phases
    3 and 3d (config 1, the hierarchical normal), which phases 11 and 12 are
    held to."""
    k1["launches"], config1_run = config1_phase()
    k2["launches"] = funnel_phase()
    k1v["launches"] = config4_phase()
    bayesian["hierarchical_normal"]["launches"], hierarchical_run = hierarchical_phase()
    bayesian["unid"]["launches"] = unid_phase()
    bayesian["eight_schools"]["launches"], mu_noncentred, log_z_noncentred = eight_schools_phase()
    LIBRARY_RUNS["eight_schools_log_z"] = log_z_noncentred
    bayesian["logistic_regression"]["launches"] = logistic_regression_phase()
    bayesian["mrna"]["launches"] = mrna_phase()
    bayesian["bernoulli"]["launches"] = bernoulli_phase()
    bayesian["eight_schools_centered"]["launches"] = centered_eight_schools_phase(
        mu_noncentred, log_z_noncentred)
    k2v["launches"] = variational_funnel_phase()
    run2a, target2a = config2a_phase()
    run2b, target2b = config2b_phase()
    automala_card_vs_cpu_phase(run2a, target2a)
    automala_card_vs_cpu_phase(run2b, target2b, "6d queued AutoMALA at config 2b, card vs CPU",
                               lanes=B_COMPARE_LANES, max_differ=2, queued=True,
                               queue_width=B_QUEUE_WIDTH, window=B_WINDOW)
    del run2a, run2b
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        folder = Path(tmp)
        ref_params = checkpoint_phase(folder)
        card_to_cpu_phase(folder)
        serial_check_phase(folder)
    k2["delta_mode"]["launches"] = invariance_phase(ref_params, delta_twin)
    k1["mesh_launches"], bayesian["hierarchical_normal"]["mesh_launches_per_rank"] = mesh_phase(
        config1_run, hierarchical_run)
    return config1_run, hierarchical_run


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ms_per_scan(pt) -> float:
    rep = pt.reports[-1]
    return rep.wall_time_s / rep.n_scans * 1e3


def float64_sweep():
    """The float64 forms of ``f32math`` and the float64 draws of ``rng``,
    card against CPU, bit for bit: every form on 2^16 arguments spread over
    its domain (and outside it), the uniforms, normals and exponentials of
    4,096 keys x 16 (NaN equals NaN, whatever its payload). Returns the
    names of the forms whose bits differ."""
    from pigeons_tpu_torch import f32math, rng

    g = torch.Generator().manual_seed(0)
    n = 1 << 16
    wide = torch.randn(n, dtype=torch.float64, generator=g) * torch.exp2(
        torch.randint(-40, 11, (n,), generator=g).to(torch.float64))
    unit = torch.rand(n, dtype=torch.float64, generator=g) * 2.0 - 1.0
    pos = torch.abs(wide) + 1e-300
    b, c = (torch.randn(n, dtype=torch.float64, generator=g) for _ in range(2))
    forms = {
        "fma": (f32math.fma, (wide, b, c)), "exp": (f32math.exp, (wide,)),
        "log": (f32math.log, (pos,)), "log1p": (f32math.log1p, (torch.abs(wide) - 0.5,)),
        "expm1": (f32math.expm1, (wide,)), "erfinv": (f32math.erfinv, (unit,)),
        "lgamma": (f32math.lgamma, (pos,)), "logaddexp": (f32math.logaddexp, (wide, b * 30.0)),
    }
    keys = rng.keys_for(rng.key(SEED), torch.arange(4096))
    draws = {
        "uniform": lambda k: rng.uniform(k, (16,), dtype=torch.float64),
        "normal": lambda k: rng.normal(k, (16,), dtype=torch.float64),
        "exponential": lambda k: rng.exponential(k, (16,), dtype=torch.float64),
    }

    def same_bits(x, y):  # a NaN's payload is the backend's own
        return bool(((x.view(torch.int64) == y.view(torch.int64))
                     | (torch.isnan(x) & torch.isnan(y))).all())

    differ = [name for name, (fn, args) in forms.items()
              if not same_bits(fn(*(a.cuda() for a in args)).cpu(), fn(*args))]
    differ += [name for name, draw in draws.items()
               if not same_bits(draw(keys.cuda()).cpu(), draw(keys))]
    print(f"float64 forms ({', '.join(forms)}) on {n} arguments and draws "
          f"({', '.join(draws)}) of {keys.shape[0]} x 16: card and CPU bits differ in {differ}")
    return differ


def float64_phase():
    """Phase 13a (side process): the float64 forms and draws card against
    CPU bit for bit (:func:`float64_sweep`); ``tests/test_dtype.py``'s three
    runs in float64 with its thresholds (the toy MVN at 8 rounds, not 9), the
    deep funnel also on the CPU, its states, permutations and samples the
    card's bit for bit; the funnel cell's target and width (d = 10, 12
    chains x 256 ladders) with the torch ``SliceSampler(n_passes=1)``, one
    scan in float64 and one in float32; and ``SliceSamplerCUDA`` refusing a
    float64 run. No kernel may launch. Every time is printed beside the
    card's name and power limit."""
    phase("13a float64 runs")
    from pigeons_tpu_torch import PT, Inputs, SliceSampler, SliceSamplerCUDA, toy_mvn_target
    from pigeons_tpu_torch.models import funnel

    t_phase = time.perf_counter()
    card = card_line()
    f64 = torch.float64
    SliceSamplerCUDA.reset_launches()
    if float64_sweep():
        raise AssertionError("float64 forms or draws: the card's bits are not the CPU's")
    s = torch.tensor([[-100.0, 1.0, 1.0]], device="cuda")
    lp32, lp64 = funnel(2).log_density(s), funnel(2).log_density(s.to(f64))
    print(f"funnel(2) at y = -100: float32 {lp32.item()}, float64 {lp64.item():.6e}")
    if torch.isfinite(lp32).any() or not torch.isfinite(lp64).all():
        raise AssertionError("funnel at y = -100: float32 must saturate, float64 must not")
    deep, deep_cpu = (PT(Inputs(target=funnel(2), n_chains=4, n_rounds=5, seed=1, dtype=f64,
                                explorer=SliceSampler(n_passes=1), show_report=False,
                                device=dev)).run() for dev in ("cuda", "cpu"))
    sa = deep.sample_array()
    same = (torch.equal(deep.states.cpu().view(torch.int64), deep_cpu.states.view(torch.int64))
            and torch.equal(deep.chain_of.cpu(), deep_cpu.chain_of)
            and torch.equal(deep.replica_of.cpu(), deep_cpu.replica_of)
            and np.array_equal(sa.view(np.int64), deep_cpu.sample_array().view(np.int64)))
    print(f"deep funnel: states {deep.states.dtype}, logZ {deep.reports[-1].log_z_estimate:.6f}, "
          f"card and CPU states, permutations and samples bitwise equal: {same}; "
          f"{ms_per_scan(deep):.1f} ms per scan ({card}), on the CPU {ms_per_scan(deep_cpu):.1f}")
    if not (deep.states.dtype == f64 and sa.dtype == np.float64 and np.isfinite(sa).all()
            and np.isfinite(deep.mean()).all()
            and math.isfinite(deep.reports[-1].log_z_estimate)):
        raise AssertionError("deep funnel in float64: a non-finite or float32 result")
    if not same:
        raise AssertionError("deep funnel in float64: the card's run is not the CPU's bit for bit")
    # 8 rounds, not the JAX test's 9: on the card its 4 lanes cost about 0.1 s a scan
    toy = PT(Inputs(target=toy_mvn_target(2), n_chains=4, n_rounds=8, seed=1, dtype=f64,
                    show_report=False, device="cuda")).run()
    print(f"toy MVN(2): mean {toy.mean()}, var {toy.var()}, {ms_per_scan(toy):.1f} ms per scan "
          f"({card})")
    if not (np.all(np.abs(toy.mean()) < 0.06) and np.all(np.abs(toy.var() - 0.1) < 0.05)):
        raise AssertionError("toy MVN in float64: moments off the JAX test's thresholds")
    cell = []
    for dt in (f64, torch.float32):  # the funnel cell, one scan in each dtype
        pt = PT(Inputs(target=funnel(9), n_chains=12, n_replicates=256, seed=1, dtype=dt,
                       explorer=SliceSampler(n_passes=1), show_report=False, device="cuda"))
        pt.run_round(1)
        print(f"funnel cell, {dt}: {ms_per_scan(pt):.1f} ms per scan ({card})")
        cell.append(np.isfinite(pt.sample_array()).all())
    if not all(cell):
        raise AssertionError("funnel cell: non-finite samples")
    try:
        PT(Inputs(target=funnel(2), dtype=f64, explorer=SliceSamplerCUDA(n_passes=1),
                  device="cuda"))
        raise AssertionError("SliceSamplerCUDA took a float64 run")
    except ValueError as e:
        if "SliceSampler(w=" not in str(e):
            raise
        print(f"SliceSamplerCUDA refuses float64: {str(e)[:90]}...")
    del deep, deep_cpu, toy, pt
    if any(SliceSamplerCUDA.launches.values()):
        raise AssertionError(f"phase 13a launched a kernel: {SliceSamplerCUDA.launches}")
    print(f"phase 13a: {time.perf_counter() - t_phase:.1f} s ({card})")


def host_targets_phase():
    """Phase 13b-d (side process): the host-evaluated targets on the card.
    (b) ``NativeTarget`` (het_normal, d = 4) at 10 chains x 256 ladders
    with its default ``AutoMALA``, 3 rounds, held to the law of the JAX slow
    test, with the density's host round trips a scan; (c) ``StreamTarget``
    over the compiled C++ worker, 10 chains; (d) ``ExternalTarget`` (5
    rounds, not 7) and ``LazyTarget`` as ``tests/test_extensions.py`` runs
    them. No kernel may launch: their densities run on the host. Every
    time is printed beside the card's name and power limit."""
    phase("13b-d host-evaluated targets")
    import pickle

    from pigeons_tpu_torch import (PT, AutoMALA, ExternalTarget, Inputs, LazyTarget,
                                   SliceSamplerCUDA, pigeons, toy_mvn_target)
    from pigeons_tpu_torch.models import register_lazy_target
    from pigeons_tpu_torch.models.native import NativeTarget, example_library
    from pigeons_tpu_torch.models.stream import StreamTarget, example_worker, java_seed

    t_phase = time.perf_counter()
    card = card_line()
    SliceSamplerCUDA.reset_launches()

    print("(b) NativeTarget (het_normal), AutoMALA")
    prec = np.array([500.0, 167.0, 56.0, 1.0])
    native = NativeTarget(example_library("het_normal"))
    calls = [0]
    density = native.log_density

    def counted(x):
        calls[0] += 1
        return density(x)

    native.log_density = counted
    pt = PT(Inputs(target=native, n_chains=10, n_replicates=256, n_rounds=3, seed=1,
                   show_report=False, device="cuda"))
    if not isinstance(pt.explorer, AutoMALA):
        raise AssertionError("NativeTarget: the default explorer is not AutoMALA")
    for _ in range(2):
        pt.run_round()
    before = calls[0]
    pt.run_round()
    trips = (calls[0] - before) / pt.reports[-1].n_scans
    print(f"native: mean {pt.mean()}, var {pt.var()}, 1/prec {1.0 / prec}; {trips:.1f} host "
          f"round trips per scan, {ms_per_scan(pt):.1f} ms per scan ({card})")
    if not (np.all(np.abs(pt.mean()) < 5.0 / np.sqrt(prec))
            and np.allclose(pt.var(), 1.0 / prec, rtol=0.5)):
        raise AssertionError("NativeTarget: moments off the JAX test's law")
    del pt

    print("(c) StreamTarget (compiled C++ worker)")
    binary = example_worker()
    target = StreamTarget(lambda i: [binary, "--seed", str(java_seed(1, i)), "--dim", "2"])
    try:
        pt = pigeons(target=target, n_chains=10, n_rounds=6, show_report=False, device="cuda")
        lps = pt.sample_array()[:, -1]
        print(f"stream: mean log density {lps.mean():.4f} (-1 exact), round trips "
              f"{pt.n_round_trips}, barrier {pt.global_barrier:.4f}, {len(target.pool.workers)} "
              f"workers, {ms_per_scan(pt):.1f} ms per scan ({card})")
        if not (np.isfinite(lps).all() and abs(lps.mean() + 1.0) < 0.3 and pt.n_round_trips > 0
                and pt.global_barrier > 0.0):
            raise AssertionError("StreamTarget: off the JAX test's law")
    finally:
        target.close()

    print("(d) ExternalTarget and LazyTarget")
    ext = ExternalTarget(lambda xb: (-0.5 * (xb**2).sum(axis=1) * 5.0).astype("float32"), dim=2)
    # 5 rounds, not the JAX test's 7: a scan of 3 lanes costs about 0.4 s on the card
    pt = pigeons(target=ext, n_chains=3, n_rounds=5, seed=1, show_report=False, device="cuda")
    print(f"external: var {pt.var()} (0.2 exact), {ms_per_scan(pt):.1f} ms per scan ({card})")
    if not np.allclose(pt.var(), 0.2, atol=0.07):
        raise AssertionError("ExternalTarget: variance off the JAX test's tolerance")
    register_lazy_target("toy3-chip", lambda: toy_mvn_target(3))
    lazy = LazyTarget("toy3-chip")
    if len(pickle.dumps(lazy)) >= 200:
        raise AssertionError("LazyTarget: more than the flag pickled")
    pt = pigeons(target=lazy, n_chains=3, n_rounds=6, seed=1, show_report=False, device="cuda")
    print(f"lazy: var {pt.var()} (0.1 exact), {ms_per_scan(pt):.1f} ms per scan ({card})")
    if not np.allclose(pt.var(), 0.1, atol=0.06):
        raise AssertionError("LazyTarget: variance off the JAX test's tolerance")
    if any(SliceSamplerCUDA.launches.values()):
        raise AssertionError(f"phase 13b-d launched a kernel: {SliceSamplerCUDA.launches}")
    print(f"phase 13b-d: {time.perf_counter() - t_phase:.1f} s ({card})")


def side_phases():
    """The phases that read nothing of the other phases' runs and are
    timed by no kernel row: NUTS and AAPS at config 2a's width (3n), the
    determinism runs (4), the quick start (5), the small runs card against
    CPU (6), the combinators (6c), the torch ``SliceSampler`` (7), the
    ordinal and Bool targets (7b), the float64 runs (13a) and the
    host-evaluated targets (13b-d). ``chip_smoke.py --side-phases`` runs them
    in a process of its own beside phases 3-11 (``start_side_phases``)."""
    nuts_aaps_runs, target2a_n = nuts_aaps_phase()
    nuts_aaps_card_vs_cpu_phase(nuts_aaps_runs, target2a_n)
    del nuts_aaps_runs
    determinism_phase()
    quickstart_phase()
    small_reference_phase()
    combinators_phase()
    torch_sampler_phase()
    discrete_phase()
    float64_phase()
    host_targets_phase()
    print(f"side phases: all passed in {time.perf_counter() - T0:.1f} s")


def start_side_phases():
    """Starts ``chip_smoke.py --side-phases`` once the kernel rows are timed
    (phases 2-2e), its output into a temporary file: the gradient path's
    eager scans and the CPU runs take about a third of the script, most of
    it on the host. Returns the process, the file and its start."""
    import tempfile

    phase("side: phases 3n, 4, 5, 6, 6c, 7, 7b and 13 start in a process of their own; its "
          "output follows phase 11")
    log = tempfile.TemporaryFile(mode="w+")
    child = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--side-phases"],
                             stdout=log, stderr=subprocess.STDOUT, text=True)
    return child, log, time.perf_counter()


def join_side_phases(side):
    """Waits for the side process, prints its output and raises if it
    failed."""
    child, log, t0 = side
    phase("side: phases 3n, 4, 5, 6, 6c, 7, 7b and 13 (their times from the side process's "
          "start)")
    t_wait = time.perf_counter()
    rc = child.wait(timeout=1200)
    log.seek(0)
    print(log.read(), end="")
    log.close()
    print(f"side process: exit {rc}, {time.perf_counter() - t0:.1f} s from its start, "
          f"{time.perf_counter() - t_wait:.1f} s waited for")
    if rc != 0:
        raise AssertionError(f"the side phases failed (exit {rc})")


def side_main():
    """``chip_smoke.py --side-phases``: the card, the built library, then
    ``side_phases``."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    from pigeons_tpu_torch import _build

    _build.load_library()
    side_phases()


T0 = time.perf_counter()

if __name__ == "__main__":
    if "--mesh-child" in sys.argv[1:]:
        at = sys.argv.index("--mesh-child")
        mesh_child(int(sys.argv[at + 1]), sys.argv[at + 2])
    elif "--side-phases" in sys.argv[1:]:
        side_main()
    else:
        main()
