"""Times variants of the port's CUDA kernels side by side on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py [--k2-only | --variational | --speculate [--rows R,...] [--splits-only] [--delta-slots S,...]] [--parent-csrc DIR ... [--parent-abi N]]

Run from the repository root. Builds ``pigeons_tpu_torch/csrc`` once for each
setting of kernel K1's tile size and refill threshold (``-DPIGEONS_K1_CHUNK=
-DPIGEONS_K1_REFILL=``) and, with ``--parent-csrc`` (repeated for more than
one: "parent", "parent 2", ...), an earlier version of the sources from ``DIR`` (for example
``git archive <commit> pigeons_tpu_torch/csrc | tar -x -C <dir>``, then
``<dir>/pigeons_tpu_torch/csrc``). ``--parent-abi`` says which entry points
that version has: 1, the first (no ``group`` argument in K2, no coordinate
term in K1); 3, the default (``group``, no coordinate term); 4, K1 with its
coordinate term and K2 without array inputs; 5, this tree's.
It then times, at the shapes of ``chip_smoke.py``:

* K1 (config 1: B=20,480, d=100, 3 passes) for each such setting and the
  parent, and the spread of iterations per element that K1 has to balance;
* K1 with the toy term and with the variational term side by side (the
  reference active, half the lanes variational, a mean and std that differ
  by coordinate) at B=5,120 (config 4) and B=20,480, d=100, 3 passes;
* K2 in full mode on the funnel path (d=10, 1 pass; B=3,072, 8,192 and
  20,480) and on the toy MVN path (B=20,480, d=100, 1 pass) for 1, 8, 16 and
  32 threads per lane, the launcher's own choice and the parent;
* K2 in full mode on each ``BayesianModel`` path (hierarchical normal, eight
  schools, unid, logistic regression; 1 pass) at 640 and 8,192 lanes (the
  logistic regression also at its path's 10,240), mRNA at its path's 8,192,
  centred eight schools and Bernoulli at their 640, for 1, 8, 16 and 32
  threads per lane, the launcher's own choice and, with ``--parent-abi 5``,
  the parent;
* K2 in delta mode (toy MVN, B=20,480, d=100, 1 pass) and the parent's.

``--variational`` times only the two rows under a variational reference,
each against the parent (``--parent-csrc``):

* K2 on the two-leg funnel (d=10, 1 pass, half the lanes variational, the
  reference active) at its path's 768 lanes and at 6,144 (bench config 3's
  width with an equal variational leg), for 1, 8, 16 and 32 threads a lane
  and the launcher's choice, and the plain funnel on the same inputs; then
  the same launch in a build with ``PIGEONS_K2_CLOCKS``, whose
  ``clock64()`` split of each lane's loop by part (the draw, prepare, the
  target's terms, the group's ``__syncwarp``, the sums, the reference, the
  machine) it prints for the slowest lane (the twin's iteration count)
  beside its nanoseconds and the kernel's device time;
* K1's variational term at B=5,120 (config 4) and 20,480, d=100, 3 passes,
  against the toy term on the same inputs, and against a copy of the
  sources whose kernel must keep 5 blocks an SM (``__launch_bounds__``);
  each instance's resident blocks (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``,
  from a query this tool appends to its own copy of ``banded_slice.cu``),
  the SASS length of both instances (``cuobjdump``) and the iterations per
  element of both terms.

``--speculate`` times only K2's rows whose groups of threads speculate the
machine's next queries, a query a thread (``--rows``, a comma list, all by
default): eight schools and unid (d = 10 and 2, 1 pass) at their paths' 640
lanes and at 8,192, Bernoulli (d = 1, 1 pass) at its path's 640 and phase
10's 10,000, and delta mode (toy MVN, d = 100, 3 passes, one thread a lane)
at phase 10's inputs: every group, the launcher's choice and the parent
(``--parent-csrc``, at its launcher's choice); at the path's batch the
``clock64()`` split of the slowest lane in each parent's
``PIGEONS_K2_CLOCKS`` build (its launcher's group) and in this tree's at
every group, with the loop's passes (iterations, or rounds; delta mode's
parts under their own names). ``--delta-slots 1,3,4,8`` also times delta
mode with that many iterations a round (``kDeltaSlots``, set in a copy of
the sources under the build directory). ``--splits-only``
checks each row's groups against the twin and prints the parents' splits,
and times nothing. The builds run at once; it writes
``chiprun_out/kernel_variants_speculate.json``.

Every variant's output must equal the first variant's bit for bit (what a
kernel computes does not depend on how its work is mapped to threads). The
variants of one kernel are timed in turns, forwards then backwards, twice
over, each turn the median of 20 CUDA-event timings: compare within a run
only. Beside them each variant's device time from ``torch.profiler`` (20
calls): a CUDA-event time counts what the card waits for the host's launch,
which at 640 lanes is most of it. Prints ``ptxas -v`` for the default build, a table, the card's name and
power limit, and writes ``chiprun_out/kernel_variants.json``. ``--k2-only``
skips the builds and races of K1's variants.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from pigeons_tpu_torch import (_build, bernoulli_target, eight_schools, funnel,  # noqa: E402
                               hierarchical_normal, logistic_regression, mrna_target,
                               unid_target)
from pigeons_tpu_torch.models import source_examples as SE  # noqa: E402
from pigeons_tpu_torch.ops import cuda_slice  # noqa: E402
from pigeons_tpu_torch.paths import toy_mvn_path  # noqa: E402

# kernel K1's (tile size, free lanes at which a warp refills)
K1_VARIANTS = ((1024, 4), (2048, 4), (4096, 4), (8192, 4), (4096, 1), (4096, 2), (4096, 8))
GROUPS = (1, 8, 16, 32)
W, P, MAX_ITER = 10.0, 20, 1024  # the explorer's defaults


def load(defines=(), csrc=_build.CSRC, verbose=False, sources=_build.SOURCES):
    path, seconds = _build.build(verbose=verbose, defines=defines, csrc=csrc, sources=sources)
    print(f"built {path.name} ({' '.join(defines) or 'defaults'}, {csrc}, "
          f"{' '.join(sources)}) in {seconds:.2f} s", flush=True)
    lib = ctypes.CDLL(str(path))
    lib.path = path
    return lib


def k1_call(lib, x, a, seeds, n_passes, variational=None, first_version=False):
    """``variational``: a ``cuda_slice.VariationalTerm`` or ``None`` (the toy
    term). ``first_version``: the entry point without a coordinate term."""
    B, d = x.shape
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [p, p, p, p, p, i, i, f, i, i, i]
    term_args = ()
    if not first_version:
        term_args = (0, None, None, None, None, None, 0.0)
        if variational is not None:
            vt = variational
            term_args = (1, vt.beta.data_ptr(), vt.isvar.data_ptr(), vt.active.data_ptr(),
                         vt.mean.data_ptr(), vt.std.data_ptr(), vt.a_target)
    lib.banded_slice_sweep.argtypes = head + ([] if first_version else [i, p, p, p, p, p, f]) + [p]

    def call():
        x_out = torch.empty_like(x)
        stats = torch.zeros((3, B), dtype=torch.float32, device=x.device)
        err = lib.banded_slice_sweep(x.data_ptr(), a.data_ptr(), seeds.data_ptr(), x_out.data_ptr(),
                                     stats.data_ptr(), B, d, W, P, n_passes, MAX_ITER, *term_args,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"banded_slice_sweep: error {err}")
        return x_out, stats

    return call


def race_terms(lib, B, d):
    """K1's two coordinate terms on the same inputs, timed in turns (their
    outputs differ: the terms are different densities)."""
    x, betas, seeds = chip_smoke.lane_inputs(B, d, 0.5, 13)
    dev = x.device
    path = toy_mvn_path(d)
    a = path.coord_factor(betas)
    rs = np.random.RandomState(4)
    half = chip_smoke.V_CHAINS
    term = cuda_slice.VariationalTerm(
        betas, ((torch.arange(B, device=dev) % (2 * half)) < half).float(),
        torch.ones(1, device=dev), float(path.coord_factor(torch.ones(()))),
        torch.tensor((rs.normal(size=d) * 0.05).astype(np.float32), device=dev),
        torch.tensor((np.sqrt(0.1) * np.exp(rs.normal(size=d) * 0.2)).astype(np.float32),
                     device=dev))
    calls = {"toy term": k1_call(lib, x, a, seeds, 3),
             "variational term": k1_call(lib, x, a, seeds, 3, term)}
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]) * 2:
        for name in order:
            times[name].append(chip_smoke.cuda_ms(calls[name], 20))
    print(f"-- K1's terms, B={B}, d={d}, 3 passes")
    for name in calls:
        print(f"{name:>36}: median {np.median(times[name]):.4f} ms, turns "
              + " ".join(f"{t:.4f}" for t in times[name]), flush=True)
    return times


def k2_call(lib, x, betas, seeds, path, coord_deltas, group, arrays=False, variational=None,
            n_passes=chip_smoke.F_PASSES):
    """``group=None``: an entry point of before the ``group`` argument.
    ``arrays``: this tree's entry point, which takes the density's arrays,
    the prior table and the variational reference (``variational``: the
    keywords ``isvar`` and ``ref_params`` of a variational launch, or none)."""
    B, d = x.shape
    density = path.device_density()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if arrays:
        inputs = cuda_slice.kernel_inputs(density, B, d, x.device, **(variational or {}))
        middle = (inputs.params, inputs.arrays, inputs.array_lens, inputs.prior, inputs.n_prior,
                  *inputs.variational)
        tail = [group]
        lib.slice_sweep.argtypes = ([p] * 6 + [i] * 4 + [ctypes.POINTER(f), ctypes.POINTER(p),
                                    ctypes.POINTER(i), ctypes.POINTER(f), i, p, p, p, p, f]
                                    + [i] * 4 + [p])
    else:
        tail = [] if group is None else [group]
        middle = ((f * cuda_slice.MAX_DENSITY_PARAMS)(*density.params),)
        lib.slice_sweep.argtypes = ([p] * 6 + [i] * 4 + [ctypes.POINTER(f), f, i, i, i]
                                    + [i] * len(tail) + [p])

    def call():
        x_out = torch.empty_like(x)
        lp = torch.empty(B, dtype=torch.float32, device=x.device)
        stats = torch.empty((3, B), dtype=torch.float32, device=x.device)
        err = lib.slice_sweep(x.data_ptr(), betas.data_ptr(), seeds.data_ptr(), x_out.data_ptr(),
                              lp.data_ptr(), stats.data_ptr(), B, d, density.kind,
                              int(coord_deltas), *middle, W, P, n_passes, MAX_ITER,
                              *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"slice_sweep: error {err}")
        return x_out, lp, stats

    return call


def device_ms(call, n=20):
    """The kernel's own time per call in ms: ``torch.profiler``'s device time
    of the sweep kernels over ``n`` calls. Unlike a CUDA-event time, which
    starts before the host has launched the kernel, it leaves out what the
    card waits for the host (a small launch is the wrapper's host time)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "slice_sweep_kernel" in e.key or "banded_slice_kernel" in e.key)
    return us / n / 1000.0


def race(title, variants):
    """Check that all ``variants`` (name -> call) agree bit for bit, then time
    them in turns. Returns name -> list of the turns' medians in ms, and the
    kernel's device time (``device_ms``) under ``"<name>, device"``."""
    names = list(variants)
    outs = {name: variants[name]() for name in names}
    torch.cuda.synchronize()
    for name in names[1:]:
        for got, want in zip(outs[name], outs[names[0]], strict=True):
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{title}: {name} differs from {names[0]}")
    times = {name: [] for name in names}
    for order in (names, names[::-1], names, names[::-1]):
        for name in order:
            times[name].append(chip_smoke.cuda_ms(variants[name], 20))
    device = {name: device_ms(variants[name]) for name in names}
    print(f"-- {title}: {len(names)} variants bitwise equal")
    for name in names:
        print(f"{name:>36}: median {np.median(times[name]):.4f} ms, turns "
              + " ".join(f"{t:.4f}" for t in times[name])
              + f"; device {device[name]:.4f} ms", flush=True)
    times.update({f"{name}, device": [ms] for name, ms in device.items()})
    return times


def k1_iterations(x, a, seeds, variational=None):
    """What kernel K1's mapping of elements to warps has to balance: the
    twin's count of iterations for every element (with the ``variational``
    term, if given), and the warp-iterations they cost with one thread per
    element (a warp of 32 consecutive elements runs as long as its slowest)
    against lanes that are always full."""
    its = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    cuda_slice.banded_sweep_reference(x, a, seeds, element_iterations=its,
                                      variational=variational)
    flat = its.flatten()
    ranked = flat.sort().values
    quantiles = {q: int(ranked[int(q * (flat.numel() - 1))]) for q in (0.5, 0.9, 0.99, 0.999)}
    per_warp = int(flat.view(-1, 32).max(1).values.sum())
    packed = -(-int(flat.sum()) // 32)
    print(f"-- K1 iterations per element: {flat.numel()} elements, {int(flat.sum())} iterations, "
          f"min {int(flat.min())}, max {int(flat.max())}, quantiles {quantiles}; warp-iterations "
          f"with one thread per element {per_warp}, with full lanes {packed}", flush=True)
    return {"min": int(flat.min()), "max": int(flat.max()), "quantiles": quantiles,
            "warp_iterations_thread_per_element": per_warp, "warp_iterations_full_lanes": packed}


K2_CLOCK_LANES = 8192  # csrc/sweep_slice.cu: kClockLanes
CLOCK_PARTS = ("draw", "prepare", "target terms", "__syncwarp", "sums", "reference", "machine")
# the same columns in delta mode's rounds (csrc/sweep_slice.cu: lookahead_delta_sweep)
DELTA_CLOCK_PARTS = ("hashes and ENTER", "prepare", "iterations", "__syncwarp", "sums",
                     "reference", "run's end")


def two_leg_funnel(B):
    """``chip_smoke.py`` phase 2e's row at ``B`` lanes: the funnel d = 10,
    each ladder's 2 x 6 chains (768 lanes) or 12 + 12 (6,144: bench config
    3's width with an equal variational leg), its first half variational,
    the reference active with a mean and std that differ by coordinate."""
    from pigeons_tpu_torch import GaussianReference, VariationalPath

    target = funnel(chip_smoke.F_NX)
    d = chip_smoke.F_NX + 1
    path = VariationalPath(target.create_path(target.default_reference()), GaussianReference())
    x, betas, seeds = chip_smoke.lane_inputs(B, d, 2.0, 11)
    dev = x.device
    half = chip_smoke.VF_CHAINS if B == 2 * chip_smoke.VF_CHAINS * chip_smoke.VF_REPLICATES \
        else chip_smoke.F_CHAINS
    rs = np.random.RandomState(4)
    var = {"isvar": ((torch.arange(B, device=dev) % (2 * half)) < half).float(),
           "ref_params": {"mean": torch.tensor((rs.normal(size=d) * 0.3).astype(np.float32),
                                               device=dev),
                          "std": torch.tensor((2.0 * np.exp(rs.normal(size=d) * 0.3))
                                              .astype(np.float32), device=dev),
                          "active": torch.tensor(1.0, device=dev)}}
    return path, (x, betas, seeds), var


def clock_split(lib, call, iterations, device_ms_, passes=True, names=CLOCK_PARTS):
    """Run ``call`` (a launch of a ``PIGEONS_K2_CLOCKS`` build) and print the
    split of the slowest lane's loop (most iterations by the twin) by part,
    its nanoseconds and microseconds an iteration, beside the launch's
    device time; and the same split summed over all lanes, as shares.
    ``passes``: whether the build counts its loop's passes (the machine's
    iterations, or the speculated machine's rounds), as this tree's does;
    the split then gives microseconds a pass too. A build records the first
    ``K2_CLOCK_LANES`` lanes only: of a larger batch, the slowest of those.
    ``names``: the parts' names (``DELTA_CLOCK_PARTS`` for delta mode)."""
    call()
    torch.cuda.synchronize()
    B = min(len(iterations), K2_CLOCK_LANES)
    iterations = iterations[:B]
    n_extra = 3 if passes else 2  # loop cycles, nanoseconds[, passes]
    buf = np.zeros((B, len(CLOCK_PARTS) + n_extra), np.uint64)
    err = lib.k2_clock_split(buf.ctypes.data_as(ctypes.c_void_p), B)
    if err:
        raise RuntimeError(f"k2_clock_split: error {err}")
    parts_of, loop_cycles, loop_ns = (buf[:, :len(CLOCK_PARTS)].astype(np.float64),
                                      buf[:, len(CLOCK_PARTS)].astype(np.float64),
                                      buf[:, len(CLOCK_PARTS) + 1].astype(np.float64))
    its = np.asarray(iterations.cpu(), np.int64)
    slow = int(np.argmax(its))
    cyc, ns, total = parts_of[slow], float(loop_ns[slow]), float(loop_cycles[slow])
    n_passes = int(buf[slow, -1]) if passes else int(its[slow])
    parts = {name: float(c) for name, c in zip(names, cyc)}
    row = {"slowest_lane": slow, "iterations": int(its[slow]), "passes": n_passes,
           "loop_cycles": total, "loop_ns": ns, "us_per_iteration": ns / 1e3 / its[slow],
           "us_per_pass": ns / 1e3 / n_passes, "cycles_per_iteration": total / its[slow],
           "cycles_per_pass": total / n_passes, "device_ms": device_ms_, "cycles_by_part": parts,
           "share_by_part_all_lanes": {name: float(v) for name, v in zip(
               names, parts_of.sum(0) / loop_cycles.sum())},
           "slowest_lane_by_ns": int(np.argmax(loop_ns)), "max_loop_ns": float(loop_ns.max())}
    if passes:
        row["passes_slowest_lane_by_ns"] = int(buf[int(np.argmax(loop_ns)), -1])
    print(f"   slowest lane {slow}: {its[slow]} iterations in {n_passes} passes, {total:.0f} cycles, "
          f"{ns / 1e3:.2f} us ({ns / 1e3 / its[slow]:.3f} us an iteration, {ns / 1e3 / n_passes:.3f} "
          f"us and {total / n_passes:.0f} cycles a pass; launch device time {device_ms_ * 1e3:.2f} "
          f"us; longest lane loop {loop_ns.max() / 1e3:.2f} us); cycles by part: "
          + ", ".join(f"{n} {c:.0f} ({c / total:.1%})" for n, c in parts.items()), flush=True)
    return row


def sass_lengths(lib_path, out_name=None):
    """Instructions of each kernel instance in the library's SASS
    (``cuobjdump -sass``), written whole to ``chiprun_out/out_name`` if given
    (K2's 30 instances are some 50 MB)."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    if res.returncode:
        print(f"cuobjdump failed: {res.stderr[:300]}")
        return {}
    if out_name:
        os.makedirs(ROOT / "chiprun_out", exist_ok=True)
        (ROOT / "chiprun_out" / out_name).write_text(res.stdout)
    lengths, name = {}, None
    for line in res.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            lengths[name] = 0
        elif name and line.strip().startswith("/*") and "*/" in line and ";" in line:
            lengths[name] += 1
    for name, n in lengths.items():
        demangled = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
        print(f"   SASS {n} instructions: {demangled[:150]}")
    return lengths


K1_OCCUPANCY = r'''
// The blocks of kernel K1's instance for coordinate term `term` that one SM
// holds at once at width d, with the launch's shared memory.
extern "C" int banded_slice_occupancy(int term, int d, int* blocks_per_sm) {
  const int max_lanes = max_tile_lanes(d);
  const auto query = [&](auto kernel, CoordTerm t) {
    const size_t shared = shared_bytes(max_lanes, t, d);
    const cudaError_t err = allow_shared_bytes(kernel, shared);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads,
                                                              shared);
  };
  if (term == kToyQuadratic) return query(banded_slice_kernel<kToyQuadratic>, kToyQuadratic);
  return query(banded_slice_kernel<kVariationalQuadratic>, kVariationalQuadratic);
}
'''


def k1_copy(name, min_blocks=None):
    """Kernel K1 alone, built from a copy of ``csrc`` under the build
    directory with :data:`K1_OCCUPANCY` appended to ``banded_slice.cu`` and,
    given ``min_blocks``, the kernel held to that many blocks an SM."""
    src = _build.BUILD_DIR / f"k1_{name}"
    src.mkdir(parents=True, exist_ok=True)
    for header in _build.HEADERS:
        shutil.copy(_build.CSRC / header, src / header)
    text = (_build.CSRC / "banded_slice.cu").read_text()
    if min_blocks is not None:
        bounds = "__launch_bounds__(kThreads)"
        if text.count(bounds) != 1:
            raise RuntimeError(f"banded_slice.cu: expected one {bounds}")
        text = text.replace(bounds, f"__launch_bounds__(kThreads, {min_blocks})")
    (src / "banded_slice.cu").write_text(text + K1_OCCUPANCY)
    return load(verbose=True, csrc=src, sources=("banded_slice.cu",))


def variational_main(args, parents):
    """``--variational``: the two rows under a variational reference."""
    results = {}
    k2_src = ("sweep_slice.cu",)
    k2 = load(verbose=True, sources=k2_src)
    clocks = load(("PIGEONS_K2_CLOCKS",), sources=k2_src)
    for B in (2 * chip_smoke.VF_CHAINS * chip_smoke.VF_REPLICATES,
              2 * chip_smoke.F_CHAINS * chip_smoke.F_REPLICATES):
        path, (x, betas, seeds), var = two_leg_funnel(B)
        want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=chip_smoke.F_PASSES,
                                          **var)
        iterations = want[2][2]
        variants = {f"this tree, group {g}": k2_call(k2, x, betas, seeds, path, False, g, True, var)
                    for g in GROUPS}
        variants["this tree, launcher's choice"] = k2_call(k2, x, betas, seeds, path, False, 0,
                                                           True, var)
        for name, parent in parents.items():
            variants[name] = k2_call(parent, x, betas, seeds, path, False, 0, True, var)
        title = f"K2 funnel under the variational reference, B={B} d=10 1 pass"
        got = variants[next(iter(variants))]()
        for t, w in zip(got, want):
            if not torch.equal(t.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{title}: this tree differs from the twin")
        results[title] = race(title, variants)
        fixed = path.fixed
        plain = {name: k2_call(lib, x, betas, seeds, fixed, False, 0, True)
                 for name, lib in (("this tree", k2), *parents.items())}
        results[f"K2 plain funnel on the same inputs, B={B}"] = race(
            f"K2 plain funnel on the same inputs, B={B}", plain)
        print(f"-- clock64 split, B={B}, the launcher's group; twin's iterations: slowest lane "
              f"{int(iterations.max())}, mean {float(iterations.mean()):.1f}", flush=True)
        call = k2_call(clocks, x, betas, seeds, path, False, 0, True, var)
        results[f"clock split, B={B}"] = clock_split(clocks, call, iterations, device_ms(call))
    results["K2 SASS"] = sass_lengths(k2.path)

    k1 = {"this tree": k1_copy("this_tree"), "5 blocks an SM": k1_copy("5_blocks", 5)}
    occupancy = {}
    for name, lib in k1.items():
        for term in (0, 1):
            blocks = ctypes.c_int(0)
            lib.banded_slice_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            err = lib.banded_slice_occupancy(term, chip_smoke.D, ctypes.byref(blocks))
            occupancy[f"{name}, {('toy', 'variational')[term]} term"] = blocks.value
            print(f"K1 {name}, {('toy', 'variational')[term]} term: {blocks.value} blocks of 256 "
                  f"an SM (error {err})")
    results["K1 resident blocks"] = occupancy
    results["K1 SASS"] = sass_lengths(k1["this tree"].path, "k1_sass.txt")
    for B in (2 * chip_smoke.V_CHAINS * chip_smoke.V_REPLICATES,
              chip_smoke.N_CHAINS * chip_smoke.N_REPLICATES):
        x, a, seeds, term = k1_variational_inputs(B, chip_smoke.D)
        want = cuda_slice.banded_sweep_reference(x, a, seeds, variational=term)
        variational = {name: k1_call(lib, x, a, seeds, 3, term) for name, lib in k1.items()}
        toy = {name: k1_call(lib, x, a, seeds, 3) for name, lib in k1.items()}
        for name, parent in parents.items():
            variational[name] = k1_call(parent, x, a, seeds, 3, term)
            toy[name] = k1_call(parent, x, a, seeds, 3)
        got = variational["this tree"]()
        for t, w in zip(got, want):
            if not torch.equal(t.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"K1 variational term, B={B}: differs from the twin")
        results[f"K1 variational term, B={B} d=100 3 passes"] = race(
            f"K1 variational term, B={B}", variational)
        results[f"K1 toy term on the same inputs, B={B}"] = race(f"K1 toy term, B={B}", toy)
        if B == 2 * chip_smoke.V_CHAINS * chip_smoke.V_REPLICATES:
            results["K1 iterations, toy term"] = k1_iterations(x, a, seeds)
            results["K1 iterations, variational term"] = k1_iterations(x, a, seeds, term)
    return results


def speculated_rows():
    """K2's rows whose groups speculate the machine's next queries, by key:
    ``(title, path, coord_deltas, n_passes, groups, [(B, inputs), ...])``,
    the path's batch first (the one of the clock splits)."""
    dev = torch.device("cuda")
    small = chip_smoke.S_CHAINS * chip_smoke.S_REPLICATES
    rows = {}
    for key, name, make, other in (("eight_schools", "eight schools", eight_schools, 8192),
                                   ("unid", "unid", unid_target, 8192),
                                   ("bernoulli", "Bernoulli", bernoulli_target,
                                    chip_smoke.I_SAMPLES)):
        model = make().to(dev)
        batches = [(B, lambda B=B, d=model.dim: chip_smoke.lane_inputs(B, d, 1.0, 11))
                   for B in (small, other)]
        rows[key] = (f"K2 full, {name} d={model.dim} 1 pass",
                     model.create_path(model.default_reference()), False, chip_smoke.F_PASSES,
                     GROUPS, batches)
    rows["delta"] = (f"K2 delta, toy MVN d={chip_smoke.D} {chip_smoke.I_DELTA_PASSES} passes",
                     toy_mvn_path(chip_smoke.D), True, chip_smoke.I_DELTA_PASSES,
                     (1,), [(chip_smoke.I_SAMPLES, chip_smoke.delta_inputs)])
    return rows


def delta_slots_csrc(slots):
    """A copy of ``csrc`` under the build directory whose delta machine takes
    ``slots`` iterations a round."""
    out = _build.BUILD_DIR / f"csrc-delta-slots-{slots}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    src = out / "sweep_slice.cu"
    text = src.read_text()
    line = "constexpr int kDeltaSlots = 2;"
    if text.count(line) != 1:
        raise RuntimeError(f"sweep_slice.cu: no line {line!r}")
    src.write_text(text.replace(line, f"constexpr int kDeltaSlots = {slots};"))
    return out


def speculate_main(args, parents):
    """``--speculate``: K2's rows whose groups speculate the machine's next
    queries (``--rows``, all by default), against the parent. With
    ``--splits-only`` only each row's bits against the twin at every group
    and the parents' clock splits."""
    results = {}
    src = ("sweep_slice.cu",)
    builds = {"this tree": ((), _build.CSRC), "this tree, clocks": (("PIGEONS_K2_CLOCKS",),
                                                                    _build.CSRC)}
    builds.update({f"{name}, clocks": (("PIGEONS_K2_CLOCKS",), csrc.resolve())
                   for name, csrc in zip(parents, args.parent_csrc)})
    rows = args.rows.split(",")
    if "delta" in rows:  # the delta machine of one thread with other numbers of slots
        builds.update({f"{s} slots": ((), delta_slots_csrc(int(s)))
                       for s in filter(None, args.delta_slots.split(","))})
    with ThreadPoolExecutor(len(builds)) as pool:  # every build at once, one nvcc each
        futures = {name: pool.submit(load, defines, csrc, name == "this tree", src)
                   for name, (defines, csrc) in builds.items()}
        libs = {name: f.result() for name, f in futures.items()}
    slot_libs = {name: lib for name, lib in libs.items() if name.endswith(" slots")}
    table = speculated_rows()
    for key in rows:
        row_title, path, deltas, n_passes, groups, batches = table[key]
        for i, (B, make_inputs) in enumerate(batches):
            x, betas, seeds = make_inputs()
            counts = torch.zeros(6, dtype=torch.int64, device=x.device)
            want = cuda_slice.sweep_reference(x, betas, seeds, path, deltas, n_passes=n_passes,
                                              phase_counts=counts)
            iterations = want[2][2]
            title = f"{row_title}, B={B}"
            print(f"-- {title}: twin's iterations: slowest lane {int(iterations.max())}, mean "
                  f"{float(iterations.double().mean()):.1f}; phases {counts.tolist()}", flush=True)

            def call(lib, group):
                return k2_call(lib, x, betas, seeds, path, deltas, group, True, n_passes=n_passes)

            variants = {f"group {g}": call(libs["this tree"], g) for g in groups}
            variants["launcher's choice"] = call(libs["this tree"], 0)
            if deltas:
                variants.update({f"group 1, {name}": call(lib, 1)
                                 for name, lib in slot_libs.items()})
            for name, variant in variants.items():
                for t, w in zip(variant(), want):
                    if not torch.equal(t.view(torch.int32), w.view(torch.int32)):
                        raise AssertionError(f"{title}: this tree's {name} differs from the twin")
            print(f"-- {title}: every group and the launcher's choice bitwise the twin")
            if not args.splits_only:
                for pname, parent in parents.items():
                    variants[pname] = call(parent, 0)
                results[title] = race(title, variants)
            if i:
                continue
            splits = [(f"{pname}, the launcher's group", libs[f"{pname}, clocks"], 0)
                      for pname in parents]
            if not args.splits_only:
                splits += [(f"this tree, group {g}", libs["this tree, clocks"], g)
                           for g in groups if g > 1 or deltas]
            for label, lib, group in splits:
                c = call(lib, group)
                print(f"-- clock64 split, {title}, {label}", flush=True)
                results[f"clock split, {title}, {label}"] = clock_split(
                    lib, c, iterations, device_ms(c),
                    names=DELTA_CLOCK_PARTS if deltas and label.startswith("this tree")
                    else CLOCK_PARTS)
    if not args.splits_only:
        results["K2 SASS"] = sass_lengths(libs["this tree"].path)
    return results


USER_GROUPS = (1, 8, 16, 32)


def user_rows(dev):
    """K2's user rows: ``(title, model, batches)``, the path's batch first
    (chip_smoke.py phase 12's)."""
    small, large = (chip_smoke.S_CHAINS * chip_smoke.S_REPLICATES,
                    chip_smoke.H_CHAINS * chip_smoke.H_REPLICATES)
    return [("hierarchical normal's likelihood as a source", SE.hierarchical_normal_source().to(dev),
             (large, small)),
            ("model U", SE.model_u().to(dev), (small, large)),
            ("CustomPath", SE.custom_path_source(chip_smoke.U_CUSTOM_DIM).to(dev), (small, large))]


def smi_clocks():
    """The card's SM clock, power draw and temperature now."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def user_main(args):
    """``--user``: K2's user instance at every group, the launcher's choice
    and the parent's one thread a lane, at 640 and 8,192 lanes, each group's
    device time read ``--user-turns`` times in turns, with every group's
    clock split of each row at 640 lanes and of the hierarchical row at its
    path's 8,192; K1's user term, the toy term and the parent's user term
    alternately on phase 12's inputs, with the card's clocks, and both
    terms' clock splits."""
    dev = torch.device("cuda")
    rows = user_rows(dev)
    coord = SE.normal_product_source(chip_smoke.D).to(dev)
    k2_sources = {title: model.create_path(model.default_reference()).device_density().source
                  for title, model, _ in rows}
    hierarchical = rows[0][0]
    small = chip_smoke.S_CHAINS * chip_smoke.S_REPLICATES
    builds = {f"{title}, this tree": (src, (), _build.CSRC) for title, src in k2_sources.items()}
    builds.update({f"{title}, parent": (src, (), csrc.resolve())
                   for title, src in k2_sources.items() for csrc in args.parent_csrc[:1]})
    # model U's text is the hierarchical row's: one library serves both
    builds.update({f"{title}, clocks": (src, ("PIGEONS_K2_CLOCKS",), _build.CSRC)
                   for title, src in k2_sources.items()})
    builds.update({"K2 clocks, parent": (k2_sources[hierarchical], ("PIGEONS_K2_CLOCKS",),
                                         csrc.resolve()) for csrc in args.parent_csrc[:1]})
    builds["K1 user term, this tree"] = (coord.source, (), _build.CSRC)
    builds["K1 user term clocks, this tree"] = (coord.source, ("PIGEONS_K1_CLOCKS",), _build.CSRC)
    builds.update({"K1 user term, parent": (coord.source, (), csrc.resolve())
                   for csrc in args.parent_csrc[:1]})
    k1_src = ("banded_slice.cu",)
    with ThreadPoolExecutor(len(builds) + 2) as pool:  # every build at once
        futures = {name: pool.submit(_build.build_user, src, True, defines, csrc)
                   for name, (src, defines, csrc) in builds.items()}
        toy = pool.submit(load, (), _build.CSRC, False, k1_src)
        toy_clocks = pool.submit(load, ("PIGEONS_K1_CLOCKS",), _build.CSRC, False, k1_src)
        paths = {name: f.result()[0] for name, f in futures.items()}
        libs = {name: _build.open_user(paths[name], _build.USER_KERNELS[src.hook])
                for name, (src, _, _) in builds.items()}
        libs["toy term"], libs["toy term clocks"] = toy.result(), toy_clocks.result()
    for name, f in futures.items():
        print(f"built {name}: {f.result()[1]:.2f} s, {paths[name].name}")
    results = {}
    for title, model, batches in rows:
        path = model.create_path(model.default_reference())
        this, parent = libs[f"{title}, this tree"], libs.get(f"{title}, parent")
        for i, B in enumerate(batches):
            x, betas, seeds = chip_smoke.lane_inputs(B, model.dim, 1.0, 11)
            counts = torch.zeros(6, dtype=torch.int64, device=dev)
            want = cuda_slice.sweep_reference(x, betas, seeds, path, n_passes=1,
                                              phase_counts=counts)
            iterations = want[2][2]
            name = f"K2 user, {title}, B={B} d={model.dim} 1 pass"
            print(f"-- {name}: twin's iterations: slowest lane {int(iterations.max())}, mean "
                  f"{float(iterations.double().mean()):.1f}; phases {counts.tolist()}; the "
                  f"launcher's group {cuda_slice.launcher_group(path, B, model.dim, this)}",
                  flush=True)

            def call(lib, group):
                return lambda: cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1,
                                                     group=group, lib=lib)

            variants = {f"group {g}": call(this, g) for g in USER_GROUPS}
            variants["launcher's choice"] = call(this, 0)
            # the explorer's wrapper, and the same with a per-call look-up of
            # the keyed library, as the wrapper made it before it kept it
            variants["the wrapper"] = lambda: cuda_slice.sweep_cuda(x, betas, seeds, path,
                                                                     n_passes=1)
            variants["the wrapper, with a per-call look-up"] = lambda: (
                _build.build_user(k2_sources[title]),
                cuda_slice.sweep_cuda(x, betas, seeds, path, n_passes=1))[1]
            if parent is not None:
                variants["parent"] = call(parent, 0)
            for vname, variant in variants.items():
                for t, w in zip(variant(), want):
                    if not torch.equal(t.view(torch.int32), w.view(torch.int32)):
                        raise AssertionError(f"{name}: {vname} differs from the twin")
            print(f"-- {name}: every variant bitwise the twin", flush=True)
            results[name] = race(name, variants)
            turns = {g: [] for g in USER_GROUPS}
            for r in range(args.user_turns):
                for g in (USER_GROUPS if r % 2 == 0 else USER_GROUPS[::-1]):
                    turns[g].append(device_ms(variants[f"group {g}"]))
            print(f"-- {name}: device ms by group, {args.user_turns} turns: "
                  + "; ".join(f"{g}: " + " / ".join(f"{t:.4f}" for t in ts)
                              for g, ts in turns.items()), flush=True)
            results[f"{name}, device ms by group in turns"] = turns
            if B != small and title != hierarchical:
                continue
            splits = [(f"this tree, group {g}", libs[f"{title}, clocks"], g)
                      for g in USER_GROUPS]
            if "K2 clocks, parent" in libs and title == hierarchical and i == 0:
                splits.insert(0, ("parent", libs["K2 clocks, parent"], 0))
            for label, lib, group in splits:
                c = call(lib, group)
                print(f"-- clock64 split, {name}, {label}", flush=True)
                results[f"clock split, {name}, {label}"] = clock_split(lib, c, iterations,
                                                                       device_ms(c))

    B, D = chip_smoke.N_CHAINS * chip_smoke.N_REPLICATES, chip_smoke.D
    x, betas, seeds = chip_smoke.lane_inputs(B, D, 2.0, 11)
    term = cuda_slice.UserTerm(betas, coord.create_path(coord.default_reference()).coord_source)
    want = cuda_slice.banded_sweep_reference(x, betas, seeds, user=term)
    a = toy_mvn_path(D).coord_factor(betas)
    terms = {"user term, this tree": lambda: cuda_slice.banded_sweep_user_cuda(
                 x, seeds, term, lib=libs["K1 user term, this tree"]),
             "toy term": k1_call(libs["toy term"], x, a, seeds, 3),
             "user term, the wrapper": lambda: cuda_slice.banded_sweep_user_cuda(x, seeds, term),
             "user term, the wrapper with a per-call look-up": lambda: (
                 _build.build_user(coord.source),
                 cuda_slice.banded_sweep_user_cuda(x, seeds, term))[1]}
    if "K1 user term, parent" in libs:
        terms["user term, parent"] = lambda: cuda_slice.banded_sweep_user_cuda(
            x, seeds, term, lib=libs["K1 user term, parent"])
    for tname, fn in terms.items():
        if tname.startswith("user"):
            for t, w in zip(fn(), want):
                if not torch.equal(t.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"K1 {tname} differs from the twin")
    print(f"-- K1's terms alternately, B={B}, d={D}, 3 passes (the user terms bitwise the twin); "
          "each turn the median of 20, then the card's SM clock, power and temperature",
          flush=True)
    turns = {tname: [] for tname in terms}
    for r in range(args.k1_turns):
        for tname in (list(terms) if r % 2 == 0 else list(terms)[::-1]):
            ms = chip_smoke.cuda_ms(terms[tname], 20)
            turns[tname].append((ms, smi_clocks()))
            print(f"   turn {r}: {tname:>22} {ms:.4f} ms; {turns[tname][-1][1]}", flush=True)
    for tname, ts in turns.items():
        ms = [t for t, _ in ts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):  # the host's time a call: the launches queue up
            terms[tname]()
        host_ms = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        dev = [device_ms(terms[tname]) for _ in range(3)]
        print(f"{tname:>44}: median {np.median(ms):.4f} ms, min {min(ms):.4f}, max "
              f"{max(ms):.4f}; device {' / '.join(f'{t:.4f}' for t in dev)} ms; host "
              f"{host_ms:.4f} ms a call", flush=True)
        results[f"K1 {tname}, device ms, host ms a call"] = (dev, host_ms)
    results[f"K1 terms alternately, B={B}"] = {k: v for k, v in turns.items()}
    for label, fn in (("K1 user term", lambda: cuda_slice.banded_sweep_user_cuda(
                          x, seeds, term, lib=libs["K1 user term clocks, this tree"])),
                      ("K1 toy term", k1_call(libs["toy term clocks"], x, a, seeds, 3))):
        lib = libs["K1 user term clocks, this tree" if label == "K1 user term" else
                   "toy term clocks"]
        split = chip_smoke.k1_clock_split(lib, fn)
        chip_smoke.print_k1_clock_split(label, split)
        results[f"clock split, {label}"] = split
    for name in ("K1 user term, this tree", "K1 user term, parent",
                 f"{rows[0][0]}, this tree", f"{rows[0][0]}, parent"):
        if name in paths:
            print(f"-- SASS of {name}")
            results[f"SASS, {name}"] = sass_lengths(paths[name])
            results[f"registers, {name}"] = resource_usage(paths[name])
    return results


def resource_usage(lib_path):
    """Registers, stack and shared memory of each kernel instance, as
    ``cuobjdump -res-usage`` prints them (a function's line, then its
    resources)."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-res-usage", str(lib_path)], capture_output=True, text=True)
    lines = [line.strip() for line in res.stdout.splitlines()
             if "Function" in line or "REG:" in line]
    for line in lines:
        print(f"   {line}")
    return lines


def k1_variational_inputs(B, d):
    """``chip_smoke.py`` phase 2c's inputs at ``B`` lanes."""
    x, betas, seeds = chip_smoke.lane_inputs(B, d, 0.5, 13)
    dev = x.device
    path = toy_mvn_path(d)
    rs = np.random.RandomState(4)
    half = chip_smoke.V_CHAINS
    term = cuda_slice.VariationalTerm(
        betas, ((torch.arange(B, device=dev) % (2 * half)) < half).float(),
        torch.ones(1, device=dev), float(path.coord_factor(torch.ones(()))),
        torch.tensor((rs.normal(size=d) * 0.05).astype(np.float32), device=dev),
        torch.tensor((np.sqrt(0.1) * np.exp(rs.normal(size=d) * 0.2)).astype(np.float32),
                     device=dev))
    return x, path.coord_factor(betas), seeds, term


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k2-only", action="store_true")
    ap.add_argument("--variational", action="store_true")
    ap.add_argument("--speculate", action="store_true")
    ap.add_argument("--user", action="store_true")
    ap.add_argument("--k1-turns", type=int, default=6)
    ap.add_argument("--user-turns", type=int, default=4)
    ap.add_argument("--rows", default="eight_schools,unid,bernoulli,delta")
    ap.add_argument("--splits-only", action="store_true")
    ap.add_argument("--delta-slots", default="")
    ap.add_argument("--parent-csrc", type=Path, action="append", default=[])
    ap.add_argument("--parent-abi", type=int, default=3, choices=(1, 3, 4, 5))
    args = ap.parse_args()
    chip_smoke.device_phase()
    if args.user:
        write_results(user_main(args), None, "kernel_variants_user.json")
        return
    if args.variational or args.speculate:
        parents = {("parent" if i == 0 else f"parent {i + 1}"): load(csrc=csrc.resolve())
                   for i, csrc in enumerate(args.parent_csrc)}
        if args.speculate:
            write_results(speculate_main(args, parents), None, "kernel_variants_speculate.json")
        else:
            write_results(variational_main(args, parents), None,
                          "kernel_variants_variational.json")
        return

    default = load(verbose=True)
    k1_libs = {} if args.k2_only else {
        v: load(defines=(f"PIGEONS_K1_CHUNK={v[0]}", f"PIGEONS_K1_REFILL={v[1]}"))
        for v in K1_VARIANTS}
    parents = {("parent" if i == 0 else f"parent {i + 1}"): load(csrc=csrc.resolve())
               for i, csrc in enumerate(args.parent_csrc)}
    parent_group = None if args.parent_abi < 3 else 0  # the launcher's choice, where it has one
    results = {}

    B, D = chip_smoke.N_CHAINS * chip_smoke.N_REPLICATES, chip_smoke.D
    x, betas, seeds = chip_smoke.lane_inputs(B, D, 1.0, 11)
    toy = toy_mvn_path(D)
    a = toy.coord_factor(betas)
    iterations = None
    if not args.k2_only:
        k1 = {f"tile {c}, refill at {r}": k1_call(lib, x, a, seeds, 3)
              for (c, r), lib in k1_libs.items()}
        k1["default build"] = k1_call(default, x, a, seeds, 3)
        for name, parent in parents.items():
            k1[name] = k1_call(parent, x, a, seeds, 3, first_version=args.parent_abi < 4)
        results["K1 banded, B=20480 d=100 3 passes"] = race("K1", k1)
        iterations = k1_iterations(x, a, seeds)
        for many in (2 * chip_smoke.V_CHAINS * chip_smoke.V_REPLICATES, B):
            results[f"K1 terms, B={many} d=100 3 passes"] = race_terms(default, many, D)

    def k2_variants(xs, bs, sds, path, groups=GROUPS):
        out = {f"group {g}": k2_call(default, xs, bs, sds, path, False, g, arrays=True)
               for g in groups}
        out["launcher's choice"] = k2_call(default, xs, bs, sds, path, False, 0, arrays=True)
        # K2 takes BayesianModel densities from the fifth version of the sources on
        if args.parent_abi >= 5 or not path.device_density().prior:
            for name, parent in parents.items():
                out[name] = k2_call(parent, xs, bs, sds, path, False, parent_group,
                                    arrays=args.parent_abi >= 5)
        return out

    target = funnel(chip_smoke.F_NX)
    fpath = target.create_path(target.default_reference())
    fx, fb, fs = chip_smoke.lane_inputs(chip_smoke.F_CHAINS * chip_smoke.F_REPLICATES,
                                        chip_smoke.F_NX + 1, 2.0, 11)
    results["K2 full, funnel B=3072 d=10 1 pass"] = race("K2 full, funnel",
                                                         k2_variants(fx, fb, fs, fpath))
    for many in (8192, 20480):
        mx, mb, ms = chip_smoke.lane_inputs(many, chip_smoke.F_NX + 1, 2.0, 11)
        results[f"K2 full, funnel B={many} d=10 1 pass"] = race(f"K2 full, funnel, B={many}",
                                                               k2_variants(mx, mb, ms, fpath))
    results["K2 full, toy MVN B=20480 d=100 1 pass"] = race("K2 full, toy MVN",
                                                            k2_variants(x, betas, seeds, toy))
    small, large = (chip_smoke.S_CHAINS * chip_smoke.S_REPLICATES,
                    chip_smoke.H_CHAINS * chip_smoke.H_REPLICATES)
    for name, make in (("hierarchical normal", hierarchical_normal),
                       ("eight schools", eight_schools), ("unid", unid_target),
                       ("logistic regression", logistic_regression), ("mRNA", mrna_target),
                       ("centred eight schools", lambda: eight_schools(centered=True)),
                       ("Bernoulli", bernoulli_target)):
        model = make().to(x.device)
        mpath = model.create_path(model.default_reference())
        # each at its path's batch; the first four also at the other
        sizes = {"mRNA": [large], "centred eight schools": [small],
                 "Bernoulli": [small]}.get(name, [small, large])
        if name == "logistic regression":  # its path's batch
            sizes.append(chip_smoke.LR_CHAINS * chip_smoke.LR_REPLICATES)
        for many in sizes:
            mx, mb, ms = chip_smoke.lane_inputs(many, model.dim, 1.0, 11)
            title = f"K2 full, {name} B={many} d={model.dim} 1 pass"
            results[title] = race(title, k2_variants(mx, mb, ms, mpath))
    delta = {"this tree": k2_call(default, x, betas, seeds, toy, True, 0, arrays=True)}
    for name, parent in parents.items():
        delta[name] = k2_call(parent, x, betas, seeds, toy, True, parent_group,
                              arrays=args.parent_abi >= 5)
    results["K2 delta, toy MVN B=20480 d=100 1 pass"] = race("K2 delta, toy MVN", delta)

    write_results(results, iterations, "kernel_variants.json")


def write_results(results, iterations, name):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / name, "w") as f:
        json.dump({"card": smi, "turn_medians_ms": results, "k1_iterations": iterations}, f,
                  indent=1)


if __name__ == "__main__":
    main()
