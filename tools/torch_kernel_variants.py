"""Times variants of the port's CUDA kernels side by side on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py [--k2-only] [--parent-csrc DIR ... [--parent-abi N]]

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
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from pigeons_tpu_torch import (_build, bernoulli_target, eight_schools, funnel,  # noqa: E402
                               hierarchical_normal, logistic_regression, mrna_target,
                               unid_target)
from pigeons_tpu_torch.ops import cuda_slice  # noqa: E402
from pigeons_tpu_torch.paths import toy_mvn_path  # noqa: E402

# kernel K1's (tile size, free lanes at which a warp refills)
K1_VARIANTS = ((1024, 4), (2048, 4), (4096, 4), (8192, 4), (4096, 1), (4096, 2), (4096, 8))
GROUPS = (1, 8, 16, 32)
W, P, MAX_ITER = 10.0, 20, 1024  # the explorer's defaults


def load(defines=(), csrc=_build.CSRC, verbose=False):
    path, seconds = _build.build(verbose=verbose, defines=defines, csrc=csrc)
    print(f"built {path.name} ({' '.join(defines) or 'defaults'}, {csrc}) in {seconds:.2f} s",
          flush=True)
    return ctypes.CDLL(str(path))


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


def k2_call(lib, x, betas, seeds, path, coord_deltas, group, arrays=False):
    """``group=None``: an entry point of before the ``group`` argument.
    ``arrays``: this tree's entry point, which takes the density's arrays,
    the prior table and the variational reference (none here)."""
    B, d = x.shape
    density = path.device_density()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if arrays:
        inputs = cuda_slice.kernel_inputs(density, B, d, x.device)
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
                              int(coord_deltas), *middle, W, P, chip_smoke.F_PASSES, MAX_ITER,
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


def k1_iterations(x, a, seeds):
    """What kernel K1's mapping of elements to warps has to balance: the
    twin's count of iterations for every element, and the warp-iterations
    they cost with one thread per element (a warp of 32 consecutive elements
    runs as long as its slowest) against lanes that are always full."""
    its = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    cuda_slice.banded_sweep_reference(x, a, seeds, element_iterations=its)
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k2-only", action="store_true")
    ap.add_argument("--parent-csrc", type=Path, action="append", default=[])
    ap.add_argument("--parent-abi", type=int, default=3, choices=(1, 3, 4, 5))
    args = ap.parse_args()
    chip_smoke.device_phase()

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
            # unid has one term: it is built for one thread per lane only
            results[title] = race(title, k2_variants(mx, mb, ms, mpath,
                                                     (1,) if name == "unid" else GROUPS))
    delta = {"this tree": k2_call(default, x, betas, seeds, toy, True, 0, arrays=True)}
    for name, parent in parents.items():
        delta[name] = k2_call(parent, x, betas, seeds, toy, True, parent_group,
                              arrays=args.parent_abi >= 5)
    results["K2 delta, toy MVN B=20480 d=100 1 pass"] = race("K2 delta, toy MVN", delta)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "kernel_variants.json", "w") as f:
        json.dump({"card": smi, "turn_medians_ms": results, "k1_iterations": iterations}, f,
                  indent=1)


if __name__ == "__main__":
    main()
