"""Times variants of the port's CUDA kernels side by side on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py [--parent-csrc DIR]

Run from the repository root. Builds ``pigeons_tpu_torch/csrc`` once for each
setting of kernel K1's tile size and refill threshold (``-DPIGEONS_K1_CHUNK=
-DPIGEONS_K1_REFILL=``) and, with ``--parent-csrc``,
an earlier version of the sources from ``DIR`` (for example
``git archive <commit> pigeons_tpu_torch/csrc | tar -x -C <dir>``, then
``<dir>/pigeons_tpu_torch/csrc``), whose entry points must be the first
version's (one thread per element in K1 and per lane in K2, no ``group``
argument). It then times, at the shapes of ``chip_smoke.py``:

* K1 (config 1: B=20,480, d=100, 3 passes) for each such setting and the
  parent, and the spread of iterations per element that K1 has to balance;
* K2 in full mode on the funnel path (d=10, 1 pass; B=3,072, 8,192 and
  20,480) and on the toy MVN path (B=20,480, d=100, 1 pass) for 1, 8, 16 and
  32 threads per lane, the launcher's own choice and the parent;
* K2 in delta mode (toy MVN, B=20,480, d=100, 1 pass) and the parent's.

Every variant's output must equal the first variant's bit for bit (what a
kernel computes does not depend on how its work is mapped to threads). The
variants of one kernel are timed in turns, forwards then backwards, twice
over, each turn the median of 20 CUDA-event timings: compare within a run
only. Prints ``ptxas -v`` for the default build, a table, the card's name and
power limit, and writes ``chiprun_out/kernel_variants.json``.
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
from pigeons_tpu_torch import _build, funnel  # noqa: E402
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
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.banded_slice_sweep.argtypes = [p, p, p, p, p, i, i, f, i, i, i, p]
    return lib


def k1_call(lib, x, a, seeds, n_passes):
    B, d = x.shape

    def call():
        x_out = torch.empty_like(x)
        stats = torch.zeros((3, B), dtype=torch.float32, device=x.device)
        err = lib.banded_slice_sweep(x.data_ptr(), a.data_ptr(), seeds.data_ptr(), x_out.data_ptr(),
                                     stats.data_ptr(), B, d, W, P, n_passes, MAX_ITER,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"banded_slice_sweep: error {err}")
        return x_out, stats

    return call


def k2_call(lib, x, betas, seeds, path, coord_deltas, group):
    """``group=None``: the first version's entry point, which has no such
    argument."""
    B, d = x.shape
    density = path.device_density()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [] if group is None else [group]
    lib.slice_sweep.argtypes = ([p] * 6 + [i] * 4 + [ctypes.POINTER(f), f, i, i, i]
                                + [i] * len(tail) + [p])
    params = (f * cuda_slice.MAX_DENSITY_PARAMS)(*density.params)

    def call():
        x_out = torch.empty_like(x)
        lp = torch.empty(B, dtype=torch.float32, device=x.device)
        stats = torch.empty((3, B), dtype=torch.float32, device=x.device)
        err = lib.slice_sweep(x.data_ptr(), betas.data_ptr(), seeds.data_ptr(), x_out.data_ptr(),
                              lp.data_ptr(), stats.data_ptr(), B, d, density.kind,
                              int(coord_deltas), params, W, P, chip_smoke.F_PASSES, MAX_ITER,
                              *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"slice_sweep: error {err}")
        return x_out, lp, stats

    return call


def race(title, variants):
    """Check that all ``variants`` (name -> call) agree bit for bit, then time
    them in turns. Returns name -> list of the turns' medians in ms."""
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
    print(f"-- {title}: {len(names)} variants bitwise equal")
    for name in names:
        print(f"{name:>36}: median {np.median(times[name]):.4f} ms, turns "
              + " ".join(f"{t:.4f}" for t in times[name]), flush=True)
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
    ap.add_argument("--parent-csrc", type=Path, default=None)
    args = ap.parse_args()
    chip_smoke.device_phase()

    default = load(verbose=True)
    k1_libs = {v: load(defines=(f"PIGEONS_K1_CHUNK={v[0]}", f"PIGEONS_K1_REFILL={v[1]}"))
               for v in K1_VARIANTS}
    parent = load(csrc=args.parent_csrc.resolve()) if args.parent_csrc else None
    results = {}

    B, D = chip_smoke.N_CHAINS * chip_smoke.N_REPLICATES, chip_smoke.D
    x, betas, seeds = chip_smoke.lane_inputs(B, D, 1.0, 11)
    toy = toy_mvn_path(D)
    a = toy.coord_factor(betas)
    k1 = {f"tile {c}, refill at {r}": k1_call(lib, x, a, seeds, 3)
          for (c, r), lib in k1_libs.items()}
    k1["default build"] = k1_call(default, x, a, seeds, 3)
    if parent:
        k1["parent"] = k1_call(parent, x, a, seeds, 3)
    results["K1 banded, B=20480 d=100 3 passes"] = race("K1", k1)
    iterations = k1_iterations(x, a, seeds)

    def k2_variants(xs, bs, sds, path):
        out = {f"group {g}": k2_call(default, xs, bs, sds, path, False, g) for g in GROUPS}
        out["launcher's choice"] = k2_call(default, xs, bs, sds, path, False, 0)
        if parent:
            out["parent"] = k2_call(parent, xs, bs, sds, path, False, None)
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
    delta = {"this tree": k2_call(default, x, betas, seeds, toy, True, 0)}
    if parent:
        delta["parent"] = k2_call(parent, x, betas, seeds, toy, True, None)
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
