"""Where the port's 16-ladder mRNA run leaves the JAX package's run, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_mrna_divergence.py [--ladders 16] [--rounds 6]

Runs ``mrna_target()`` with 32 chains x 16 ladders, seed 1, one slice pass a
scan, rounds of 2, 4, ..., 64 scans (``chip_smoke.py``'s ``M_JAX_ROUNDS``
run) in both packages on the CPU, round by round, both recording every
chain's state and density after each scan's exploration (``extended_traces``)
and the chain of each replica before each swap (``index_process``). After
each round it prints the round's pooled means, barrier and logZ beside each
other and the first scan, chain and coordinate at which the two runs'
records differ in their bits, and where they part: the explored states, the
densities of the runtime's pass, or the swaps.

The JAX package runs ``SliceSamplerPallas(interpret=True)`` as its own tests
run it. The port runs ``SliceSamplerCUDA`` on the CPU, with kernel K2's
source compiled for the host (``g++`` against ``tests/cuda_stub``, one
thread a lane) in place of the torch twin: the two are bit for bit the same
(``tests/test_torch_csrc_host_bayesian.py``), and the host build takes
seconds a scan where the twin takes minutes. Everything else is the port's
CPU run. Needs JAX and ``g++``; about 5 minutes.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests" / "cuda_stub"))

ROUNDS = (2, 4, 8, 16, 32, 64)
NAMES = ("lt0", "lkm0", "lbeta", "ldelta", "lsigma")


def host_sweep(lib_path):
    """``cuda_slice.sweep_reference``'s contract, answered by the host build
    of kernel K2 with one thread a lane."""
    import host_call
    from pigeons_tpu_torch.ops import cuda_slice

    class Queue:
        def put(self, value):
            self.value = value

    def sweep(x, betas, seeds, path, coord_deltas=False, w=10.0, p=20, n_passes=3,
              max_iter=1024, isvar=None, ref_params=None, **_):
        density = path.device_density()
        out = Queue()
        host_call.slice_sweep(lib_path, x.numpy(), betas.numpy(), seeds.numpy(), density.kind,
                              density.params, coord_deltas, w, p, n_passes, max_iter, 1, out,
                              arrays=tuple(a.numpy() for a in density.arrays),
                              prior=density.prior)
        err, *arrays = out.value
        if err:
            raise RuntimeError(f"host build of slice_sweep: error {err}")
        return tuple(torch.from_numpy(a) for a in arrays)

    cuda_slice.sweep_reference = sweep


def build_host_library(out_dir):
    gxx = shutil.which("g++")
    if gxx is None:
        raise SystemExit("needs g++ to compile kernel K2 for the host")
    lib = Path(out_dir) / "sweep_slice.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-pthread",
                    "-shared", "-fPIC", "-I", str(ROOT / "tests" / "cuda_stub"), "-o", str(lib),
                    str(ROOT / "pigeons_tpu_torch" / "csrc" / "sweep_slice.cu")], check=True)
    return lib


def record(pt, states, chain_of, replica_of):
    """One round's arrays of either package, as numpy, in the port's layout."""
    R, n = np.asarray(chain_of).reshape(-1, pt.n_chains).shape
    ext = np.asarray(pt.extended_traces)
    idx = np.asarray(pt.index_process)
    return {"states": np.asarray(states).reshape(R * n, -1),
            "chain_of": np.asarray(chain_of).reshape(R, n),
            "replica_of": np.asarray(replica_of).reshape(R, n),
            "extended": ext.reshape(ext.shape[0], R, n, -1) if ext.shape[0] != R or R == 1
            else np.swapaxes(ext, 0, 1).reshape(-1, R, n, ext.shape[-1]),
            "index": idx.reshape(idx.shape[0], R, n) if idx.shape[0] != R or R == 1
            else np.swapaxes(idx, 0, 1).reshape(-1, R, n)}


def summary(pt, target):
    q = target.constrained_samples(pt)
    out = {k: float(np.mean(q[k])) for k in NAMES}
    out.update(barrier=float(pt.global_barrier), logZ=float(pt.reports[-1].log_z_estimate))
    return out


def first_difference(j, t, d):
    """Print where the round's records first differ; True if they do."""
    ej, et = j["extended"], t["extended"]
    ij, it = j["index"], t["index"]
    n_scans = ej.shape[0]
    for s in range(n_scans):
        ix = np.nonzero(ij[s] != it[s])
        xs = np.nonzero(ej[s, ..., :d].view(np.int32) != et[s, ..., :d].view(np.int32))
        lp = np.nonzero(ej[s, ..., d].view(np.int32) != et[s, ..., d].view(np.int32))
        if len(ix[0]) or len(xs[0]) or len(lp[0]):
            print(f"  first differing scan {s + 1} of {n_scans}: {len(xs[0])} state elements, "
                  f"{len(lp[0])} densities (of {ej[s, ..., d].size}) and {len(ix[0])} chains "
                  f"before the swap differ")
            if len(ix[0]):
                r, c = ix[0][0], ix[1][0]
                print(f"  the swap: ladder {r}, replica {c} at chain {ij[s, r, c]} (JAX) / "
                      f"{it[s, r, c]} (port)")
            for kind, where in (("state", xs), ("density", lp)):
                for k in range(min(4, len(where[0]))):
                    r, c = where[0][k], where[1][k]
                    col = where[2][k] if kind == "state" else d
                    a, b = ej[s, r, c, col], et[s, r, c, col]
                    print(f"  {kind}: ladder {r}, chain {c}, column {col}: JAX {a!r} port {b!r} "
                          f"({abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))} ulp)")
            return True
    return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ladders", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=len(ROUNDS))
    args = ap.parse_args()
    import pigeons_tpu as J
    import pigeons_tpu_torch as T
    from pigeons_tpu.inputs import RECORD_DEFAULT

    torch.set_num_threads(4)
    tmp = tempfile.mkdtemp(prefix="mrna_divergence_")
    host_sweep(build_host_library(tmp))
    kw = dict(n_chains=32, n_replicates=args.ladders, seed=1, show_report=False,
              extended_traces=True, record=RECORD_DEFAULT + ("index_process",))
    jt, tt = J.mrna_target(), T.mrna_target()
    ja = J.PT(J.Inputs(target=jt, explorer=J.SliceSamplerPallas(interpret=True, n_passes=1), **kw))
    ta = T.PT(T.Inputs(target=tt, explorer=T.SliceSamplerCUDA(n_passes=1), device="cpu", **kw))
    d = ta.dim
    same0 = np.array_equal(np.asarray(ja.states).reshape(-1, d), ta.states.numpy().reshape(-1, d))
    print(f"mrna_target, 32 chains x {args.ladders} ladders, seed 1; initial states bitwise "
          f"equal: {same0}", flush=True)
    parted = False
    for r, n_scans in enumerate(ROUNDS[:args.rounds], start=1):
        t0 = time.perf_counter()
        ja.run_round(n_scans=n_scans)
        t1 = time.perf_counter()
        ta.run_round(n_scans=n_scans)
        t2 = time.perf_counter()
        sj, st = summary(ja, jt), summary(ta, tt)
        rel = {k: abs(st[k] - sj[k]) / abs(sj[k]) for k in sj}
        print(f"round {r} ({n_scans} scans; JAX {t1 - t0:.1f} s, port {t2 - t1:.1f} s): "
              + ", ".join(f"{k} {sj[k]:.6f} / {st[k]:.6f} (rel {rel[k]:.2e})" for k in sj),
              flush=True)
        j = record(ja, ja.states, ja.chain_of, ja.replica_of)
        t = record(ta, ta.states, ta.chain_of, ta.replica_of)
        n_state = int((j["states"].view(np.int32) != t["states"].view(np.int32)).sum())
        print(f"  after the round: {n_state} of {j['states'].size} state elements differ, "
              f"chain_of equal {np.array_equal(j['chain_of'], t['chain_of'])}, schedules within "
              f"{np.abs(np.asarray(ja.schedule.grids) - ta.schedule.grids).max():.3g}", flush=True)
        if not parted and first_difference(j, t, d):
            parted = True
            np.savez(Path(tmp) / f"round{r}.npz", **{f"jax_{k}": v for k, v in j.items()},
                     **{f"port_{k}": v for k, v in t.items()})
            print(f"  both runs' records in {tmp}/round{r}.npz", flush=True)


if __name__ == "__main__":
    main()
