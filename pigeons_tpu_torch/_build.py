"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, never at import, into ``pigeons_tpu_torch/_build/``: one ``nvcc``
call over all sources, which it compiles in parallel (``--threads``). The
library's name is keyed by a hash of the sources, the shared headers and the
flags, so a changed source or header rebuilds and an unchanged tree is reused.
``build`` also takes preprocessor definitions and another source directory,
for ``tools/torch_kernel_variants.py``, which times variants side by side.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("banded_slice.cu", "sweep_slice.cu")  # kernels K1, K2
HEADERS = ("common.cuh", "densities.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "--threads", str(len(SOURCES)),
)


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(defines: tuple = (), csrc: Path = CSRC, sources: tuple = SOURCES) -> Path:
    h = hashlib.sha256()
    for name in (*sources, *HEADERS):
        h.update((csrc / name).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines, *sources)).encode())
    return BUILD_DIR / f"libpigeons_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, defines: tuple = (), csrc: Path = CSRC,
          sources: tuple = SOURCES) -> tuple[Path, float]:
    """Compile the kernels of ``sources`` in ``csrc`` with ``-D`` for each of
    ``defines``, unless the keyed library exists. Returns its path and the
    seconds spent compiling (0.0 when it was already built). ``verbose``
    prints what ``ptxas -v`` says of each kernel: registers, shared memory,
    spills. A library of fewer sources than ``SOURCES`` lacks the others'
    entry points: ``open_library`` does not take it."""
    out = library_path(defines, csrc, sources)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           *(str(csrc / name) for name in sources)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, end="")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C signatures."""
    return open_library(build()[0])


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the C signatures of its entry points."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # x, a, seeds, x_out, stats, B, d, w, p, n_passes, max_iter, term, then the
    # variational term's beta, isvar, active, mean, std (null for the toy
    # term) and a_target, stream
    lib.banded_slice_sweep.argtypes = [p, p, p, p, p, i, i, f, i, i, i, i, p, p, p, p, p, f, p]
    lib.banded_slice_sweep.restype = i
    # x, betas, seeds, x_out, lp, stats, B, d, density, coord_deltas, then in
    # host memory params, the arrays' device pointers, their lengths and the
    # prior table with its number of rows, then the variational run's isvar,
    # mean, std, active (null otherwise), w, p, n_passes, max_iter, group,
    # stream
    lib.slice_sweep.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.POINTER(f),
                                ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(f), i,
                                p, p, p, p, f, i, i, i, i, p]
    lib.slice_sweep.restype = i
    if hasattr(lib, "slice_sweep_group"):  # B, d, density, params, variational
        lib.slice_sweep_group.argtypes = [i, i, i, ctypes.POINTER(f), i]
        lib.slice_sweep_group.restype = i
    return lib
