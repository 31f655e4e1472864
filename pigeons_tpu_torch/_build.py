"""Build and load the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, never at import, into ``pigeons_tpu_torch/_build/``: ``nvcc``
processes started together, one for ``banded_slice.cu`` and ``K2_PARTS`` for
``sweep_slice.cu``, each compiling the kernel instances of its share of K2's
density kinds (``-DPIGEONS_K2_PART``), then one call that links the objects.
The library's name is keyed by a hash of the sources, the shared headers and
the flags, so a changed source or header rebuilds and an unchanged tree is
reused.
``build`` also takes preprocessor definitions and another source directory,
for ``tools/torch_kernel_variants.py``, which times variants side by side.

A user's density as CUDA source (``device_source.DeviceSource``) has a
library of its own (``build_user``): one ``nvcc`` over ``sweep_slice.cu``
(or ``banded_slice.cu`` for coordinate terms) with the user's text included
(``-DPIGEONS_USER_SOURCE``), which compiles the kernel instances that run it
(K2's at 1, 8, 16 and 32 threads a lane) and none of the library's. It is
keyed by a hash of the text, the hook, the sources, the headers and the
flags, built at first use and loaded with ``open_user``, which declares only
the user entry points.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("banded_slice.cu", "sweep_slice.cu")  # kernels K1, K2
HEADERS = ("common.cuh", "densities.cuh", "user_density.cuh")
BUILD_DIR = _PKG / "_build"
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared")
# the translation units of sweep_slice.cu in the library's build: its kinds'
# seven slots (sweep_slice.cu: PIGEONS_K2_SLOT), one a unit
K2_PARTS = 7


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


def units(defines: tuple = (), csrc: Path = CSRC, sources: tuple = SOURCES) -> list:
    """The translation units of a build: ``(source, extra defines)`` each.
    ``sweep_slice.cu`` is split in ``K2_PARTS`` where its text has the parts
    (an earlier tree's may not) and no clock split is asked for (its clocks
    are one unit's device array)."""
    out = []
    for name in sources:
        if (name == "sweep_slice.cu" and "PIGEONS_K2_CLOCKS" not in defines
                and "PIGEONS_K2_PART" in (csrc / name).read_text()):
            out += [(name, (f"PIGEONS_K2_PARTS={K2_PARTS}", f"PIGEONS_K2_PART={i}"))
                    for i in range(K2_PARTS)]
        else:
            out.append((name, ()))
    return out


def library_path(defines: tuple = (), csrc: Path = CSRC, sources: tuple = SOURCES) -> Path:
    h = hashlib.sha256()
    for name in (*sources, *HEADERS):
        if (csrc / name).exists():  # an earlier tree's csrc/ may lack a header
            h.update((csrc / name).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines, *sources)).encode())
    h.update(repr(units(defines, csrc, sources)).encode())
    return BUILD_DIR / f"libpigeons_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, defines: tuple = (), csrc: Path = CSRC,
          sources: tuple = SOURCES) -> tuple[Path, float]:
    """Compile the kernels of ``sources`` in ``csrc`` with ``-D`` for each of
    ``defines``, unless the keyed library exists: the translation units
    (``units``) in ``nvcc`` processes started together, then their objects
    linked. Returns its path and the seconds spent compiling (0.0 when it was
    already built). ``verbose`` prints what ``ptxas -v`` says of each kernel:
    registers, shared memory, spills. A library of fewer sources than
    ``SOURCES`` lacks the others' entry points: ``open_library`` does not
    take it."""
    out = library_path(defines, csrc, sources)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objects = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.objects")
    objects.mkdir()
    t0 = time.perf_counter()
    try:
        jobs = []
        for k, (name, extra) in enumerate(units(defines, csrc, sources)):
            obj = objects / f"{k}.o"
            cmd = [nvcc(), *COMPILE_FLAGS, "-c", "-o", str(obj),
                   *(f"-D{d}" for d in (*defines, *extra)), str(csrc / name)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        failed = []
        for obj, proc in jobs:
            text = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{' '.join(proc.args)}\n{text}")
            elif verbose:
                print(text, end="")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        _compile(out, [str(obj) for obj, _ in jobs], False,
                 flags=(*COMPILE_FLAGS[:2], "-shared"))  # the architecture
    finally:
        shutil.rmtree(objects, ignore_errors=True)
    return out, time.perf_counter() - t0


def _tmp(path: Path) -> Path:
    """A name beside ``path`` of this process and thread alone."""
    return path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


def _compile(out: Path, args: list, verbose: bool, flags: tuple = NVCC_FLAGS) -> float:
    """One ``nvcc`` call with ``flags`` and ``args`` into ``out``; its
    seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp(out)
    cmd = [nvcc(), *flags, "-o", str(tmp), *args]
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
    return seconds


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


# the kernel a user's hook runs in, and its entry point
USER_KERNELS = {"target": "sweep_slice.cu", "path": "sweep_slice.cu",
                "likelihood": "sweep_slice.cu", "coord": "banded_slice.cu"}
USER_ENTRY = {"sweep_slice.cu": "slice_sweep_user", "banded_slice.cu": "banded_slice_sweep_user"}


def user_library_path(source, defines: tuple = (), csrc: Path = CSRC) -> Path:
    """The keyed library of a ``DeviceSource``: a hash of its text and hook
    (``source.key``), the kernel's source, the headers and the flags."""
    kernel = USER_KERNELS[source.hook]
    h = hashlib.sha256()
    for name in (kernel, *HEADERS):
        h.update((csrc / name).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines, kernel, source.key)).encode())
    return BUILD_DIR / f"libpigeons_user-{h.hexdigest()[:16]}.so"


def build_user(source, verbose: bool = False, defines: tuple = (),
               csrc: Path = CSRC) -> tuple[Path, float]:
    """Compile a ``DeviceSource`` into its library unless it exists: one
    ``nvcc`` over its kernel's source in ``csrc`` with the user's text
    included and ``-D`` for each of ``defines``. Returns the path and the
    seconds spent (0.0 when it was built). A source that does not compile
    raises with ``nvcc``'s output. ``defines`` and ``csrc`` serve the tools
    that build variants (a clock split, an earlier version of the
    sources)."""
    from .device_source import HOOKS

    out = user_library_path(source, defines, csrc)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = out.with_suffix(".cuh")
    if not text.exists():
        tmp = _tmp(text)
        tmp.write_text(source.code)
        os.replace(tmp, text)
    args = [f'-DPIGEONS_USER_SOURCE="{text}"', f"-DPIGEONS_USER_HOOK={HOOKS[source.hook]}",
            *(f"-D{d}" for d in defines), str(csrc / USER_KERNELS[source.hook])]
    return out, _compile(out, args, verbose)


_USER_LIBRARIES: dict = {}  # DeviceSource.key -> its loaded library


def load_user(source) -> ctypes.CDLL:
    """Build a ``DeviceSource``'s library if needed and load it, once a
    process for each text and hook (``source.key``). A launch then looks up
    no file: the keyed name hashes the kernel's source and the headers, some
    0.2-0.3 ms of host time a call, which a launch's CUDA-event time counts
    while the card waits."""
    lib = _USER_LIBRARIES.get(source.key)
    if lib is None:
        path, _ = build_user(source)
        lib = _USER_LIBRARIES[source.key] = open_user(path, USER_KERNELS[source.hook])
    return lib


def open_user(path: Path, kernel: str) -> ctypes.CDLL:
    """Load a user's library and declare its entry points: K2's
    ``slice_sweep_user`` and ``slice_sweep_user_group`` (``kernel``
    ``"sweep_slice.cu"``) or K1's ``banded_slice_sweep_user``. A K2 library
    built from sources that had no groups (an earlier ``csrc``, which
    ``chip_smoke.py --parent-csrc`` times) has no ``slice_sweep_user_group``
    and its ``slice_sweep_user`` takes no group: ``lib.takes_group`` says
    which."""
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if USER_ENTRY[kernel] == "slice_sweep_user":
        lib.takes_group = hasattr(lib, "slice_sweep_user_group")
        # x, betas, seeds, x_out, lp, stats, B, d, then in host memory params,
        # the arrays' device pointers, their lengths and the prior table with
        # its number of rows, then isvar, mean, std, active (null but in a
        # variational run), w, p, n_passes, max_iter, group, stream
        lib.slice_sweep_user.argtypes = ([p, p, p, p, p, p, i, i, ctypes.POINTER(f),
                                          ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(f),
                                          i, p, p, p, p, f, i, i, i] + [i] * lib.takes_group
                                         + [p])
        lib.slice_sweep_user.restype = i
        if lib.takes_group:
            lib.slice_sweep_user_group.argtypes = [i, i, i]  # B, d, variational
            lib.slice_sweep_user_group.restype = i
    else:
        # x, betas, seeds, x_out, stats, B, d, w, p, n_passes, max_iter, then
        # in host memory params, the arrays' device pointers and lengths, stream
        lib.banded_slice_sweep_user.argtypes = [p, p, p, p, p, i, i, f, i, i, i,
                                                ctypes.POINTER(f), ctypes.POINTER(p),
                                                ctypes.POINTER(i), p]
        lib.banded_slice_sweep_user.restype = i
    return lib
