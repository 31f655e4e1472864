"""Native targets: models compiled to shared libraries, called through a C
ABI.

Counterpart of ``pigeons_tpu/models/native.py`` (reference BridgeStan
extension, ``ext/PigeonsBridgeStanExt/interface.jl:120-183``). A model is
any shared library exporting the ``ptn_`` C ABI:

.. code-block:: c

    /* required */
    int    ptn_dim(void);
    double ptn_log_density(const double* x, int dim);
    /* optional: enables gradient explorers (AutoMALA by default) */
    double ptn_log_density_gradient(const double* x, int dim, double* grad);
    /* optional: batched fast path, row-major [batch, dim] */
    void   ptn_log_density_batch(const double* x, int batch, int dim,
                                 double* lp_out);

The library is evaluated on the host: the lanes ``[B, dim]`` are copied to
the host once per evaluation, the library is called (its batch entry point,
or a loop), and the float32 densities go back to the lanes' device. A
non-finite density becomes -inf and that lane's gradient 0. The gradient is
a ``torch.autograd.Function`` whose backward is the library's gradient times
the cotangent (the JAX package's ``jax.custom_vjp``), so
:func:`~..paths.value_and_grad` and ``AutoMALA`` differentiate through it.

Only the library path pickles; each process ``dlopen``s the library again on
first use. :func:`example_library` builds the repository's example model
(``examples/native/het_normal.cpp``) with ``g++`` into ``_build/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .target import Reference, StandardNormalReference, Target

_NEG_INF = float("-inf")
_EXAMPLES = Path(__file__).resolve().parents[2] / "examples" / "native"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_C_DBL_P = ctypes.POINTER(ctypes.c_double)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_C_DBL_P)


class _NativeLib:
    """ctypes binding of one ``ptn_`` library (cached per path per process)."""

    _cache: dict = {}

    def __new__(cls, path: str):
        path = os.path.abspath(path)
        if path not in cls._cache:
            self = super().__new__(cls)
            self._init(path)
            cls._cache[path] = self
        return cls._cache[path]

    def _init(self, path: str) -> None:
        self.path = path
        lib = ctypes.CDLL(path)
        lib.ptn_dim.restype = ctypes.c_int
        lib.ptn_dim.argtypes = []
        lib.ptn_log_density.restype = ctypes.c_double
        lib.ptn_log_density.argtypes = [_C_DBL_P, ctypes.c_int]
        self.lib = lib
        self.dim = int(lib.ptn_dim())
        self.has_gradient = hasattr(lib, "ptn_log_density_gradient")
        if self.has_gradient:
            lib.ptn_log_density_gradient.restype = ctypes.c_double
            lib.ptn_log_density_gradient.argtypes = [_C_DBL_P, ctypes.c_int, _C_DBL_P]
        self.has_batch = hasattr(lib, "ptn_log_density_batch")
        if self.has_batch:
            lib.ptn_log_density_batch.restype = None
            lib.ptn_log_density_batch.argtypes = [_C_DBL_P, ctypes.c_int, ctypes.c_int, _C_DBL_P]

    # every entry point maps a non-finite result to -inf, as the reference
    # maps Stan's exceptions (interface.jl:128-141)
    def log_density_batch(self, xb: np.ndarray) -> np.ndarray:
        xb = np.ascontiguousarray(xb, dtype=np.float64)
        b, d = xb.shape
        out = np.empty((b,), np.float64)
        if self.has_batch:
            self.lib.ptn_log_density_batch(_ptr(xb), b, d, _ptr(out))
        else:
            for i in range(b):
                out[i] = self.lib.ptn_log_density(_ptr(xb[i]), d)
        out[~np.isfinite(out)] = _NEG_INF
        return out

    def gradient_batch(self, xb: np.ndarray):
        xb = np.ascontiguousarray(xb, dtype=np.float64)
        b, d = xb.shape
        lps = np.empty((b,), np.float64)
        grads = np.empty((b, d), np.float64)
        for i in range(b):
            lps[i] = self.lib.ptn_log_density_gradient(_ptr(xb[i]), d, _ptr(grads[i]))
        bad = ~np.isfinite(lps)
        lps[bad] = _NEG_INF
        grads[bad] = 0.0
        return lps, grads


def _host_block(x: torch.Tensor, dim: int) -> np.ndarray:
    return x.detach().reshape(-1, dim).cpu().numpy()


class _NativeLogDensity(torch.autograd.Function):
    """The library's density with its gradient (JAX: ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x, lib_path):
        lib = _NativeLib(lib_path)
        lps, grads = lib.gradient_batch(_host_block(x, lib.dim))
        ctx.save_for_backward(torch.from_numpy(grads.astype(np.float32)).reshape(x.shape)
                              .to(x.device))
        return torch.from_numpy(lps.astype(np.float32)).reshape(x.shape[:-1]).to(x.device)

    @staticmethod
    def backward(ctx, g):
        (grads,) = ctx.saved_tensors
        return grads * g[..., None], None


class NativeTarget(Target):
    """Temper a model compiled to a ``ptn_`` ABI shared library."""

    host_evaluated = True  # the density runs on the host

    def __init__(self, lib_path: str, reference: Optional[Reference] = None):
        self._lib_path = os.path.abspath(lib_path)
        self._reference = reference
        self.dim = _NativeLib(self._lib_path).dim

    def log_density(self, x):
        """float32 densities of ``x [..., dim]`` on ``x``'s device: the
        library's batch evaluation, or its gradient entry point where a
        gradient is being recorded."""
        lib = _NativeLib(self._lib_path)
        if lib.has_gradient and torch.is_grad_enabled() and x.requires_grad:
            return _NativeLogDensity.apply(x, self._lib_path)
        out = lib.log_density_batch(_host_block(x, lib.dim)).astype(np.float32)
        return torch.from_numpy(out).reshape(x.shape[:-1]).to(x.device)

    def default_reference(self) -> Reference:
        if self._reference is not None:
            return self._reference
        return StandardNormalReference(self.dim).as_reference()

    def default_explorer(self):
        if _NativeLib(self._lib_path).has_gradient:
            from ..ops import AutoMALA

            return AutoMALA()
        return super().default_explorer()

    def __getstate__(self):
        return {"_lib_path": self._lib_path, "_reference": self._reference}

    def __setstate__(self, state):
        self._lib_path = state["_lib_path"]
        self._reference = state["_reference"]
        self.dim = _NativeLib(self._lib_path).dim


def compile_native_model(source: str, out_path: str, compiler: str = "g++",
                         flags: tuple = ("-O3",)) -> str:
    """Compile a C/C++ ``ptn_`` model source file to a shared library (the
    analogue of BridgeStan's model compilation step). Returns ``out_path``."""
    cmd = [compiler, "-shared", "-fPIC", *flags, source, "-o", out_path, "-lm"]
    subprocess.run(cmd, check=True, capture_output=True)
    return out_path


def build_example(name: str, build, suffix: str = "") -> str:
    """``examples/native/<name>.cpp`` built by ``build(source, out)`` into
    ``_build/<name>-<hash of the source><suffix>`` on first use; returns the
    output's path."""
    src = _EXAMPLES / f"{name}.cpp"
    out = _BUILD / f"{name}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}{suffix}"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        build(str(src), str(tmp))
        os.replace(tmp, out)
    return str(out)


def example_library(name: str = "het_normal") -> str:
    """The repository's example model ``examples/native/<name>.cpp``, built
    with :func:`compile_native_model` (``g++``) on first use."""
    return build_example(name, compile_native_model, ".so")
