"""Calls into a host build of the port's CUDA sources (``cuda_runtime.h``
beside this file), made in a child process: a kernel whose threads disagree
about a mask deadlocks there as it would on the card, and the parent's time
limit ends it. Imports numpy and ctypes only, so that a child starts fast.
"""

import ctypes

import numpy as np

VP, CI, CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_DENSITY_PARAMS = 8  # csrc/densities.cuh: DensityParams


def _ptr(a):
    return a.ctypes.data_as(VP)


def banded_slice_sweep(lib_path, x, a, seeds, w, p, n_passes, max_iter, out):
    """Kernel K1's entry point on ``x [B, d]`` float32, ``a [B]`` float32 and
    ``seeds [B]`` int64; puts ``(err, x_out, stats)`` on ``out``."""
    lib = ctypes.CDLL(str(lib_path))
    lib.banded_slice_sweep.argtypes = [VP] * 5 + [CI, CI, CF, CI, CI, CI, VP]
    B, d = x.shape
    x_out, stats = np.empty_like(x), np.zeros((3, B), np.float32)
    err = lib.banded_slice_sweep(_ptr(x), _ptr(a), _ptr(seeds), _ptr(x_out), _ptr(stats), B, d,
                                 w, p, n_passes, max_iter, None)
    out.put((err, x_out, stats))


def slice_sweep(lib_path, x, betas, seeds, kind, params, coord_deltas, w, p, n_passes, max_iter,
                group, out):
    """Kernel K2's entry point; puts ``(err, x_out, lp, stats)`` on ``out``."""
    lib = ctypes.CDLL(str(lib_path))
    lib.slice_sweep.argtypes = [VP] * 6 + [CI] * 4 + [ctypes.POINTER(CF), CF, CI, CI, CI, CI, VP]
    B, d = x.shape
    x_out, lp, stats = np.empty_like(x), np.empty(B, np.float32), np.empty((3, B), np.float32)
    c_params = (CF * MAX_DENSITY_PARAMS)(*params)
    err = lib.slice_sweep(_ptr(x), _ptr(betas), _ptr(seeds), _ptr(x_out), _ptr(lp), _ptr(stats),
                          B, d, kind, int(coord_deltas), c_params, w, p, n_passes, max_iter, group,
                          None)
    out.put((err, x_out, lp, stats))
