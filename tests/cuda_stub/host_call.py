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


def banded_slice_sweep(lib_path, x, a, seeds, w, p, n_passes, max_iter, variational, out):
    """Kernel K1's entry point on ``x [B, d]`` float32, ``a [B]`` float32 and
    ``seeds [B]`` int64; ``variational`` is ``None`` (the toy term) or the
    variational term's ``(beta [B], isvar [B], active [1], mean [d], std [d],
    a_target)``. Puts ``(err, x_out, stats)`` on ``out``."""
    lib = ctypes.CDLL(str(lib_path))
    lib.banded_slice_sweep.argtypes = [VP] * 5 + [CI, CI, CF, CI, CI, CI, CI] + [VP] * 5 + [CF, VP]
    B, d = x.shape
    x_out, stats = np.empty_like(x), np.zeros((3, B), np.float32)
    term, term_args = 0, (None,) * 5 + (0.0,)
    if variational is not None:
        term, term_args = 1, tuple(_ptr(t) for t in variational[:5]) + (variational[5],)
    err = lib.banded_slice_sweep(_ptr(x), _ptr(a), _ptr(seeds), _ptr(x_out), _ptr(stats), B, d,
                                 w, p, n_passes, max_iter, term, *term_args, None)
    out.put((err, x_out, stats))


MAX_DENSITY_ARRAYS = 4  # csrc/densities.cuh: DensityArrays


def slice_sweep(lib_path, x, betas, seeds, kind, params, coord_deltas, w, p, n_passes, max_iter,
                group, out, arrays=(), prior=(), variational=None):
    """Kernel K2's entry point; ``arrays`` are the density's float32 arrays,
    ``prior`` the rows of its prior table, ``variational`` ``None`` or
    ``(isvar [B], mean [d], std [d], active [1])``. Puts ``(err, x_out, lp,
    stats)`` on ``out``."""
    lib = ctypes.CDLL(str(lib_path))
    lib.slice_sweep.argtypes = ([VP] * 6 + [CI] * 4 + [ctypes.POINTER(CF), ctypes.POINTER(VP),
                                ctypes.POINTER(CI), ctypes.POINTER(CF), CI] + [VP] * 4
                                + [CF, CI, CI, CI, CI, VP])
    B, d = x.shape
    x_out, lp, stats = np.empty_like(x), np.empty(B, np.float32), np.empty((3, B), np.float32)
    c_params = (CF * MAX_DENSITY_PARAMS)(*params)
    pad = MAX_DENSITY_ARRAYS - len(arrays)
    c_arrays = (VP * MAX_DENSITY_ARRAYS)(*[a.ctypes.data for a in arrays], *[None] * pad)
    c_lens = (CI * MAX_DENSITY_ARRAYS)(*[a.size for a in arrays], *[0] * pad)
    rows = [float(v) for row in prior for v in row]
    c_prior = (CF * max(len(rows), 1))(*rows)
    var = (None,) * 4 if variational is None else tuple(_ptr(a) for a in variational)
    err = lib.slice_sweep(_ptr(x), _ptr(betas), _ptr(seeds), _ptr(x_out), _ptr(lp), _ptr(stats),
                          B, d, kind, int(coord_deltas), c_params, c_arrays, c_lens, c_prior,
                          len(prior), *var, w, p, n_passes, max_iter, group, None)
    out.put((err, x_out, lp, stats))


def slice_sweep_child(*args):
    """``slice_sweep`` with the queue last, as ``_in_child`` of
    ``tests/test_torch_csrc_host.py`` calls a child's function: ``(lib_path,
    x, betas, seeds, kind, params, coord_deltas, w, p, n_passes, max_iter,
    group, arrays, prior, variational, out)``."""
    *head, arrays, prior, variational, out = args
    slice_sweep(*head, out, arrays, prior, variational)
