"""Log densities of standard distributions on batched tensors.

Counterpart of ``pigeons_tpu/models/distributions.py``. Only
``normal_logpdf`` is here, which the banana target uses; the ``Distribution``
classes wait for the Bayesian-model frontend (ROADMAP queue 1, item 11b).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import f32math

LOG_2PI = math.log(2.0 * math.pi)
_LOG_2PI_F32 = float(np.float32(LOG_2PI))


@functools.lru_cache(maxsize=None)
def normal_constants(scale: float) -> tuple[float, float]:
    """``(1 / scale, -log(scale))`` in float32, the two constants that
    :func:`normal_logpdf` needs for a fixed ``scale``."""
    s = np.float32(scale)
    neg_log = -f32math.log(torch.tensor(s, dtype=torch.float32))
    return float(np.float32(1.0) / s), float(neg_log)


def normal_logpdf(y, loc, scale: float):
    """``sum(-0.5 (log 2 pi + z^2) - log(scale))`` over the last axis of
    ``y [..., k]``, with ``z = (y - loc) / scale`` and a constant ``scale``.

    Evaluated as XLA evaluates the JAX function: the division by the constant
    is a multiplication by its float32 reciprocal, ``log 2 pi + z^2`` and the
    halving are fused multiply-adds, and the terms are added in order."""
    inv_scale, neg_log_scale = normal_constants(scale)
    z = (y - loc) * inv_scale
    terms = f32math.fma(-f32math.fma(z, z, _LOG_2PI_F32), 0.5, neg_log_scale)
    acc = terms[..., 0]
    for i in range(1, terms.shape[-1]):
        acc = acc + terms[..., i]
    return acc
