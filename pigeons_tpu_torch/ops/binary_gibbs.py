"""Exact Gibbs updates for binary coordinates.

Counterpart of ``pigeons_tpu/ops/binary_gibbs.py`` (reference
``src/explorers/SliceSampler.jl:65-86``): a Bool coordinate is not sliced;
its full conditional comes from one extra density evaluation, ``p(x_c = 0) =
1 / (1 + exp(lp1 - lp0))``, and is sampled directly. States are float
vectors with binary coordinates in {0., 1.}; ``mask`` (0/1 per coordinate)
restricts the updates to the binary coordinates. Written for the whole batch
of lanes at once: the coordinate index is shared, so a coordinate off the
mask costs nothing. Pass ``p`` of coordinate ``c`` draws its uniform from
``fold_in(fold_in(key, p), c)``, as the JAX step does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import f32math, rng
from ..paths import lane_log_density
from .base import Explorer, StepOut


class BinaryGibbs(Explorer):
    def __init__(self, mask: Optional[Sequence[int]] = None, n_passes: int = 1):
        """``mask``: optional 0/1 per-coordinate flags marking the binary
        coordinates (default: all)."""
        self.mask = None if mask is None else tuple(int(m) for m in mask)
        self.n_passes = int(n_passes)

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        B, d = xs.shape

        def lp_fn(x):
            return lane_log_density(path, x, betas, isvar, ref_params)

        x = xs.clone()
        lp_cur = lp_fn(x) if lp is None else lp
        z = torch.zeros(B, dtype=torch.float32, device=xs.device)
        n_evals = z.clone()
        for p in range(self.n_passes):
            k_pass = rng.fold_in(keys, p)
            for c in range(d):
                if self.mask is not None and not self.mask[c]:
                    continue
                cur = x[:, c]
                flipped = x.clone()
                flipped[:, c] = 1.0 - cur
                lp_flip = lp_fn(flipped)
                is_one = cur > 0.5
                lp1 = torch.where(is_one, lp_cur, lp_flip)
                lp0 = torch.where(is_one, lp_flip, lp_cur)
                p_zero = 1.0 / (1.0 + f32math.exp(lp1 - lp0))
                u = rng.uniform(rng.fold_in(k_pass, c))
                new = torch.where(u < p_zero, 0.0, 1.0)
                lp_cur = torch.where(new == cur, lp_cur, lp_flip)
                x[:, c] = new
                n_evals = n_evals + 1.0
        return StepOut(x, lp_cur, z, z.clone(), n_evals)
