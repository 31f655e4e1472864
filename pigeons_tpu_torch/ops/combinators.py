"""Explorer combinators over the batch: deterministic compositions and mixtures.

Counterpart of ``pigeons_tpu/ops/combinators.py`` (reference
``src/explorers/Compose.jl``, ``Mix.jl``). Each combinator composes its
components' ``step_batched``; its adapted state is the tuple of theirs (a
tree, ``tree.py``), and ``init_state``, ``needs_online_moments``,
``check_target``, ``check_path`` and ``adapt`` recurse into the components.
The components' own statistics (``extra_names``) are concatenated as
``f"{i}_{name}"`` in fixed slots, and ``adapt`` hands each component the
view of ``extra_mean`` / ``extra_n`` at its slots.

* :class:`Compose` runs every component in order: component ``i`` takes
  ``fold_in(key, i)`` and the state and density the previous one returned;
  the acceptance and step statistics add up.
* :class:`Mix` draws for each lane ``k_pick, k_step = split(key)`` and the
  component ``randint(k_pick, (), 0, K)``, which moves it with ``k_step``.
  The JAX package's ``lax.switch`` under ``vmap`` runs every branch on every
  lane and selects; here each component is handed only the lanes that chose
  it (indexed out, scattered back), which gives the same result: lanes are
  independent. The other components' statistic slots of a lane get zeros.
  On the card a density whose reductions round by batch shape would break
  that equality; none on these paths does (the logistic regression's
  cuBLAS product comes in only above 1,024 observations, ``ROADMAP.md``
  §3).
* :class:`ScanMix` runs component ``scan_idx % K`` on every lane with the
  lane's key: one component a scan, all lanes, cycling across scans.

A :class:`~.cuda_slice.SliceSamplerCUDA` component is refused: the JAX
combinators call each component's per-lane ``step``, and
``SliceSamplerPallas.step`` is the XLA sampler
(``pigeons_tpu/ops/pallas_slice.py:43-44``), whose counterpart here is the
torch :class:`~.slice_sampler.SliceSampler` with the same ``w``, ``p``,
``n_passes`` and ``max_iter``, which the caller passes: a kernel sampler is
never replaced by it silently.
"""

from __future__ import annotations

import torch

from .. import rng
from ..tree import tree_map
from .base import Explorer, StepOut
from .cuda_slice import SliceSamplerCUDA


def _params_of(chain_params, i, lanes=None):
    """Component ``i``'s chain params (at ``lanes``), ``None`` where it has none."""
    if chain_params is None or not isinstance(chain_params[i], dict):
        return None
    cp = chain_params[i]
    return cp if lanes is None else tree_map(lambda v: v[lanes], cp)


class _Combinator(Explorer):
    def __init__(self, *explorers):
        for e in explorers:
            if isinstance(e, SliceSamplerCUDA):
                raise ValueError(
                    f"{type(self).__name__}: a SliceSamplerCUDA component is not taken. The JAX "
                    "combinators run SliceSamplerPallas.step, the XLA sampler; its counterpart "
                    f"here is SliceSampler(w={e.w}, p={e.p}, n_passes={e.n_passes}, "
                    f"max_iter={e.max_iter}). Pass that component instead.")
        self.explorers = tuple(explorers)
        self.extra_names = tuple(
            f"{i}_{name}" for i, e in enumerate(self.explorers) for name in e.extra_names)
        self._extra_slices = []
        off = 0
        for e in self.explorers:
            self._extra_slices.append((off, len(e.extra_names)))
            off += len(e.extra_names)

    def init_state(self, n_chains: int, dim: int, device=None):
        return tuple(e.init_state(n_chains, dim, device) for e in self.explorers)

    def needs_online_moments(self) -> bool:
        return any(e.needs_online_moments() for e in self.explorers)

    def check_target(self, target) -> None:
        for e in self.explorers:
            e.check_target(target)

    def check_path(self, path) -> None:
        for e in self.explorers:
            e.check_path(path)

    def adapt(self, state, reduced, round_idx: int):
        out = []
        for e, s, (off, k) in zip(self.explorers, state, self._extra_slices):
            view = reduced
            if k:
                view = reduced._replace(extra_mean=reduced.extra_mean[:, off:off + k],
                                        extra_n=reduced.extra_n[:, off:off + k])
            out.append(e.adapt(s, view, round_idx))
        return tuple(out)

    def _slots(self, B, device):
        K = len(self.extra_names)
        if not K:
            return None, None
        z = torch.zeros(B, K, dtype=torch.float32, device=device)
        return z, z.clone()


class Compose(_Combinator):
    """Deterministic composition: run each component in order (reference
    ``Compose.jl``)."""

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        z = torch.zeros(xs.shape[0], dtype=torch.float32, device=xs.device)
        a_s, a_n, ns = z, z, z
        ex_s, ex_n = [], []
        x = xs
        for i, e in enumerate(self.explorers):
            out = e.step_batched(rng.fold_in(keys, i), x, betas, path, isvar=isvar,
                                 ref_params=ref_params, lp=lp,
                                 chain_params=_params_of(chain_params, i), scan_idx=scan_idx)
            x, lp = out.x, out.lp
            a_s, a_n, ns = a_s + out.accept_sum, a_n + out.accept_n, ns + out.n_steps
            if self._extra_slices[i][1]:
                ex_s.append(out.extras_sum)
                ex_n.append(out.extras_n)
        return StepOut(x, lp, a_s, a_n, ns,
                       torch.cat(ex_s, dim=1) if ex_s else None,
                       torch.cat(ex_n, dim=1) if ex_n else None)


class Mix(_Combinator):
    """Uniform random mixture: each lane picks one component per step
    (reference ``Mix.jl:23``), drawn as the JAX ``Mix`` draws it; each
    component moves only the lanes that picked it."""

    def choices(self, keys):
        """Each lane's component ``[B]`` (int32) and the key it steps with."""
        k_pick, k_step = rng.split(keys).unbind(-2)
        return rng.randint(k_pick, (), 0, len(self.explorers)), k_step

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        B = xs.shape[0]
        choice, k_step = self.choices(keys)
        x = xs.clone()
        lp_new = torch.empty(B, dtype=torch.float32, device=xs.device)
        all_lp = True
        z = torch.zeros(B, dtype=torch.float32, device=xs.device)
        a_s, a_n, ns = z.clone(), z.clone(), z.clone()
        es, en = self._slots(B, xs.device)
        for i, e in enumerate(self.explorers):
            lanes = torch.nonzero(choice == i).squeeze(1)
            if lanes.numel() == 0:
                continue

            def sub(t):
                return None if t is None else t[lanes]

            out = e.step_batched(k_step[lanes], xs[lanes], betas[lanes], path, isvar=sub(isvar),
                                 ref_params=ref_params, lp=sub(lp),
                                 chain_params=_params_of(chain_params, i, lanes),
                                 scan_idx=scan_idx)
            x[lanes] = out.x.to(x.dtype)
            if out.lp is None:
                all_lp = False
            else:
                lp_new[lanes] = out.lp
            a_s[lanes], a_n[lanes], ns[lanes] = out.accept_sum, out.accept_n, out.n_steps
            off, k = self._extra_slices[i]
            if k:
                es[lanes, off:off + k] = out.extras_sum
                en[lanes, off:off + k] = out.extras_n
        return StepOut(x, lp_new if all_lp else None, a_s, a_n, ns, es, en)


class ScanMix(_Combinator):
    """Systematic-scan mixture: component ``scan_idx % K`` moves every lane
    this scan, with the lane's own key, cycling across scans (the JAX
    ``ScanMix``). The other components' statistic slots get zeros."""

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        if scan_idx is None:
            raise ValueError("ScanMix picks its component by the scan index: pass scan_idx")
        i = int(scan_idx) % len(self.explorers)
        out = self.explorers[i].step_batched(keys, xs, betas, path, isvar=isvar,
                                            ref_params=ref_params, lp=lp,
                                            chain_params=_params_of(chain_params, i),
                                            scan_idx=scan_idx)
        es, en = self._slots(xs.shape[0], xs.device)
        off, k = self._extra_slices[i]
        if k:
            es[:, off:off + k] = out.extras_sum
            en[:, off:off + k] = out.extras_n
        return StepOut(out.x, out.lp, out.accept_sum, out.accept_n, out.n_steps, es, en)
