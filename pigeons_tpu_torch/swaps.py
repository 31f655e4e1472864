"""Non-reversible DEO swaps as permutation updates, batched over ladders.

Counterpart of ``pigeons_tpu/swaps.py``. States are indexed by replica and
never move; ``chain_of [R, N]`` and ``replica_of [R, N]`` hold each of ``R``
independent ladders' permutations, so one swap scan is a handful of gathers
over ``[R, N]`` tensors, independent of the state dimension.

DEO semantics (0-indexed chains): odd scans pair (0,1),(2,3),...; even scans
pair (1,2),(3,4),...; a pair swaps iff the uniform of the replica at its
lower chain is below ``min(1, exp(r1 + r2))``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import f32math, rng


def deo_partner_map(n_chains: int, scan_idx: int, device=None) -> torch.Tensor:
    """partner[c] for each chain c under the DEO graph of scan ``scan_idx``
    (1-indexed scan counter)."""
    offset = 1 if scan_idx % 2 == 0 else 0  # even scan -> pairs start at chain 1
    c = torch.arange(n_chains, dtype=torch.int64, device=device)
    partner = torch.where((c - offset) % 2 == 0, c + 1, c - 1)
    return torch.where((partner < 0) | (partner >= n_chains), c, partner)


def metropolis_accept_pr(stat_sum):
    return torch.minimum(torch.ones_like(stat_sum), f32math.exp(stat_sum))


class SwapResult(NamedTuple):
    chain_of: torch.Tensor  # [R, N] updated replica -> chain permutation
    replica_of: torch.Tensor  # [R, N] updated chain -> replica permutation
    pair_active: torch.Tensor  # [N-1] bool: pair (c, c+1) interacted this scan
    accept_pr: torch.Tensor  # [R, N-1] acceptance probability (0 where inactive)
    ratio_fwd: torch.Tensor  # [R, N-1] log-ratio recorded for key (c, c+1)
    ratio_bwd: torch.Tensor  # [R, N-1] log-ratio recorded for key (c+1, c)
    do_swap: torch.Tensor  # [R, N-1] bool swap decisions


def swap_scan(
    swap_keys: torch.Tensor,
    scan_idx: int,
    chain_of: torch.Tensor,
    replica_of: torch.Tensor,
    log_ratio: torch.Tensor,
    accept_fn: Callable = metropolis_accept_pr,
    partner_map: torch.Tensor = None,
) -> SwapResult:
    """One communication step of ``R`` ladders.

    ``swap_keys [R, 2]`` are the ladders' swap keys; ``log_ratio [R, N]`` is
    each replica's ``log pi_partner(x_r) - log pi_own(x_r)``, in replica
    order. ``partner_map [N]`` (an involution, shared by all ladders)
    defaults to the DEO graph of ``scan_idx``.
    """
    n = chain_of.shape[-1]
    dev = chain_of.device
    if partner_map is None:
        partner_map = deo_partner_map(n, scan_idx, dev)

    ratio_by_chain = torch.gather(log_ratio, 1, replica_of)
    # one uniform per replica from fold_in(swap_key, replica); a pair uses the
    # uniform of the replica at its lower chain
    u = rng.uniform(rng.keys_for(swap_keys, torch.arange(n, device=dev)))
    u_by_chain = torch.gather(u, 1, replica_of)

    # pairs indexed by their lower chain c, padded to max(N-1, 1) entries
    c = torch.arange(max(n - 1, 1), device=dev)
    partner_c = partner_map[torch.clamp(c, max=n - 1)]
    pair_active = partner_c > c
    ratio_fwd = ratio_by_chain[:, c]
    ratio_bwd = ratio_by_chain[:, partner_c]
    stat_sum = ratio_fwd + ratio_bwd
    accept_pr = torch.where(pair_active, accept_fn(stat_sum), torch.zeros_like(stat_sum))
    do_swap = pair_active & (u_by_chain[:, c] < accept_pr)

    # chain-level destination: a chain in a swapped pair moves to its
    # partner's slot; the involution is its own inverse, so one gather keeps
    # chain_of and one keeps replica_of
    cidx = torch.arange(n, dtype=chain_of.dtype, device=dev)
    low = torch.minimum(cidx, partner_map)
    swapped_chain = do_swap[:, torch.clamp(low, max=max(n - 2, 0))] & (partner_map != cidx)
    dest = torch.where(swapped_chain, partner_map, cidx)
    return SwapResult(
        chain_of=torch.gather(dest, 1, chain_of),
        replica_of=torch.gather(replica_of, 1, dest),
        pair_active=pair_active,
        accept_pr=accept_pr,
        ratio_fwd=ratio_fwd,
        ratio_bwd=ratio_bwd,
        do_swap=do_swap,
    )
