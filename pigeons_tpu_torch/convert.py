"""Carry run state across from the JAX package.

``pigeons_tpu/checkpoint.py:write_checkpoint`` stores a run's state as the
numpy arrays ``states``, ``chain_of``, ``replica_of`` and ``schedule``.
:func:`state_from_numpy` loads such arrays into a port :class:`~.pt.PT`
built from the same ``Inputs``, so that both packages continue one run from
one state: round ``round_idx + 1`` then draws from the same keys in both.
"""

from __future__ import annotations

import numpy as np
import torch

from .schedule import Schedule


def state_from_numpy(pt, arrays, round_idx: int):
    """Load ``arrays`` (a mapping with ``states [(R,) N, d]``, ``chain_of``
    and ``replica_of [(R,) N]``, ``schedule [N]``) as the state after round
    ``round_idx``. Returns ``pt``."""
    R, n, d = pt.n_replicates, pt.n_chains, pt.dim
    states = np.asarray(arrays["states"], dtype=np.float32)
    chain_of = np.asarray(arrays["chain_of"])
    replica_of = np.asarray(arrays["replica_of"])
    want = (n, d) if R == 1 else (R, n, d)
    if states.shape != want or chain_of.shape != want[:-1] or replica_of.shape != want[:-1]:
        raise ValueError(
            f"expected states {want} and permutations {want[:-1]}, got "
            f"{states.shape}, {chain_of.shape}, {replica_of.shape}"
        )
    dev = pt.device
    pt._states = torch.tensor(states.reshape(R * n, d), device=dev)
    pt._chain_of = torch.tensor(chain_of.reshape(R, n), dtype=torch.int64, device=dev)
    pt._replica_of = torch.tensor(replica_of.reshape(R, n), dtype=torch.int64, device=dev)
    pt.schedule = Schedule(np.asarray(arrays["schedule"], dtype=np.float64))
    pt.round_idx = int(round_idx)
    return pt
