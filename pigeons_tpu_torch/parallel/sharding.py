"""Replica-axis sharding over the ranks of a ``torch.distributed`` group.

Counterpart of ``pigeons_tpu/parallel/sharding.py``. The JAX package shards
the replica axis of the state batch over a 1-D device mesh and runs the round
under ``shard_map``; here every rank of a process group is one device, and
each rank runs the same Python loop of scans on its own block of replicas:

* Replicas are block-partitioned in global index order: rank k owns
  replicas ``[k*N/P, (k+1)*N/P)``. RNG streams derive from the *global*
  replica index, so they do not depend on the layout (reference
  ``replicas.jl:87-98``).
* Chain sharding (one ladder): each scan's per-lane values are gathered once,
  in rank order, and every rank runs the swap and the recorders on the same
  ``[N]`` tensors as the one-process run. Replicate sharding (independent
  ladders): no collective inside a round; the recorders and the recorded
  outputs are gathered at the round's end. Either way the result is the
  one-process run bit for bit (reference ``Entangler.jl:214-277``).

Backends: NCCL when every rank has a card of its own; gloo on the CPU, or
where ranks share a card (NCCL refuses two ranks on one device). gloo takes
no CUDA tensor in ``all_gather``, so :meth:`ReplicaMesh.gather` stages every
collective of a CUDA tensor on a gloo group through pinned host memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

REPLICA_AXIS = "replicas"

# this process's place among the ranks on its host, as MultiHostLauncher
# found it when it made the group (None: a group made otherwise)
host_rank: Optional[int] = None


@dataclass(frozen=True)
class ReplicaMesh:
    """The ranks of ``group`` (``None``: the default group, ``WORLD``) over
    which the replica axis of the state batch is sharded, one device a rank."""

    group: Optional[Any] = None

    @property
    def n_devices(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def device(self) -> torch.device:
        """This rank's card, ``cuda:{local_rank % device_count}``."""
        return self.device_for("cuda")

    def device_for(self, kind) -> torch.device:
        """This rank's device of ``kind`` (``"cuda"`` or ``"cpu"``; a device
        with an index is kept as given). The card is the rank's place on its
        host: :data:`host_rank` where :class:`~..submission.MultiHostLauncher`
        made the group, else torchrun's ``LOCAL_RANK``, else the rank."""
        dev = torch.device(kind)
        if dev.type != "cuda" or dev.index is not None:
            return dev
        local = host_rank
        if local is None:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())

    def block(self, n: int) -> tuple[int, int]:
        """``(lo, hi)``: the global indices ``[lo, hi)`` of this rank's block
        of ``n`` (which :meth:`validate` has checked)."""
        size = n // self.n_devices
        return self.rank * size, (self.rank + 1) * size

    def validate(self, n_chains: int, what: str = "n_chains") -> None:
        if n_chains % self.n_devices != 0:
            raise ValueError(
                f"{what} ({n_chains}) must be divisible by the mesh size "
                f"({self.n_devices}); pad {what} or use fewer devices"
            )

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order, on
        ``t``'s device. A collective: every rank must call it, with tensors
        of one shape and dtype."""
        src = t.contiguous()
        staged = src.is_cuda and self.backend == "gloo"
        if staged:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src)
            src = host
        parts = [torch.empty_like(src) for _ in range(self.n_devices)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim)
        return out.to(t.device, non_blocking=False) if staged else out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` on every rank (pickled). A collective."""
        box = [obj if self.rank == src else None]
        device = self.device if self.backend == "nccl" else None
        dist.broadcast_object_list(box, src=src, group=self.group, device=device)
        return box[0]


def replica_mesh(group=None) -> ReplicaMesh:
    """The replica mesh over the ranks of ``group`` (default: every rank of
    the default group). The process group must exist: start the ranks with
    ``torchrun`` and call :class:`~..submission.MultiHostLauncher`, or call
    ``torch.distributed.init_process_group`` first."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "replica_mesh() needs a torch.distributed process group: run through "
            "MultiHostLauncher (pigeons(..., on=MultiHostLauncher())), or call "
            "torch.distributed.init_process_group before building the mesh"
        )
    return ReplicaMesh(group)


def put_global(arr, mesh: Optional[ReplicaMesh], device=None) -> torch.Tensor:
    """This rank's block along axis 0 of a host array (every rank holds the
    same value: the run state is a function of the seed), on ``device``;
    the whole array without a mesh."""
    t = torch.tensor(np.asarray(arr))  # a copy: the caller's array stays its own
    if mesh is not None:
        lo, hi = mesh.block(t.shape[0])
        t = t[lo:hi]
    return t.to(device) if device is not None else t


def to_host(t, mesh: Optional[ReplicaMesh] = None, dim: int = 0) -> np.ndarray:
    """A tensor sharded along ``dim`` over ``mesh``, gathered in rank order,
    as a host array (without a mesh, ``t`` itself). With a mesh this is a
    COLLECTIVE: every rank must call it (the SPMD contract, as the
    reference's ``Allreduce`` discipline)."""
    if mesh is not None:
        t = mesh.gather(t, dim)
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
