"""Multi-process execution: a ``torch.distributed`` process group and the
replica mesh over all its ranks, one device a rank.

Counterpart of ``pigeons_tpu/submission/multihost.py``. The reference's
distributed backend is MPI (one process per rank exchanging point-to-point
messages, ``src/mpi_utils/``); the JAX package runs one SPMD program over
``jax.distributed``. Here every rank runs the same program too: start one
process a card with ``torchrun --nproc-per-node=K script.py`` (or run
``python -m pigeons_tpu_torch.submission.host_main`` on every host), and
every rank calls ``pigeons(inputs, on=MultiHostLauncher())``.
"""

from __future__ import annotations

import datetime
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel import sharding


@dataclass
class ThisProcess:
    """Run in the current process (reference ``ThisProcess``, api.jl)."""

    def submit(self, inputs):
        from ..pt import PT

        return PT(inputs).run()


def choose_backend(device: str, local_ranks: int) -> str:
    """NCCL when the run is on the card and each of the ``local_ranks``
    ranks on a host (the most on any one host) has a card of its own; gloo
    on the CPU, or where ranks share a card (NCCL refuses two ranks on one
    device)."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def host_ranks(store, rank: int, world: int, host: Optional[str] = None) -> tuple[int, int]:
    """``(local_rank, per_host)``: this rank's place among the ranks on its
    host, and the most ranks that any one host runs (every rank gets the
    same, so every rank chooses the same backend), from every rank's host
    name (``host``, by default this machine's) exchanged over the
    rendezvous ``store``. Every rank of the group must call it."""
    host = host or socket.gethostname()
    store.set(f"pigeons_tpu_torch/host/{rank}", host)
    hosts = [store.get(f"pigeons_tpu_torch/host/{r}").decode() for r in range(world)]
    return hosts[:rank].count(host), max(hosts.count(h) for h in hosts)


@dataclass
class MultiHostLauncher:
    """Initialize a ``torch.distributed`` process group and run with the
    replica axis sharded over all its ranks. Invoke the same script on every
    rank, passing the coordinator either here (``host:port``, or an
    ``init_method`` URL such as ``file:///shared/pg``, with the process count
    and this process's id) or through torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``: ``env://``).
    The ranks exchange their host names before the group is made, so the
    backend is :func:`choose_backend`'s for the ranks that really share a
    host, and each rank's card is its place among them
    (``parallel.sharding.host_rank``), with or without torchrun. A group that
    is already initialized is kept. ``timeout_s``: how long a rank waits in
    a collective for the others, so that a rank that fails ends the run
    instead of leaving the others waiting."""

    coordinator_address: Optional[str] = None  # host:port of process 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    timeout_s: float = 600.0

    def init(self, device: str = "cuda") -> None:
        """Join (or keep) the process group."""
        if dist.is_initialized():
            return
        from torch.distributed.rendezvous import rendezvous

        if self.coordinator_address is None:
            url, rank, world = "env://", -1, -1  # torchrun's RANK and WORLD_SIZE
        else:
            address = self.coordinator_address
            url = address if "://" in address else f"tcp://{address}"
            rank, world = self.process_id, self.num_processes
        timeout = datetime.timedelta(seconds=self.timeout_s)
        store, rank, world = next(rendezvous(url, rank, world, timeout=timeout))
        store.set_timeout(timeout)
        local_rank, per_host = host_ranks(store, rank, world)
        sharding.host_rank = local_rank  # this rank's card
        # the process group's keys apart from the host names, as
        # init_process_group keeps them when it makes the store itself
        dist.init_process_group(backend=choose_backend(device, per_host),
                                store=dist.PrefixStore("default_pg", store), world_size=world,
                                rank=rank, timeout=timeout)

    def submit(self, inputs):
        from ..parallel import replica_mesh
        from ..pt import PT

        self.init(inputs.device)
        inputs.mesh = replica_mesh()  # every rank of the group
        return PT(inputs).run()
