"""Submission backends: ``pigeons(inputs, on=...)``.

Counterpart of ``pigeons_tpu/submission``: this process, a child process,
the multi-process launcher and the cluster back ends (SLURM / PBS / LSF
scripts and job control)."""

from .child_process import ChildProcess
from .cluster import (
    ClusterSubmission,
    MPISettings,
    kill_job,
    queue_ncpus_free,
    queue_status,
    setup_compute_canada,
    setup_mpi,
    setup_sockeye,
    setup_tpu_pod,
    watch,
)
from .multihost import MultiHostLauncher, ThisProcess
from .result import Result

__all__ = [
    "ChildProcess",
    "ClusterSubmission",
    "MPISettings",
    "MultiHostLauncher",
    "Result",
    "ThisProcess",
    "kill_job",
    "queue_ncpus_free",
    "queue_status",
    "setup_compute_canada",
    "setup_mpi",
    "setup_sockeye",
    "setup_tpu_pod",
    "watch",
]
