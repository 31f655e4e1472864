"""Per-process entry point for multi-process jobs: every rank runs

    python -m pigeons_tpu_torch.submission.host_main --inputs RUN.pkl \\
        --exec-folder FOLDER [--n-hosts P --coordinator HOST:PORT --process-id K]

(without ``--coordinator``, torchrun's environment, ``torchrun
--nproc-per-node=K -m pigeons_tpu_torch.submission.host_main ...``, or the
tasks of SLURM's ``srun``, as ``ClusterSubmission``'s script starts them;
with neither and ``--n-hosts 1``, a group of this one process).
Counterpart of ``pigeons_tpu/submission/host_main.py`` (reference
``.launch_script.jl``, ``src/submission/submission_utils.jl:160-196``).
``--inputs`` is an ``Inputs`` written by ``checkpoint.dump_object`` (its
arrays in the ``immutables`` folder beside it) or by ``pickle``; the run
checkpoints into ``--exec-folder``.
"""

from __future__ import annotations

import argparse
import os
import socket


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--inputs", required=True)
    parser.add_argument("--exec-folder", required=True)
    parser.add_argument("--n-hosts", type=int, default=1)
    parser.add_argument("--coordinator", default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)

    from pigeons_tpu_torch.checkpoint import load_object
    from pigeons_tpu_torch.submission import MultiHostLauncher

    inputs = load_object(args.inputs, os.path.join(os.path.dirname(args.inputs), "immutables"))
    inputs.checkpoint = True
    inputs.checkpoint_folder = args.exec_folder

    from pigeons_tpu_torch.submission.multihost import slurm_task

    coordinator, process_id = args.coordinator, args.process_id
    if coordinator is None and "RANK" not in os.environ and slurm_task() is None:
        if args.n_hosts != 1:
            raise ValueError(
                f"host_main: --n-hosts {args.n_hosts} without --coordinator, torchrun's "
                "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or an srun task's")
        coordinator, process_id = f"127.0.0.1:{free_port()}", 0  # a group of one
    launcher = MultiHostLauncher(
        coordinator_address=coordinator,
        num_processes=args.n_hosts if coordinator else None,
        process_id=process_id,
    )
    return launcher.submit(inputs)


def free_port() -> int:
    """A TCP port of this host that no process listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    main()
