"""Per-process entry point for multi-process jobs: every rank runs

    python -m pigeons_tpu_torch.submission.host_main --inputs RUN.pkl \\
        --exec-folder FOLDER [--n-hosts P --coordinator HOST:PORT --process-id K]

(without ``--coordinator``, torchrun's environment: ``torchrun
--nproc-per-node=K -m pigeons_tpu_torch.submission.host_main ...``).
Counterpart of ``pigeons_tpu/submission/host_main.py`` (reference
``.launch_script.jl``, ``src/submission/submission_utils.jl:160-196``).
``--inputs`` is an ``Inputs`` written by ``checkpoint.dump_object`` (its
arrays in the ``immutables`` folder beside it) or by ``pickle``; the run
checkpoints into ``--exec-folder``.
"""

from __future__ import annotations

import argparse
import os


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

    launcher = MultiHostLauncher(
        coordinator_address=args.coordinator,
        num_processes=args.n_hosts if args.coordinator else None,
        process_id=args.process_id,
    )
    return launcher.submit(inputs)


if __name__ == "__main__":
    main()
