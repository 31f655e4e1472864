"""Cluster submission: SLURM / PBS / LSF script generation and job control.

Reference semantics (``src/submission/MPIProcesses.jl``): a "rosetta" table
maps a common resource spec (walltime, tasks, cpus, memory) onto the three
schedulers' directive syntaxes; scripts are generated, submitted with
sbatch/qsub/bsub, and tracked via ``Result``; ``MPISettings`` persists the
user's cluster preset (``src/submission/MPISettings.jl``, ``presets.jl``).

Counterpart of ``pigeons_tpu/submission/cluster.py``, whole: the same
rosetta, presets, scripts and job utilities. Instead of ``mpiexec julia`` the
generated script launches the port's ``submission/host_main.py``: under
SLURM one task a host (``srun``), which join one ``torch.distributed``
group from SLURM's environment (:func:`~.multihost.slurm_task`) and run the
PT on the replica mesh; under PBS and LSF one process, so ``n_hosts`` must
be 1 there (the JAX package's script starts one process there too, and
``jax.distributed.initialize`` finds no other).
The run's ``Inputs`` are written with :func:`~..checkpoint.dump_object`
(their arrays in ``immutables/`` beside them), as ``host_main`` reads them.
"""

from __future__ import annotations

import json
import os
import subprocess
from dataclasses import dataclass, field
from typing import Dict, Optional

from .result import Result

# the reference's rosetta (MPIProcesses.jl:17-52), adapted: scheduler -> directives
_ROSETTA = {
    "slurm": {
        "directive": "#SBATCH",
        "walltime": "--time={}",
        "n_hosts": "--nodes={}",
        "cpus": "--cpus-per-task={}",
        "memory": "--mem={}",
        "name": "--job-name={}",
        "output": "--output={}",
        "submit": ["sbatch"],
        "del": ["scancel"],
        "queue_status": ["squeue", "-u"],
        "ncpu_info": ["sinfo", "-o", "%C"],
    },
    "pbs": {
        "directive": "#PBS",
        "walltime": "-l walltime={}",
        "n_hosts": "-l select={}",
        "cpus": "-l ncpus={}",
        "memory": "-l mem={}",
        "name": "-N {}",
        "output": "-o {}",
        "submit": ["qsub"],
        "del": ["qdel"],
        "queue_status": ["qstat", "-u"],
        "ncpu_info": ["pbsnodes", "-aSj"],
    },
    "lsf": {
        "directive": "#BSUB",
        "walltime": "-W {}",
        "n_hosts": "-nnodes {}",
        "cpus": "-n {}",
        "memory": "-M {}",
        "name": "-J {}",
        "output": "-o {}",
        "submit": ["bsub"],
        "del": ["bkill"],
        "queue_status": ["bjobs", "-u"],
        "ncpu_info": ["bhosts"],
    },
}

_SETTINGS_PATH = os.path.expanduser("~/.pigeons_tpu/settings.json")


@dataclass
class MPISettings:
    """Persisted cluster configuration (reference ``MPISettings.jl:5-57``)."""

    submission_system: str = "slurm"
    add_to_submission: list = field(default_factory=list)  # extra directives
    environment_modules: list = field(default_factory=list)

    def save(self, path: str = _SETTINGS_PATH) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.__dict__, f, indent=2)

    @classmethod
    def load(cls, path: str = _SETTINGS_PATH) -> "MPISettings":
        if os.path.exists(path):
            with open(path) as f:
                return cls(**json.load(f))
        return cls()


def setup_mpi(**kwargs) -> MPISettings:
    """Persist cluster settings (reference ``setup_mpi``, ``MPISettings.jl:103``)."""
    settings = MPISettings(**kwargs)
    settings.save()
    return settings


# -- cluster presets (reference src/submission/presets.jl:12-48) -------------


def setup_compute_canada() -> MPISettings:
    """Compute Canada / Alliance clusters (reference presets.jl:12-19)."""
    return setup_mpi(
        submission_system="slurm",
        environment_modules=["python/3.12"],
    )


def setup_sockeye(allocation_code: str) -> MPISettings:
    """UBC Sockeye (reference presets.jl:26-39)."""
    return setup_mpi(
        submission_system="slurm",
        environment_modules=[],
        add_to_submission=[
            f"#SBATCH -A {allocation_code}",
            "#SBATCH --nodes=1-10000",
        ],
    )


def setup_tpu_pod(accelerator_type: str = "v5e-8") -> MPISettings:
    """The JAX package's preset for pod slices, kept by name and behaviour: a
    SLURM constraint on the node type (here any ``--constraint`` value, e.g.
    a GPU node type)."""
    return setup_mpi(
        submission_system="slurm",
        add_to_submission=[f"#SBATCH --constraint={accelerator_type}"],
    )


@dataclass
class ClusterSubmission:
    """Generate and submit a multi-host cluster job
    (``pigeons(inputs, on=ClusterSubmission(...))``)."""

    n_hosts: int = 1
    walltime: str = "00:30:00"
    cpus_per_task: int = 8
    memory: str = "16gb"
    name: str = "pigeons_tpu"
    settings: Optional[MPISettings] = None
    dry_run: bool = False  # generate the script without submitting

    def script(self, inputs_path: str, exec_folder: str) -> str:
        settings = self.settings or MPISettings.load()
        if settings.submission_system != "slurm" and self.n_hosts != 1:
            raise ValueError(
                f"ClusterSubmission(n_hosts={self.n_hosts}) under {settings.submission_system}: "
                "the script starts one process, and only SLURM's srun starts one on every "
                "host; use n_hosts=1, or start host_main on each host with --coordinator "
                "and --process-id (or under torchrun)")
        ros = _ROSETTA[settings.submission_system]
        d = ros["directive"]
        lines = ["#!/bin/bash"]
        lines.append(f"{d} {ros['walltime'].format(self.walltime)}")
        lines.append(f"{d} {ros['n_hosts'].format(self.n_hosts)}")
        lines.append(f"{d} {ros['cpus'].format(self.cpus_per_task)}")
        lines.append(f"{d} {ros['memory'].format(self.memory)}")
        lines.append(f"{d} {ros['name'].format(self.name)}")
        lines.append(
            f"{d} {ros['output'].format(os.path.join(exec_folder, 'info', 'stdout.txt'))}"
        )
        lines.extend(f"{d} {extra}" for extra in settings.add_to_submission)
        lines.extend(f"module load {m}" for m in settings.environment_modules)
        runner = os.path.join(os.path.dirname(__file__), "host_main.py")
        launch = (
            f"python {runner} --inputs {inputs_path} --exec-folder {exec_folder} "
            f"--n-hosts {self.n_hosts}"
        )
        if settings.submission_system == "slurm":
            lines.append(f"srun {launch}")
        else:
            lines.append(launch)
        return "\n".join(lines) + "\n"

    def submit(self, inputs) -> Result:
        import dataclasses

        from ..checkpoint import dump_object, immutables_dir, next_exec_folder

        exec_folder = os.path.abspath(next_exec_folder())
        os.makedirs(os.path.join(exec_folder, "info"), exist_ok=True)
        inputs = dataclasses.replace(inputs, mesh=None)
        inputs_path = os.path.join(exec_folder, ".inputs.pkl")
        dump_object(inputs, inputs_path, immutables_dir(exec_folder), "the run's Inputs")
        script = self.script(inputs_path, exec_folder)
        script_path = os.path.join(exec_folder, ".submission_script.sh")
        with open(script_path, "w") as f:
            f.write(script)
        os.chmod(script_path, 0o755)
        if self.dry_run:
            return Result(exec_folder=exec_folder, job_id=None)
        settings = self.settings or MPISettings.load()
        ros = _ROSETTA[settings.submission_system]
        out = subprocess.run(
            ros["submit"] + [script_path], capture_output=True, text=True, check=True
        )
        return Result(exec_folder=exec_folder, job_id=out.stdout.strip())


# -- job utilities (reference submission_utils.jl:6-81) ----------------------


def queue_status(settings: Optional[MPISettings] = None) -> str:
    settings = settings or MPISettings.load()
    ros = _ROSETTA[settings.submission_system]
    user = os.environ.get("USER", "")
    out = subprocess.run(ros["queue_status"] + [user], capture_output=True, text=True)
    return out.stdout


def queue_ncpus_free(settings: Optional[MPISettings] = None) -> str:
    """Free-CPU summary from the scheduler (reference ``queue_ncpus_free``,
    ``submission_utils.jl:37-41``)."""
    settings = settings or MPISettings.load()
    ros = _ROSETTA[settings.submission_system]
    out = subprocess.run(ros["ncpu_info"], capture_output=True, text=True)
    return out.stdout


def kill_job(result: Result, settings: Optional[MPISettings] = None) -> None:
    settings = settings or MPISettings.load()
    ros = _ROSETTA[settings.submission_system]
    subprocess.run(ros["del"] + [result.job_id], check=True)


def watch(result: Result, lines: int = 40) -> str:
    """Tail the run's stdout (reference ``watch``, ``submission_utils.jl:62``)."""
    path = os.path.join(result.exec_folder, "info", "stdout.txt")
    if not os.path.exists(path):
        return "(no output yet)"
    with open(path) as f:
        return "".join(f.readlines()[-lines:])
