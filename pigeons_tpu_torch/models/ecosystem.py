"""Ecosystem provisioning for the external-worker bridges.

Counterpart of ``pigeons_tpu/models/ecosystem.py``, whole (the port keeps
its own copy: it imports nothing of the JAX package). The reference can BOOTSTRAP its external model ecosystems, not just talk to
them: ``setup_blang`` clones + gradle-builds Blang model repositories (or
fetches precompiled builds), ``blang_executable`` derives the ``java -cp``
invocation (``src/targets/BlangTarget.jl:126-180``), and
``tppl_compile_model`` / container-command constructors compile TreePPL
models — optionally inside docker/podman/apptainer/singularity — and build
the run commands with the right mounts and env plumbing
(``src/targets/TreePPLTarget.jl:163-521``). This module is the faithful
equivalent: every function constructs the exact command sequences and
executes them through an injectable ``runner`` (default: ``subprocess.run``
with check), so environments without network/JVM/containers can still unit-
test the full provisioning logic (the tests do exactly that, the way the
cluster-submission rosetta is tested by script generation).
"""

from __future__ import annotations

import os
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

# Blang repos with precompiled builds hosted by the Blang maintainers
# (reference BlangTarget.jl:120)
PRECOMPILED_BLANG_LIBS = ("nowellpack", "blangDemos")

TPPL_SUPPORTED_CONTAINER_ENGINES = (
    "docker", "podman", "singularity", "apptainer"
)


def _default_runner(cmd: Sequence[str], cwd: Optional[str] = None) -> None:
    subprocess.run(list(cmd), cwd=cwd, check=True)


def settings_folder() -> str:
    """Per-user install folder (the reference reuses its ``~/.pigeons`` MPI
    settings folder, ``BlangTarget.jl:131``)."""
    return os.path.expanduser("~/.pigeons_tpu")


# ---------------------------------------------------------------------------
# Blang (reference BlangTarget.jl:126-180)
# ---------------------------------------------------------------------------


def setup_blang(
    repo_name: str,
    organization: str = "UBC-Stat-ML",
    base_dir: Optional[str] = None,
    runner: Callable = _default_runner,
) -> Optional[str]:
    """Clone + gradle-build a Blang model repository (or fetch the
    precompiled build for the known UBC-Stat-ML libraries). Idempotent: a
    repo that is already set up is left alone. Returns the repo path, or
    None when it already existed."""
    base = base_dir or settings_folder()
    os.makedirs(base, exist_ok=True)
    repo_path = os.path.join(base, repo_name)
    if os.path.isdir(repo_path):
        # reference: "it seems setup_blang() was already ran; remove the
        # folder to force re-running"
        return None
    if organization == "UBC-Stat-ML" and repo_name in PRECOMPILED_BLANG_LIBS:
        url = f"https://www.stat.ubc.ca/~bouchard/pub/{repo_name}.zip"
        runner(["curl", "-fL", url, "--output", f"{repo_name}.zip"], cwd=base)
        runner(["unzip", f"{repo_name}.zip"], cwd=base)
    else:
        runner(
            ["git", "clone", f"https://github.com/{organization}/{repo_name}.git"],
            cwd=base,
        )
        gradle = os.path.join(repo_path, "gradlew")
        runner([gradle, "installDist"], cwd=repo_path)
    if not os.path.isdir(repo_path):
        # e.g. the zip's top-level directory differs from the repo name —
        # fail HERE rather than later with a confusing "run setup_blang
        # first" from blang_executable (and a half-installed dir that would
        # make re-runs no-op)
        raise FileNotFoundError(
            f"setup completed but {repo_path} does not exist; inspect {base}"
        )
    return repo_path


def blang_executable(
    repo_name: str, qualified_main_class: str, base_dir: Optional[str] = None
) -> list:
    """The ``java -cp <libs>/* <main>`` invocation for a set-up Blang repo
    (reference ``blang_executable``, BlangTarget.jl:169-180); pass the
    result to :class:`~pigeons_tpu_torch.models.stream.BlangTarget`."""
    base = base_dir or settings_folder()
    repo_path = os.path.join(base, repo_name)
    if not os.path.isdir(repo_path):
        raise FileNotFoundError(
            f"run setup_blang({repo_name!r}) first (this only needs to be "
            "done once)"
        )
    libs = os.path.join(repo_path, "build", "install", repo_name, "lib")
    return ["java", "-cp", os.path.join(libs, "*"), qualified_main_class]


def blang_demo_model(
    qualified_main_class: str,
    model_args: Sequence[str] = (),
    seed: int = 1,
    base_dir: Optional[str] = None,
):
    """A canned model from the ``blangDemos`` repository (the reference's
    example set: Ising, sitka phylogenetics, eight schools, unid —
    BlangTarget.jl:54-100) as a runnable target; requires
    ``setup_blang("blangDemos")`` to have run and a JVM on PATH."""
    from .stream import BlangTarget

    cmd = blang_executable("blangDemos", qualified_main_class, base_dir)
    return BlangTarget(cmd + list(model_args), seed=seed)


# ---------------------------------------------------------------------------
# TreePPL (reference TreePPLTarget.jl:244-521)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreePPLBinary:
    """A compiled TreePPL binary plus its compilation metadata (reference
    ``TreePPLBinary``, TreePPLTarget.jl:94-160)."""

    path: str
    container_engine: Optional[str] = None
    img_name: Optional[str] = None
    local_exploration_steps: int = 1
    use_global: bool = True
    record_samples: bool = True
    sampling_period: int = 1
    cps: str = "full"
    align: bool = True
    kernel: bool = True
    drift: float = 1.0
    global_prob: float = 0.0


def _tpplc_args(
    local_exploration_steps, cps, global_prob, drift, sampling_period,
    use_global, kernel, align, record_samples,
) -> list:
    """The ``tpplc`` flag list for a Pigeons-bridge build (reference
    TreePPLTarget.jl:259-276)."""
    if cps not in ("none", "full", "partial"):
        raise ValueError(
            "Only `--cps none`, `--cps full` and `--cps partial` are allowed."
        )
    args = [
        "-m", "mcmc-lightweight",
        "--pigeons",
        "--pigeons-explore-steps", str(local_exploration_steps),
        "--cps", cps,
        "--mcmc-lw-gprob", str(global_prob),
        "--drift", str(drift),
        "--sampling-period", str(sampling_period),
    ]
    for cond, flag in (
        (not use_global, "--pigeons-no-global"),
        (kernel, "--kernel"),
        (align, "--align"),
        (record_samples, "--incremental-printing"),
    ):
        if cond:
            args.append(flag)
    return args


def construct_docker_podman_cmd(
    container_sh_cmd: str,
    img_name: str,
    container_engine: str,
    allow_stdin: bool = False,
    volumes: Sequence = (),
    envs: Optional[Dict[str, str]] = None,
) -> list:
    """``docker``/``podman run`` wrapper (reference TreePPLTarget.jl:466-497).
    ``-i`` keeps std streams open so the bridge protocol can talk to the
    worker inside the container."""
    if container_engine not in ("docker", "podman"):
        raise ValueError(f"Unsupported container engine: {container_engine}")
    cmd = [container_engine, "run", "--rm"]
    if allow_stdin:
        cmd.append("-i")
    for source, target in volumes:
        cmd += ["-v", f"{source}:{target}"]
    for var, val in (envs or {}).items():
        cmd += ["-e", f"{var}={val}"]
    cmd += [img_name, "sh", "-c", container_sh_cmd]
    return cmd


def construct_apptainer_singularity_cmd(
    container_sh_cmd: str,
    img_name: str,
    container_engine: str,
    allow_stdin: bool = False,
    volumes: Sequence = (),
    envs: Optional[Dict[str, str]] = None,
) -> list:
    """``apptainer``/``singularity run`` wrapper (reference
    TreePPLTarget.jl:499-521)."""
    if container_engine not in ("apptainer", "singularity"):
        raise ValueError(f"Unsupported container engine: {container_engine}")
    del allow_stdin  # std streams are inherited by default
    cmd = [container_engine, "run"]
    for source, target in volumes:
        cmd += ["--bind", f"{source}:{target}"]
    for var, val in (envs or {}).items():
        cmd += ["--env", f"{var}={val}"]
    cmd += [img_name, "sh", "-c", container_sh_cmd]
    return cmd


def tppl_compile_model(
    model_path: str,
    bin: str = "out",
    tpplc: str = "tpplc",
    container_engine: Optional[str] = None,
    img_name: Optional[str] = None,
    local_exploration_steps: int = 1,
    use_global: bool = True,
    record_samples: bool = True,
    sampling_period: int = 1,
    cps: str = "full",
    align: bool = True,
    kernel: bool = True,
    drift: float = 1.0,
    global_prob: float = 0.0,
    runner: Callable = _default_runner,
) -> TreePPLBinary:
    """Compile a TreePPL model for the Pigeons bridge — directly via
    ``tpplc`` or inside a container (reference ``tppl_compile_model``,
    TreePPLTarget.jl:244-304)."""
    args = _tpplc_args(
        local_exploration_steps, cps, global_prob, drift, sampling_period,
        use_global, kernel, align, record_samples,
    )
    if container_engine is None:
        runner([tpplc, *args, model_path, "--output", bin])
    elif container_engine in TPPL_SUPPORTED_CONTAINER_ENGINES:
        if img_name is None:
            raise ValueError(
                "You have specified a container engine but have set img_name=None."
            )
        model_dir = os.path.abspath(os.path.dirname(model_path) or ".")
        bin_dir = os.path.abspath(os.path.dirname(bin) or ".")
        sh = (
            f"tpplc {' '.join(args)} /in/{os.path.basename(model_path)} "
            f"--output /out/{os.path.basename(bin)}"
        )
        volumes = [(model_dir, "/in"), (bin_dir, "/out")]
        if container_engine in ("docker", "podman"):
            cmd = construct_docker_podman_cmd(sh, img_name, container_engine, volumes=volumes)
        else:
            cmd = construct_apptainer_singularity_cmd(sh, img_name, container_engine, volumes=volumes)
        runner(cmd)
    else:
        raise ValueError(f"Unsupported container engine: {container_engine}")
    return TreePPLBinary(
        path=os.path.abspath(bin),
        container_engine=container_engine,
        img_name=img_name,
        local_exploration_steps=local_exploration_steps,
        use_global=use_global,
        record_samples=record_samples,
        sampling_period=sampling_period,
        cps=cps,
        align=align,
        kernel=kernel,
        drift=drift,
        global_prob=global_prob,
    )


def tppl_replica_output_path(output_dir: str, replica_index: int) -> str:
    return os.path.join(output_dir, f"replica={replica_index}.json")


def tppl_construct_target(
    binary: TreePPLBinary,
    data_path: str,
    output_dir: Optional[str] = None,
    seed: int = 1,
):
    """A runnable target from a compiled TreePPL binary (reference
    ``tppl_construct_target`` + per-replica ``initialization``,
    TreePPLTarget.jl:165-242): each replica's worker gets ``PPL_SEED`` and,
    when recording, ``PPL_OUTPUT``; containerized binaries run inside the
    engine with ``/in``, ``/data`` (and ``/out``) mounts."""
    from .stream import StreamTarget, java_seed

    if binary.record_samples:
        if output_dir is None:
            raise ValueError(
                "record_samples is true but no output_dir was provided"
            )
        os.makedirs(output_dir, exist_ok=True)

    def env_for(replica_index: int) -> dict:
        envs = {"PPL_SEED": str(java_seed(seed, replica_index))}
        if binary.record_samples:
            envs["PPL_OUTPUT"] = tppl_replica_output_path(output_dir, replica_index)
        return envs

    def build(replica_index: int) -> list:
        envs = dict(env_for(replica_index))
        if binary.container_engine is None:
            return [binary.path, data_path]
        volumes = [
            (os.path.abspath(os.path.dirname(binary.path) or "."), "/in"),
            (os.path.abspath(os.path.dirname(data_path) or "."), "/data"),
        ]
        if "PPL_OUTPUT" in envs:
            out = envs["PPL_OUTPUT"]
            envs["PPL_OUTPUT"] = f"/out/{os.path.basename(out)}"
            volumes.append((os.path.abspath(os.path.dirname(out) or "."), "/out"))
        sh = (
            f"/in/{os.path.basename(binary.path)} "
            f"/data/{os.path.basename(data_path)}"
        )
        if binary.container_engine in ("docker", "podman"):
            return construct_docker_podman_cmd(
                sh, binary.img_name, binary.container_engine,
                allow_stdin=True, volumes=volumes, envs=envs,
            )
        return construct_apptainer_singularity_cmd(
            sh, binary.img_name, binary.container_engine,
            allow_stdin=True, volumes=volumes, envs=envs,
        )

    def env(replica_index: int) -> dict:
        e = dict(os.environ)
        if binary.container_engine is None:
            # env vars ride the process env directly; containerized workers
            # receive them through -e/--env flags in the command instead
            e.update(env_for(replica_index))
        return e

    target = StreamTarget(build, env)
    target.binary = binary
    target.data_path = data_path
    target.output_dir = output_dir
    return target
