"""The port's cluster submission (``pigeons_tpu_torch/submission/cluster.py``)
against the JAX package's: the scripts of every scheduler held line by line
to the JAX package's (the one line that differs launches the port's
``submission/host_main.py``), the rosetta, the presets, the settings file
and the job utilities, with ``subprocess.run`` replaced by a recorder.
Nothing is submitted. The generated launch line itself is run on the CPU
under a faked scheduler environment (an ``srun`` task's for one and two
ranks, none for a one-host PBS job), and its checkpoint is the
one-process run bit for bit."""

import os
import shlex
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pigeons_tpu as J
import pigeons_tpu_torch as T
from pigeons_tpu.submission import cluster as JC
from pigeons_tpu_torch.submission import cluster as TC


def test_rosetta_is_the_jax_one():
    assert TC._ROSETTA == JC._ROSETTA


@pytest.mark.parametrize("system", ["slurm", "pbs", "lsf"])
def test_scripts_are_the_jax_ones_but_the_launcher(system, tmp_path):
    # one host under PBS and LSF: their script starts one process (below)
    n_hosts = 4 if system == "slurm" else 1
    kw = dict(n_hosts=n_hosts, walltime="01:00:00", cpus_per_task=6, memory="32gb", name="run")
    extra = dict(add_to_submission=["-A abc"], environment_modules=["python/3.12", "cuda"])
    j = JC.ClusterSubmission(settings=JC.MPISettings(submission_system=system, **extra), **kw)
    t = TC.ClusterSubmission(settings=TC.MPISettings(submission_system=system, **extra), **kw)
    js = j.script("/x/.inputs.pkl", "/x").splitlines()
    ts = t.script("/x/.inputs.pkl", "/x").splitlines()
    assert len(js) == len(ts)
    launcher = [i for i, (a, b) in enumerate(zip(js, ts)) if a != b]
    assert launcher == [len(ts) - 1]
    here = os.path.join(os.path.dirname(TC.__file__), "host_main.py")
    there = os.path.join(os.path.dirname(JC.__file__), "host_main.py")
    assert ts[-1] == js[-1].replace(there, here) and here in ts[-1]


def test_dry_run_writes_inputs_the_port_host_main_reads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for system, directive in [("slurm", "#SBATCH"), ("pbs", "#PBS"), ("lsf", "#BSUB")]:
        sub = T.ClusterSubmission(n_hosts=4 if system == "slurm" else 1, walltime="01:00:00",
                                  dry_run=True,
                                  settings=T.submission.MPISettings(submission_system=system))
        res = T.pigeons(T.Inputs(target=T.toy_mvn_target(2), device="cpu"), on=sub)
        assert res.job_id is None
        script = open(os.path.join(res.exec_folder, ".submission_script.sh")).read()
        assert directive in script and "pigeons_tpu_torch" in script
        assert T.submission.watch(res) == "(no output yet)"
        from pigeons_tpu_torch.checkpoint import load_object

        inputs = load_object(os.path.join(res.exec_folder, ".inputs.pkl"),
                             os.path.join(res.exec_folder, "immutables"))
        assert inputs.target.dim == 2 and inputs.mesh is None


def test_settings_roundtrip_and_presets(tmp_path, monkeypatch):
    path = str(tmp_path / "settings.json")
    T.submission.MPISettings(submission_system="pbs", environment_modules=["python/3.12"]).save(path)
    loaded = T.submission.MPISettings.load(path)
    assert (loaded.submission_system, loaded.environment_modules) == ("pbs", ["python/3.12"])
    assert T.submission.MPISettings.load(str(tmp_path / "none.json")) == TC.MPISettings()
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "_SETTINGS_PATH", str(tmp_path / mod.__name__ / "s.json"))
    monkeypatch.setattr(TC.MPISettings.save, "__defaults__", (TC._SETTINGS_PATH,))
    monkeypatch.setattr(JC.MPISettings.save, "__defaults__", (JC._SETTINGS_PATH,))
    for name, args in (("setup_compute_canada", ()), ("setup_sockeye", ("abc-123",)),
                       ("setup_tpu_pod", ("v5e-8",)), ("setup_mpi", ())):
        assert getattr(TC, name)(*args).__dict__ == getattr(JC, name)(*args).__dict__, name
        assert os.path.exists(TC._SETTINGS_PATH)


def test_job_utilities_run_the_jax_commands(tmp_path, monkeypatch):
    calls = {}
    res = T.Result(exec_folder=str(tmp_path), job_id="42")

    for mod, name in ((JC, "jax"), (TC, "torch")):
        seen = calls.setdefault(name, [])

        def fake(cmd, **kw):
            seen.append(list(cmd))
            return subprocess.CompletedProcess(cmd, 0, stdout="out", stderr="")

        monkeypatch.setattr(mod.subprocess, "run", fake)
        s = mod.MPISettings(submission_system="lsf")
        assert mod.queue_status(s) == "out" and mod.queue_ncpus_free(s) == "out"
        mod.kill_job(res, s)
    assert calls["jax"] == calls["torch"]
    os.makedirs(tmp_path / "info")
    (tmp_path / "info" / "stdout.txt").write_text("".join(f"line {i}\n" for i in range(50)))
    assert TC.watch(res, lines=3) == JC.watch(res, lines=3) == "line 47\nline 48\nline 49\n"


def test_submit_runs_the_scheduler(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = []

    def fake(cmd, **kw):
        seen.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0, stdout="Submitted 7\n", stderr="")

    monkeypatch.setattr(TC.subprocess, "run", fake)
    sub = T.ClusterSubmission(settings=TC.MPISettings(submission_system="pbs"))
    res = sub.submit(T.Inputs(target=T.toy_mvn_target(2), device="cpu"))
    assert res.job_id == "Submitted 7" and seen[0][0] == "qsub"
    assert seen[0][1] == os.path.join(res.exec_folder, ".submission_script.sh")
    assert J.submission.ClusterSubmission.__dataclass_fields__.keys() == \
        T.ClusterSubmission.__dataclass_fields__.keys()


@pytest.mark.parametrize("system", ["pbs", "lsf"])
def test_one_process_schedulers_refuse_several_hosts(system):
    sub = TC.ClusterSubmission(n_hosts=2, settings=TC.MPISettings(submission_system=system))
    with pytest.raises(ValueError, match="only SLURM's srun"):
        sub.script("/x/.inputs.pkl", "/x")


def test_first_host_and_slurm_task():
    from pigeons_tpu_torch.submission.multihost import first_host, slurm_task

    assert first_host("node[007-009,012],gpu1") == "node007"
    assert first_host("gpu-a[3-4]") == "gpu-a3" and first_host("a1,a2") == "a1"
    env = dict(SLURM_JOB_NODELIST="x[2-3]", SLURM_PROCID="1", SLURM_NTASKS="2",
               SLURM_JOB_ID="12345")
    # jax.distributed's port for a SLURM job: id % 4096 + 61440
    assert slurm_task(env) == ("x2:61497", 2, 1)
    assert slurm_task(dict(env, SLURM_STEP_NODELIST="y7")) == ("y7:61497", 2, 1)
    assert slurm_task({}) is None


def _slurm_job_id():
    """A job id whose port (``id % 4096 + 61440``) is free on this host."""
    for port in range(61440 + os.getpid() % 4000, 65536):
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return 4096 + port - 61440
    raise RuntimeError("no free port in 61440-65535")


@pytest.mark.parametrize("system,ranks", [("slurm", 1), ("slurm", 2), ("pbs", 1)])
def test_generated_launch_line_runs(system, ranks, tmp_path, monkeypatch):
    """The script's last line, run as its scheduler runs it: under SLURM one
    task a rank with ``srun``'s variables (``SLURM_PROCID``, ``SLURM_NTASKS``,
    the node list, the job id), under PBS one process with none. The ranks
    join one gloo group, and the checkpoint they write is the one-process run
    bit for bit."""
    from pigeons_tpu_torch.checkpoint import latest_checkpoint_round, load_pt

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_mesh_worker import inputs_for

    monkeypatch.chdir(tmp_path)
    inputs = inputs_for(T, "smoke")
    sub = T.ClusterSubmission(n_hosts=ranks, dry_run=True,
                              settings=TC.MPISettings(submission_system=system))
    res = sub.submit(inputs)
    script = open(os.path.join(res.exec_folder, ".submission_script.sh")).read()
    line = shlex.split(script.splitlines()[-1])
    if system == "slurm":
        assert line[0] == "srun"
        line = line[1:]
    assert line[0] == "python"
    repo = str(Path(TC.__file__).resolve().parents[2])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SLURM_") and k not in ("RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    job = str(_slurm_job_id())
    procs = []
    for rank in range(ranks):
        task = dict(SLURM_JOB_ID=job, SLURM_JOB_NODELIST="localhost", SLURM_PROCID=str(rank),
                    SLURM_NTASKS=str(ranks)) if system == "slurm" else {}
        procs.append(subprocess.Popen([sys.executable, *line[1:]], env=dict(env, **task),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {ranks}:\n{out[-3000:]}"
    assert latest_checkpoint_round(res.exec_folder) == inputs.n_rounds
    got = load_pt(res.exec_folder, device="cpu")
    want = T.PT(inputs_for(T, "smoke"))
    want.run()
    assert np.array_equal(got.states.numpy(), want.states.numpy())
    assert np.array_equal(got.sample_array(), want.sample_array())
