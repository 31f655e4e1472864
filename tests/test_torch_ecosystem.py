"""The port's ecosystem provisioning (``pigeons_tpu_torch/models/ecosystem.py``)
against the JAX package's: the JAX file's cases (``tests/test_ecosystem.py``)
with a recording runner in place of the commands, and every command and
worker command the port builds held equal, element for element, to the one
the JAX package builds from the same arguments. Nothing is executed."""

import os

import pytest

from pigeons_tpu.models import ecosystem as JE
from pigeons_tpu.models import stream as JS
from pigeons_tpu_torch.models import ecosystem as TE
from pigeons_tpu_torch.models import stream as TS


class Recorder:
    """Records commands and makes the folder that a clone or an unzip would
    make, so that ``setup_blang``'s check after the install passes."""

    def __init__(self, creates=None):
        self.calls = []
        self.creates = creates

    def __call__(self, cmd, cwd=None):
        self.calls.append((list(cmd), cwd))
        if self.creates and cmd[0] in ("git", "unzip"):
            os.makedirs(self.creates, exist_ok=True)


@pytest.mark.parametrize("repo,org", [("blangDemos", "UBC-Stat-ML"), ("myModels", "someone")])
def test_setup_blang_runs_the_jax_commands(tmp_path, repo, org):
    calls = []
    for mod, sub in ((JE, "jax"), (TE, "torch")):
        base = tmp_path / sub
        r = Recorder(creates=str(base / repo))
        path = mod.setup_blang(repo, organization=org, base_dir=str(base), runner=r)
        assert path == str(base / repo)
        assert mod.setup_blang(repo, organization=org, base_dir=str(base), runner=r) is None
        calls.append([(c, None if cwd is None else os.path.relpath(cwd, base))
                      for c, cwd in r.calls])
    # the gradle wrapper's path lies under each base folder
    norm = [[([a.replace(str(tmp_path / s), "") for a in c], cwd) for c, cwd in k]
            for k, s in zip(calls, ("jax", "torch"))]
    assert norm[0] == norm[1]
    if org == "UBC-Stat-ML":
        assert calls[1][0][0][:2] == ["curl", "-fL"]
    else:
        assert calls[1][0][0] == ["git", "clone", "https://github.com/someone/myModels.git"]


def test_setup_blang_detects_broken_install(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        TE.setup_blang("blangDemos", base_dir=str(tmp_path), runner=Recorder())


def test_blang_executable_and_demo_model(tmp_path):
    with pytest.raises(FileNotFoundError, match="setup_blang"):
        TE.blang_executable("blangDemos", "demo.Main", base_dir=str(tmp_path))
    (tmp_path / "blangDemos").mkdir()
    cmd = TE.blang_executable("blangDemos", "demo.Main", base_dir=str(tmp_path))
    assert cmd == JE.blang_executable("blangDemos", "demo.Main", base_dir=str(tmp_path))
    t = TE.blang_demo_model("demo.Main", ["--model.x", "1"], seed=3, base_dir=str(tmp_path))
    j = JE.blang_demo_model("demo.Main", ["--model.x", "1"], seed=3, base_dir=str(tmp_path))
    assert isinstance(t, TS.BlangTarget)
    assert t._command_builder(4) == j._command_builder(4)


@pytest.mark.parametrize("kw", [
    dict(local_exploration_steps=10, sampling_period=10, kernel=True, drift=0.01),
    dict(use_global=False, record_samples=False, align=False, kernel=False, cps="partial"),
    dict(container_engine="docker", img_name="img:1"),
    dict(container_engine="apptainer", img_name="img.sif", global_prob=0.5),
])
def test_tppl_compile_model_builds_the_jax_command(tmp_path, kw):
    cmds = []
    for mod in (JE, TE):
        r = Recorder()
        binary = mod.tppl_compile_model(str(tmp_path / "m.tppl"), bin=str(tmp_path / "out"),
                                        runner=r, **kw)
        cmds.append((r.calls, binary.__dict__ if hasattr(binary, "__dict__") else None))
    assert cmds[0] == cmds[1]


def test_tppl_compile_rejects_bad_cps_and_engine():
    with pytest.raises(ValueError, match="cps"):
        TE.tppl_compile_model("m.tppl", cps="bogus", runner=Recorder())
    with pytest.raises(ValueError, match="img_name"):
        TE.tppl_compile_model("m.tppl", container_engine="docker", runner=Recorder())
    with pytest.raises(ValueError, match="container engine"):
        TE.tppl_compile_model("m.tppl", container_engine="lxc", img_name="x", runner=Recorder())


@pytest.mark.parametrize("engine", ["docker", "podman", "apptainer", "singularity"])
def test_container_commands_are_the_jax_ones(engine):
    kw = dict(allow_stdin=True, volumes=[("/a", "/in"), ("/b", "/out")], envs={"PPL_SEED": "7"})
    name = ("construct_docker_podman_cmd" if engine in ("docker", "podman")
            else "construct_apptainer_singularity_cmd")
    assert getattr(TE, name)("./bin d.json", "img", engine, **kw) == \
        getattr(JE, name)("./bin d.json", "img", engine, **kw)
    other = "apptainer" if engine in ("docker", "podman") else "docker"
    with pytest.raises(ValueError, match="Unsupported container engine"):
        getattr(TE, name)("./bin", "img", other)


@pytest.mark.parametrize("engine", [None, "docker", "singularity"])
def test_tppl_construct_target_builds_the_jax_workers(tmp_path, engine):
    kw = dict(path=str(tmp_path / "bin"), record_samples=True, container_engine=engine,
              img_name=None if engine is None else "img:1")
    t = TE.tppl_construct_target(TE.TreePPLBinary(**kw), str(tmp_path / "d.json"),
                                 output_dir=str(tmp_path / "o"), seed=3)
    j = JE.tppl_construct_target(JE.TreePPLBinary(**kw), str(tmp_path / "d.json"),
                                 output_dir=str(tmp_path / "o"), seed=3)
    assert (tmp_path / "o").is_dir()
    for i in (0, 2):
        assert t._command_builder(i) == j._command_builder(i)
        te, je = t._env_builder(i), j._env_builder(i)
        assert {k: v for k, v in te.items() if k.startswith("PPL_")} == \
            {k: v for k, v in je.items() if k.startswith("PPL_")}
    if engine is None:
        assert t._env_builder(2)["PPL_SEED"] == str(JS.java_seed(3, 2))
        assert t._env_builder(2)["PPL_OUTPUT"].endswith("replica=2.json")
    assert t.binary == TE.TreePPLBinary(**kw) and t.output_dir == str(tmp_path / "o")


def test_tppl_record_without_output_dir_rejected(tmp_path):
    binary = TE.TreePPLBinary(path=str(tmp_path / "bin"), record_samples=True)
    with pytest.raises(ValueError, match="output_dir"):
        TE.tppl_construct_target(binary, str(tmp_path / "d.json"))
