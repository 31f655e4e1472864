"""ChildProcess submission: run in a freshly spawned Python process.

Counterpart of ``pigeons_tpu/submission/child_process.py`` (reference
``src/submission/ChildProcess.jl``): write the Inputs to the run's folder,
spawn a script that reads and runs them with checkpoints into that folder,
wait (or not), and return a :class:`~.result.Result` over it. The serial
check of ``checked_round`` runs its re-execution this way.

The child runs on the parent's ``Inputs.device`` (they are in the Inputs it
reads) and inherits the parent's environment, ``CUDA_VISIBLE_DEVICES``
included. It imports the package from the parent's source tree, so it loads
the kernel library the parent built in ``pigeons_tpu_torch/_build/`` (keyed
by a hash of the sources) instead of building it again.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from .result import Result

_LAUNCH_SCRIPT = """\
import sys, time
sys.path.insert(0, {pkg_root!r})
t0 = time.perf_counter()
from pigeons_tpu_torch.checkpoint import load_object
inputs = load_object({inputs_path!r}, {immutables!r})
inputs.checkpoint = True
inputs.checkpoint_folder = {exec_folder!r}
from pigeons_tpu_torch import PT
PT(inputs).run()
print(f"child process: {{inputs.n_rounds}} rounds on {{inputs.device}} in "
      f"{{time.perf_counter() - t0:.3f}} s")
"""


@dataclass
class ChildProcess:
    """``pigeons(inputs, on=ChildProcess(...))``: ``exec_folder`` is the
    run's folder (default: a new one under ``results/all``), ``env`` adds to
    the parent's environment."""

    wait: bool = True
    env: Dict[str, str] = field(default_factory=dict)
    python: str = sys.executable
    exec_folder: Optional[str] = None

    def submit(self, inputs) -> Result:
        from ..checkpoint import dump_object, immutables_dir, next_exec_folder

        exec_folder = os.path.abspath(self.exec_folder or next_exec_folder())
        info = os.path.join(exec_folder, "info")
        os.makedirs(info, exist_ok=True)
        inputs_path = os.path.join(exec_folder, ".inputs.pkl")
        dump_object(inputs, inputs_path, immutables_dir(exec_folder), "the run's Inputs")
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        script_path = os.path.join(exec_folder, ".launch_script.py")
        with open(script_path, "w") as f:
            f.write(_LAUNCH_SCRIPT.format(pkg_root=pkg_root, inputs_path=inputs_path,
                                          immutables=immutables_dir(exec_folder),
                                          exec_folder=exec_folder))
        env = dict(os.environ)
        env.update(self.env)
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        with open(os.path.join(info, "stdout.txt"), "wb") as out, open(
                os.path.join(info, "stderr.txt"), "wb") as err:
            proc = subprocess.Popen([self.python, script_path], env=env, stdout=out, stderr=err)
        wall = None
        if self.wait:
            code = proc.wait()
            wall = time.perf_counter() - t0
            if code != 0:
                with open(os.path.join(info, "stderr.txt")) as f:
                    tail = f.read()[-2000:]
                raise RuntimeError(f"child process exited with {code}; stderr tail:\n{tail}")
        return Result(exec_folder=exec_folder, job_id=str(proc.pid), wall_time_s=wall)
