"""Stream-protocol targets: worker processes explored over stdin/stdout.

Counterpart of ``pigeons_tpu/models/stream.py`` (reference
``src/targets/StreamTarget.jl``): one worker process a lane, speaking a text
protocol, so that a model written in any language can be tempered —

  * ``log_potential(0.6)\\n``  -> the worker answers ``response(-124.23)\\n``,
    the joint log density at ``beta = 0.6``;
  * ``call_sampler!(0.4)\\n``  -> the worker explores its own state at
    ``beta = 0.4`` and answers ``response()\\n``.

The worker owns the state and the path; the run sees only the log density.
The explorer and the reference chain's regeneration both delegate to
``call_sampler!`` (the worker sees ``beta == 0``), swaps exchange chain
indices, and a worker's seed derives from the master seed by replica index
(:func:`java_seed`, ``StreamTarget.jl:100``).

Routing follows the JAX package: request ``i`` of a batch goes to worker
``i``, the lane's index in the flat batch of ``R * N`` lanes (with
``n_replicates = R > 1`` there are ``R * N`` workers: the JAX runtime does
not refuse replicates, whatever its module docstring says; ROADMAP §3). A
batch fans out to the workers from a thread pool, so a scan costs a few
worker round trips, not one a lane. Each evaluation copies the lanes' betas
to the host and the densities back to the lanes' device; the states (one
dummy coordinate a lane) stay where the run keeps them.

``BlangTarget`` / ``TreePPLTarget`` build the worker commands of the two
ecosystems the reference bridges (``src/targets/BlangTarget.jl:14-42``,
``src/targets/TreePPLTarget.jl``). A pure-Python demo worker is
``pigeons_tpu_torch.models.stream_worker_demo``; :func:`example_worker`
builds the C++ one of ``examples/native/stream_worker.cpp``.
"""

from __future__ import annotations

import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.base import Explorer, StepOut, _zero_stats
from .target import Reference, Target


def java_seed(seed: int, replica_index: int) -> int:
    """Positive 63-bit worker seed derived from (master seed, replica index)
    (``StreamTarget.jl:100``: the sign bit dropped for Java)."""
    z = (seed * 0x9E3779B97F4A7C15 + replica_index + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


class _Worker:
    """One child process and the stdin/stdout protocol (an expect-style scan
    for ``response(`` ... ``)``, tolerating other output in between)."""

    def __init__(self, command: Sequence[str], echo: bool = False, env=None):
        self.proc = subprocess.Popen(list(command), stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                     text=True, bufsize=1, env=env)
        self.lock = threading.Lock()
        self.echo = echo

    def invoke(self, request: str) -> str:
        """Send one command line, scan stdout up to ``response(...)`` and
        return the text between the parentheses."""
        with self.lock:
            self.proc.stdin.write(request + "\n")
            self.proc.stdin.flush()
            buf = ""
            while True:
                ch = self.proc.stdout.read(1)
                if ch == "":
                    raise RuntimeError(f"stream worker exited (rc={self.proc.poll()}) while "
                                       f"answering {request!r}")
                buf += ch
                start = buf.find("response(")
                if start < 0:
                    continue
                end = buf.find(")", start)
                if end < 0:
                    continue
                # the text before the response, not the newline that ended the
                # previous one (the JAX worker echoes that too: a blank line an answer)
                if self.echo and buf[:start].strip():
                    print(buf[:start], end="")
                return buf[start + len("response("):end]

    def close(self) -> None:
        try:
            if self.proc.stdin is not None:
                self.proc.stdin.close()
            self.proc.terminate()
            self.proc.wait(timeout=5)
        except Exception:
            try:
                self.proc.kill()
            except Exception:
                pass


class _WorkerPool:
    """Workers spawned on first use, one a lane index, driven concurrently."""

    def __init__(self, command_builder: Callable[[int], Sequence[str]],
                 env_builder: Optional[Callable[[int], dict]] = None):
        self.command_builder = command_builder
        self.env_builder = env_builder  # replica index -> process environment
        self.workers: dict[int, _Worker] = {}
        self.pool: Optional[ThreadPoolExecutor] = None
        self._spawn_lock = threading.Lock()

    def worker(self, i: int) -> _Worker:
        with self._spawn_lock:
            if i not in self.workers:
                # replica 1's informational output is echoed, as in the
                # reference (StreamTarget.jl:118-122)
                env = self.env_builder(i) if self.env_builder is not None else None
                self.workers[i] = _Worker(self.command_builder(i), echo=(i == 0), env=env)
            return self.workers[i]

    def invoke_batch(self, requests: list[str]) -> list[str]:
        if self.pool is None:
            self.pool = ThreadPoolExecutor(max_workers=min(64, max(1, len(requests))))
        futures = [self.pool.submit(self.worker(i).invoke, req) for i, req in enumerate(requests)]
        return [f.result() for f in futures]

    def close(self) -> None:
        for w in self.workers.values():
            w.close()
        self.workers.clear()
        if self.pool is not None:
            self.pool.shutdown(wait=False)
            self.pool = None


def _betas(beta: torch.Tensor) -> np.ndarray:
    """The lanes' betas on the host, rows ``[..., B]`` as a 2-D array."""
    b = beta.detach().cpu().numpy().astype(np.float64)
    return b.reshape(-1, b.shape[-1]) if b.ndim else b.reshape(1, 1)


def _densities(target: "StreamTarget", command: str, rows: np.ndarray, like: torch.Tensor):
    """``command(beta)`` of every lane, one batch a row; the answers as
    float32 densities on ``like``'s device in ``like``'s shape."""
    out = np.array([[float(s) for s in target.pool.invoke_batch(
        [f"{command}({float(v)!r})" for v in row])] for row in rows], np.float32)
    return torch.from_numpy(out).reshape(like.shape).to(like.device)


class StreamPath:
    """Path whose interpolation lives inside the workers: only beta crosses
    the bridge (reference ``StreamPath``, ``StreamTarget.jl:54-63``).
    ``log_density(x, beta)`` routes by lane: ``beta [..., B]``'s column
    ``i`` goes to worker ``i``, each row as one batch."""

    has_iid_reference = False

    def __init__(self, target: "StreamTarget"):
        self._target = target

    def log_density(self, x, beta):
        del x  # the worker owns the state
        beta = torch.as_tensor(beta)
        return _densities(self._target, "log_potential", _betas(beta), beta)


class StreamExplorer(Explorer):
    """Delegates exploration to the workers: one ``call_sampler!(beta)`` a
    lane a scan, then one ``log_potential(beta)`` refresh (reference
    ``step!(explorer::StreamTarget, ...)``, ``StreamTarget.jl:68-73``)."""

    extra_names: tuple = ()

    def __init__(self, target: "StreamTarget"):
        self._target = target

    def step_batched(self, keys, xs, betas, path, isvar=None, ref_params=None, lp=None,
                     chain_params=None, scan_idx=None) -> StepOut:
        rows = _betas(betas)
        target = self._target
        target.pool.invoke_batch([f"call_sampler!({float(v)!r})" for v in rows[0]])
        lp_new = _densities(target, "log_potential", rows, betas)
        a, n, s = _zero_stats(xs.shape[0], xs.device)
        return StepOut(xs, lp_new, a + 1.0, n + 1.0, s + 1.0)


class StreamTarget(Target):
    """Temper a model implemented by external worker processes.

    ``command_builder(replica_index) -> argv list``; :func:`java_seed` gives
    a per-replica seed to pass on. The run's state is one dummy coordinate,
    so traces and moments carry only the log density, as in the reference
    (``StreamState.jl:23-24``)."""

    dim = 1
    host_evaluated = True

    def __init__(self, command_builder: Callable[[int], Sequence[str]],
                 env_builder: Optional[Callable[[int], dict]] = None):
        self._command_builder = command_builder
        self._env_builder = env_builder
        self.pool = _WorkerPool(command_builder, env_builder)

    def log_density(self, x):
        return StreamPath(self).log_density(x, torch.ones(x.shape[:-1], device=x.device))

    def default_reference(self) -> Reference:
        # the worker owns the path: a reference for the interface only,
        # never evaluated (create_path is overridden)
        return Reference(log_density=lambda x: torch.zeros(x.shape[:-1], device=x.device),
                         sample_iid=None)

    def create_path(self, reference):
        del reference
        return StreamPath(self)

    def default_explorer(self):
        return StreamExplorer(self)

    def initialization(self, keys):
        return torch.zeros(keys.shape[:-1] + (1,), dtype=torch.float32, device=keys.device)

    def close(self) -> None:
        """Dispose of the worker processes (reference
        ``kill_child_processes``, ``StreamTarget.jl:28-36``)."""
        self.pool.close()

    def __getstate__(self):
        return {"_command_builder": self._command_builder, "_env_builder": self._env_builder}

    def __setstate__(self, state):
        self._command_builder = state["_command_builder"]
        self._env_builder = state.get("_env_builder")
        self.pool = _WorkerPool(self._command_builder, self._env_builder)


def example_worker(name: str = "stream_worker") -> str:
    """The repository's compiled worker ``examples/native/<name>.cpp``, built
    with ``g++ -O2 -std=c++17`` on first use; returns the binary's path."""
    from .native import build_example

    def build(src, out):
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", out, src], check=True,
                       capture_output=True)

    return build_example(name, build)


def kill_child_processes(pt) -> None:
    """Close the worker pool of a finished run (reference
    ``StreamTarget.jl:28-36``)."""
    target = pt.inputs.target
    if isinstance(target, StreamTarget):
        target.close()


class BlangTarget(StreamTarget):
    """A Blang (JVM) model speaking the Pigeons bridge protocol (reference
    ``src/targets/BlangTarget.jl:14-42``). ``command`` is the compiled
    model's invocation, e.g. ``["java", "pkg.MyModel", ...]``; the bridge
    engine's flags and the per-replica seed are appended."""

    def __init__(self, command: Sequence[str], seed: int = 1):
        base = list(command)

        def build(replica_index: int):
            return base + [
                "--experimentConfigs.resultsHTMLPage", "false",
                "--experimentConfigs.saveStandardStreams", "false",
                "--engine", "blang.engines.internals.factories.Pigeons",
                "--engine.random", str(java_seed(seed, replica_index)),
            ]

        super().__init__(build)


class TreePPLTarget(StreamTarget):
    """A compiled TreePPL binary speaking the protocol (reference
    ``src/targets/TreePPLTarget.jl``); the seed rides the ``PPL_SEED``
    environment variable (``TreePPLTarget.jl:166-167``)."""

    def __init__(self, command: Sequence[str], seed: int = 1):
        base = list(command)
        self._seed = seed

        def build(replica_index: int):
            return base

        def env(replica_index: int):
            e = dict(os.environ)
            e["PPL_SEED"] = str(java_seed(seed, replica_index))
            return e

        super().__init__(build, env)
