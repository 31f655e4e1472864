"""Submission backends: ``pigeons(inputs, on=...)``.

Counterpart of ``pigeons_tpu/submission``: this process, a child process
and the multi-process launcher; the cluster back ends are ROADMAP queue 1,
item 16."""

from .child_process import ChildProcess
from .multihost import MultiHostLauncher, ThisProcess
from .result import Result

__all__ = ["ChildProcess", "MultiHostLauncher", "Result", "ThisProcess"]
