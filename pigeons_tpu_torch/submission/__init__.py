"""Submission backends: ``pigeons(inputs, on=ChildProcess(...))``.

Counterpart of ``pigeons_tpu/submission`` for one backend, the child
process; the cluster and multi-host backends are ROADMAP queue 1, items 15
and 16."""

from .child_process import ChildProcess
from .result import Result

__all__ = ["ChildProcess", "Result"]
