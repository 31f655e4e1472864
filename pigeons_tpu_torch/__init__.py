"""pigeons_tpu_torch: non-reversible parallel tempering in PyTorch, with hand
written CUDA kernels for Hopper (H100).

The port of ``pigeons_tpu`` (JAX on a TPU), held bit for bit or within
stated tolerances against it by ``tests/test_torch_*.py``. It imports torch
and numpy only; kernels build with ``nvcc`` at first use
(``pigeons_tpu_torch/_build.py``).
"""

from .inputs import Inputs
from .models import StandardNormalReference, banana, funnel, mvn_target, toy_mvn_target
from .ops import NoOpExplorer, SliceSamplerCUDA, ToyExplorer
from .paths import ScaledPrecisionNormalPath, toy_mvn_path
from .pt import PT, RoundReport, pigeons
from .schedule import Schedule, equally_spaced_schedule

__all__ = [
    "Inputs",
    "NoOpExplorer",
    "PT",
    "RoundReport",
    "Schedule",
    "ScaledPrecisionNormalPath",
    "SliceSamplerCUDA",
    "StandardNormalReference",
    "ToyExplorer",
    "banana",
    "equally_spaced_schedule",
    "funnel",
    "mvn_target",
    "pigeons",
    "toy_mvn_path",
    "toy_mvn_target",
]
