"""pigeons_tpu_torch: non-reversible parallel tempering in PyTorch, with hand
written CUDA kernels for Hopper (H100).

The port of ``pigeons_tpu`` (JAX on a TPU), held bit for bit or within
stated tolerances against it by ``tests/test_torch_*.py``. It imports torch
and numpy only; kernels build with ``nvcc`` at first use
(``pigeons_tpu_torch/_build.py``).
"""

from . import diagnostics, plots
from .adaptation import communication_barriers, optimal_schedule
from .checkpoint import increment_n_rounds, load_pt, process_sample
from .checks import ParallelismInvarianceError, check_against_serial
from .diagnostics import ess, reports_dataframe, split_rhat, summary, swap_prs_dataframe
from .device_source import DeviceSource, SourceCoordTarget, SourceLikelihood, SourceTarget
from .evidence import stepping_stone, stepping_stone_pair
from .inputs import Inputs
from .invariance_test import InvarianceTestResult, invariance_test
from .models import (
    BayesianModel,
    BlangTarget,
    CustomPath,
    CustomPathTarget,
    ExternalTarget,
    IsingTarget,
    LazyTarget,
    NativeTarget,
    PoissonCount,
    StandardNormalReference,
    StanTarget,
    StreamTarget,
    TestSwapper,
    TreePPLTarget,
    banana,
    bernoulli_target,
    binary_mixture_target,
    eight_schools,
    funnel,
    hierarchical_normal,
    ising_target,
    logistic_regression,
    mrna_target,
    mvn_target,
    poisson_count_target,
    stan_target,
    toy_mvn_target,
    unid_target,
)
from .ops import (
    AAPS,
    MALA,
    NUTS,
    AutoMALA,
    BinaryGibbs,
    Compose,
    DiagonalPreconditioner,
    IdentityPreconditioner,
    Mix,
    MixDiagonalPreconditioner,
    NoOpExplorer,
    ScanMix,
    SliceSampler,
    SliceSamplerCUDA,
    ToyExplorer,
    leapfrog,
    log_joint,
)
from .paths import InterpolatingPath, ScaledPrecisionNormalPath, VariationalPath, toy_mvn_path

# The JAX package's name for its kernel-backed slice sampler, so that a script
# written for it imports unchanged: the two constructors share w, p,
# n_passes, max_iter, coord_deltas and parallel_coords with the same defaults
# (tests/test_torch_api_surface.py); the Pallas tiling and interpreter options
# and the masks, which the CUDA kernels do not take, raise a TypeError here.
SliceSamplerPallas = SliceSamplerCUDA
from .pt import PT, RoundReport, pigeons
from .schedule import Schedule, equally_spaced_schedule
from .submission import ChildProcess, ClusterSubmission, MultiHostLauncher, Result, ThisProcess
from .variational import GaussianReference

__all__ = [
    "DeviceSource",
    "SourceCoordTarget",
    "SourceLikelihood",
    "SourceTarget",
    "AAPS",
    "AutoMALA",
    "BayesianModel",
    "BinaryGibbs",
    "BlangTarget",
    "ChildProcess",
    "ClusterSubmission",
    "Compose",
    "CustomPath",
    "CustomPathTarget",
    "DiagonalPreconditioner",
    "ExternalTarget",
    "GaussianReference",
    "IdentityPreconditioner",
    "Inputs",
    "InterpolatingPath",
    "InvarianceTestResult",
    "IsingTarget",
    "LazyTarget",
    "MALA",
    "Mix",
    "MixDiagonalPreconditioner",
    "MultiHostLauncher",
    "NUTS",
    "NativeTarget",
    "NoOpExplorer",
    "PT",
    "ParallelismInvarianceError",
    "PoissonCount",
    "Result",
    "RoundReport",
    "Schedule",
    "ScaledPrecisionNormalPath",
    "ScanMix",
    "SliceSampler",
    "SliceSamplerCUDA",
    "SliceSamplerPallas",
    "StandardNormalReference",
    "StanTarget",
    "StreamTarget",
    "TestSwapper",
    "ThisProcess",
    "ToyExplorer",
    "TreePPLTarget",
    "VariationalPath",
    "banana",
    "bernoulli_target",
    "binary_mixture_target",
    "check_against_serial",
    "communication_barriers",
    "diagnostics",
    "eight_schools",
    "equally_spaced_schedule",
    "ess",
    "funnel",
    "hierarchical_normal",
    "increment_n_rounds",
    "invariance_test",
    "ising_target",
    "leapfrog",
    "load_pt",
    "log_joint",
    "logistic_regression",
    "mrna_target",
    "mvn_target",
    "optimal_schedule",
    "pigeons",
    "plots",
    "poisson_count_target",
    "process_sample",
    "reports_dataframe",
    "split_rhat",
    "stan_target",
    "stepping_stone",
    "stepping_stone_pair",
    "summary",
    "swap_prs_dataframe",
    "toy_mvn_path",
    "toy_mvn_target",
    "unid_target",
]
