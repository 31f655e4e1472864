from .bayesian import BayesianModel
from .distributions import (
    Beta,
    Cauchy,
    Exponential,
    HalfCauchy,
    LogNormal,
    Normal,
    Uniform,
    bernoulli_logpmf,
    binomial_logpmf,
    normal_logpdf,
)
from .ecosystem import (
    TreePPLBinary,
    blang_demo_model,
    blang_executable,
    setup_blang,
    tppl_compile_model,
    tppl_construct_target,
)
from .external import ExternalTarget, LazyTarget, register_lazy_target
from .ising import IsingTarget, ising_target
from .library import (
    MVN,
    Banana,
    BinaryMixture,
    Funnel,
    PoissonCount,
    banana,
    bernoulli_target,
    binary_mixture_target,
    eight_schools,
    funnel,
    hierarchical_normal,
    logistic_regression,
    mrna_target,
    mvn_target,
    poisson_count_target,
    unid_analytic_log_z,
    unid_target,
)
from .native import NativeTarget, compile_native_model
from .stan import StanTarget, load_stan_data, stan_target
from .stream import (
    BlangTarget,
    StreamExplorer,
    StreamTarget,
    TreePPLTarget,
    java_seed,
    kill_child_processes,
)
from .target import CustomPath, CustomPathTarget, Reference, StandardNormalReference, Target
from .toy_mvn import ToyMVNTarget, toy_mvn_target
from .test_swapper import TestSwapper
