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
from .target import CustomPath, CustomPathTarget, Reference, StandardNormalReference, Target
from .toy_mvn import ToyMVNTarget, toy_mvn_target
from .test_swapper import TestSwapper
