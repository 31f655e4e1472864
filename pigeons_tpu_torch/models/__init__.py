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
from .library import (
    MVN,
    Banana,
    Funnel,
    banana,
    eight_schools,
    funnel,
    hierarchical_normal,
    logistic_regression,
    mvn_target,
    unid_analytic_log_z,
    unid_target,
)
from .target import CustomPath, CustomPathTarget, Reference, StandardNormalReference, Target
from .toy_mvn import ToyMVNTarget, toy_mvn_target
from .test_swapper import TestSwapper
