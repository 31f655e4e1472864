from .base import Explorer, NoOpExplorer, StepOut, ToyExplorer
from .cuda_slice import SliceSamplerCUDA
from .slice_sampler import SliceSampler
from .automala import AutoMALA
from .hamiltonian import (DiagonalPreconditioner, IdentityPreconditioner, MixDiagonalPreconditioner,
                          leapfrog, log_joint)
from .mala import MALA
