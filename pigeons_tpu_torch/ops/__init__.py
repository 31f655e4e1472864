from .base import Explorer, NoOpExplorer, StepOut, ToyExplorer
from .binary_gibbs import BinaryGibbs
from .cuda_slice import SliceSamplerCUDA
from .slice_sampler import SliceSampler
from .automala import AutoMALA
from .aaps import AAPS
from .combinators import Compose, Mix, ScanMix
from .hamiltonian import (DiagonalPreconditioner, IdentityPreconditioner, MixDiagonalPreconditioner,
                          leapfrog, log_joint)
from .mala import MALA
from .nuts import NUTS
