from .base import Explorer, NoOpExplorer, StepOut, ToyExplorer
from .cuda_slice import SliceSamplerCUDA
from .slice_sampler import SliceSampler
