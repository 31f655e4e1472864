from .library import MVN, Banana, Funnel, banana, funnel, mvn_target
from .target import Reference, StandardNormalReference, Target
from .toy_mvn import ToyMVNTarget, toy_mvn_target
from .test_swapper import TestSwapper
