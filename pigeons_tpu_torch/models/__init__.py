from .target import Reference, Target
from .toy_mvn import ToyMVNTarget, toy_mvn_target
