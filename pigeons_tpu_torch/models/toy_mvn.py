"""Toy multivariate normal target = the scaled-precision normal path.

Counterpart of ``pigeons_tpu/models/toy_mvn.py`` (reference
``src/targets/toy_mvn_target.jl``): the target is the analytic path,
iid-sampleable at every beta, explored by default with the iid ToyExplorer.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..paths import ScaledPrecisionNormalPath, toy_mvn_path
from .target import Reference, Target


@dataclass(frozen=True)
class ToyMVNTarget(Target):
    dim: int

    @property
    def path(self) -> ScaledPrecisionNormalPath:
        return toy_mvn_path(self.dim)

    def log_density(self, x):
        return self.path.log_density(x, 1.0)

    def default_reference(self) -> Reference:
        p = self.path
        return Reference(
            log_density=lambda x: p.log_density(x, 0.0),
            sample_iid=p.sample_reference,
        )

    def create_path(self, reference: Reference) -> ScaledPrecisionNormalPath:
        return self.path

    def default_explorer(self):
        from ..ops import ToyExplorer

        return ToyExplorer(self.path)

    def initialization(self, keys):
        return self.path.sample_reference(keys)


def toy_mvn_target(dim: int) -> ToyMVNTarget:
    return ToyMVNTarget(dim)
