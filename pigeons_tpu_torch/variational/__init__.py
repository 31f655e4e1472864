from .gaussian import GaussianReference

__all__ = ["GaussianReference"]
