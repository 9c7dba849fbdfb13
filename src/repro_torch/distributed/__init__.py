"""The pencil-distributed solve on ``torch.distributed`` (counterpart of
``repro.distributed``)."""
from .pencil import DistributedPoissonSolver  # noqa: F401

__all__ = ["DistributedPoissonSolver"]
