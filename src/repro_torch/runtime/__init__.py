"""Resilient solve runtime (DESIGN.md #10, #13), the port's counterpart of
``repro.runtime``.

``faults``      deterministic fault injection (the chaos-test substrate)
``resilience``  graceful-degradation ladder, retry policy, SolveError
``health``      numerical health guards (NaN/Inf, FD residual)
``abft``        algorithm-based fault tolerance (checksummed stages,
                wire checksums, the Freivalds sandwich)
"""
from . import abft, faults, health, resilience  # noqa: F401

from .abft import IntegrityError  # noqa: F401
from .resilience import SolveError  # noqa: F401

__all__ = ["abft", "faults", "health", "resilience", "IntegrityError",
           "SolveError"]
