"""Resilient solve runtime (DESIGN.md #10), the port's counterpart of
``repro.runtime``.

``faults``      deterministic fault injection (the chaos-test substrate)
``resilience``  graceful-degradation ladder, retry policy, SolveError
``health``      numerical health guards (NaN/Inf, FD residual)

The reference's ``abft`` (algorithm-based fault tolerance) is not ported
yet.
"""
from . import faults, health, resilience  # noqa: F401

from .resilience import SolveError  # noqa: F401

__all__ = ["faults", "health", "resilience", "SolveError"]
