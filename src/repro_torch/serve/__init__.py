"""Solve-as-a-service: the multi-tenant batched Poisson server
(DESIGN.md #11).

``server``   admission, per-plan-key request coalescing, deadline-bounded
             dynamic batching, the serve loop itself; ``follow``, the
             loop of every other rank of a mesh the server serves
``pool``     warm plan pool with memory-budget eviction
``stats``    per-tenant latency percentiles + degradation records
"""
from .server import (AdmissionError, PlanSpec, PoissonServer, ServerClosed,
                     SolveResult, default_batch_ranks, follow)  # noqa: F401
from .pool import WarmPool  # noqa: F401
from .stats import TenantStats, percentile  # noqa: F401
