"""Per-tenant serving observability: latency percentiles + degradations.

Every completed request contributes one ``RequestRecord`` to its tenant's
``TenantStats``; ``summary()`` renders the p50/p95/p99 latency split into
queue wait vs solve time, the mean coalesced-batch occupancy, and the
degradation records the resilience ladder attributed to the tenant's
batches -- the per-tenant view of DESIGN.md #10's structured
``stats["degradations"]``.

Percentiles are nearest-rank over a bounded reservoir (the most recent
``capacity`` samples): a serve process that has handled millions of
requests keeps O(capacity) memory and the percentiles track the *current*
tail, which is what an operator watching an SLO wants.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass, field

__all__ = ["RequestRecord", "TenantStats", "percentile"]


def percentile(samples, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of an iterable of floats."""
    xs = sorted(samples)
    if not xs:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[min(rank, len(xs)) - 1]


@dataclass(frozen=True)
class RequestRecord:
    """One served request, as the tenant experienced it."""

    request_id: int
    queue_wait_s: float      # admission -> batch flush
    solve_s: float           # batched solve wall time (shared by the batch)
    total_s: float           # admission -> response ready
    batch_size: int          # live requests coalesced into the solve
    padded_to: int           # batch rank the batch was padded to
    degradations: tuple = () # ladder records attributed to this batch


@dataclass
class TenantStats:
    """Bounded per-tenant accounting; thread-safe."""

    tenant: str
    capacity: int = 4096
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)
    _records: deque = field(default=None, repr=False)
    served: int = 0
    rejected: int = 0
    failed: int = 0
    degradations: list = field(default_factory=list)

    def __post_init__(self):
        if self._records is None:
            self._records = deque(maxlen=self.capacity)

    def record(self, rec: RequestRecord):
        with self._lock:
            self.served += 1
            self._records.append(rec)
            self.degradations.extend(rec.degradations)

    def record_rejected(self):
        with self._lock:
            self.rejected += 1

    def record_failed(self):
        with self._lock:
            self.failed += 1

    def summary(self) -> dict:
        with self._lock:
            recs = list(self._records)
            out = {"tenant": self.tenant, "served": self.served,
                   "rejected": self.rejected, "failed": self.failed,
                   "degradations": list(self.degradations)}
        if recs:
            total = [r.total_s for r in recs]
            out.update(
                p50_ms=percentile(total, 50) * 1e3,
                p95_ms=percentile(total, 95) * 1e3,
                p99_ms=percentile(total, 99) * 1e3,
                mean_queue_wait_ms=sum(r.queue_wait_s for r in recs)
                / len(recs) * 1e3,
                mean_solve_ms=sum(r.solve_s for r in recs) / len(recs) * 1e3,
                mean_batch_occupancy=sum(r.batch_size for r in recs)
                / len(recs),
            )
        return out
