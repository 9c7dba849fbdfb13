"""Warm plan pool: constructed solvers for hot plan keys, evicted under a
memory budget.

The pool is the serving layer on top of ``core.solver.get_solver``: it
tracks which plan keys are hot, how many bytes each warm plan pins
(its device Green's functions + field workspaces per served batch rank),
and evicts least-recently-used keys when the budget is exceeded --
including from the module-level LRU (``evict_solver_instance``), so an
evicted plan's Green's functions actually become collectable rather than
living on behind the pool's back.

``acquire`` goes through ``get_solver``, so concurrent workers hitting a
cold key coalesce into ONE construction (the single-flight path) and a
re-acquired evicted key rebuilds transparently.

A key served on a mesh of several ranks has a mirror on every follower
rank (``serve.server.follow``): the server decides with ``lookup``
whether a batch hits or builds, learns every eviction through
``on_evict`` and ``discard``s a build that failed on another rank, so
the followers build, hit and evict exactly when this pool does.
"""
from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from repro_torch.core import solver as sv

__all__ = ["WarmEntry", "WarmPool"]


@dataclass
class WarmEntry:
    solver: object
    est_bytes: int
    last_used: float
    hits: int = 0
    warmed_ranks: set = field(default_factory=set)


def _green_bytes(solver) -> int:
    """Bytes of every device copy of the solver's Green's function: a
    ``PoissonSolver`` keeps one per working dtype (``_green``, a dict
    that gains the float32 copy at the first float32 request), a
    ``DistributedPoissonSolver`` this rank's slice (``_green_dev``)."""
    copies = getattr(solver, "_green", None)
    copies = (copies.values() if isinstance(copies, dict)
              else [getattr(solver, "_green_dev", None)])
    return sum(g.numel() * g.element_size() for g in copies
               if g is not None)


def _estimate_bytes(solver, ranks=()) -> int:
    """Rough resident footprint of one warm plan: the device Green's
    functions (the plan's dominant persistent tensors) plus ~3
    field-sized buffers per served batch rank (input, spectral
    workspace, output) at the solver's working precision (float64 where
    the solver has none: the single-process solver takes the request's).
    An estimate is all eviction needs -- relative sizes order the pool
    correctly."""
    grid = math.prod(solver.input_shape)
    itemsize = getattr(solver, "dtype", torch.float64).itemsize
    per_rank = 3 * grid * itemsize
    return _green_bytes(solver) + per_rank * sum(max(1, r) for r in ranks)


class WarmPool:
    """LRU pool of constructed solvers under ``budget_bytes``.

    ``acquire(key, build)`` returns the cached solver for ``key`` or
    builds (and admits) it; admission evicts LRU entries until the pool
    fits the budget again.  The entry being admitted is never evicted by
    its own admission, so one plan larger than the whole budget still
    serves (the budget then only forbids *keeping* anything else)."""

    def __init__(self, budget_bytes: int | None = None, on_evict=None):
        self.budget_bytes = budget_bytes
        # called with each evicted key, under the pool lock
        self.on_evict = on_evict
        self._entries: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.stats = {"builds": 0, "hits": 0, "evictions": 0,
                      "evicted_bytes": 0}

    def lookup(self, key):
        """The warm solver of ``key`` (counted as a hit), or None."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            e.hits += 1
            e.last_used = time.perf_counter()
            self._entries.move_to_end(key)
            self.stats["hits"] += 1
            return e.solver

    def acquire(self, key, build):
        solver = self.lookup(key)
        if solver is not None:
            return solver
        # build OUTSIDE the pool lock: construction is seconds of planning
        # and Green assembly, and get_solver's single-flight already
        # coalesces concurrent builders of the same key
        solver = build()
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = WarmEntry(solver, _estimate_bytes(solver),
                              time.perf_counter())
                self._entries[key] = e
                self.stats["builds"] += 1
                self._evict_over_budget(keep=key)
            else:                      # a racing admit won; use its entry
                e.hits += 1
                e.last_used = time.perf_counter()
            self._entries.move_to_end(key)
            return e.solver

    def note_rank(self, key, rank: int):
        """Record that ``key`` has served batch rank ``rank`` (grows the
        entry's footprint estimate; the Green's function is re-counted,
        since a first float32 request adds its float32 copy)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or rank in e.warmed_ranks:
                return
            e.warmed_ranks.add(rank)
            e.est_bytes = _estimate_bytes(e.solver, e.warmed_ranks)
            self._evict_over_budget(keep=key)

    def discard(self, key):
        """Drop ``key`` (and its module-LRU entry) without counting an
        eviction: its build is void."""
        with self._lock:
            e = self._entries.pop(key, None)
        if e is not None:
            sv.evict_solver_instance(e.solver)

    def warmed_ranks(self, key) -> tuple:
        with self._lock:
            e = self._entries.get(key)
            return tuple(sorted(e.warmed_ranks)) if e is not None else ()

    def _evict_over_budget(self, keep=None):
        # caller holds the lock
        if self.budget_bytes is None:
            return
        while (len(self._entries) > 1
               and self.total_bytes_locked() > self.budget_bytes):
            victim = next(k for k in self._entries if k != keep)
            e = self._entries.pop(victim)
            self.stats["evictions"] += 1
            self.stats["evicted_bytes"] += e.est_bytes
            sv.evict_solver_instance(e.solver)
            if self.on_evict is not None:
                self.on_evict(victim)

    def total_bytes_locked(self) -> int:
        return sum(e.est_bytes for e in self._entries.values())

    def info(self) -> dict:
        with self._lock:
            return dict(self.stats, size=len(self._entries),
                        total_bytes=self.total_bytes_locked(),
                        budget_bytes=self.budget_bytes,
                        keys=[{"est_bytes": e.est_bytes, "hits": e.hits,
                               "ranks": sorted(e.warmed_ranks)}
                              for e in self._entries.values()])
