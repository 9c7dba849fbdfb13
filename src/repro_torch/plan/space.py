"""The declarative plan space (counterpart of ``repro.plan.space``).

A ``PlanPoint`` is one fully-specified execution plan for the distributed
solve: the comm sub-space (strategy x n_chunks x relayout fold x chunk
axis -- what ``core.comm.autotune_comm`` sweeps by brute force) extended
with the plan-level knobs that are otherwise fixed by the caller:
execution ``order_policy``, Hockney ``doubling`` mode, layout
``relayout`` schedule, the Stockham kernel's ``radix`` and the
process-mesh shape (P3DFFT's slab-vs-pencil decomposition knob).
``PlanSpace`` enumerates a validity-constrained cross-product of those
dimensions; the cost model (``plan.costmodel``) ranks the enumeration and
``plan.search`` times only the shortlisted frontier.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

from repro_torch.core.comm import CHUNK_AXES, CommConfig, FOLDS, cfg_label

__all__ = ["ORDER_POLICIES", "DOUBLINGS", "RELAYOUTS", "RADIXES",
           "PlanPoint", "PlanSpace", "mesh_shapes_for"]

ORDER_POLICIES = ("layout", "natural")
DOUBLINGS = ("deferred", "upfront")
RELAYOUTS = ("scheduled", "baseline")
# Stockham kernel radix cap (kernels.fft_stockham): 4 = mixed radix-4/2
# (default), 2 = pure radix-2.  Only the "cuda" engine executes it; the
# "torch" engine's space is constrained to the default.
RADIXES = (4, 2)


@dataclass(frozen=True)
class PlanPoint:
    """One candidate execution plan -- every searchable knob, pinned."""

    strategy: str = "a2a"
    n_chunks: int = 1
    fold: str = "pack"
    chunk_axis: str = "auto"
    order_policy: str = "layout"
    doubling: str = "deferred"
    relayout: str = "scheduled"
    radix: int = 4
    mesh_shape: tuple | None = None    # (p1, p2); None = caller's mesh

    def comm(self) -> CommConfig:
        return CommConfig(self.strategy, self.n_chunks, self.fold,
                          self.chunk_axis)

    def label(self) -> str:
        """Human/cache label.  The comm sub-label matches
        ``core.comm.cfg_label`` exactly so solver-level census and
        plan-level census rows line up."""
        lbl = cfg_label(self.comm())
        for tag, val, default in (("order", self.order_policy, "layout"),
                                  ("dbl", self.doubling, "deferred"),
                                  ("lay", self.relayout, "scheduled"),
                                  ("r", self.radix, 4)):
            if val != default:
                lbl += f"|{tag}={val}"
        if self.mesh_shape is not None:
            lbl += f"|mesh={self.mesh_shape[0]}x{self.mesh_shape[1]}"
        return lbl

    def asdict(self) -> dict:
        return {"strategy": self.strategy, "n_chunks": self.n_chunks,
                "fold": self.fold, "chunk_axis": self.chunk_axis,
                "order_policy": self.order_policy,
                "doubling": self.doubling, "relayout": self.relayout,
                "radix": self.radix,
                "mesh_shape": (list(self.mesh_shape)
                               if self.mesh_shape is not None else None)}

    @classmethod
    def fromdict(cls, d: dict) -> "PlanPoint":
        ms = d.get("mesh_shape")
        return cls(str(d["strategy"]), int(d["n_chunks"]),
                   str(d.get("fold", "pack")),
                   str(d.get("chunk_axis", "auto")),
                   str(d.get("order_policy", "layout")),
                   str(d.get("doubling", "deferred")),
                   str(d.get("relayout", "scheduled")),
                   int(d.get("radix", 4)),
                   None if ms is None else tuple(int(p) for p in ms))


def _chunk_counts(max_chunks: int) -> tuple:
    out, nc = [], 2
    while nc <= max_chunks:
        out.append(nc)
        nc *= 2
    return tuple(out)


@dataclass(frozen=True)
class PlanSpace:
    """Validity-constrained cross-product of plan dimensions.

    Constraints applied by ``points()`` (so ``len(space)`` counts only
    distinct EXECUTABLE plans):

    * monolithic strategies (``a2a``/``fused``) carry ``n_chunks=1`` and
      the default chunk axis -- chunk knobs are meaningless there;
    * ``fold="unpack"`` exists only under ``relayout="scheduled"`` (the
      baseline pipelines never fold a permute into the switch);
    * ``chunk_axis="grid"`` is enumerated only when the space was built
      ``batched`` (without a free batch axis "auto" and "grid" pick the
      same axis);
    * ``radix != 4`` is enumerated only for the ``"cuda"`` engine.
    """

    strategies: tuple = ("a2a", "fused", "pipelined", "overlap")
    chunk_counts: tuple = (2, 4)
    folds: tuple = ("pack",)
    chunk_axes: tuple = ("auto",)
    order_policies: tuple = ("layout",)
    doublings: tuple = ("deferred",)
    relayouts: tuple = ("scheduled",)
    radixes: tuple = (4,)
    mesh_shapes: tuple = (None,)

    @classmethod
    def comm(cls, max_chunks: int = 4, folds=("pack",), batched=False,
             relayout: str = "scheduled") -> "PlanSpace":
        """The comm sub-space one solver instance tunes over -- mirrors
        ``core.comm.autotune_candidates(max_chunks, folds)`` plus the
        chunk-axis dimension when an in-block batch is present."""
        return cls(chunk_counts=_chunk_counts(max_chunks),
                   folds=tuple(folds),
                   chunk_axes=CHUNK_AXES if batched else ("auto",),
                   relayouts=(relayout,))

    @classmethod
    def full(cls, n_devices: int = None, max_chunks: int = 4,
             engine: str = "cuda", batched=False,
             order_policies=ORDER_POLICIES, doublings=("deferred",),
             relayouts=RELAYOUTS, mesh_shapes=None) -> "PlanSpace":
        """The plan-level space ``plan.search.search_plan`` explores."""
        if mesh_shapes is None:
            mesh_shapes = (mesh_shapes_for(n_devices)
                           if n_devices else (None,))
        folds = ("pack", "unpack") if "scheduled" in relayouts else ("pack",)
        return cls(chunk_counts=_chunk_counts(max_chunks), folds=folds,
                   chunk_axes=CHUNK_AXES if batched else ("auto",),
                   order_policies=tuple(order_policies),
                   doublings=tuple(doublings), relayouts=tuple(relayouts),
                   radixes=RADIXES if engine == "cuda" else (4,),
                   mesh_shapes=tuple(mesh_shapes))

    def points(self):
        """Yield every valid ``PlanPoint`` (deduplicated)."""
        for (rel, order, dbl, radix, ms) in itertools.product(
                self.relayouts, self.order_policies, self.doublings,
                self.radixes, self.mesh_shapes):
            folds = self.folds if rel == "scheduled" else ("pack",)
            for fold in folds:
                for strat in self.strategies:
                    chunked = strat in ("pipelined", "overlap")
                    ncs = self.chunk_counts if chunked else (1,)
                    cas = self.chunk_axes if chunked else ("auto",)
                    for nc, ca in itertools.product(ncs, cas):
                        yield PlanPoint(strat, nc, fold, ca, order, dbl,
                                        rel, radix, ms)

    def __len__(self) -> int:
        return sum(1 for _ in self.points())

    def comm_configs(self) -> tuple:
        """The comm sub-space as ``CommConfig`` candidates, in enumeration
        order (what feeds ``autotune_comm``)."""
        seen, out = set(), []
        for pt in self.points():
            cfg = pt.comm()
            if cfg not in seen:
                seen.add(cfg)
                out.append(cfg)
        return tuple(out)


def mesh_shapes_for(n_devices: int, include_slabs: bool = True) -> tuple:
    """Candidate (p1, p2) process grids for ``n_devices`` ranks: every
    factor pair, slab decompositions (a 1-sized axis) included -- P3DFFT's
    observation that the mesh shape is itself a first-order tuning knob.
    Ordered squarest-first (the usual pencil prior)."""
    shapes = []
    for p1 in range(1, n_devices + 1):
        if n_devices % p1 == 0:
            p2 = n_devices // p1
            if include_slabs or (p1 > 1 and p2 > 1):
                shapes.append((p1, p2))
    return tuple(sorted(shapes, key=lambda s: (abs(s[0] - s[1]), s)))
