"""Cost-model-guided frontier search over the plan space (counterpart of
``repro.plan.search``).

Two levels:

* ``guided_comm_candidates`` -- the in-solver path behind
  ``DistributedPoissonSolver(comm="auto", autotune_search="guided")`` (the
  default): rank the comm sub-space (strategy x n_chunks x fold x
  chunk_axis) with the analytic predictor, drop chunked candidates whose
  solve-time zero-padding already costs more than the best monolithic
  plan, and hand only the shortlisted frontier to
  ``core.comm.autotune_comm`` (which keeps its budget/census/cache
  machinery -- the shortlist labels are part of the cache identity, so a
  model change can never replay a stale winner).  It is a pure function of
  the plan, so every rank computes the same shortlist.
* ``search_plan`` -- the plan-level search over order_policy x doubling x
  relayout x radix x mesh shape ON TOP of the comm sub-space: plans are
  built with ``make_plan`` (cheap numpy) for prediction, only the top-k
  points are built and wall-clock timed, and the winner is persisted in
  the schema-versioned $REPRO_COMM_CACHE JSON keyed by (shape-family,
  devices, dtype, engine).  It is collective over the default process
  group: every candidate mesh is a ``DeviceMesh`` over the same world
  ranks, and every candidate's time and failure are MAX-reduced over the
  world before the choice, so every rank picks the same winner.

The frontier policy is ``SHORTLIST_DIVISOR``: time ceil(space/6) of the
live candidates (>= 1), which on the default 12-candidate comm grid times
2 -- a 6x reduction, held as ">= 5x fewer timed" by the oracle tests.
"""
from __future__ import annotations

import math
import os
import time
import zlib
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.core import green as gr
from repro_torch.core.bc import DataLayout
from repro_torch.core.comm import (cache_load_entries, cache_store_entry,
                                   cfg_label)
from repro_torch.core.engine import TransformEngine
from repro_torch.core.solver import make_plan
from repro_torch.plan.costmodel import CostModel
from repro_torch.plan.space import PlanPoint, PlanSpace, mesh_shapes_for

__all__ = ["SHORTLIST_DIVISOR", "guided_comm_candidates", "PlanDecision",
           "search_plan"]

# fraction of the (post-prune) candidate space that gets wall-clock timed
SHORTLIST_DIVISOR = 6


def _shortlist_size(n_live: int, k=None) -> int:
    if k is not None:
        return max(1, min(int(k), n_live))
    return max(1, math.ceil(n_live / SHORTLIST_DIVISOR))


def guided_comm_candidates(plan, p1: int, p2: int, dtype, *, batch=None,
                           folds=("pack",), max_chunks: int = 4,
                           relayout: str = "scheduled", max_radix: int = 4,
                           model: CostModel = None, k=None,
                           census=None) -> tuple:
    """Predictor-ranked shortlist of ``CommConfig`` candidates for one
    solver instance (its plan, mesh extents, dtype and in-block batch).

    ``census`` (when a dict) is extended with the search's account:
    ``space`` (candidate count), ``predicted`` (label -> predicted
    seconds), ``pruned_padding`` (chunked candidates dropped because
    their zero-padding overhead exceeds the predicted win over the best
    monolithic plan) and ``shortlist`` (the labels handed to the timer).
    """
    model = model or CostModel()
    space = PlanSpace.comm(max_chunks=max_chunks, folds=folds,
                           batched=batch is not None, relayout=relayout)
    cands = space.comm_configs()
    preds, metas = {}, {}
    for cfg in cands:
        c, meta = model.comm_cost(plan, p1, p2, dtype, cfg, batch=batch,
                                  max_radix=max_radix)
        preds[cfg_label(cfg)] = c
        metas[cfg_label(cfg)] = meta
    # padding prune: a chunked candidate that needs solve-time zero-padding
    # AND does not even beat the best monolithic plan under the model has
    # no path to winning -- timing it is pure sweep cost
    mono_floor = min((preds[cfg_label(c)] for c in cands
                      if c.n_chunks == 1), default=float("inf"))
    pruned = [cfg_label(c) for c in cands
              if metas[cfg_label(c)]["padded"]
              and preds[cfg_label(c)] >= mono_floor]
    live = [c for c in cands if cfg_label(c) not in pruned]
    live.sort(key=lambda c: preds[cfg_label(c)])
    short = tuple(live[:_shortlist_size(len(live), k)])
    if census is not None:
        census["space"] = len(cands)
        census["predicted"] = preds
        census["pruned_padding"] = pruned
        census["shortlist"] = [cfg_label(c) for c in short]
    return short


# ---------------------------------------------------------------------------
# plan-level search (mesh shape / order / doubling / relayout / radix)
# ---------------------------------------------------------------------------

@dataclass
class PlanDecision:
    """Outcome of one ``search_plan`` run."""

    point: PlanPoint
    seconds: float = float("nan")     # measured winner time (nan on cache)
    timings: dict = field(default_factory=dict)   # label -> seconds
    census: dict = field(default_factory=dict)
    cached: bool = False


def _family_key(plan, n_devices: int, axes, dtype, engine: str,
                batch) -> str:
    """Shape-family identity of a persisted plan decision: what must match
    for a cached winner to be replayed (the reference's tuple, so the
    file reads the same)."""
    return repr(("plansearch", 1,
                 tuple(p.n for p in plan.dirs),
                 tuple((p.bc.left.name, p.bc.right.name) for p in plan.dirs),
                 plan.dirs[0].layout.name,
                 int(n_devices), tuple(axes), str(dtype), engine, batch))


def _world_max(values, device) -> list:
    """Element-wise MAX of ``values`` (floats) over every rank."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def search_plan(shape, L, bcs, *, layout=None, green_kind=None,
                dtype=None, engine: str = "cuda", device=None,
                axes=("data", "model"), mesh_shapes=None,
                order_policies=("layout", "natural"),
                doublings=("deferred",), relayouts=("scheduled",),
                max_chunks: int = 4, batch=None, k=None, reps: int = 3,
                budget_s=None, cache_path=None, model: CostModel = None,
                census=None, solver_kw=None) -> PlanDecision:
    """Search the FULL plan space for one problem and return the winner.

    Collective: every rank of the default process group calls it with the
    same arguments; ``mesh_shapes`` (default ``mesh_shapes_for`` the world
    size) are (p1, p2) grids over all of its ranks.  Every (mesh_shape x
    order_policy x doubling x relayout x radix) combo is planned with
    ``make_plan`` and its comm sub-space predicted; only the global top-k
    points (default ceil(space/SHORTLIST_DIVISOR)) are built as
    ``DistributedPoissonSolver``s on ``engine`` ("cuda" or "torch"; radix
    2 is searched on "cuda" only) and timed, each the best of ``reps``
    solves of a field of ones after one warm-up.  Each point's time and
    failure are MAX-reduced over the world; ``budget_s`` skips a point
    whose agreed time exceeds it, after it ran (no collective is ever
    abandoned).  Points that share a plan share its Green's function.

    The winner is persisted under ``cache_path`` (default
    $REPRO_COMM_CACHE) by rank 0, in the schema-versioned JSON, keyed by
    shape family + device count + dtype + engine; a later call replays it
    (``cached=True``) when every rank reads the same point.  If every
    shortlisted point fails, the predictor's best point is returned
    untimed.  ``device``: this rank's device; None means the card it has
    selected, and raises without one.
    """
    from repro_torch.distributed.pencil import (DistributedPoissonSolver,
                                                _resolve_device)
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("search_plan is collective over the default "
                           "process group: call torch.distributed."
                           "init_process_group first")
    device = _resolve_device(device)
    layout = layout if layout is not None else DataLayout.CELL
    green_kind = green_kind if green_kind is not None else gr.GreenKind.CHAT2
    dtype = dtype if dtype is not None else torch.float32
    model = model or CostModel()
    census = census if census is not None else {}
    n_dev = dist.get_world_size()
    if mesh_shapes is None:
        mesh_shapes = mesh_shapes_for(n_dev)
    mesh_shapes = tuple(tuple(int(p) for p in ms) for ms in mesh_shapes)
    for p1, p2 in mesh_shapes:
        if p1 * p2 != n_dev:
            raise ValueError(f"mesh shape ({p1}, {p2}) does not cover the "
                             f"{n_dev} ranks of the process group")
    if cache_path is None:
        cache_path = os.environ.get("REPRO_COMM_CACHE") or None

    def agree(values):
        return _world_max(values, device)

    ref_plan = make_plan(shape, L, bcs, layout, green_kind)
    fam = _family_key(ref_plan, n_dev, axes,
                      str(dtype).replace("torch.", ""), engine, batch)
    if cache_path:
        entry = cache_load_entries(cache_path, census=census).get(fam)
        try:
            pt = PlanPoint.fromdict(entry["point"])
        except (KeyError, TypeError, ValueError):
            pt = None       # absent or malformed: fall through to a search
        # a hit counts only when every rank read the same point
        tag = -1.0 if pt is None else float(zlib.crc32(pt.label().encode()))
        hi, neg_lo = agree([tag, -tag])
        if hi == -neg_lo >= 0:
            return PlanDecision(pt, census=dict(census, cached=True),
                                cached=True)

    space = PlanSpace.full(max_chunks=max_chunks, engine=engine,
                           batched=batch is not None,
                           order_policies=order_policies,
                           doublings=doublings, relayouts=relayouts,
                           mesh_shapes=mesh_shapes)
    plans, preds, metas = {}, {}, {}
    for pt in space.points():
        pk = (pt.order_policy, pt.doubling)
        if pk not in plans:
            plans[pk] = make_plan(shape, L, bcs, layout, green_kind,
                                  doubling=pt.doubling,
                                  order_policy=pt.order_policy)
        c, meta = model.plan_cost(pt, plans[pk], dtype, batch=batch)
        preds[pt] = c
        metas[pt] = meta
    mono_floor = min((c for pt, c in preds.items() if pt.n_chunks == 1),
                     default=float("inf"))
    pruned = [pt for pt in preds
              if metas[pt]["padded"] and preds[pt] >= mono_floor]
    live = sorted((pt for pt in preds if pt not in pruned),
                  key=preds.get)
    short = live[:_shortlist_size(len(live), k)]
    census.update(space=len(preds),
                  predicted={pt.label(): preds[pt] for pt in live},
                  pruned_padding=[pt.label() for pt in pruned],
                  shortlist=[pt.label() for pt in short])

    # every rank builds the shortlist's meshes (and so their process
    # groups) in the same order
    ranks = torch.arange(n_dev)
    meshes = {ms: DeviceMesh(device.type, ranks.reshape(ms),
                             mesh_dim_names=tuple(axes))
              for ms in mesh_shapes
              if any(pt.mesh_shape == ms for pt in short)}
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    greens = {}
    kw = dict(solver_kw or {})

    def time_point(pt):
        pk = (pt.order_policy, pt.doubling)
        s = DistributedPoissonSolver(
            shape, L, bcs, layout, green_kind, mesh=meshes[pt.mesh_shape],
            axes=axes, comm=pt.comm(), dtype=dtype,
            engine=TransformEngine(engine, max_radix=pt.radix),
            doubling=pt.doubling, relayout=pt.relayout,
            order_policy=pt.order_policy, device=device,
            _green_cache=greens.get(pk), **kw)
        greens[pk] = s._green_raw
        f = torch.ones(((batch,) if batch else ()) + tuple(s.input_shape),
                       dtype=dtype, device=device)
        s.solve(f)                                # warm
        sync()
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            s.solve(f)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    timings, failed, skipped = {}, {}, []
    for pt in short:
        lbl = pt.label()
        err = None
        try:
            t = float(time_point(pt))
        except Exception as e:      # noqa: BLE001 -- agreed below
            err, t = e, 0.0
        t, any_failed = agree([t, float(err is not None)])
        if any_failed:
            failed[lbl] = ("RuntimeError: failed on another rank"
                           if err is None
                           else f"{type(err).__name__}: {err}"[:200])
            continue
        if budget_s and budget_s > 0 and t > budget_s:
            skipped.append(lbl)
            continue
        timings[lbl] = t
    census.update(timed=dict(timings), failed=failed,
                  skipped_budget=skipped)
    if not timings:
        # every shortlisted point failed: fall back to the predictor's
        # best point (it is at least a valid plan)
        win = short[0] if short else PlanPoint(mesh_shape=mesh_shapes[0])
        return PlanDecision(win, timings=timings, census=census)
    by_label = {pt.label(): pt for pt in short}
    best_label = min(timings, key=timings.get)
    win = by_label[best_label]
    if cache_path:
        if dist.get_rank() == 0:
            cache_store_entry(cache_path, fam, {
                "point": win.asdict(),
                "timings_us": {lb: round(t * 1e6, 1)
                               for lb, t in timings.items()}})
        agree([0.0])        # the file is written before any rank returns
    return PlanDecision(win, seconds=timings[best_label], timings=timings,
                        census=census)
