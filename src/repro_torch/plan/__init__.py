"""Declarative plan space + cost-model-guided search (counterpart of
``repro.plan``).

``space``     -- the enumerable cross-product of every plan-time knob
                 (comm strategy, chunking, relayout fold, chunk axis,
                 execution order policy, Hockney doubling mode, relayout
                 schedule, Stockham kernel radix, process-mesh shape).
``costmodel`` -- an analytic bytes/FLOPs/latency predictor for any point
                 of the space, evaluated WITHOUT running a solve; its byte
                 counts are asserted bit-for-bit against the bytes the
                 comm layer hands to ``all_to_all_single``
                 (``core.comm.collective_census``).
``search``    -- predictor-pruned frontier search: rank the space with the
                 cost model, wall-clock-time only a shortlist (reusing the
                 ``autotune_comm`` budget/census/agreement machinery),
                 persist the winners in the schema-versioned
                 $REPRO_COMM_CACHE JSON.
"""
from repro_torch.plan.space import (PlanPoint, PlanSpace, mesh_shapes_for)
from repro_torch.plan.costmodel import (CostModel, predict_bytes,
                                        switch_traces)
from repro_torch.plan.search import (SHORTLIST_DIVISOR,
                                     guided_comm_candidates, search_plan)

__all__ = [
    "PlanPoint", "PlanSpace", "mesh_shapes_for",
    "CostModel", "predict_bytes", "switch_traces",
    "SHORTLIST_DIVISOR", "guided_comm_candidates", "search_plan",
]
