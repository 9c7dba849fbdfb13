"""Analytic bytes/FLOPs/latency predictor for plan points (counterpart of
``repro.plan.costmodel``, with the same constants).

``core.comm.collective_census`` MEASURES the per-collective send-buffer
bytes the comm layer hands to ``all_to_all_single`` (the counterpart of
the reference's HLO census); this module PREDICTS the same numbers from
the plan alone -- no solve -- by replaying the distributed pipeline's
shape algebra (``distributed.pencil``):

Let ``order = (d0, d1, d2)`` be the plan's execution order, ``U[d] =
Plan1D.valid_in`` (live physical extent outside d's own transform),
``S[d] = Plan1D.n_out`` (spectral extent), and ``PU/PS`` those extents
padded up to the mesh-axis multiple the equal-split exchange needs.  The
four topology switches then see, per rank, exactly:

  ========  ====  =========================================  =====  =====
  switch    axis  local dims {d0, d1, d2}                    split  chunk
  ========  ====  =========================================  =====  =====
  fwd a1    p1    PS0,      PU1/p1,   PU2/p2                 d0     d2
  fwd a2    p2    PS0/p1,   PS1,      PU2/p2                 d1     d0
  bwd a2    p2    PS0/p1,   PS1/p2,   PU2                    d2     d0
  bwd a1    p1    PS0/p1,   PU1,      PU2/p2                 d1     d2
  ========  ====  =========================================  =====  =====

(The ``chunk`` column is the uninvolved grid axis the chunked strategies
cut when no free batch axis applies.)  An operand is complex once the
first r2c/c2c transform in execution order has run forward and until it
runs backward; the dims are IDENTICAL across relayout baseline/scheduled
and fold pack/unpack -- a permutation reorders axes, never changes the
payload -- which is why only strategy/n_chunks/order/doubling/mesh move
bytes.  ``tests/test_torch_plansearch.py`` asserts ``predict_bytes``
equals the reference's prediction and the port's collective census
bit-for-bit across the reference's sampled space.  A switch over a
one-rank mesh axis issues no collective (``core.comm._a2a``) and is
predicted as none.

On top of the exact byte counts, ``CostModel`` adds a latency/bandwidth/
FLOPs time estimate (alpha-beta model plus a 5 n log2 n transform term
and an overlap discount) -- heuristic, used ONLY to rank candidates; the
guided-search guarantees are enforced empirically by the oracle tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SwitchTrace", "switch_traces", "predict_bytes",
           "predict_collectives", "CostModel"]


def _ceil_to(n: int, p: int) -> int:
    return -(-n // p) * p


@dataclass(frozen=True)
class SwitchTrace:
    """Shape facts of ONE topology switch (per rank, pre-collective)."""

    index: int              # program order, 0..3
    axis_size: int          # ranks of the mesh axis the switch runs over
    dims: tuple             # ((logical_dim, local_extent), ...) sorted by dim
    split_dim: int          # logical dim the collective splits
    chunk_dim: int          # uninvolved grid dim (chunked-strategy fallback)
    is_complex: bool        # operand dtype is complex at this switch

    @property
    def elems(self) -> int:
        n = 1
        for _, e in self.dims:
            n *= e
        return n

    def extent(self, dim: int) -> int:
        return dict(self.dims)[dim]


def switch_traces(plan, p1: int, p2: int) -> tuple:
    """The four per-switch shape traces of ``plan`` on a (p1, p2) grid."""
    d0, d1, d2 = plan.order
    dirs = plan.dirs
    U = [p.valid_in for p in dirs]
    S = [p.n_out for p in dirs]
    PU1, PU2 = _ceil_to(U[d1], p1), _ceil_to(U[d2], p2)
    PS0, PS1 = _ceil_to(S[d0], p1), _ceil_to(S[d1], p2)
    # dft dims are a suffix of the execution order (r2r dims transform
    # first); the operand turns complex at the first dft dim's forward
    # transform and turns back real at its backward transform
    n_dft = sum(1 for d in plan.order if dirs[d].dft is not None)

    def mk(i, p, dims, split, chunk, cplx):
        return SwitchTrace(i, p, tuple(sorted(dims.items())), split, chunk,
                           bool(cplx))

    return (
        mk(0, p1, {d0: PS0, d1: PU1 // p1, d2: PU2 // p2}, d0, d2,
           dirs[d0].dft is not None),
        mk(1, p2, {d0: PS0 // p1, d1: PS1, d2: PU2 // p2}, d1, d0,
           n_dft >= 2),
        mk(2, p2, {d0: PS0 // p1, d1: PS1 // p2, d2: PU2}, d2, d0,
           n_dft >= 2),
        mk(3, p1, {d0: PS0 // p1, d1: PU1, d2: PU2 // p2}, d1, d2,
           n_dft >= 3),
    )


def _itemsize(dtype) -> int:
    """Bytes of one real element: a ``torch.dtype`` (which ``np.dtype``
    refuses), a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    return int(np.dtype(dtype).itemsize)


def predict_collectives(plan, p1: int, p2: int, dtype, cfg,
                        batch=None) -> list:
    """Per-collective prediction in program order: one dict per emitted
    all-to-all -- ``{"switch", "bytes", "chunked", "padded"}``.

    ``batch`` is the in-block multi-RHS extent riding every switch (the
    chunked strategies' preferred free chunk axis), ``None`` when absent.
    ``padded`` marks a chunk whose axis did not divide ``n_chunks`` (the
    solve-time zero-padding ``core.comm._split_chunks`` warns about).
    """
    item = _itemsize(dtype)
    chunked = cfg.strategy in ("pipelined", "overlap") and cfg.n_chunks > 1
    nc = cfg.n_chunks if chunked else 1
    out = []
    for sw in switch_traces(plan, p1, p2):
        if sw.axis_size == 1:
            continue        # 1-rank mesh axis: the identity exchange, no
            # collective is issued
        eb = item * (2 if sw.is_complex else 1)
        core = sw.elems * (batch if batch is not None else 1)
        if nc == 1:
            out.append({"switch": sw.index, "bytes": core * eb,
                        "chunked": False, "padded": False})
            continue
        # chunk-axis resolution mirrors CommStrategy._chunk_axis: the
        # batch axis when present, preferred ("auto") and dividing;
        # otherwise the uninvolved grid dim, zero-padded if non-dividing
        if (batch is not None and cfg.chunk_axis == "auto"
                and batch % nc == 0):
            per, padded = core // nc * eb, False
        else:
            ln = sw.extent(sw.chunk_dim)
            cl = -(-ln // nc)
            per = core // ln * cl * eb
            padded = bool(ln % nc)
        out.extend({"switch": sw.index, "bytes": per,
                    "chunked": True, "padded": padded}
                   for _ in range(nc))
    return out


def predict_bytes(plan, p1: int, p2: int, dtype, cfg, batch=None) -> list:
    """Program-order per-collective send-buffer bytes -- the exact
    counterpart of ``[c["bytes"] for c in census.per_collective]`` over
    one ``solve_local`` under ``core.comm.collective_census()`` (asserted
    bit-for-bit in tests/test_torch_plansearch.py)."""
    return [c["bytes"] for c in
            predict_collectives(plan, p1, p2, dtype, cfg, batch=batch)]


# -- time model --------------------------------------------------------------

def _stages(n: int, max_radix: int) -> int:
    """Stockham stage count of a length-n transform: radix-4 with one
    radix-2 step absorbing an odd log2 factor, pure radix-2 under
    max_radix=2 -- the stages ``kernels.ref.fft_stockham`` runs and the
    CUDA kernel groups into passes."""
    lg = max(int(math.log2(max(n, 2))), 1)
    return lg if max_radix < 4 else (lg + 1) // 2


@dataclass(frozen=True)
class CostModel:
    """alpha-beta-gamma time predictor over plan points.

    ``alpha_s``: per-collective dispatch/latency cost; ``bytes_per_s``:
    effective all-to-all wire bandwidth per rank; ``flops_per_s``:
    effective 1-D transform throughput; ``overlap_eff``: fraction of
    in-flight wire time the ``overlap`` strategy hides behind per-chunk
    transforms; ``pipeline_eff``: the (smaller) comm/comm overlap of
    ``pipelined``.  Absolute values are the reference's host-calibrated
    guesses, not calibrated on a GPU -- only the RANKING matters, and the
    oracle tests hold that ranking to a 10% regret bound against brute
    force.
    """

    alpha_s: float = 40e-6
    bytes_per_s: float = 8e9
    flops_per_s: float = 5e9
    overlap_eff: float = 0.6
    pipeline_eff: float = 0.25

    def transform_seconds(self, plan, batch=None, max_radix: int = 4):
        """Per-direction 1-D transform time: 5 n log2(n) flops per row
        element (halved for real transforms), scaled by the Stockham
        stage-count ratio when a radix cap lengthens the kernel."""
        dirs = plan.dirs
        rows_all = (batch if batch is not None else 1)
        ext = [p.valid_in for p in dirs]
        out = {}
        for d, p in enumerate(dirs):
            rows = rows_all
            for o, e in enumerate(ext):
                if o != d:
                    rows *= e
            n = max(p.n_fft, 2)
            fl = 5.0 * rows * n * math.log2(n)
            if p.dft != "c2c":
                fl *= 0.5       # r2c / r2r: half-spectrum work
            fl *= _stages(n, max_radix) / max(_stages(n, 4), 1)
            out[d] = fl / self.flops_per_s
        return out

    def comm_cost(self, plan, p1: int, p2: int, dtype, cfg, batch=None,
                  max_radix: int = 4):
        """Predicted seconds of the four switch+transform stages under one
        comm config.  Returns ``(seconds, meta)`` where ``meta`` records
        ``bytes`` (total wire), ``collectives`` and ``padded`` (any chunk
        axis needed solve-time zero-padding)."""
        cols = predict_collectives(plan, p1, p2, dtype, cfg, batch=batch)
        tsec = self.transform_seconds(plan, batch=batch,
                                      max_radix=max_radix)
        d0, d1, d2 = plan.order
        # the post continuation each switch carries (fwd d1, fwd d2,
        # bwd d1, bwd d0) -- what the overlap strategy hides wire time with
        post = {0: tsec[d1], 1: tsec[d2], 2: tsec[d1], 3: tsec[d0]}
        total = tsec[d0] + tsec[d2]          # stages outside any switch
        padded = False
        for i in range(4):
            sw_cols = [c for c in cols if c["switch"] == i]
            nc = len(sw_cols)
            wire = sum(c["bytes"] for c in sw_cols) / self.bytes_per_s
            padded = padded or any(c["padded"] for c in sw_cols)
            stage = self.alpha_s * nc + wire + post[i]
            if nc > 1:
                frac = (nc - 1) / nc
                if cfg.strategy == "overlap":
                    # chunk k's transform runs while chunk k+1 is on the
                    # wire: hide the smaller of the two, derated
                    stage -= self.overlap_eff * min(post[i] * frac,
                                                    wire * frac)
                else:
                    stage -= self.pipeline_eff * wire * frac
            total += stage
        meta = {"bytes": sum(c["bytes"] for c in cols),
                "collectives": len(cols), "padded": padded}
        return total, meta

    def plan_cost(self, point, plan, dtype, batch=None):
        """Cost of a full ``PlanPoint`` (its own mesh shape, radix, comm)
        -- the plan-level search's ranking key.  ``point.mesh_shape`` must
        be set."""
        p1, p2 = point.mesh_shape
        return self.comm_cost(plan, p1, p2, dtype, point.comm(),
                              batch=batch, max_radix=point.radix)
