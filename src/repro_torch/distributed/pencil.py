"""Distributed pencil-decomposition Poisson solver on ``torch.distributed``.

Counterpart of ``repro.distributed.pencil``.  The 2-D process grid
(P1, P2) is two named axes of a ``torch.distributed.device_mesh.DeviceMesh``
(by default ``("data", "model")``), the counterpart of the reference's
``jax.make_mesh`` mesh; each axis is one process group
(``mesh.get_group(name)``), the paper's sub-communicator, and every
topology switch is one ``CommStrategy`` collective on it.  The
per-direction math is ``repro_torch.core.engine``'s, unchanged, so the
distributed pipeline runs the same kernels as the single-process solve,
on each rank's pencil.

The reference runs one program over all devices (``shard_map``); here
every rank runs this class on its own pencil (SPMD), and every rank of
the mesh must call the same methods with the same arguments.  The local
solve is a software pipeline of fused transform+switch STAGES: each
topology switch carries the next direction's 1-D transform as its
``post`` continuation, so the ``overlap`` strategy can run chunk k's
transform while chunk k+1 is on the wire.  Every stage is VALID-EXTENT
aware: the split axis's live extent is handed to
``CommStrategy.stage(valid_extent=...)``, which crops and re-pads to the
equal-split multiple.

Uneven counts (the node-centered N+1 points) are handled as in the
reference, by padding the *inactive* (split) axes to a multiple of the
axis size; ``repro_torch.core.partition`` is the source of truth for how
an uneven split would be laid out.

Decisions are agreed across the mesh, since ranks that disagree would
issue mismatched collectives and hang: ``comm="auto"`` reduces every
candidate's time and failure with MAX over the mesh before choosing, and
every ladder step reduces the ranks' failure flags first.  A rank that
fails alone inside a collective cannot be told apart from a slow one;
that case is left to the process groups' ``timeout=``.

``comm="auto"`` runs the guided search by default
(``repro_torch.plan.search.guided_comm_candidates``: the cost model ranks
the candidate grid and only its shortlist is timed);
``autotune_search="brute"`` times the whole grid.

ABFT (DESIGN.md #13): ``verify="abft-stages"`` runs the checked
pipeline (every stage checksummed, every collective with its checksum
sidecar; the report MAX-reduced over the mesh, so every rank reaches the
same verdict).  ``verify="abft"`` runs the clean pipeline with the
Freivalds sandwich: ``<r, u>`` by three chained contractions of each
rank's output pencil with the rank-1 probe's factors and ``<w, f>`` by
one dot, both on the device, summed over the mesh, the mismatch agreed
(MAX) before it is compared; a trip re-dispatches the checked pipeline.
The weight ``w`` comes from the single-process ``"torch"``-engine
adjoint over the global grid; on the ``"cuda"`` engine there is none
(the kernels carry no gradient) and ``verify="abft"`` runs the checked
pipeline on every solve, as the reference does on ``"pallas"``.

``lower`` is the dry run of one local solve: the rank's pipeline on fake
tensors (``FakeTensorMode``; nothing is allocated, no kernel launched,
the collectives go to whatever process group the mesh holds, the
``"fake"`` backend's in ``launch.mesh``), recorded as a program-order
``core.trace.Trace``: the counterpart of the reference's lowered HLO,
which ``launch.hlo_stats`` reads.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import green as gr
from repro_torch.core.bc import DataLayout
from repro_torch.core.comm import (CommConfig, as_comm, autotune_comm,
                                   autotune_candidates as _default_candidates,
                                   crop_axis, make_strategy, pad_axis)
from repro_torch.core.engine import (RELAYOUT_MODES, as_engine,
                                     build_schedule, crop_doubling,
                                     materialize_doubling, relayout)
from repro_torch.core.solver import (_check_kernel_lengths, _check_verify,
                                     build_green, lite_reference_impl,
                                     lite_weight, make_plan)
from repro_torch.plan.search import guided_comm_candidates
from repro_torch.runtime import abft as _abft
from repro_torch.runtime import faults, health, resilience

__all__ = ["DistributedPoissonSolver"]


def _pad_to(n: int, p: int) -> int:
    return -(-n // p) * p


def _resolve_device(device) -> torch.device:
    """Each rank's device: the card it has selected (``cuda:<current
    device>``) unless the caller names another; raise without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "DistributedPoissonSolver runs on the GPU by default, and torch "
            "finds no CUDA device; pass device='cpu' to solve on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class _MeshFailure(RuntimeError):
    """One solve attempt failed on at least one rank of the mesh.  Raised
    on EVERY rank with the agreed flags, so all ranks take the same ladder
    step: ``transient`` only when every failing rank's error was
    transient, ``injected`` only when an armed fault plan caused every
    one."""

    def __init__(self, local, stage, transient: bool, injected: bool):
        why = "another rank failed" if local is None else repr(local)
        super().__init__(f"distributed solve failed at {stage!r}: {why}")
        self.stage = stage
        self.transient = transient
        self.injected = injected


class DistributedPoissonSolver:
    """Pencil-distributed flups solve over a (P1, P2) mesh-axis pair.

    ``mesh``: a ``DeviceMesh`` holding ``axes`` (and ``batch_axis``); the
    rank order of each axis's group must be the mesh coordinate.
    ``batch_axis``: optional extra mesh axis (e.g. "pod"): the solver then
    takes a leading batch dimension split over that axis.  ``comm``: a
    ``CommConfig``, a strategy name, or ``"auto"`` (plan-time autotuned:
    by default the cost model's shortlist is timed, and
    ``autotune_search="brute"`` times the full candidate grid; the
    search's account is in ``autotune_census``).
    ``relayout``: ``"scheduled"`` (relayouts folded into the switches) or
    ``"baseline"``.  ``engine``: ``"cuda"`` (the hand kernels; their plain
    versions on CPU tensors) or ``"torch"``.  ``device``: this rank's
    device; None means ``cuda:<current device>`` and raises without a card.
    ``dtype``: the working precision (float32 or float64).
    ``verify``: "nan" | "residual" | "abft" | "abft-stages" (see the
    module docstring); ``abft_rtol``: the ABFT checksum tolerance, 0.0
    meaning ``abft.tol_for(dtype)``.

    ``solve(f)`` takes the GLOBAL field on every rank and returns the
    global solution on every rank (the reference's API): each rank slices
    its pencil, and the output pencils are all-gathered at the end.
    ``solve_local(x)`` takes and returns the rank's own padded pencil
    (``shard_input`` / ``gather_output`` convert); it runs the pipeline
    once, without the ladder, as the reference's ``jit_for(...)`` does on
    an already sharded array.  Leading batch axes: ``(B, *grid)`` is an
    in-block multi-RHS batch; with ``batch_axis``, ``(B_pod, *grid)`` or
    ``(B_pod, B, *grid)``.
    """

    def __init__(self, shape, L, bcs, layout=DataLayout.CELL,
                 green_kind=gr.GreenKind.CHAT2, *, mesh,
                 axes=("data", "model"),
                 comm=CommConfig(), batch_axis=None,
                 eps_factor: float = 2.0, dtype=torch.float32,
                 lazy_green: bool = False, engine="cuda",
                 doubling: str = "deferred", relayout: str = "scheduled",
                 order_policy: str = "layout",
                 autotune_candidates=None, autotune_cache=None,
                 autotune_batch=None, autotune_budget=None,
                 autotune_search: str = "guided",
                 verify=None, verify_rtol=0.5, abft_rtol=0.0,
                 device=None, _green_cache=None):
        if relayout not in RELAYOUT_MODES:
            raise ValueError(f"relayout must be one of {RELAYOUT_MODES}")
        _check_verify(verify)
        if autotune_search not in ("guided", "brute"):
            raise ValueError(f"autotune_search must be 'guided' or 'brute', "
                             f"got {autotune_search!r}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"dtype must be torch.float32 or torch.float64, "
                            f"got {dtype}")
        self.device = _resolve_device(device)
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed.device_mesh."
                            f"DeviceMesh, got {type(mesh).__name__}")
        self.mesh = mesh
        self.axes = tuple(axes)
        self.batch_axis = batch_axis
        self.dtype = dtype
        names = tuple(mesh.mesh_dim_names or ())
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not part of the mesh")
        self._groups, self._coord, self._size = {}, {}, {}
        for a in self.axes + ((batch_axis,) if batch_axis else ()):
            if a not in names:
                raise ValueError(f"mesh axis {a!r} not in {names}")
            g = mesh.get_group(a)
            self._groups[a] = g
            self._coord[a] = coord[names.index(a)]
            self._size[a] = dist.get_world_size(g)
            if dist.get_rank(g) != self._coord[a]:
                raise ValueError(
                    f"axis {a!r}: group rank {dist.get_rank(g)} is not the "
                    f"mesh coordinate {self._coord[a]}; the tiled exchange "
                    "needs them equal")
        # every group of the mesh, for the agreement reductions
        self._mesh_groups = [mesh.get_group(i) for i in range(len(names))]
        self._ctor = dict(shape=tuple(shape), L=L, bcs=bcs, layout=layout,
                          green_kind=green_kind, eps_factor=eps_factor,
                          lazy_green=lazy_green, order_policy=order_policy,
                          comm_req=comm, engine_obj=as_engine(engine),
                          autotune_candidates=autotune_candidates,
                          autotune_cache=autotune_cache,
                          autotune_batch=autotune_batch,
                          autotune_budget=autotune_budget,
                          autotune_search=autotune_search)
        self.verify = verify
        self.verify_rtol = float(verify_rtol)
        # ABFT checksum tolerance; 0.0 = auto per data dtype (abft.tol_for)
        self.abft_rtol = float(abft_rtol)
        self.stats = {"solves": 0, "retries": 0, "verify_failures": 0,
                      "degradations": []}
        # raw (unpadded, natural-layout, float64) transformed Green: built
        # once and reused across ladder rebuilds and elastic rebuilds
        self._green_raw = _green_cache
        self._configure({"engine": as_engine(engine).name, "comm": None,
                         "doubling": doubling, "relayout": relayout})

    # -- plan and configuration -------------------------------------------

    def _configure(self, cfg: dict):
        """(Re)build plan, schedule, padded extents, this rank's Green slice
        and the comm strategy for one runtime config (the ladder's rebuild
        hook).  The first build (``cfg["comm"] is None``) resolves the
        user's comm request, ``"auto"`` included."""
        c = self._ctor
        self._cfg = dict(cfg)
        self.plan = make_plan(c["shape"], c["L"], c["bcs"], c["layout"],
                              c["green_kind"], c["eps_factor"],
                              doubling=cfg["doubling"],
                              order_policy=c["order_policy"])
        base = c["engine_obj"]
        self.engine = (base if base.name == cfg["engine"]
                       else as_engine(cfg["engine"]))
        if self.engine.use_cuda:
            _check_kernel_lengths(self.plan)
        self.schedule = build_schedule(self.plan, self.engine)
        self.relayout = cfg["relayout"]
        d0, d1, d2 = self.plan.order
        a1, a2 = self.axes
        p1, p2 = self._size[a1], self._size[a2]
        self._axis_sizes = {a1: p1, a2: p2}
        dirs = self.plan.dirs
        # per-dim live extent OUTSIDE the dim's own transform (U) and the
        # spectral storage size (S)
        U = [p.valid_in for p in dirs]
        S = [p.n_out for p in dirs]
        self._U, self._S = U, S
        self._PU1 = _pad_to(U[d1], p1)
        self._PU2 = _pad_to(U[d2], p2)
        self._PS0 = _pad_to(S[d0], p1)
        self._PS1 = _pad_to(S[d1], p2)
        # the scheduled pipeline multiplies in the spectral layout
        self._gperm = (self.schedule.layouts.spectral
                       if self.relayout == "scheduled" else (0, 1, 2))
        if c["lazy_green"]:
            shp = self._local_green_shape()
            self._green_dev = torch.zeros(
                tuple(shp[d] for d in self._gperm), dtype=self.dtype,
                device=self.device)
        else:
            if self._green_raw is None:
                self._green_raw = build_green(self.plan)
            self._green_dev = self._local_green(self._green_raw)
        # the checked solves (``abft_jit_for``) and the Freivalds material
        # of verify="abft" (rank-1 probe factors, this rank's block of
        # w = S^T C^T r), rebuilt per config
        self._abft_jits = {}
        self._lite_weights = {}

        if cfg["comm"] is None:
            req = c["comm_req"]
            if isinstance(req, str) and req == "auto":
                self.comm = self._autotune(c["autotune_candidates"],
                                           c["autotune_cache"],
                                           c["autotune_batch"],
                                           budget=c["autotune_budget"])
            else:
                self.comm = as_comm(req)
            self._cfg["comm"] = self.comm.strategy
        elif cfg["comm"] != self.comm.strategy:
            # ladder rebuild: degraded strategy, n_chunks/fold carried over
            prev = self.comm
            nc = prev.n_chunks if cfg["comm"] in ("pipelined", "overlap") \
                else 1
            self.comm = CommConfig(cfg["comm"], max(nc, 1), prev.fold,
                                   prev.chunk_axis)

    def _local_green_shape(self):
        d0, d1, d2 = self.plan.order
        a1, a2 = self.axes
        shp = [0, 0, 0]
        shp[d0] = self._PS0 // self._size[a1]
        shp[d1] = self._PS1 // self._size[a2]
        shp[d2] = self._S[d2]
        return shp

    def _local_green(self, g):
        """This rank's block of the padded Green's function (d0 split over
        the first axis, d1 over the second), in the multiply's layout, in
        the working precision, on the device.  Only the block is copied."""
        d0, d1, _ = self.plan.order
        a1, a2 = self.axes
        shp = self._local_green_shape()
        start = {d0: self._coord[a1] * shp[d0], d1: self._coord[a2] * shp[d1]}
        src = tuple(slice(start.get(d, 0),
                          min(start.get(d, 0) + shp[d], g.shape[d]))
                    for d in range(3))
        part = g[src]
        blk = np.zeros(shp, dtype=np.float64 if self.dtype == torch.float64
                       else np.float32)
        blk[tuple(slice(0, max(n, 0)) for n in part.shape)] = part
        return torch.from_numpy(np.ascontiguousarray(
            blk.transpose(self._gperm))).to(self.device)

    def green_device(self):
        """This rank's device block of the Green's function."""
        return self._green_dev

    # -- agreement across the mesh ----------------------------------------

    def _agree(self, values):
        """Element-wise MAX of ``values`` (floats) over every rank of the
        mesh: one all-reduce per mesh axis."""
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=self.device)
        for g in self._mesh_groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
        return t.tolist()

    # -- local (per-pencil) pipelines -------------------------------------

    def _chunk_axis(self, x, cfg: CommConfig):
        """The in-block multi-RHS batch axis (after the pod batch axis),
        the chunked strategies' preferred free chunk axis, or None."""
        off = x.ndim - len(self.plan.dirs)
        pod = 1 if self.batch_axis is not None else 0
        return off - 1 if off > pod and cfg.chunk_axis == "auto" else None

    def _strategy(self, cfg: CommConfig, col=None, tol=None):
        return make_strategy(cfg, axis_sizes=self._axis_sizes,
                             abft=None if col is None else (col, tol),
                             groups=self._groups)

    def _local_solve(self, x, green, *, cfg: CommConfig, col=None,
                     tol=None):
        """Baseline pipeline: every direction transformed in natural
        layout; each switch carries the next direction's transform.
        ``col``/``tol``: the ABFT collector threaded through every stage
        and switch (None: unchecked)."""
        sched = self.schedule
        d0, d1, d2 = self.plan.order
        a1, a2 = self.axes
        U, S = self._U, self._S
        strat = self._strategy(cfg, col, tol)
        ca = self._chunk_axis(x, cfg)
        off = x.ndim - len(self.plan.dirs)
        e0, e1, e2 = d0 + off, d1 + off, d2 + off

        x = sched.fwd_chunk(x, d0, col, tol)
        x = strat.stage(
            x, a1, e0, e1, chunk_axis=ca, valid_extent=S[d0],
            post=lambda c: sched.fwd_chunk(crop_axis(c, e1, U[d1]), d1,
                                           col, tol))
        x = strat.stage(
            x, a2, e1, e2, chunk_axis=ca, valid_extent=S[d1],
            post=lambda c: sched.fwd_chunk(crop_axis(c, e2, U[d2]), d2,
                                           col, tol))
        x = sched.green_multiply(x, green, col, tol)
        x = sched.bwd_chunk(x, d2, col, tol)
        x = strat.stage(
            x, a2, e2, e1, chunk_axis=ca, valid_extent=U[d2],
            post=lambda c: sched.bwd_chunk(crop_axis(c, e1, S[d1]), d1,
                                           col, tol))
        x = strat.stage(
            x, a1, e1, e0, chunk_axis=ca, valid_extent=U[d1],
            post=lambda c: sched.bwd_chunk(crop_axis(c, e0, S[d0]), d0,
                                           col, tol))
        if x.is_complex():
            x = x.real
        return x.to(self.dtype)

    def _local_solve_scheduled(self, x, green, *, cfg: CommConfig, col=None,
                               tol=None):
        """Layout-scheduled pipeline: every stage keeps its active axis
        minor-most, and the one relayout between consecutive directions
        is folded into the topology switch (``permute=``), so the
        collective splits the retiring dim as the MAJOR axis and gathers
        the incoming dim into the minor-most slot the next transform
        reads.  On the cuda engine the last forward FFT runs the Green
        multiply as its epilogue (``fwd_last_green``), except under a
        collector: the checks need the spectrum before the multiply."""
        sched = self.schedule
        d0, d1, d2 = self.plan.order
        a1, a2 = self.axes
        U, S = self._U, self._S
        L0, L1, L2 = sched.layouts.fwd
        B0, B1, B2 = sched.layouts.bwd
        strat = self._strategy(cfg, col, tol)
        ca = self._chunk_axis(x, cfg)
        off = x.ndim - len(self.plan.dirs)
        nat = tuple(range(len(self.plan.dirs)))
        first, last = off, x.ndim - 1

        def pm(src, dst):
            return (tuple(range(off))
                    + tuple(off + src.index(d) for d in dst))

        x = relayout(x, nat, L0)
        x = sched.fwd_last(x, d0, col, tol)
        x = strat.stage(
            x, a1, first, last, chunk_axis=ca,
            valid_extent=S[d0], permute=pm(L0, L1),
            post=lambda c: sched.fwd_last(crop_axis(c, last, U[d1]), d1,
                                          col, tol))
        if col is None and sched.can_fuse_green(d2):
            # the stage continuation only crops; the fused FFT x Green
            # kernel runs on the whole switched block
            x = strat.stage(
                x, a2, first, last, chunk_axis=ca,
                valid_extent=S[d1], permute=pm(L1, L2),
                post=lambda c: crop_axis(c, last, U[d2]))
            x = sched.fwd_last_green(x, d2, green)
        else:
            x = strat.stage(
                x, a2, first, last, chunk_axis=ca,
                valid_extent=S[d1], permute=pm(L1, L2),
                post=lambda c: sched.fwd_last(crop_axis(c, last, U[d2]), d2,
                                              col, tol))
            x = sched.green_multiply(x, green, col, tol)
        x = sched.bwd_last(x, d2, col, tol)
        x = strat.stage(
            x, a2, first, last, chunk_axis=ca,
            valid_extent=U[d2], permute=pm(B0, B1),
            post=lambda c: sched.bwd_last(crop_axis(c, last, S[d1]), d1,
                                          col, tol))
        x = strat.stage(
            x, a1, first, last, chunk_axis=ca,
            valid_extent=U[d1], permute=pm(B1, B2),
            post=lambda c: sched.bwd_last(crop_axis(c, last, S[d0]), d0,
                                          col, tol))
        x = relayout(x, B2, nat)
        if x.is_complex():
            x = x.real
        return x.to(self.dtype)

    def _body(self, x, cfg: CommConfig, col=None, tol=None, green=None):
        body = (self._local_solve_scheduled if self.relayout == "scheduled"
                else self._local_solve)
        return body(x, self._green_dev if green is None else green, cfg=cfg,
                    col=col, tol=tol)

    def _run_local(self, x, cfg: CommConfig, col=None, tol=None):
        if self._ctor["lazy_green"]:
            raise RuntimeError("a lazy_green solver holds no Green's "
                               "function: it only times and plans")
        return self._body(x, cfg, col, tol)

    # -- ABFT (DESIGN.md #13) ------------------------------------------------

    def _abft_tol(self) -> float:
        return self.abft_rtol or _abft.tol_for(self.dtype)

    def _mesh_reduce(self, t, op):
        """``t`` reduced with ``op`` over the pencil axes' groups (one
        all-reduce per axis of more than one rank), in place."""
        for a in self.axes:
            if self._size[a] > 1:
                dist.all_reduce(t, op=op, group=self._groups[a])
        return t

    def abft_jit_for(self, local_batch: bool = False):
        """The CHECKED distributed solve: ``(fn, names)`` where ``fn(x)``
        takes this rank's padded pencil and returns ``(y, report)``.  The
        local pipeline runs with an ``abft.Collector`` threaded through
        every transform stage and topology switch (the comm strategy
        ships the checksum sidecars); the report is MAX-reduced over both
        pencil axes, so every rank holds the same worst-case vector, and
        ``names`` (filled by each call) gives each slot's stage.  With a
        pod batch every batch element keeps its own report row
        (``(B_pod, K)``, gathered over the pod axis).  Collective: every
        rank calls ``fn``.  Cached per ``local_batch`` (the reference's
        key; the pencil's rank carries the batch) until the next
        config."""
        ent = self._abft_jits.get(bool(local_batch))
        if ent is not None:
            return ent
        names: list = []
        tol = self._abft_tol()
        pod = self.batch_axis is not None

        def run(x):
            col = _abft.Collector()
            y = self._run_local(x, self.comm, col, tol)
            names[:] = col.names
            return y, col.stacked().to(self.device)

        def fn(x):
            if not pod:
                y, rep = run(x)
                return y, self._mesh_reduce(rep, dist.ReduceOp.MAX)
            # one checked pipeline per local batch element (the pod axis
            # kept at size 1), so each element keeps its report row
            outs = [run(x[i:i + 1]) for i in range(x.shape[0])]
            rep = self._mesh_reduce(torch.stack([r for _, r in outs]),
                                    dist.ReduceOp.MAX)
            rows = self._all_gather(rep, self.batch_axis, 0)
            return torch.cat([y for y, _ in outs]), rows

        ent = self._abft_jits[bool(local_batch)] = (fn, names)
        return ent

    def _lite_pair(self):
        """Plan-time Freivalds material: ``(qs, w, w_norm, q_local)`` --
        the rank-1 probe factors ``lite_probe_axes(user_grid)`` (numpy),
        this rank's pencil of ``w = S^T C^T r`` (zero in the padding; its
        valid corner is that of the single-process adjoint), ``||w||``
        over the whole grid, and this rank's slices of the factors
        zero-padded to the padded extents (on the device).  ``w`` is one
        vector-Jacobian product of the single-process ``"torch"``-engine
        solve over the global grid (the same linear operator as the
        distributed pipeline), with the probe as its cotangent.  The
        batch axes share it, so it is built once per config.  None on
        the ``"cuda"`` engine (the kernels carry no gradient) and for a
        lazy_green solver: ``solve`` then runs the checked pipeline."""
        if "pair" in self._lite_weights:
            return self._lite_weights["pair"]
        ent = None
        if not (self.engine.use_cuda or self._ctor["lazy_green"]):
            grid = tuple(p.n_pts for p in self.plan.dirs)
            qs = _abft.lite_probe_axes(grid, self.dtype)
            r = torch.from_numpy(np.einsum("i,j,k->ijk", *qs)).to(
                self.device)
            w = lite_weight(lite_reference_impl(
                self.plan, self._green_raw, self.device), r)
            wn = float(torch.linalg.vector_norm(w.double()))
            if self.batch_axis is None:
                w_loc = self.shard_input(w)
            else:      # shard_input splits the leading pod axis too
                npod = self._size[self.batch_axis]
                w_loc = self.shard_input(w.expand((npod,) + w.shape))[0]
            # the factors on the padded extents, this rank's block of d1
            # and d2 (d0 is whole on every rank)
            d0, d1, d2 = self.plan.order
            a1, a2 = self.axes
            shp = self.local_input_shape()
            q_loc = []
            for dim, q in enumerate(qs):
                full = np.zeros(self.padded_input_shape()[dim], q.dtype)
                full[:q.shape[0]] = q
                start = {d1: self._coord[a1] * shp[d1],
                         d2: self._coord[a2] * shp[d2]}.get(dim, 0)
                q_loc.append(torch.from_numpy(
                    full[start:start + shp[dim]].copy()).to(self.device))
            ent = (qs, w_loc, wn, q_loc)
        self._lite_weights["pair"] = ent
        return ent

    def _lite_mismatch(self, x, y, ent):
        """The sandwich's relative mismatch, the same on every rank: this
        rank's ``<r, u>`` (three chained contractions of its output
        pencil ``y`` with its factor slices), ``<w, f>`` (one dot of its
        input pencil ``x`` with its block of ``w``) and ``||f||^2`` per
        batch row, summed over the mesh; the mismatch of those sums is
        MAX-agreed before anyone compares it with the tolerance."""
        _, w_loc, wn, (q0, q1, q2) = ent
        off = x.ndim - 3
        lead = tuple(x.shape[:off])
        rows = int(np.prod(lead)) if lead else 1
        a = torch.matmul(torch.matmul(torch.matmul(y, q2), q1), q0)
        xf = x.reshape(rows, -1)
        b = torch.matmul(xf, w_loc.reshape(-1))
        ff = torch.linalg.vector_norm(xf, dim=-1) ** 2
        part = torch.stack([a.reshape(rows), b, ff]).double()
        start, total = 0, rows
        if self.batch_axis is not None:
            # the pod rows are this rank's block of the global batch
            npod = self._size[self.batch_axis]
            start, total = self._coord[self.batch_axis] * rows, rows * npod
        sums = torch.zeros((3, total), dtype=torch.float64,
                           device=self.device)
        sums[:, start:start + rows] = part
        self._mesh_reduce(sums, dist.ReduceOp.SUM)
        if self.batch_axis is not None and npod > 1:
            dist.all_reduce(sums, op=dist.ReduceOp.SUM,
                            group=self._groups[self.batch_axis])
        a, b, ff = sums.cpu().numpy()
        n = float(np.prod([p.n_pts for p in self.plan.dirs]))
        floor = wn * np.sqrt(ff) / np.sqrt(n)
        return self._agree([_abft.lite_mismatch_ab(a, b, floor)])[0]

    # -- plan-time comm autotuner -----------------------------------------

    def autotune_key(self):
        """Canonical, repr-stable identity of (shape, bcs, layout, mesh,
        execution config): what every candidate's timing depends on."""
        dirs = self.plan.dirs
        eng = self.engine.name + ("" if self.engine.max_radix == 4
                                  else f"@r{self.engine.max_radix}")
        names = tuple(self.mesh.mesh_dim_names or ())
        return (
            tuple(p.n for p in dirs),
            tuple((p.bc.left.name, p.bc.right.name) for p in dirs),
            dirs[0].layout.name,
            tuple((a, int(self.mesh.size(i))) for i, a in enumerate(names)),
            self.mesh.device_type,
            tuple(self.axes), self.batch_axis,
            str(self.dtype).replace("torch.", ""), eng,
            ("doubling", self.plan.doubling),
            ("relayout", self.relayout),
            ("order", self.plan.order),
        )

    def comm_time_fn(self, batch=None, reps: int = 3):
        """``time_fn(cfg) -> seconds``: this rank's best of ``reps`` local
        solves under one comm config, after one warm-up.  ``batch`` follows
        ``_autotune``'s convention: the pod-split extent when
        ``batch_axis`` is set, else the in-block multi-RHS extent."""
        shape = self.local_input_shape(batch)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))

        def time_cfg(cfg):
            # a lazy_green solver times against its zero Green's function:
            # the switches' cost does not depend on its values
            x = torch.ones(shape, dtype=self.dtype, device=self.device)
            self._body(x, cfg)
            sync()
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                self._body(x, cfg)
                sync()
                best = min(best, time.perf_counter() - t0)
            return best

        return time_cfg

    def _autotune(self, candidates, cache_path, batch=None,
                  reps: int = 3, budget=None) -> CommConfig:
        if self.batch_axis is not None and batch is None:
            batch = self._size[self.batch_axis]
        self.autotune_results = {}
        self.autotune_census = {}
        if candidates is None:
            folds = (("pack", "unpack") if self.relayout == "scheduled"
                     else ("pack",))
            if self._ctor["autotune_search"] == "guided":
                # rank the comm sub-space with the analytic cost model and
                # time only the shortlisted frontier; the shortlist is a
                # pure function of the plan (the same on every rank), and
                # its labels are cache-key material, so a guided pick
                # never shadows (or replays) a brute one
                a1, a2 = self.axes
                candidates = guided_comm_candidates(
                    self.plan, self._size[a1], self._size[a2], self.dtype,
                    batch=batch if self.batch_axis is None else None,
                    folds=folds, relayout=self.relayout,
                    max_radix=self.engine.max_radix,
                    census=self.autotune_census)
            else:
                candidates = _default_candidates(folds=folds)
        key = self.autotune_key() + (("tuned_batch", batch),)
        return autotune_comm(key, self.comm_time_fn(batch, reps=reps),
                             candidates=candidates, cache_path=cache_path,
                             results=self.autotune_results,
                             budget_s=budget, census=self.autotune_census,
                             agree=self._agree, persist=dist.get_rank() == 0)

    # -- shapes, sharding and gathering -----------------------------------

    @property
    def input_shape(self):
        return self.plan.input_shape

    def padded_input_shape(self, batch=None):
        d0, d1, d2 = self.plan.order
        shp = [0, 0, 0]
        shp[d0] = self._U[d0]
        shp[d1] = self._PU1
        shp[d2] = self._PU2
        shp = tuple(shp)
        return ((batch,) + shp) if batch is not None else shp

    def local_input_shape(self, batch=None):
        """Shape of this rank's pencil of ``padded_input_shape(batch)``:
        d1 split over the first axis, d2 over the second, and ``batch``
        over ``batch_axis`` when one is set."""
        d0, d1, d2 = self.plan.order
        a1, a2 = self.axes
        shp = list(self.padded_input_shape())
        shp[d1] //= self._size[a1]
        shp[d2] //= self._size[a2]
        if batch is None:
            return tuple(shp)
        if self.batch_axis is not None:
            batch = _pad_to(batch, self._size[self.batch_axis]) \
                // self._size[self.batch_axis]
        return (batch,) + tuple(shp)

    def _pad_input(self, f):
        d0, d1, d2 = self.plan.order
        off = f.ndim - 3
        f = materialize_doubling(f, self.plan.dirs)
        f = pad_axis(f, d1 + off, self._PU1)
        return pad_axis(f, d2 + off, self._PU2)

    def shard_input(self, f):
        """This rank's padded pencil of the global field ``f`` (a tensor on
        the solver's device, in the working precision)."""
        d0, d1, d2 = self.plan.order
        a1, a2 = self.axes
        fp = self._pad_input(f)
        off = fp.ndim - 3
        blocks = [(d1 + off, a1), (d2 + off, a2)]
        if self.batch_axis is not None:
            blocks.append((0, self.batch_axis))
        for ax, a in blocks:
            m = fp.shape[ax] // self._size[a]
            if m * self._size[a] != fp.shape[ax]:
                raise ValueError(f"axis {ax} of length {fp.shape[ax]} does "
                                 f"not split over {self._size[a]} ranks of "
                                 f"{a!r}")
            fp = fp.narrow(ax, self._coord[a] * m, m)
        return fp.contiguous()

    def _all_gather(self, x, axis_name, ax):
        g = self._groups[axis_name]
        parts = [torch.empty_like(x) for _ in range(self._size[axis_name])]
        dist.all_gather(parts, x.contiguous(), group=g)
        return torch.cat(parts, dim=ax)

    def gather_output(self, y):
        """The global solution from every rank's output pencil ``y``:
        all-gathered over each mesh axis, then cropped to the user grid."""
        d0, d1, d2 = self.plan.order
        a1, a2 = self.axes
        off = y.ndim - 3
        y = self._all_gather(y, a2, d2 + off)
        y = self._all_gather(y, a1, d1 + off)
        if self.batch_axis is not None:
            y = self._all_gather(y, self.batch_axis, 0)
        y = crop_axis(y, d1 + off, self._U[d1])
        y = crop_axis(y, d2 + off, self._U[d2])
        return crop_doubling(y, self.plan.dirs).contiguous()

    # -- public API ----------------------------------------------------------

    def solve_local(self, x, green=None):
        """The local pipeline on this rank's padded pencil ``x`` (shape
        ``local_input_shape``, on the solver's device) under the current
        comm config; returns this rank's output pencil.  Collective: every
        rank of the mesh calls it.  No ladder, no verify.  ``green``: a
        Green block of ``lowered_shapes()[1]`` in place of the solver's
        own (a dry run passes a fake one, as ``lower`` does)."""
        if green is None:
            return self._run_local(x, self.comm)
        return self._body(x, self.comm, green=green)

    def solve(self, f, verify=None):
        """f: the global field on every rank, ``(*grid)``, ``(B, *grid)``
        (in-block batch, or the pod-split batch when ``batch_axis`` is set)
        or ``(B_pod, B, *grid)``; a numpy array or a tensor.  Returns the
        global solution, a tensor on every rank's device in the working
        precision.  Runs under the degradation ladder (every step agreed
        across the mesh; a rung is taken only for a failure an armed fault
        plan injected) and the ``verify`` guard ("nan" | "residual" |
        "abft" | "abft-stages"; module docstring).  Under ABFT, repaired
        stages land in ``stats["integrity"]``, surviving compute
        corruption raises ``IntegrityError`` into the ladder, and
        wire-attributed corruption retries as a transient first."""
        if isinstance(f, np.ndarray):
            f = torch.from_numpy(np.ascontiguousarray(f))
        f = torch.as_tensor(f).to(device=self.device, dtype=self.dtype)
        base = 3 + (1 if self.batch_axis is not None else 0)
        if f.ndim not in (base, base + 1) \
                or tuple(f.shape[-3:]) != tuple(self.input_shape):
            raise ValueError(f"f has shape {tuple(f.shape)}; the plan takes "
                             f"{self.input_shape} with {base - 3} or "
                             f"{base - 2} leading batch axes")
        verify = self.verify if verify is None else verify
        _check_verify(verify)

        def checked(x):
            fn, names = self.abft_jit_for(x.ndim > base)
            y, rep = fn(x)
            # the report is the same on every rank: so is the verdict
            _abft.verify_report(list(names), rep, tol=self._abft_tol(),
                                stats=self.stats, describe="dist.solve")
            return self.gather_output(y)

        def lite(x):
            ent = self._lite_pair()
            if ent is None:        # no sandwich weight: the checked mode
                return checked(x)
            y = self._run_local(x, self.comm)
            m = self._lite_mismatch(x, y, ent)
            tol = self._abft_tol() * _abft.LITE_HEADROOM
            if m <= tol:
                return self.gather_output(y)
            # the sandwich tripped on the mesh: localize through the
            # checked pipeline (every rank agreed on m, so every rank
            # re-dispatches)
            self.stats["verify_failures"] += 1
            self.stats.setdefault("integrity", []).append({
                "stage": "solve.linearity", "kind": "linearity",
                "mismatch": float(m), "tol": float(tol),
                "action": "localize", "describe": "dist.solve"})
            return checked(x)

        def attempt():
            fired = faults.firings()
            err = None
            try:
                faults.fail_point("dist.dispatch")
                x = self.shard_input(f)
                if verify == "abft-stages":
                    out = checked(x)
                elif verify == "abft":
                    out = lite(x)
                else:
                    out = self.gather_output(self._run_local(x, self.comm))
                if verify in ("nan", "residual"):
                    health.check_solution(
                        out, f, self.plan, mode=verify,
                        rtol=self.verify_rtol, stats=self.stats,
                        locate=lambda: health.locate_nonfinite_stage(
                            self.plan, self.schedule, f, self._green_raw))
            except resilience.SolveError:
                raise
            except Exception as e:  # noqa: BLE001 -- agreed below
                err = e
            injected = err is not None and (
                isinstance(err, faults.InjectedFault)
                or faults.firings() > fired)
            failed, real, lasting = self._agree([
                err is not None, err is not None and not injected,
                err is not None and not resilience.is_transient(err)])
            if failed:
                stage = (getattr(err, "stage", None) or "dist.solve"
                         if err is not None else "dist.peer")
                raise _MeshFailure(err, stage, transient=not lasting,
                                   injected=not real) from err
            return out

        out = resilience.run_with_ladder(
            attempt, config=self._cfg, reconfigure=self._configure,
            stats=self.stats,
            may_degrade=lambda e, action: getattr(e, "injected", False))
        self.stats["solves"] += 1
        return out

    # -- elastic recovery ----------------------------------------------------

    def rebuild(self, mesh, *, axes=None, comm=None):
        """Re-plan on a (possibly shrunken) surviving mesh: a NEW solver
        with the full construction identity replayed, the raw Green's
        function handed over (never reassembled), the current (possibly
        degraded) engine/relayout/doubling carried, and the old mesh's
        ``get_solver`` entries evicted.  Every rank of the NEW mesh calls
        it."""
        from repro_torch.core.solver import evict_solver_entries
        evict_solver_entries(self.mesh)
        c = self._ctor
        new = DistributedPoissonSolver(
            c["shape"], c["L"], c["bcs"], c["layout"], c["green_kind"],
            mesh=mesh, axes=tuple(axes) if axes is not None else self.axes,
            comm=comm if comm is not None else c["comm_req"],
            batch_axis=self.batch_axis, eps_factor=c["eps_factor"],
            dtype=self.dtype, lazy_green=c["lazy_green"],
            engine=(c["engine_obj"]
                    if c["engine_obj"].name == self._cfg["engine"]
                    else self._cfg["engine"]),
            doubling=self._cfg["doubling"],
            relayout=self._cfg["relayout"],
            order_policy=c["order_policy"],
            autotune_candidates=c["autotune_candidates"],
            autotune_cache=c["autotune_cache"],
            autotune_batch=c["autotune_batch"],
            autotune_budget=c["autotune_budget"],
            autotune_search=c["autotune_search"],
            verify=self.verify, verify_rtol=self.verify_rtol,
            abft_rtol=self.abft_rtol, device=self.device,
            _green_cache=self._green_raw)
        new.stats["degradations"] = list(self.stats["degradations"])
        return new

    # -- dry run -------------------------------------------------------------

    def lower(self, batch=None, dtype=None, *, local_batch: bool = False):
        """Trace this rank's local solve on fake tensors (the dry run): a
        ``core.trace.Trace`` of the all-to-alls, transforms, relayouts,
        Green multiply and kernel calls in program order, its ``inputs``
        the pencil's and the Green block's ``(shape, dtype)``.  Every rank
        of the mesh calls it (the collectives are issued, on fake
        tensors).

        ``batch`` sizes the leading batch dims as the reference's does: an
        int for the single one in play (the pod-split dim when
        ``batch_axis`` is set, else the in-block multi-RHS dim under
        ``local_batch=True``), or a ``(pod, local)`` pair when both are
        present; missing leading dims default to the pod axis's size and
        1.  ``dtype``: the field's, the working precision by default."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.core import trace as _trace
        dtype = dtype or self.dtype
        shape, gshape = self.lowered_shapes(batch, local_batch=local_batch)
        with FakeTensorMode(allow_non_fake_inputs=True), \
                _trace.tracing() as tr:
            x = torch.empty(shape, dtype=dtype, device=self.device)
            g = torch.empty(gshape, dtype=self.dtype, device=self.device)
            y = self.solve_local(x, green=g)
        tr.inputs = [(shape, dtype), (gshape, self.dtype)]
        tr.outputs = [(tuple(y.shape), y.dtype)]
        return tr

    def lowered_shapes(self, batch=None, *, local_batch: bool = False):
        """``(pencil shape, Green block shape)`` of this rank's local solve
        for ``lower``'s ``batch`` and ``local_batch``."""
        defaults = []           # leading dims in order: pod-split, local
        if self.batch_axis is not None:
            defaults.append(self._size[self.batch_axis])
        if local_batch:
            defaults.append(1)
        n_lead = len(defaults)
        lead = () if batch is None else (
            tuple(batch) if isinstance(batch, (tuple, list)) else (batch,))
        if len(lead) < n_lead:
            lead = tuple(defaults[:n_lead - len(lead)]) + lead
        if len(lead) != n_lead:
            raise ValueError(f"batch={batch!r} gives {len(lead)} leading "
                             f"dims; batch_axis={self.batch_axis!r} and "
                             f"local_batch={local_batch} take {n_lead}")
        if self.batch_axis is not None:
            lead = self.local_input_shape(lead[0])[:1] + lead[1:]
        return (lead + self.local_input_shape(),
                tuple(self._local_green_shape()[d] for d in self._gperm))

