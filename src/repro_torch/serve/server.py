"""Multi-tenant batched Poisson solve server (solve-as-a-service).

The paper's dominant production operation -- the unbounded Poisson solve
-- served from a long-lived process:

    admission -> per-plan-key coalescing -> batched multi-RHS solve
              -> per-tenant response + stats

* **Admission**: ``submit`` validates the request against its plan,
  applies backpressure (bounded pending depth, ``AdmissionError``), and
  enqueues it with its arrival timestamp.  Tenants are just labels --
  isolation is by plan key, accounting by tenant.
* **Coalescing**: requests sharing a plan key are merged into ONE batched
  multi-RHS solve (same transform count and kernel launches, B-fold
  payload).  A batch flushes when it reaches ``max_batch`` or when its
  oldest request has waited ``max_delay_ms`` (the latency deadline),
  whichever first.  The batch is zero-padded up to the nearest rank on
  the ``batch_ranks`` ladder (rows are independent through the whole
  pipeline, so padding never perturbs live results).  PyTorch runs
  eagerly and compiles nothing per batch size, so the ladder buys no
  compiled specialization here; it bounds the set of batch shapes a key
  serves, and ``padded_to``, ``padded_rhs`` and ``warmed_ranks`` report
  it as the reference does.
* **Warm pool**: constructed solvers live in a ``WarmPool`` under a
  memory budget; hot keys stay resident, cold keys are evicted (also
  from the module LRU) and rebuild on the next request through
  ``get_solver``'s single-flight path.
* **Resilience**: every batched solve runs under the degradation ladder
  (``PoissonSolver.solve`` -> ``run_with_ladder``).  Ladder records
  produced by a batch are attributed to every request in it and surface
  per tenant in ``tenant_stats()``.  A request may carry its own
  ``FaultPlan`` (chaos testing): it is armed around that batch's solve
  only, and because the fault token is part of the ``get_solver`` key the
  armed batch runs on a shadow solver -- the clean warm plan is never
  degraded.  The fault plan stack is process-global, as in ``repro``.
* **The device**: a spec's solver runs where its ``device`` says (None:
  the card, raising without one).  The batch goes to the device inside
  ``solve`` and its answer comes back to the host inside the ``solve_s``
  window, so ``solve_s`` includes the device work, not only its launch.
  Every worker thread launches on the device's current (default)
  stream, so ``workers > 1`` overlaps host work (stacking, copies,
  launch overhead), not device work.
* **Distributed specs**: a spec whose ``mesh`` holds one rank is served
  as any other.  A larger mesh is served by its lowest rank (rank 0 of
  the world when the mesh spans it), and every other rank of the mesh
  calls ``follow(mesh)``, which returns when the server stops: the
  multi-controller counterpart of the reference's single controller.
  For each batch the server broadcasts a header (the spec without mesh
  and device, the batch's shape, rank, dtype and verify mode, the armed
  fault plan's specs, and the pool's decision: build, hit or a shadow
  build, plus the keys it evicted since the last header), then the
  padded batch in the solver's working dtype.  Every rank then builds or
  looks up its solver as the pool decided, the ranks agree on the
  build's outcome, and all enter the same ``solve``; the answer is
  turned into ``SolveResult``s on the server's rank only.  Mesh batches
  hold one lock from their broadcast to the end of their solve, so with
  ``workers > 1`` their collectives never interleave and the followers
  meet them in the order sent; other keys still run concurrently.
  ``stop`` ends with a stop sentinel for every mesh served.  The header
  travels over the world group when the mesh spans the world, else a
  group of the mesh's ranks; a follower waits for it at most that
  group's timeout, then raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue
import threading
import time
import warnings
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import solver as sv
from repro_torch.core.bc import DataLayout
from repro_torch.core.green import GreenKind
from repro_torch.runtime import faults

from .pool import WarmPool
from .stats import RequestRecord, TenantStats

__all__ = ["PlanSpec", "SolveResult", "PoissonServer", "AdmissionError",
           "ServerClosed", "default_batch_ranks", "follow"]


class AdmissionError(RuntimeError):
    """Request rejected at admission (backpressure or bad shape)."""


class ServerClosed(AdmissionError):
    """Request submitted to a stopped/draining server, or failed by the
    drain deadline at shutdown.  ``queue_position`` (1-based, None for
    admission-time rejections) records where the request sat in the
    unserved queue when the deadline expired."""

    def __init__(self, msg: str, *, queue_position=None):
        super().__init__(msg)
        self.queue_position = queue_position


@dataclass(frozen=True)
class PlanSpec:
    """The serving identity of a solve: everything that selects a plan.

    Mirrors the ``get_solver`` signature; two requests coalesce into one
    batched solve iff their specs freeze to the same key.  ``mesh`` makes
    the spec distributed (a pencil solver on that mesh); ``solver_kw``
    passes through extra ``get_solver`` keywords (``comm``, ``dtype``,
    autotune knobs, ...) as a tuple of (name, value) pairs.  ``engine``:
    ``"cuda"`` (the hand kernels) or ``"torch"`` (``torch.fft``).
    ``device``: where the solver runs; None means the card, and building
    the solver raises without one.
    """

    shape: tuple
    bcs: tuple
    L: float = 1.0
    layout: DataLayout = DataLayout.CELL
    green_kind: GreenKind = GreenKind.CHAT2
    eps_factor: float = 2.0
    engine: str = "cuda"
    doubling: str = "deferred"
    relayout: str = "scheduled"
    order_policy: str = "layout"
    mesh: object = None
    solver_kw: tuple = ()
    # comm="auto" candidate policy on distributed specs (DESIGN.md #12):
    # "guided" warms the pool off the cost-model shortlist, "brute" sweeps
    search: str = "guided"
    device: object = None

    def key(self):
        return sv._freeze((self.shape, self.L, self.bcs, self.layout,
                           self.green_kind, self.eps_factor, self.engine,
                           self.doubling, self.relayout, self.order_policy,
                           self.mesh, self.solver_kw, self.search,
                           self.device))

    def build(self):
        kw = dict(self.solver_kw)
        if self.mesh is not None:
            kw.setdefault("autotune_search", self.search)
        return sv.get_solver(self.shape, self.L, self.bcs,
                             layout=self.layout, green_kind=self.green_kind,
                             eps_factor=self.eps_factor, engine=self.engine,
                             doubling=self.doubling, relayout=self.relayout,
                             order_policy=self.order_policy,
                             device=self.device, mesh=self.mesh, **kw)


@dataclass(frozen=True)
class SolveResult:
    """One response: the solution plus how the server produced it."""

    u: np.ndarray
    request_id: int
    tenant: str
    batch_size: int          # live requests in the coalesced solve
    padded_to: int           # batch rank the solve actually ran at
    queue_wait_s: float
    solve_s: float
    total_s: float
    degradations: tuple = ()
    integrity: tuple = ()    # ABFT repair/escalation records (verify="abft")


@dataclass
class _Request:
    request_id: int
    tenant: str
    f: np.ndarray
    spec: PlanSpec
    future: Future
    admit_t: float
    verify: str | None = None
    fault_plan: object = None
    # settled = response delivered (result, failure, or drain-deadline
    # ServerClosed) and the inflight count decremented -- exactly once,
    # even when a wedged worker completes after the deadline already
    # failed its batch
    settled: bool = False


@dataclass
class _Pending:
    """Per-plan-key coalescing buffer."""

    spec: PlanSpec
    requests: list = field(default_factory=list)

    @property
    def oldest_t(self):
        return self.requests[0].admit_t


def default_batch_ranks(max_batch: int) -> tuple:
    """Power-of-two batch-rank ladder up to ``max_batch`` (always
    includes ``max_batch`` itself): {1, 2, 4, ..., max_batch}."""
    ranks, r = [], 1
    while r < max_batch:
        ranks.append(r)
        r *= 2
    ranks.append(max_batch)
    return tuple(dict.fromkeys(ranks))


# -- serving on a mesh of several ranks ---------------------------------------

def _on_mesh(spec: PlanSpec) -> bool:
    return spec.mesh is not None and spec.mesh.size() > 1


def _mesh_ranks(mesh) -> tuple:
    return tuple(sorted(int(r) for r in mesh.mesh.flatten().tolist()))


def _mesh_layout(mesh) -> tuple:
    return tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names or ())


_GROUPS: dict = {}
_GROUPS_LOCK = threading.Lock()
# mesh ranks -> the server serving them: followers follow one at a time
_SERVING: dict = {}


def _serve_group(mesh):
    """The process group that carries a mesh's headers and batches (None,
    the world, when the mesh spans it) and its leader, the mesh's lowest
    global rank."""
    ranks = _mesh_ranks(mesh)
    if len(ranks) == dist.get_world_size():
        return None, ranks[0]
    with _GROUPS_LOCK:
        g = _GROUPS.get(ranks)
        if g is None:
            g = _GROUPS[ranks] = dist.new_group(
                list(ranks), use_local_synchronization=True)
    return g, ranks[0]


def _wire_device(group) -> torch.device:
    """Where a group's tensors travel: the card under NCCL, else the
    host (gloo stages a CUDA tensor through it anyway)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _send_batch(group, src, header: dict, x):
    """The leader's side of one batch: the header (pickled), then the
    padded batch (none after the stop sentinel)."""
    dist.broadcast_object_list([header], src=src, group=group)
    if x is not None:
        dist.broadcast(x, src=src, group=group)


def _recv_batch(group, src):
    """A follower's side of ``_send_batch``: ``(header, batch)``, the
    batch None after the stop sentinel."""
    box = [None]
    dist.broadcast_object_list(box, src=src, group=group)
    h = box[0]
    if h["op"] == "stop":
        return h, None
    x = torch.empty(h["shape"], dtype=h["dtype"], device=_wire_device(group))
    dist.broadcast(x, src=src, group=group)
    return h, x


def _agree_build(group, ranks, err):
    """Agree on every rank's solver build before any rank enters the
    collective solve: when one failed, every rank raises the same
    ``RuntimeError`` naming each failed rank's error."""
    flag = torch.tensor([0.0 if err is None else 1.0],
                        device=_wire_device(group))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    if flag.item() == 0.0:
        return
    why = [None] * len(ranks)
    dist.all_gather_object(why, None if err is None else repr(err),
                           group=group)
    failed = "; ".join(f"rank {r}: {w}" for r, w in zip(ranks, why)
                       if w is not None)
    raise RuntimeError(f"building the batch's solver failed on {failed}") \
        from err


def _mesh_batch(group, ranks, op, get, drop, run):
    """One batch on any rank of a mesh, after its broadcast: the solver
    (``get()``: a hit, a build or a shadow build as the header's ``op``
    says), its outcome agreed over the mesh, then ``run(solver)``, the
    collective solve.  A build that failed on another rank is void:
    ``drop(solver)`` forgets it, so the next batch of its key builds
    again on every rank; a shadow solver is evicted after its batch."""
    solver = err = None
    try:
        solver = get()
    except Exception as e:  # noqa: BLE001 -- agreed below
        err = e
    try:
        _agree_build(group, ranks, err)
    except RuntimeError:
        if solver is not None and op != "hit":
            drop(solver)
        raise
    try:
        return run(solver)
    finally:
        if op == "shadow":
            sv.evict_solver_instance(solver)


def _timed_solve(solver, fb, verify):
    """The batch's solve with its seconds and the degradation and
    integrity records it added.  The solver moves the batch to its
    device; the answer comes back to the host inside the window (which
    waits for the device: its work is asynchronous)."""
    ndeg0 = len(solver.stats["degradations"])
    nint0 = len(solver.stats.get("integrity", ()))
    t0 = time.perf_counter()
    ub = solver.solve(fb, verify=verify).cpu().numpy()
    solve_s = time.perf_counter() - t0
    return (ub, solve_s, tuple(solver.stats["degradations"][ndeg0:]),
            tuple(solver.stats.get("integrity", ())[nint0:]))


def follow(mesh, *, device=None) -> dict:
    """Follow the server of ``mesh`` on this rank until it stops.

    Every rank of the mesh but its lowest (the one that runs
    ``PoissonServer``) calls this once per server, with the ``DeviceMesh``
    the server's specs carry.  For each batch it receives the header and
    the padded batch, rebuilds the spec on ``mesh`` and ``device`` (this
    rank's; None means the card and raises without one), builds, hits or
    evicts its solver as the server's pool did, arms a fresh
    ``FaultPlan`` from the header's specs around the batch, and enters
    the same ``solve``.  A batch whose build or solve fails fails on every
    rank alike (the outcome is agreed); the follower notes it and waits
    for the next header.  Returns at the stop sentinel with ``batches``
    (entered), ``failed`` (each failed batch's error) and ``solvers``
    (the solvers this rank keeps warm: the server's pool size on the
    mesh).  Raises when no header arrives within the group's timeout."""
    group, src = _serve_group(mesh)
    ranks = _mesh_ranks(mesh)
    me = dist.get_rank()
    if me == src or me not in ranks:
        raise ValueError(f"rank {me} is not a follower of the mesh over "
                         f"ranks {ranks}: rank {src} runs the server")
    layout = _mesh_layout(mesh)
    mirror: dict = {}
    out = {"batches": 0, "failed": []}
    while True:
        h, x = _recv_batch(group, src)
        for kid in h["evict"]:
            s = mirror.pop(kid, None)
            if s is not None:
                sv.evict_solver_instance(s)
        if x is None:
            break
        out["batches"] += 1
        kid, op = h["key"], h["op"]
        spec = dataclasses.replace(h["spec"], mesh=mesh, device=device)

        def get():
            if h["mesh"] != layout:
                raise ValueError(f"the batch's mesh {h['mesh']} is not "
                                 f"this follower's {layout}")
            if op == "hit":
                return mirror[kid]
            if op == "shadow":
                return spec.build()
            stale = mirror.pop(kid, None)
            if stale is not None:
                sv.evict_solver_instance(stale)
            s = mirror[kid] = spec.build()
            return s

        def drop(s):
            if mirror.get(kid) is s:
                del mirror[kid]
            sv.evict_solver_instance(s)

        plan = (contextlib.nullcontext() if h["faults"] is None
                else faults.FaultPlan(h["faults"]))
        try:
            with plan:
                _mesh_batch(group, ranks, op, get, drop,
                            lambda s: s.solve(x, verify=h["verify"]))
        except Exception as e:  # noqa: BLE001 -- failed on every rank
            out["failed"].append(f"{type(e).__name__}: {e}")
    out["solvers"] = len(mirror)
    return out


class PoissonServer:
    """Long-lived multi-tenant Poisson solve service.

    ``max_batch``     coalescing limit (and largest batch rank)
    ``max_delay_ms``  latency deadline: a pending batch never waits longer
                      than this for co-batchable traffic before flushing
    ``batch_ranks``   batch-shape ladder (default powers of two);
                      batches pad up to the nearest rank
    ``memory_budget_mb``  warm-pool budget; None = unbounded
    ``max_pending``   admission backpressure bound (pending + in-flight)
    ``workers``       solve worker threads (distinct plan keys execute
                      concurrently; one key's batches stay ordered through
                      the flush queue)
    ``drain_timeout_s``  bound on ``stop(drain=True)``: once the deadline
                      expires, every unserved request fails with
                      ``ServerClosed`` (carrying its queue position) so a
                      wedged solve can never hang shutdown.  None = wait
                      forever (the pre-deadline behaviour)

    Use as a context manager or call ``start()``/``stop()``.  ``submit``
    returns a ``concurrent.futures.Future`` resolving to ``SolveResult``.
    """

    def __init__(self, *, max_batch: int = 8, max_delay_ms: float = 2.0,
                 batch_ranks=None, memory_budget_mb=None,
                 max_pending: int = 1024, workers: int = 1,
                 verify=None, drain_timeout_s: float | None = 30.0):
        assert max_batch >= 1 and max_pending >= 1 and workers >= 1
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) * 1e-3
        self.batch_ranks = tuple(sorted(batch_ranks)) if batch_ranks \
            else default_batch_ranks(self.max_batch)
        assert self.batch_ranks[-1] >= self.max_batch, (
            "batch_ranks must cover max_batch", self.batch_ranks)
        self.verify = verify
        self.drain_timeout_s = drain_timeout_s
        self.pool = WarmPool(
            None if memory_budget_mb is None
            else int(memory_budget_mb * 1e6), on_evict=self._evicted)
        self.max_pending = int(max_pending)
        self.workers = int(workers)
        self._ids = itertools.count()
        self._cv = threading.Condition()
        self._pending: dict = {}            # key -> _Pending
        self._dispatched: dict = {}         # request_id -> _Request, flushed
        self._inflight = 0                  # admitted, not yet responded
        self._running = False
        self._draining = False
        self._flushq: queue.Queue = queue.Queue()
        self._threads: list = []
        self._tenants: dict = {}
        self._tenants_lock = threading.Lock()
        # mesh batches: one at a time from broadcast to gather; each mesh
        # key's id in the headers; the mesh keys the pool evicted since
        # the last header; each mesh's (group, leader), for the sentinel
        self._mesh_lock = threading.Lock()
        self._mesh_ids: dict = {}
        self._mesh_evicted: list = []
        self._evicted_lock = threading.Lock()
        self._meshes: dict = {}
        self.stats = {"admitted": 0, "rejected": 0, "completed": 0,
                      "failed": 0, "batches": 0, "deadline_flushes": 0,
                      "full_flushes": 0, "drain_flushes": 0,
                      "padded_rhs": 0, "drain_timeouts": 0}

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        assert not self._running and not self._threads
        self._running = True
        self._draining = False
        t = threading.Thread(target=self._dispatch_loop,
                             name="serve-dispatch", daemon=True)
        self._threads.append(t)
        for i in range(self.workers):
            w = threading.Thread(target=self._worker_loop,
                                 name=f"serve-worker-{i}", daemon=True)
            self._threads.append(w)
        for t in self._threads:
            t.start()
        return self

    def stop(self, drain: bool = True, timeout=None):
        """Stop the server; ``drain=True`` (default) first serves every
        admitted request -- bounded by ``timeout`` (default: the
        constructor's ``drain_timeout_s``).  When the deadline expires,
        every still-unserved request fails with ``ServerClosed`` carrying
        its queue position, so one wedged solve (a stalled collective, a
        fault-armed shadow batch) cannot hang shutdown; the wedged worker
        thread is abandoned as a daemon and its late result is discarded
        by the per-request ``settled`` guard.  ``drain=False`` fails
        pending requests immediately."""
        deadline = self.drain_timeout_s if timeout is None else timeout
        with self._cv:
            if not self._running:
                return
            self._draining = True
            if not drain:
                for p in self._pending.values():
                    for r in p.requests:
                        r.settled = True
                        r.future.set_exception(
                            ServerClosed("server stopped without drain"))
                        self._request_done()
                self._pending.clear()
            self._cv.notify_all()
        # wait for the dispatcher to flush the tail, then stop the workers
        with self._cv:
            drained = self._cv.wait_for(
                lambda: not self._pending and self._inflight == 0,
                timeout=deadline)
            if not drained:
                self._fail_unserved_locked(deadline)
            self._running = False
            self._cv.notify_all()
        for _ in range(self.workers):
            self._flushq.put(None)
        join_t = None if deadline is None else max(deadline, 1.0)
        alive = []
        for t in self._threads:
            t.join(timeout=join_t)
            if t.is_alive():
                alive.append(t.name)
        self._threads.clear()
        if alive:
            with self._cv:
                self.stats["abandoned_threads"] = \
                    self.stats.get("abandoned_threads", 0) + len(alive)
        self._release_followers(join_t)

    def _release_followers(self, wait_s):
        """Send every mesh served the stop sentinel once no mesh batch
        holds the lock, waiting at most ``wait_s`` (None: no bound) for
        a wedged one; past that the followers leave at their group's
        timeout."""
        if not self._meshes:
            return
        if not self._mesh_lock.acquire(
                timeout=-1 if wait_s is None else wait_s):
            warnings.warn("PoissonServer.stop: a mesh batch still holds "
                          "the mesh lock; its followers leave at their "
                          "group's timeout", RuntimeWarning, stacklevel=3)
            return
        try:
            evict = self._take_evicted()
            for ranks, (group, src) in self._meshes.items():
                _send_batch(group, src, {"op": "stop", "evict": evict}, None)
                with _GROUPS_LOCK:
                    _SERVING.pop(ranks, None)
            self._meshes.clear()
        finally:
            self._mesh_lock.release()

    def _fail_unserved_locked(self, deadline):
        """Drain deadline expired: fail every unserved request (in-flight
        batches first, then never-flushed pending, in admission order)
        with a position-stamped ``ServerClosed``.  Caller holds the cv."""
        backlog = [r for p in self._pending.values() for r in p.requests]
        self._pending.clear()
        victims = (sorted(self._dispatched.values(),
                          key=lambda r: r.request_id)
                   + sorted(backlog, key=lambda r: r.request_id))
        victims = [r for r in victims if not r.settled]
        for pos, r in enumerate(victims, 1):
            r.settled = True
            self._dispatched.pop(r.request_id, None)
            r.future.set_exception(ServerClosed(
                f"drain deadline ({deadline}s) expired with request "
                f"{r.request_id} unserved at queue position "
                f"{pos}/{len(victims)}", queue_position=pos))
            self._tenant(r.tenant).record_failed()
            self.stats["failed"] += 1
            self.stats["drain_timeouts"] += 1
            self._request_done()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=exc == (None, None, None))
        return False

    # -- admission ---------------------------------------------------------
    def submit(self, f, spec: PlanSpec, *, tenant: str = "default",
               verify=None, fault_plan=None) -> Future:
        """Admit one solve request (a single rhs of ``spec``'s grid shape).

        Returns a future resolving to ``SolveResult``.  Raises
        ``ServerClosed`` after ``stop`` began and ``AdmissionError`` under
        backpressure (``max_pending`` admitted-but-unserved requests) or on
        a shape mismatch -- rejections are also counted per tenant.
        A spec on a mesh of several ranks is served by the mesh's lowest
        rank; ``submit`` on any other rank raises ``RuntimeError`` (that
        rank calls ``follow(mesh)``).
        """
        if _on_mesh(spec):
            src = _mesh_ranks(spec.mesh)[0]
            if dist.get_rank() != src:
                raise RuntimeError(
                    f"rank {dist.get_rank()} follows the server of this "
                    f"mesh: call repro_torch.serve.follow(mesh) here and "
                    f"submit on rank {src}")
        f = np.asarray(f)
        ts = self._tenant(tenant)
        grid = tuple(spec.shape)
        want = tuple(n + (1 if spec.layout == DataLayout.NODE else 0)
                     for n in grid)
        if f.shape != want:
            ts.record_rejected()
            with self._cv:
                self.stats["rejected"] += 1
            raise AdmissionError(
                f"rhs shape {f.shape} does not match plan grid {want}")
        fut: Future = Future()
        with self._cv:
            if not self._running or self._draining:
                self.stats["rejected"] += 1
                ts.record_rejected()
                raise ServerClosed("server is not accepting requests")
            if self._inflight >= self.max_pending:
                self.stats["rejected"] += 1
                ts.record_rejected()
                raise AdmissionError(
                    f"backpressure: {self._inflight} requests in flight "
                    f"(max_pending={self.max_pending})")
            req = _Request(next(self._ids), tenant, f, spec, fut,
                           time.perf_counter(), verify=verify,
                           fault_plan=fault_plan)
            key = spec.key()
            pend = self._pending.get(key)
            if pend is None:
                pend = self._pending[key] = _Pending(spec)
            pend.requests.append(req)
            self._inflight += 1
            self.stats["admitted"] += 1
            self._cv.notify_all()
        return fut

    def solve(self, f, spec: PlanSpec, *, tenant: str = "default",
              timeout=None) -> SolveResult:
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(f, spec, tenant=tenant).result(timeout=timeout)

    # -- dispatcher --------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            with self._cv:
                batch = self._take_ready_locked()
                while batch is None:
                    if self._draining and not self._pending:
                        if self._inflight == 0:
                            self._cv.notify_all()
                        if not self._running:
                            return
                        self._cv.wait(0.01)
                    else:
                        self._cv.wait(self._next_deadline_locked())
                    if not self._running and not self._pending:
                        return
                    batch = self._take_ready_locked()
            self._flushq.put(batch)

    def _take_ready_locked(self):
        """Pop the first flush-ready batch: full, past its deadline, or
        the server is draining.  Caller holds the condition lock."""
        now = time.perf_counter()
        for key, pend in self._pending.items():
            full = len(pend.requests) >= self.max_batch
            aged = now - pend.oldest_t >= self.max_delay_s
            if not (full or aged or self._draining):
                continue
            take = pend.requests[:self.max_batch]
            pend.requests = pend.requests[self.max_batch:]
            if not pend.requests:
                del self._pending[key]
            for r in take:
                self._dispatched[r.request_id] = r
            self.stats["batches"] += 1
            self.stats["full_flushes" if full else
                       "drain_flushes" if self._draining and not aged else
                       "deadline_flushes"] += 1
            return key, pend.spec, take
        return None

    def _next_deadline_locked(self):
        if not self._pending:
            return None                     # sleep until notified
        now = time.perf_counter()
        oldest = min(p.oldest_t for p in self._pending.values())
        return max(1e-4, oldest + self.max_delay_s - now)

    # -- workers -----------------------------------------------------------
    def _worker_loop(self):
        while True:
            item = self._flushq.get()
            if item is None:
                return
            key, spec, reqs = item
            try:
                self._execute(key, spec, reqs)
            except BaseException as e:  # noqa: BLE001 -- fail the batch, not the server
                with self._cv:
                    fresh = [r for r in reqs if not r.settled]
                    for r in fresh:
                        r.settled = True
                        self._dispatched.pop(r.request_id, None)
                    self.stats["failed"] += len(fresh)
                    for _ in fresh:
                        self._request_done()
                for r in fresh:
                    if not r.future.done():
                        r.future.set_exception(e)
                    self._tenant(r.tenant).record_failed()

    def _execute(self, key, spec: PlanSpec, reqs):
        flush_t = time.perf_counter()
        b = len(reqs)
        rank = next(r for r in self.batch_ranks if r >= b)
        fb = np.stack([r.f for r in reqs], axis=0)
        if rank > b:                        # pad to the nearest rank:
            pad = np.zeros((rank - b,) + fb.shape[1:], fb.dtype)
            fb = np.concatenate([fb, pad], axis=0)
        # one armed FaultPlan per batch (chaos tests submit one faulted
        # request at a time); arming it keys get_solver to a shadow solver
        # so the clean warm plan's config is never degraded
        plans = [r.fault_plan for r in reqs if r.fault_plan is not None]
        ctx = plans[0] if plans else contextlib.nullcontext()
        verify = next((r.verify for r in reqs if r.verify is not None),
                      self.verify)
        with ctx:
            if _on_mesh(spec):
                ub, solve_s, degs, ints = self._solve_on_mesh(
                    key, spec, fb, plans[0] if plans else None, verify)
            else:
                # an armed batch bypasses the pool: the fault token in the
                # get_solver key yields a SHADOW solver, so the ladder
                # degrades (and the fault taints) that transient instance
                # -- never the clean warm plan other tenants keep hitting
                solver = spec.build() if plans \
                    else self.pool.acquire(key, spec.build)
                ub, solve_s, degs, ints = _timed_solve(solver, fb, verify)
        if not plans:                       # shadow solvers are transient
            self.pool.note_rank(key, rank)
        done_t = time.perf_counter()
        with self._cv:
            fresh = {r.request_id for r in reqs if not r.settled}
            for r in reqs:
                if r.request_id in fresh:
                    r.settled = True
                    self._dispatched.pop(r.request_id, None)
            self.stats["completed"] += len(fresh)
            self.stats["padded_rhs"] += rank - b
            for _ in fresh:
                self._request_done()
        for i, r in enumerate(reqs):
            if r.request_id not in fresh:   # drain deadline beat us to it
                continue
            res = SolveResult(
                u=ub[i], request_id=r.request_id, tenant=r.tenant,
                batch_size=b, padded_to=rank,
                queue_wait_s=flush_t - r.admit_t, solve_s=solve_s,
                total_s=done_t - r.admit_t, degradations=degs,
                integrity=ints)
            self._tenant(r.tenant).record(RequestRecord(
                r.request_id, res.queue_wait_s, solve_s, res.total_s,
                b, rank, degs))
            r.future.set_result(res)

    def _solve_on_mesh(self, key, spec: PlanSpec, fb, plan, verify):
        """One batch of a mesh spec, the leader's side (module docstring):
        under the mesh lock, the header and the padded batch go to the
        followers, every rank gets its solver as this pool decides, the
        outcome is agreed, and every rank enters the solve."""
        group, src = _serve_group(spec.mesh)
        ranks = _mesh_ranks(spec.mesh)
        dtype = dict(spec.solver_kw).get("dtype", torch.float32)
        with self._mesh_lock:
            with _GROUPS_LOCK:
                other = _SERVING.setdefault(ranks, self)
            if other is not self:
                raise RuntimeError(f"another PoissonServer serves the mesh "
                                   f"over ranks {ranks}: its followers "
                                   "follow one server at a time")
            self._meshes[ranks] = (group, src)
            kid = self._mesh_ids.setdefault(key, len(self._mesh_ids))
            solver = None if plan is not None else self.pool.lookup(key)
            op = ("shadow" if plan is not None
                  else "hit" if solver is not None else "build")
            # the working dtype's bits, cast once here for every rank
            x = torch.from_numpy(fb).to(_wire_device(group), dtype)
            header = {
                "op": op, "key": kid, "evict": self._take_evicted(),
                "spec": dataclasses.replace(spec, mesh=None, device=None),
                "mesh": _mesh_layout(spec.mesh), "rank": fb.shape[0],
                "shape": tuple(x.shape), "dtype": dtype, "verify": verify,
                "faults": None if plan is None else [
                    dataclasses.asdict(s) for s in plan.specs]}
            _send_batch(group, src, header, x)

            def get():
                if op == "hit":
                    return solver
                if op == "shadow":
                    return spec.build()
                return self.pool.acquire(key, spec.build)
            return _mesh_batch(group, ranks, op, get,
                               lambda s: self.pool.discard(key),
                               lambda s: _timed_solve(s, x, verify))

    def _evicted(self, key):
        # the pool's eviction hook (under its lock): a mesh key's
        # followers drop it at the next header
        if key in self._mesh_ids:
            with self._evicted_lock:
                self._mesh_evicted.append(self._mesh_ids[key])

    def _take_evicted(self) -> list:
        with self._evicted_lock:
            taken, self._mesh_evicted = self._mesh_evicted, []
        return taken

    def _request_done(self):
        # caller holds self._cv
        self._inflight -= 1
        if self._inflight == 0:
            self._cv.notify_all()

    # -- observability -----------------------------------------------------
    def _tenant(self, name: str) -> TenantStats:
        with self._tenants_lock:
            ts = self._tenants.get(name)
            if ts is None:
                ts = self._tenants[name] = TenantStats(name)
            return ts

    def tenant_stats(self) -> dict:
        with self._tenants_lock:
            tenants = list(self._tenants.values())
        return {ts.tenant: ts.summary() for ts in tenants}

    def server_stats(self) -> dict:
        with self._cv:
            out = dict(self.stats, inflight=self._inflight,
                       pending_keys=len(self._pending))
        out["pool"] = self.pool.info()
        out["solver_cache"] = sv.solver_cache_info()
        if out["batches"]:
            out["mean_batch_occupancy"] = out["completed"] / out["batches"]
        return out
