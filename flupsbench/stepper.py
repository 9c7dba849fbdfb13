"""The closed-loop time stepper the window drives, on one rank or on each
rank of a mesh, and the check of what it produced.

A step takes the ring's next right-hand side, solves, and reads back one
scalar, max|u| (all-reduced over the ranks on a mesh), as a CFL check
would: that read-back is the step's one synchronisation.  A step fails if
the solve raised, walked the degradation ladder (``stats`` ``retries`` or
``degradations`` grew) or returned a non-finite value.

The program is entered through ``PoissonSolver.solve`` on one rank and
``DistributedPoissonSolver.solve_local`` on each rank of a mesh; the
benchmark takes nothing else from it but ``shard_input`` /
``gather_output`` (the pencils' layout) and the collective census.
"""
from __future__ import annotations

import contextlib
import math
import sys
import time
from dataclasses import dataclass, field

import torch

from flupsbench import catalog, devtrace, fields

# the traced run: host enqueue times over the first half of the window,
# then this many steps under the profiler
PROFILE_STEPS = 40
# the comparison also takes the output of one step drawn from the seed
# among the window's first ones
SAMPLE_BELOW = 64
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What one rank saw of a run; the metric readers read rank 0's."""
    config: dict
    traffic: dict
    world: int
    batch: int
    device_kind: str
    setup_s: float = float("nan")
    steps: list = field(default_factory=list)     # wall s a step
    host: list = field(default_factory=list)      # enqueue s a step
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    stretch: devtrace.Stretch | None = None
    busy_s: float = 0.0           # the traced stretch, averaged over ranks
    traced_s: float = 0.0
    census_bytes: int = 0         # all-to-all bytes a step on this rank
    checks: dict = field(default_factory=dict)
    errors: list = field(default_factory=list)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _comm(spec: str):
    from repro_torch.core.comm import CommConfig
    strategy, _, chunks = spec.partition(":")
    return CommConfig(strategy=strategy, n_chunks=int(chunks or 2))


class Program:
    """The system under test, built as the configuration states."""

    def __init__(self, cell: catalog.Cell, device, mesh=None):
        from repro_torch.core.bc import BCType, DataLayout
        cfg = cell.config
        self.batch = int(cfg["batch"])
        self.dtype = getattr(torch, cfg["dtype"])
        self.mesh = mesh
        kw = dict(layout=DataLayout(cfg["layout"]), green_kind=cfg["green"],
                  engine=cfg["engine"], doubling=cfg["doubling"],
                  relayout=cfg["relayout"], device=device)
        shape = (cfg["n"],) * 3
        bcs = tuple(tuple(BCType(b) for b in pair) for pair in cfg["bcs"])
        if mesh is None:
            from repro_torch.core.solver import PoissonSolver
            self.solver = PoissonSolver(shape, float(cfg["L"]), bcs, **kw)
            self.step = self.solver.solve
        else:
            from repro_torch.distributed.pencil import \
                DistributedPoissonSolver
            self.solver = DistributedPoissonSolver(
                shape, float(cfg["L"]), bcs, mesh=mesh,
                comm=_comm(cfg["comm"]), dtype=self.dtype,
                **kw)
            self.step = self.solver.solve_local

    def local(self, f):
        """This rank's input of the global fields ``f``."""
        f = f.to(self.dtype)
        return f if self.mesh is None else self.solver.shard_input(f)

    def whole(self, y):
        """The global solution from this rank's output (collective)."""
        return y if self.mesh is None else self.solver.gather_output(y)

    def health(self):
        s = self.solver.stats
        return s["retries"], len(s["degradations"])


class _Stepper:
    """One rank's steps: solve, read back, agree on the flags."""

    def __init__(self, prog, ring, device, world):
        self.prog, self.ring, self.world = prog, ring, world
        self.flags = torch.zeros(3, dtype=torch.float64, device=device)
        self.health = prog.health()
        self.k = 0
        self.last = None          # (step, ring index, output)
        self.sample = None
        self.sample_at = -1

    def __call__(self, run: Run, stop: bool, traced: bool = False):
        """One step; returns whether the window is to close (rank 0's
        ``stop``, agreed over the ranks)."""
        idx = self.k % len(self.ring)
        ta = time.perf_counter()
        y, bad = None, False
        try:
            y = self.prog.step(self.ring[idx])
        except Exception as e:  # noqa: BLE001 -- counted as a failed step
            bad = True
            if len(run.errors) < 3:
                run.errors.append(f"step {self.k}: {type(e).__name__}: {e}")
        tb = time.perf_counter()
        h = self.prog.health()
        if h != self.health:
            bad, self.health = True, h
        ctx = (torch.profiler.record_function(devtrace.READBACK) if traced
               else contextlib.nullcontext())
        with ctx:
            if self.world == 1:
                m = math.inf if y is None else float(
                    torch.linalg.vector_norm(y, ord=math.inf))
                agreed = [m, float(bad), float(stop)]
            else:
                import torch.distributed as dist
                if y is None:
                    self.flags[0].fill_(math.inf)
                else:
                    self.flags[0].copy_(torch.nan_to_num(
                        torch.linalg.vector_norm(y, ord=math.inf),
                        nan=math.inf))
                self.flags[1].fill_(float(bad))
                self.flags[2].fill_(float(stop))
                dist.all_reduce(self.flags, op=dist.ReduceOp.MAX)
                agreed = self.flags.tolist()
        tc = time.perf_counter()
        run.steps.append(tc - ta)
        run.host.append(tb - ta)
        run.attempted += 1
        if agreed[1] or not math.isfinite(agreed[0]):
            run.failed += 1
        if self.k == self.sample_at and y is not None:
            self.sample = (self.k, idx, y.clone())
        self.last = (self.k, idx, y)
        self.k += 1
        return bool(agreed[2])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(step: _Stepper, run: Run, seconds: float, trace: bool,
            rank: int, device):
    """Steps until rank 0 has seen ``seconds`` pass (half of them in a
    traced run, then ``PROFILE_STEPS`` steps under the profiler)."""
    limit = seconds / 2 if trace else seconds
    w0 = time.perf_counter()
    while not step(run, rank == 0 and time.perf_counter() - w0 >= limit):
        pass
    run.window_s = time.perf_counter() - w0
    if not trace:
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    first = len(run.steps)
    with profile(activities=acts) as prof:
        with record_function(devtrace.STRETCH):
            for _ in range(PROFILE_STEPS):
                step(run, False, traced=True)
    # the enqueue times under the profiler are the profiler's, not the
    # program's: the host metric reads the untraced half
    del run.host[first:]
    run.stretch = devtrace.read(prof, PROFILE_STEPS)


def _census(prog, x) -> int:
    """All-to-all bytes one step sends from this rank (the comm layer's
    census, one extra solve in set-up)."""
    from repro_torch.core.comm import collective_census
    with collective_census() as c:
        prog.step(x)
    return int(c.stats()["total_bytes"])


def _rel_err(u, ref) -> float:
    """max over fields of max|u - ref| / max|ref|, in float64."""
    out = 0.0
    for a, b in zip(u, ref):
        b = b.to(torch.float64)
        d = (a.to(torch.float64) - b).abs().max() / b.abs().max()
        out = max(out, float(d))
    return out


def check(cell: catalog.Cell, seed: int, device, batch: int,
          outputs) -> dict:
    """Hold each ``(name, ring index, output)`` against the plain reference
    on the same right-hand sides, made again from the seed: ``{name:
    {"value", "limit"}}``; a missing output reads inf."""
    cfg = cell.config
    ref_mod = catalog.reference(cfg)
    ring = fields.ring(cfg, cell.traffic, seed, device, batch)
    limit = float(cfg["limits"]["rel_err"])
    out = {}
    for name, idx, u in outputs:
        if u is None:
            out[name] = {"value": math.inf, "limit": limit}
            continue
        ref = ref_mod.solve(cfg, ring[idx].to(getattr(torch, cfg["dtype"])))
        out[name] = {"value": _rel_err(u, ref), "limit": limit}
        del ref
    return out


def control(cell: catalog.Cell):
    """The control, as a ``patch`` for ``drive``: the plain reference kept
    in the configuration's ``control_store`` precision (its arithmetic in
    float32) put in the program's place, so that the window drives it and
    the run's own comparison judges it.  One rank only."""
    cfg = cell.config
    ref_mod = catalog.reference(cfg)
    store, dtype = getattr(torch, cfg["control_store"]), \
        getattr(torch, cfg["dtype"])

    def patch(prog):
        prog.step = lambda f: ref_mod.solve(
            cfg, f, store=store, work=torch.float32).to(dtype)
    return patch


def drive(cell: catalog.Cell, seeds, seconds: float, trace: bool, device,
          rank: int = 0, world: int = 1, mesh=None, t0: float | None = None,
          patch=None):
    """Run the cell on this rank for each seed in turn (one program, built
    once); returns ``[Run, ...]``, complete on rank 0.  ``patch(prog)``
    (the control, tests' faults) may replace what the window drives."""
    import torch.distributed as dist
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog = Program(cell, device, mesh)
    if patch is not None:
        patch(prog)
    runs = []
    for i, seed in enumerate(seeds):
        run = Run(cell.config, cell.traffic, world, prog.batch, kind)
        ring = [prog.local(f) for f in fields.ring(
            cell.config, cell.traffic, seed, device, prog.batch)]
        step = _Stepper(prog, ring, device, world)
        for _ in range(int(cell.traffic["warmup_steps"])):
            step(run, False)
        if world > 1 and i == 0:
            run.census_bytes = _census(prog, ring[0])
        run.steps.clear()
        run.host.clear()
        run.attempted = run.failed = 0
        step.k = 0
        step.sample_at = (int(seed) * 2654435761) % SAMPLE_BELOW
        step.sample, step.last = None, None
        _sync(device)
        if world > 1:
            dist.barrier()
        if t0 is not None and i == 0:
            run.setup_s = time.perf_counter() - t0
        _window(step, run, seconds, trace, rank, device)
        found = forbidden_modules()
        if found:
            raise SystemExit(f"flupsbench: {', '.join(found)} loaded in the "
                             "process that reports: refusing to report")
        if device.type == "cuda":
            run.peak_bytes = torch.cuda.max_memory_allocated(device)
        if run.stretch is not None:
            run.busy_s, run.traced_s = run.stretch.busy_s(), \
                run.stretch.window_s
        # a window too short to reach the sampled step compares the last
        outs = [(n, v[1], None if v[2] is None else prog.whole(v[2]))
                for n, v in (("last_step", step.last),
                             ("sampled_step", step.sample)) if v is not None]
        if world > 1:
            t = torch.tensor([run.peak_bytes, run.busy_s, run.traced_s],
                             dtype=torch.float64, device=device)
            mx = t.clone()
            dist.all_reduce(mx, op=dist.ReduceOp.MAX)
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
            run.peak_bytes = int(mx[0])
            run.busy_s, run.traced_s = float(t[1]) / world, \
                float(t[2]) / world
        del ring, step
        last_seed = i == len(seeds) - 1
        if last_seed:
            # the program's state goes before the reference runs, so the
            # reference neither sets the peak nor runs short of memory
            del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if rank == 0:
            run.checks = check(cell, seed, device, run.batch, outs)
        del outs
        if world > 1:
            dist.barrier()
        runs.append(run)
    return runs


def rank_entry(rank: int, world: int, init: str, root: str, name: str,
               seeds, seconds: float, trace: bool, device_type: str,
               t0=None, patch=None):
    """One rank of a mesh run: join the group, build the mesh the traffic
    names, drive the cell, leave.  Returns the runs (rank 0's complete)."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    cell = catalog.cell(name, root)
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        shape = tuple(cell.traffic["mesh"])
        mesh = DeviceMesh(device.type, torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        return drive(cell, seeds, seconds, trace, device, rank, world, mesh,
                     t0, patch)
    finally:
        dist.destroy_process_group()
