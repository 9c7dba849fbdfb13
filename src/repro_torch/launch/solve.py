"""Distributed Poisson solve launcher (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.solve --n 32 --p1 2 --p2 2 \
        --bcs unb --comm pipelined [--device cpu]

Builds the pencil-decomposed solver on a (p1, p2) grid of
``torch.distributed`` ranks, solves the paper's validation case for the
chosen BCs and reports the error against the analytical solution plus
the time per solve; ``--ckpt`` runs the survivable ``--steps`` loop
(periodic checkpoints, resume, and an elastic rebuild on an injected
device loss).  Counterpart of ``repro.launch.solve``, with its flags,
prints and return value (rank 0's E_inf); the fields are float64.

Deliberate differences from the reference:

* ``--engine`` is ``cuda`` (the hand kernels, the default) or ``torch``
  (``torch.fft``): the reference's ``pallas`` and ``xla``.
* ``--device`` says where the ranks run: the card unless ``cpu`` is
  given, and without a card that default raises.
* One rank runs in this process, on a (1, 1) ``DeviceMesh`` over a
  one-process group (NCCL on the card, gloo on the CPU).  More ranks are
  ``p1 * p2`` processes started with ``spawn`` (CUDA cannot fork) that
  meet through a ``file://`` rendezvous in a temporary directory.  NCCL
  runs only when every rank has a card of its own (it refuses two ranks
  on one device); otherwise the ranks are gloo ranks on the one device.
  A rank that fails makes ``main`` raise.
* The right-hand side goes to the device once; every timed step
  re-acquires the solver through ``get_solver`` and synchronizes the
  device before the clock is read.
* A device loss halves ``p1`` (else ``p2``).  A rank cannot leave its
  process group, so every rank builds the survivors' mesh over ranks
  ``[0, p1 * p2)`` (building a group is collective over the world), only
  its members rebuild the solver and solve, and the others follow the
  loop's steps without solving until the final world barrier.  Rank 0
  writes each checkpoint, then the survivors' group meets at a barrier
  before any rank lists or restores.

``main`` hands rank 0's result to :func:`report` in the calling process
before it returns: the field (with ``--ckpt``, the accumulated field), the
error, the time per solve, the solves made, the plan-cache counters, the
backend and devices, and the kernel launches summed over the ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--p1", type=int, default=1)
    ap.add_argument("--p2", type=int, default=1)
    ap.add_argument("--bcs", default="unb", choices=["unb", "per", "mix"])
    ap.add_argument("--layout", default="node", choices=["node", "cell"])
    ap.add_argument("--comm", default="a2a",
                    choices=["a2a", "pipelined", "fused", "overlap", "auto"])
    ap.add_argument("--chunks", type=int, default=2,
                    help="pipelined/overlap granularity (paper's n_batch)")
    ap.add_argument("--green", default="chat2")
    ap.add_argument("--engine", default="cuda", choices=["cuda", "torch"],
                    help="transform engine: the hand CUDA kernels or "
                         "torch.fft")
    ap.add_argument("--device", default=None,
                    help="where the ranks run (default: the card; 'cpu' "
                         "for the CPU)")
    ap.add_argument("--doubling", default="deferred",
                    choices=["deferred", "upfront"],
                    help="Hockney doubling: deferred (pruned transforms + "
                         "valid-extent switches, default) or upfront (dense "
                         "textbook baseline -- the bench_solve comparison)")
    ap.add_argument("--relayout", default="scheduled",
                    choices=["scheduled", "baseline"],
                    help="data-layout policy: scheduled (plan-time layout "
                         "schedule, relayouts folded into the topology "
                         "switches, default) or baseline (per-direction "
                         "moveaxis round trips -- the A/B reference)")
    ap.add_argument("--batch", type=int, default=1,
                    help="right-hand sides per solve (batched multi-RHS "
                         "pipeline when > 1)")
    ap.add_argument("--steps", type=int, default=1,
                    help="driver steps; each step re-acquires the solver "
                         "through the global plan cache (CFD-loop shape)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory; enables the survivable "
                         "--steps loop (periodic save, restart/resume, "
                         "elastic rebuild on injected device loss)")
    ap.add_argument("--ckpt-every", type=int, default=2,
                    help="checkpoint every k steps (with --ckpt)")
    ap.add_argument("--search", default="guided",
                    choices=["guided", "brute"],
                    help="comm=auto candidate policy: guided (cost-model "
                         "shortlist, times ~1/6 of the space) or brute "
                         "(exhaustive sweep -- the oracle reference)")
    ap.add_argument("--verify", default=None,
                    choices=["nan", "residual", "abft"],
                    help="opt-in per-solve health guard: nan/residual "
                         "(runtime.health) or abft (checksum-sandwiched "
                         "pipeline with localize-and-recompute, "
                         "runtime.abft)")
    return ap


def report(result: dict):
    """Receives rank 0's result record once per ``main`` call, in the
    calling process (see the module docstring).  Does nothing; a test or
    a calling program replaces it to read the field."""


def _plan_backend(device, world):
    """``(backend, [device of each rank])`` for ``world`` ranks whose
    device is ``device`` (already resolved)."""
    import torch
    if device.type != "cuda":
        return "gloo", [str(device)] * world
    if world == 1:
        return "nccl", [str(device)]
    if torch.cuda.device_count() >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", [str(device)] * world


def main(argv=None):
    args = _parser().parse_args(argv)
    import torch
    import torch.multiprocessing as mp
    from repro_torch.core.solver import _resolve_device
    from repro_torch.launch import solve as this

    dev = _resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    world = args.p1 * args.p2
    backend, devices = _plan_backend(dev, world)
    with tempfile.TemporaryDirectory() as d:
        if world == 1:
            ranks = [_rank_main(0, args, backend, devices, d)]
        else:
            mp.start_processes(this._rank_main,
                               args=(args, backend, devices, d),
                               nprocs=world, start_method="spawn")
            ranks = []
            for r in range(world):
                # written by this launcher's own ranks just above
                with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
                    ranks.append(pickle.load(fh))
    result = ranks[0]
    launches: dict = {}
    for res in ranks:
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
    result["launches"] = launches
    report(result)
    return result["err"]


def _rank_main(rank, args, backend, devices, d):
    """One rank: join the group, run the solves, meet the world at a
    barrier and leave.  Returns the rank's record; a spawned rank writes
    it to ``<d>/rank<rank>.pkl`` instead (the field on rank 0 only)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import LAUNCHES

    world = len(devices)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif world > 1:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    before = dict(LAUNCHES)
    # init_process_group wraps sys.excepthook to tag tracebacks with the
    # rank; put it back on leaving, or every run in one process adds a tag
    excepthook = sys.excepthook
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(d, 'rendezvous')}",
        rank=rank, world_size=world, timeout=GROUP_TIMEOUT)
    meshes = []
    try:
        res = _drive(args, rank, dev, backend, devices, meshes)
        res["launches"] = {k: v - before[k] for k, v in LAUNCHES.items()}
        if world > 1:
            if rank:
                res.pop("u")
            with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as fh:
                pickle.dump(res, fh)
        dist.barrier()
    finally:
        from repro_torch.core.solver import evict_solver_entries
        for mesh in meshes:
            evict_solver_entries(mesh)
        dist.destroy_process_group()
        sys.excepthook = excepthook
    return res


def _build_mesh(dev, p1, p2, meshes):
    """The (p1, p2) mesh over ranks ``[0, p1 * p2)`` and the process group
    holding all of them (None: the world's).  Every rank of the world
    calls it: building a group is collective."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(p1 * p2).reshape(p1, p2)
    mesh = DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))
    meshes.append(mesh)
    group = (None if p1 * p2 == dist.get_world_size()
             else dist.new_group(ranks=list(range(p1 * p2))))
    return mesh, group


def _drive(args, rank, dev, backend, devices, meshes) -> dict:
    """The launcher's solves on one rank; returns the rank's record (the
    result on rank 0)."""
    import torch
    from repro_torch.core.bc import BCType, DataLayout
    from repro_torch.core.comm import CommConfig, cfg_label
    from repro_torch.core.solver import get_solver, solver_cache_info
    from repro_torch.launch.cases import validation_case

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB
    bcs = {"unb": ((U, U),) * 3,
           "per": ((P, P),) * 3,
           "mix": ((E, E), (O, E), (P, P))}[args.bcs]
    layout = DataLayout.NODE if args.layout == "node" else DataLayout.CELL
    world = args.p1 * args.p2
    mesh, group = _build_mesh(dev, args.p1, args.p2, meshes)
    comm = ("auto" if args.comm == "auto"
            else CommConfig(strategy=args.comm, n_chunks=args.chunks))
    skw = dict(layout=layout, green_kind=args.green, mesh=mesh, comm=comm,
               dtype=torch.float64, engine=args.engine,
               doubling=args.doubling, relayout=args.relayout,
               autotune_search=args.search, device=dev)
    solver = get_solver((args.n,) * 3, 1.0, bcs, **skw)
    if args.comm == "auto":
        picked = (f"{solver.comm.strategy}"
                  f"(n_chunks={solver.comm.n_chunks})")
        cen = solver.autotune_census
        if args.search == "guided" and cen.get("shortlist") is not None:
            say(f"[solve] guided search: {cen['space']} candidates -> "
                f"{len(cen['shortlist'])} timed "
                f"({len(cen.get('pruned_padding', []))} pruned on "
                "padding overhead)")
        if solver.autotune_results:
            say(f"[solve] comm=auto -> {picked}, candidates: " +
                ", ".join(f"{k}={v*1e3:.1f}ms"
                          for k, v in sorted(
                              solver.autotune_results.items())))
        else:
            say(f"[solve] comm=auto -> {picked} (cached winner, "
                "sweep skipped)")

    # rhs: the paper's validation field for the chosen BCs
    rhs, sol = validation_case(args.bcs, args.n, layout)
    if args.batch > 1:
        rhs = np.broadcast_to(rhs, (args.batch,) + rhs.shape).copy()
    f = torch.from_numpy(rhs).to(dev)
    res = {"backend": backend, "devices": list(devices),
           "comm": cfg_label(solver.comm),
           "autotune": dict(getattr(solver, "autotune_results", {}))}

    if args.ckpt is not None:
        err, acc, p1, p2 = _run_survivable(args, say, solver, f, sol, dev,
                                           group, meshes)
        return dict(res, err=err, u=acc, final_mesh=[p1, p2])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    u = solver.solve(f)          # plan + warm
    sync()
    t0 = time.perf_counter()
    reps = max(args.repeats, args.steps)
    for step in range(reps):
        # CFD-driver shape: every step re-acquires the (cached) solver
        solver = get_solver((args.n,) * 3, 1.0, bcs, **skw)
        u = solver.solve(f)
        sync()
    dt = (time.perf_counter() - t0) / reps
    u0 = (u[0] if args.batch > 1 else u).cpu().numpy()
    err = float(np.max(np.abs(u0 - sol)))
    thr = rhs.size * 8 / dt / 1e6 / world
    ci = solver_cache_info()
    say(f"[solve] n={args.n}^3 grid, ({args.p1}x{args.p2}) pencils, "
        f"comm={args.comm}, engine={args.engine}, batch={args.batch}: "
        f"{dt*1e3:.1f} ms/solve, E_inf={err:.3e}, "
        f"throughput {thr:.1f} MB/s/rank, "
        f"plan-cache {ci['hits']} hits / {ci['misses']} misses, "
        f"{backend} on {', '.join(sorted(set(devices)))}")
    return dict(res, err=err, u=u0, ms=dt * 1e3, solves=reps + 1,
                cache={k: ci[k] for k in ("hits", "misses")})


def _run_survivable(args, say, solver, f, sol, dev, group, meshes):
    """The --ckpt variant of the --steps loop: a long-running CFD-style
    driver that checkpoints every ``--ckpt-every`` steps, restarts from the
    last valid step, and survives an injected device loss by rebuilding the
    solver on the shrunken surviving mesh (elastic recovery) and resuming
    from the last checkpoint.  Faults are armed via ``$REPRO_FAULTS`` on
    every rank, and every rank polls them at the same steps, so all ranks
    agree.  Returns ``(err, accumulated field, p1, p2)``."""
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.runtime import faults

    rank = dist.get_rank()
    plan = faults.plan_from_env()
    with (plan if plan is not None else contextlib.nullcontext()):
        # the driver state: an accumulated field (the stand-in for the
        # evolving CFD solution) -- what checkpoints must preserve
        acc = np.zeros(tuple(f.shape), dtype=np.float64)
        last = ck.latest_step(args.ckpt)
        step = 0
        if last is not None:
            acc = np.array(ck.restore(args.ckpt, last, acc),
                           dtype=np.float64)
            step = last + 1
            say(f"[solve] resuming from checkpoint step {last}")
        p1, p2 = args.p1, args.p2
        losses = 0
        member = True
        while step < args.steps:
            if faults.should_fire("device_loss", step=step) and \
                    hasattr(solver, "rebuild"):
                # half the devices are gone: shrink to the survivors,
                # re-plan (Green reused), roll back to the last checkpoint
                # and resume there
                losses += 1
                if p1 > 1:
                    p1 //= 2
                elif p2 > 1:
                    p2 //= 2
                mesh, group = _build_mesh(dev, p1, p2, meshes)
                say(f"[solve] device loss at step {step}: rebuilding on "
                    f"({p1}x{p2}) surviving mesh")
                member = rank < p1 * p2
                if member:
                    solver = solver.rebuild(mesh)
                # every checkpoint the old mesh wrote is on disk before
                # any rank lists the steps
                dist.barrier()
                last = ck.latest_step(args.ckpt)
                if last is None:
                    acc = np.zeros_like(acc)
                    step = 0
                else:
                    acc = np.array(ck.restore(args.ckpt, last, acc),
                                   dtype=np.float64)
                    step = last + 1
                say(f"[solve] resumed at step {step}")
                continue
            if member:
                # per-step rhs scaling: steps are distinguishable, so a
                # resume from the wrong step shows up in the final field
                u = solver.solve(f * (1.0 / (1 + step)), verify=args.verify)
                acc += u.cpu().numpy().astype(np.float64)
                if (step + 1) % args.ckpt_every == 0:
                    if rank == 0:
                        ck.save(args.ckpt, step, acc)
                    dist.barrier(group=group)
            step += 1

    scale = sum(1.0 / (1 + k) for k in range(args.steps))
    acc0 = acc[0] if args.batch > 1 else acc
    err = float(np.max(np.abs(acc0 / scale - sol)))
    stats = getattr(solver, "stats", {})
    ndeg = len(stats.get("degradations", ()))
    say(f"[solve] survivable loop: {args.steps} steps on final "
        f"({p1}x{p2}) mesh, {losses} device losses, "
        f"{ndeg} degradations, E_inf={err:.3e}")
    report_path = os.environ.get("REPRO_CHAOS_LOG")
    if report_path and rank == 0:
        # the CI chaos job uploads this as its artifact: what was injected,
        # what fired, what the ladder did about it, and the final error
        with open(report_path, "w") as fh:
            json.dump({"steps": args.steps, "final_mesh": [p1, p2],
                       "device_losses": losses, "err_inf": err,
                       "fault_log": plan.log if plan is not None else [],
                       "retries": stats.get("retries", 0),
                       "degradations": stats.get("degradations", []),
                       "integrity": stats.get("integrity", [])},
                      fh, indent=2, default=str)
        say(f"[solve] chaos report written to {report_path}")
    return err, acc0, p1, p2


if __name__ == "__main__":
    main()
