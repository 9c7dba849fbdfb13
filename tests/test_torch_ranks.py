"""Run ``repro_torch``'s distributed code on gloo CPU ranks, without JAX.

The harness of the port's distributed tests; it holds no test itself.
They compute the reference (``repro``, JAX) in the pytest process, write
it under ``tmp_path`` and call ``launch``: it starts ``python
tests/test_torch_ranks.py <scenario> <dir> <world>`` in a subprocess that
never imports JAX.  That process imports torch and ``repro_torch``
once, then forks ``world`` ranks (it has run no torch op, so it holds no
thread to lose across the fork).  Each rank joins a gloo process group
that rendezvous through a file in the test's directory (no port, so
parallel test workers never collide), with a ``timeout`` of its own, runs
the named scenario function of this module and writes what it found to
``<dir>/rank<r>.json``.  A mismatched collective fails the run at the
group's timeout, and ``launch`` bounds the whole subprocess too.
"""
from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 60


def launch(scenario: str, tmp_path, world: int, params=None,
           timeout: float = 120.0):
    """Run ``scenario`` on ``world`` gloo ranks; returns the list of the
    ranks' result dicts.  ``params`` (JSON) is passed to every rank."""
    d = str(tmp_path)
    with open(os.path.join(d, "params.json"), "w") as fh:
        json.dump(params or {}, fh)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for k in ("REPRO_COMM_CACHE", "REPRO_FAULTS", "REPRO_COMM_BUDGET"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), scenario, d, str(world)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-4000:])
    res = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as fh:
            res.append(json.load(fh))
    return res


# ---------------------------------------------------------------------------
# rank side (never imports JAX)
# ---------------------------------------------------------------------------

def _bcs(names):
    from repro_torch.core.bc import BCType
    return tuple(tuple(getattr(BCType, b) for b in pair) for pair in names)


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _maxerr(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def scenario_cases(rank, d, params):
    """One reference case on mesh (2, 4): every strategy (n_chunks=2) on
    both engines, float64, plus its local batch and pod batch flags."""
    import torch
    from repro_torch.core.bc import DataLayout
    from repro_torch.core.comm import CommConfig
    from repro_torch.core.solver import build_green, make_plan
    from repro_torch.distributed.pencil import DistributedPoissonSolver

    cfg = params["case"]
    n = cfg["n"]
    bcs = _bcs(cfg["bcs"])
    layout = DataLayout[cfg["layout"]]
    f = np.load(os.path.join(d, "f.npy"))
    want = np.load(os.path.join(d, "want.npy"))
    mesh = _mesh((2, 4), ("data", "model"))
    green = build_green(make_plan((n,) * 3, 1.0, bcs, layout, cfg["green"]))
    kw = dict(layout=layout, green_kind=cfg["green"], dtype=torch.float64,
              device="cpu", _green_cache=green)
    errs = {}
    for engine in ("torch", "cuda"):
        for strategy in ("a2a", "pipelined", "fused", "overlap"):
            tag = f"{engine}/{strategy}"
            ds = DistributedPoissonSolver(
                (n,) * 3, 1.0, bcs, mesh=mesh, engine=engine,
                comm=CommConfig(strategy, 2), **kw)
            errs[tag] = _maxerr(ds.solve(f), want)
            assert not ds.stats["degradations"], ds.stats
            if cfg.get("local_batch"):
                scales = (1.0, -0.5, 2.0, 0.25)
                got = ds.solve(np.stack([a * f for a in scales]))
                errs[tag + "/local_batch"] = max(
                    _maxerr(g, a * want) for a, g in zip(scales, got))
            if cfg.get("batch"):
                mesh3 = _mesh((2, 2, 2), ("pod", "data", "model"))
                ds3 = DistributedPoissonSolver(
                    (n,) * 3, 1.0, bcs, mesh=mesh3, engine=engine,
                    comm=CommConfig(strategy), batch_axis="pod", **kw)
                got = ds3.solve(np.stack([f, 2.0 * f]))
                errs[tag + "/pod_batch"] = max(_maxerr(got[0], want),
                                               _maxerr(got[1], 2.0 * want))
    return {"errs": errs}


def _ref_case(d):
    """The CELL (E,E),(O,E),(P,P) n=16 case of the reference and its
    input, as the pytest process wrote them."""
    return (np.load(os.path.join(d, "f.npy")),
            np.load(os.path.join(d, "want.npy")))


_SPEC = ((("EVEN", "EVEN"), ("ODD", "EVEN"), ("PER", "PER")), 16)


def _solver(mesh, **kw):
    import torch
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    names, n = _SPEC
    kw.setdefault("dtype", torch.float64)
    kw.setdefault("device", "cpu")
    return DistributedPoissonSolver((n,) * 3, 1.0, _bcs(names), mesh=mesh,
                                    **kw)


def scenario_auto(rank, d, params):
    """comm="auto" (brute) on mesh (2, 4): one winner on every rank, a
    second construction served by the cache, rank-dependent timings still
    agreed, the JSON cache written by rank 0 and read by all, and a
    mangled cache entry falling through to a live sweep."""
    from repro_torch.core import comm as cm
    from repro_torch.runtime import faults
    f, want = _ref_case(d)
    mesh = _mesh((2, 4), ("data", "model"))
    path = os.path.join(d, "comm_cache.json")
    kw = dict(comm="auto", autotune_search="brute")
    ds = _solver(mesh, **kw)
    out = {"winner": cm.cfg_label(ds.comm),
           "n_timed": len(ds.autotune_results),
           "err": _maxerr(ds.solve(f), want)}
    ds2 = _solver(mesh, _green_cache=ds._green_raw, **kw)
    out["second"] = [cm.cfg_label(ds2.comm), len(ds2.autotune_results)]
    try:
        _solver(mesh, comm="auto", _green_cache=ds._green_raw)
        out["guided"] = "no error"
    except NotImplementedError as e:
        out["guided"] = str(e)

    # rank-dependent timings: alone each rank would pick its own winner
    cands = cm.autotune_candidates()
    labels = [cm.cfg_label(c) for c in cands]

    def skewed(cfg):
        return 1.0 + (labels.index(cm.cfg_label(cfg)) - rank) % len(cands)

    cm.clear_autotune_cache()
    out["alone"] = cm.cfg_label(cm.autotune_comm(("skew",), skewed,
                                                 cache_path=""))
    cm.clear_autotune_cache()
    out["agreed"] = cm.cfg_label(cm.autotune_comm(
        ("skew",), skewed, cache_path="", agree=ds._agree))

    # the JSON cache: rank 0 writes, every rank reads it back
    cm.clear_autotune_cache()
    best = cm.autotune_comm(("json",), skewed, cache_path=path,
                            agree=ds._agree, persist=rank == 0)
    ds._agree([0.0])                  # the file is written before reading
    cm.clear_autotune_cache()

    def must_not_time(cfg):
        raise AssertionError("a cache hit must not time")

    out["json_hit"] = cm.cfg_label(cm.autotune_comm(
        ("json",), must_not_time, cache_path=path, agree=ds._agree,
        persist=rank == 0)) == cm.cfg_label(best)
    with open(path) as fh:
        out["json_schema"] = json.load(fh)["schema"]
    cm.clear_autotune_cache()
    census = {}
    with faults.FaultPlan([dict(kind="corrupt_cache", count=-1)]):
        again = cm.autotune_comm(("json",), skewed, cache_path=path,
                                 agree=ds._agree, persist=False,
                                 census=census)
    out["mangled"] = [cm.cfg_label(again) == cm.cfg_label(best),
                      len(census["timed"])]

    # a pruned and a dense plan never share a winner: distinct keys, and
    # a dense winner in the JSON cache is not replayed for the pruned plan
    cm.clear_autotune_cache()
    from repro_torch.core.bc import BCType
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    U = (BCType.UNB, BCType.UNB)
    stale = os.path.join(d, "doubling_cache.json")
    kw = dict(mesh=mesh, device="cpu", lazy_green=True, comm="auto",
              autotune_candidates=(cm.CommConfig("a2a", 1),),
              autotune_cache=stale)
    dd = DistributedPoissonSolver((8,) * 3, 1.0, (U, U, U),
                                  doubling="upfront", **kw)
    dp = DistributedPoissonSolver((8,) * 3, 1.0, (U, U, U), **kw)
    ds._agree([0.0])
    with open(stale) as fh:
        entries = json.load(fh)["entries"]
    out["doubling"] = [("doubling", "deferred") in dp.autotune_key(),
                       ("doubling", "upfront") in dd.autotune_key(),
                       len(dd.autotune_results), len(dp.autotune_results),
                       sorted("'doubling', 'upfront'" in k for k in entries)]
    return out


def scenario_switch(rank, d, params):
    """The tiled exchange on an asymmetric block, the pad-and-warn of a
    prime chunk axis, ``fold="unpack"`` solves and ``all_reduce_mean``."""
    import torch
    from repro_torch.core import comm as cm
    from repro_torch.core.comm import CommConfig, topology_switch
    mesh = _mesh((2, 4), ("data", "model"))
    groups = {a: mesh.get_group(a) for a in ("data", "model")}
    out = {}
    # the global block G[i, j, k] = 100 i + 10 j + k, (8, 12, 3): rank
    # (r1, r2) holds rows j in [3 r2, 3 r2 + 3) of G[4 r1: 4 r1 + 4]; the
    # switch over "model" splits axis 0 and gathers axis 1, so afterwards
    # rank (r1, r2) holds G[4 r1 + r2, :, :]
    r1, r2 = mesh.get_coordinate()
    g = (100 * np.arange(8)[:, None, None] + 10 * np.arange(12)[None, :, None]
         + np.arange(3)[None, None, :]).astype(np.float64)
    x = torch.from_numpy(g[4 * r1:4 * r1 + 4, 3 * r2:3 * r2 + 3].copy())
    want = g[4 * r1 + r2:4 * r1 + r2 + 1]
    out["tiled"] = {}
    for s in cm.STRATEGIES:
        y = topology_switch(x, "model", 0, 1, CommConfig(s, 3),
                            groups=groups)
        out["tiled"][s] = [list(y.shape), _maxerr(y, want)]
    # complex payload, split and concat swapped (axis 1 split, axis 0
    # gathered) and the block permuted on the way
    xc = torch.complex(x, -x)
    y = topology_switch(xc, "model", 1, 0, CommConfig("fused"),
                        groups=groups, permute=(1, 0, 2))
    # in the permuted frame (j, i, k): rank (r1, r2) holds i = 4 r1 + r2
    wantc = ((1 - 1j) * g[4 * r1 + r2])[:, None, :]
    out["tiled_permuted"] = _maxerr(y.numpy(), wantc)
    yy = topology_switch(xc, "model", 1, 0, CommConfig("overlap", 2),
                         groups=groups, permute=(1, 0, 2))
    out["tiled_permuted_overlap"] = _maxerr(yy.numpy(), wantc)
    out["tiled_permuted_shape"] = list(y.shape)

    # prime chunk axis (7 does not divide into 2): zero-padded, warned,
    # and equal to the monolithic switch
    x7 = torch.from_numpy(
        np.random.default_rng(rank).standard_normal((4, 6, 7)))
    ref = topology_switch(x7, "data", 0, 1, CommConfig("a2a", 1),
                          groups=groups)
    cm.reset_warn_once()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pip = topology_switch(x7, "data", 0, 1, CommConfig("pipelined", 2),
                              groups=groups)
    out["prime_warned"] = any("zero-padding" in str(w.message) for w in rec)
    ov = topology_switch(x7, "data", 0, 1, CommConfig("overlap", 2),
                         groups=groups)
    out["prime"] = [_maxerr(pip, ref), _maxerr(ov, ref), list(pip.shape)]

    # fold="unpack": the relayout after each collective
    f, want = _ref_case(d)
    out["unpack"] = {}
    for s in cm.STRATEGIES:
        ds = _solver(mesh, comm=CommConfig(s, 2, fold="unpack"),
                     engine="cuda")
        out["unpack"][s] = _maxerr(ds.solve(f), want)
    v = torch.tensor([float(rank)], dtype=torch.float64)
    out["mean"] = cm.all_reduce_mean(v, groups["model"]).item()
    return out


def scenario_faults(rank, d, params):
    """The ladder on every rank: an armed ``comm.overlap`` and
    ``comm.pipelined`` fault, a NaN at ``green`` under verify="nan",
    transient ``dist.dispatch`` faults, a real (not injected) switch
    failure, and the not-ported entry points."""
    from repro_torch.core.comm import CommConfig, PipelinedStrategy
    from repro_torch.runtime import SolveError, faults
    f, want = _ref_case(d)
    mesh = _mesh((2, 4), ("data", "model"))
    clean = _solver(mesh, comm=CommConfig("overlap", 2))
    base = clean.solve(f).numpy()
    g = clean._green_raw
    out = {"clean": _maxerr(base, want)}

    def trail(s):
        return [r["action"] for r in s.stats["degradations"]]

    s = _solver(mesh, comm=CommConfig("overlap", 2), engine="torch",
                _green_cache=g)
    with faults.FaultPlan([dict(kind="error", stage="comm.overlap",
                                count=-1)]) as plan:
        got = s.solve(f).numpy()
    out["overlap"] = [trail(s), len(plan.log), _maxerr(got, base),
                      s.comm.strategy, s.comm.n_chunks]
    s = _solver(mesh, comm=CommConfig("pipelined", 2), engine="torch",
                _green_cache=g)
    with faults.FaultPlan([dict(kind="error", stage="comm.pipelined",
                                count=-1)]):
        got = s.solve(f).numpy()
    out["pipelined"] = [trail(s), _maxerr(got, base)]
    s = _solver(mesh, verify="nan", _green_cache=g)
    with faults.FaultPlan([dict(kind="nan", stage="green")]):
        got = s.solve(f).numpy()
    out["nan"] = [trail(s), s.stats["verify_failures"],
                  s.stats["degradations"][0]["stage"], _maxerr(got, base)]
    s = _solver(mesh, _green_cache=g)
    with faults.FaultPlan([dict(kind="error", stage="dist.dispatch", count=2,
                                transient=True)]):
        got = s.solve(f).numpy()
    out["transient"] = [s.stats["retries"], trail(s), _maxerr(got, base)]
    s = _solver(mesh, _green_cache=g)
    try:
        with faults.FaultPlan([dict(kind="error", stage="dist.dispatch",
                                    count=-1)]):
            s.solve(f)
        out["exhausted"] = None
    except SolveError as e:
        out["exhausted"] = [e.stage, [r["action"] for r in e.degradations]]
    # a switch that really fails (no fault armed) on every rank: SolveError
    # at once, no rung taken
    s = _solver(mesh, comm=CommConfig("pipelined", 2), _green_cache=g)
    real = PipelinedStrategy._switch

    def broken(self, *a, **kw):
        raise RuntimeError("all_to_all_single: connection reset")

    PipelinedStrategy._switch = broken
    try:
        s.solve(f)
        out["real"] = None
    except SolveError as e:
        out["real"] = [e.stage, list(e.degradations), trail(s),
                       s.comm.strategy]
    finally:
        PipelinedStrategy._switch = real
    out["not_ported"] = []
    for call in (lambda: s.lower(), lambda: s.abft_jit_for(),
                 lambda: s.solve(f, verify="abft")):
        try:
            call()
        except NotImplementedError as e:
            out["not_ported"].append(str(e))
    return out


def scenario_rebuild(rank, d, params):
    """``get_solver(mesh=...)`` hits, ``rebuild`` from (2, 4) onto the
    4-rank (2, 2) mesh of the survivors, and ``evict_solver_entries``."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.comm import CommConfig
    from repro_torch.core.solver import (evict_solver_entries, get_solver,
                                         solver_cache_info)
    import torch
    f, want = _ref_case(d)
    names, n = _SPEC
    mesh_a = _mesh((2, 4), ("data", "model"))
    kw = dict(mesh=mesh_a, device="cpu", dtype=torch.float64,
              comm=CommConfig("overlap", 2))
    s = get_solver((n,) * 3, 1.0, _bcs(names), **kw)
    s_again = get_solver((n,) * 3, 1.0, _bcs(names), **kw)
    info = solver_cache_info()
    base = s.solve(f)
    out = {"hit": s_again is s, "info": [info["hits"], info["misses"]],
           "err_a": _maxerr(base, want)}
    # every rank builds the survivors' mesh (new_group is collective over
    # the world); only its members rebuild and solve
    mesh_b = DeviceMesh("cpu", [[0, 1], [2, 3]],
                        mesh_dim_names=("data", "model"))
    if rank < 4:
        s_b = s.rebuild(mesh_b)
        got = s_b.solve(f)
        out["rebuilt"] = [_maxerr(got, base), _maxerr(got, want),
                          s_b._green_raw is s._green_raw,
                          [s_b._size["data"], s_b._size["model"]]]
    else:
        evict_solver_entries(mesh_a)
    before = solver_cache_info()["misses"]
    out["evicted_again"] = evict_solver_entries(mesh_a)
    s2 = get_solver((n,) * 3, 1.0, _bcs(names), **kw)
    out["fresh"] = [s2 is not s, solver_cache_info()["misses"] - before]
    return out


def _run_rank(rank, scenario, d, world):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        with open(os.path.join(d, "params.json")) as fh:
            params = json.load(fh)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = globals()[f"scenario_{scenario}"](rank, d, params)
        with open(os.path.join(d, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _main(scenario, d, world):
    import threading
    import torch.multiprocessing as mp
    import repro_torch  # noqa: F401 -- imported once, before the fork
    assert threading.active_count() == 1, "fork needs a single thread"
    mp.start_processes(_run_rank, args=(scenario, d, world), nprocs=world,
                       start_method="fork")


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
