"""Run ``repro_torch``'s distributed code on gloo CPU ranks, without JAX.

The harness of the port's distributed tests; it holds no test itself.
They compute the reference (``repro``, JAX) in the pytest process, write
it under ``tmp_path`` and call ``launch``: it starts ``python
tests/test_torch_ranks.py <scenario> <dir> <world>`` in a subprocess that
never imports JAX.  That process imports torch and ``repro_torch``
once, then forks ``world`` ranks (it has run no torch op, so it holds no
thread to lose across the fork).  Each rank joins a gloo process group
that rendezvous through a file in the test's directory (no port, so
parallel test workers never collide), with a ``timeout`` of its own
(``GROUP_TIMEOUT_S``, or the ``group_timeout`` a scenario's params set), runs
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
    second construction served by the cache, the default guided search,
    rank-dependent timings still agreed, the JSON cache written by rank 0
    and read by all, and a mangled cache entry falling through to a live
    sweep."""
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
    # the default search: the cost model's shortlist, timed and agreed
    dg = _solver(mesh, comm="auto", _green_cache=ds._green_raw)
    out["guided"] = {"winner": cm.cfg_label(dg.comm),
                     "timed": sorted(dg.autotune_results),
                     "space": dg.autotune_census["space"],
                     "shortlist": dg.autotune_census["shortlist"],
                     "err": _maxerr(dg.solve(f), want)}

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
    failure, and the dry run (``lower``) on the rank group."""
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
    # the dry run on the gloo ranks: the lowered pipelined:2 solve's
    # all-to-alls against the byte predictor, and its kernel calls
    import torch
    from repro_torch.launch.hlo_stats import comm_bytes_stats
    from repro_torch.plan.costmodel import predict_bytes
    lowered = s.lower()
    out["lowered"] = [
        [c["bytes"] for c in comm_bytes_stats(lowered)["per_collective"]],
        predict_bytes(s.plan, 2, 4, torch.float64, s.comm),
        dict(lowered.kernels), [list(x) for x, _ in lowered.outputs]]
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


def _a2a_collective(x, group, p, split_axis, concat_axis, async_op=False,
                    view=False):
    """``core.comm._a2a`` as it ran before one-rank axes were skipped: the
    block packed and the collective issued whatever the group size.  The
    oracle the skip is held to, bit for bit."""
    import torch
    import torch.distributed as dist
    nd = x.ndim
    s, c = split_axis % nd, concat_axis % nd
    q = x.shape[s] // p
    xs = x.unflatten(s, (p, q))
    if view:
        cc = c if c < s else c + 1
        rest = [a for a in range(nd + 1) if a not in (s, s + 1, cc)]
        send = xs.permute([s, cc, s + 1] + rest).contiguous()
    else:
        send = xs.movedim(s, 0).contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group,
                                  async_op=async_op)
    if not view:
        return recv.movedim(0, c), work
    order = [c, s] + [a for a in range(nd) if a not in (s, c)]
    return (recv.flatten(0, 1).permute([order.index(a) for a in range(nd)]),
            work)


class _CountedA2A:
    """``torch.distributed.all_to_all_single`` counted while armed."""

    def __init__(self):
        import torch.distributed as dist
        self.calls = 0
        self._real = dist.all_to_all_single

    def __enter__(self):
        import torch.distributed as dist

        def counted(*a, **kw):
            self.calls += 1
            return self._real(*a, **kw)
        dist.all_to_all_single = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.all_to_all_single = self._real


def scenario_plan_one(rank, d, params):
    """One rank: the (1, 1) mesh's switches under every strategy, fold,
    relayout and engine issue no collective and give the bits of the
    collective path; ``search_plan`` at 8^3 on the one-rank group (the
    frontier timed, the cache round trip, the dtype split)."""
    import torch
    from repro_torch.core import comm as cm
    from repro_torch.core.comm import CommConfig
    from repro_torch.core.bc import BCType
    from repro_torch.plan import search_plan
    f, want = _ref_case(d)
    mesh = _mesh((1, 1), ("data", "model"))
    out = {"one_rank": {}}
    green = None
    with _CountedA2A() as counter:
        for engine in ("torch", "cuda"):
            for relayout in ("scheduled", "baseline"):
                folds = ("pack", "unpack") if relayout == "scheduled" \
                    else ("pack",)
                for lbl in ("a2a:1", "fused:1", "pipelined:2", "overlap:2"):
                    for fold in folds:
                        c = cm.label_to_cfg(lbl)
                        ds = _solver(mesh, engine=engine, relayout=relayout,
                                     comm=CommConfig(c.strategy, c.n_chunks,
                                                     fold),
                                     _green_cache=green)
                        green = ds._green_raw
                        x = ds.shard_input(torch.from_numpy(f))
                        n0 = counter.calls
                        with cm.collective_census() as census:
                            u = ds.solve_local(x)
                        skipped = [len(census.per_collective),
                                   counter.calls - n0]
                        real = cm._a2a
                        cm._a2a = _a2a_collective
                        try:
                            n0 = counter.calls
                            u_old = ds.solve_local(x)
                        finally:
                            cm._a2a = real
                        tag = f"{engine}/{relayout}/{lbl}/{fold}"
                        out["one_rank"][tag] = skipped + [
                            counter.calls - n0, bool(torch.equal(u, u_old)),
                            _maxerr(ds.gather_output(u), want)]
    P = (BCType.PER, BCType.PER)
    path = os.path.join(d, "plans.json")
    kw = dict(mesh_shapes=((1, 1),), device="cpu", cache_path=path, reps=1)
    census = {}
    dec = search_plan((8,) * 3, 1.0, (P, P, P), census=census, **kw)
    with open(path) as fh:
        data = json.load(fh)
    dec2 = search_plan((8,) * 3, 1.0, (P, P, P), **kw)
    dec3 = search_plan((8,) * 3, 1.0, (P, P, P), dtype=torch.float64, **kw)
    out["search"] = {
        "point": dec.point.label(), "cached": dec.cached,
        "census": {k: census[k] for k in ("space", "predicted",
                                          "pruned_padding", "shortlist")},
        "timed": sorted(census["timed"]), "failed": census["failed"],
        "schema": data["schema"], "entries": len(data["entries"]),
        "again": [dec2.cached, dec2.point == dec.point,
                  dec2.census.get("cached")],
        "f64_cached": dec3.cached}
    return out


def scenario_plan_four(rank, d, params):
    """Four ranks: ``search_plan`` at (U,U,U) 8^3 over the meshes (2, 2),
    (1, 4) and (4, 1) on the "cuda" engine's plain path (radix 4 and 2),
    rank 0 alone writing the cache and a second call replaying it; the
    slab meshes' census against the predictor."""
    import torch
    from repro_torch.core import comm as cm
    from repro_torch.core.bc import BCType
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.plan import predict_bytes
    from repro_torch.plan import search as ps
    U = (BCType.UNB, BCType.UNB)
    path = os.path.join(d, "plans.json")
    stores = []
    real_store = ps.cache_store_entry

    def store(*a, **kw):
        stores.append(a[1])
        return real_store(*a, **kw)

    ps.cache_store_entry = store
    try:
        census = {}
        dec = ps.search_plan((8,) * 3, 1.0, (U, U, U), device="cpu",
                             cache_path=path, census=census, reps=1)
        census2 = {}
        dec2 = ps.search_plan((8,) * 3, 1.0, (U, U, U), device="cpu",
                              cache_path=path, census=census2, reps=1)
    finally:
        ps.cache_store_entry = real_store
    out = {"point": dec.point.label(), "seconds": dec.seconds,
           "census": {k: census[k] for k in ("space", "predicted",
                                             "pruned_padding", "shortlist")},
           "timed": sorted(census["timed"]), "failed": census["failed"],
           "stores": len(stores),
           "again": [dec.cached, dec2.cached, dec2.point == dec.point]}
    out["slabs"] = {}
    for ms in ((1, 4), (4, 1)):
        mesh = _mesh(ms, ("data", "model"))
        ds = DistributedPoissonSolver((8,) * 3, 1.0, (U, U, U), mesh=mesh,
                                      device="cpu")
        with cm.collective_census() as c:
            ds.solve_local(torch.zeros(ds.local_input_shape()))
        out["slabs"][f"{ms[0]}x{ms[1]}"] = [
            [e["bytes"] for e in c.per_collective],
            predict_bytes(ds.plan, ms[0], ms[1], ds.dtype, ds.comm)]
    return out


def scenario_census(rank, d, params):
    """Eight ranks: each predictor case of ``params["cases"]`` solved once
    (``solve_local`` on a zero pencil) under ``collective_census()``,
    with ``all_to_all_single`` counted."""
    import torch
    from repro_torch.core import comm as cm
    from repro_torch.core.bc import DataLayout
    from repro_torch.core.comm import CommConfig
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    meshes = {}
    for case in params["cases"]:
        ms = tuple(case["mesh"])
        if ms not in meshes:
            meshes[ms] = _mesh(ms, ("data", "model"))
    out = {}
    with _CountedA2A() as counter:
        for case in params["cases"]:
            n = case["n"]
            ds = DistributedPoissonSolver(
                (n,) * 3, 1.0, _bcs(case["bcs"]), DataLayout[case["layout"]],
                mesh=meshes[tuple(case["mesh"])],
                comm=CommConfig(*case["comm"]),
                dtype=getattr(torch, case["dtype"]),
                doubling=case["doubling"], relayout=case["relayout"],
                order_policy=case["order"], device="cpu")
            x = torch.zeros(ds.local_input_shape(case["batch"]),
                            dtype=ds.dtype)
            n0 = counter.calls
            with cm.collective_census() as c:
                ds.solve_local(x)
            out[case["id"]] = {"bytes": [e["bytes"]
                                         for e in c.per_collective],
                               "issued": counter.calls - n0,
                               "stats": c.stats()}
    return out


def scenario_abft_sdc(rank, d, params):
    """The assertions of ``tests/test_abft.py``'s distributed SDC script,
    one by one, on mesh (2, 4), float32, engine "torch" (the reference's
    "xla"): per case, the verdicts and what they saw."""
    import torch
    from repro_torch.core.comm import CommConfig
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.runtime import SolveError, faults

    mesh = _mesh((2, 4), ("data", "model"))
    n = params["n"]
    f = np.load(os.path.join(d, "f.npy"))
    kw = dict(mesh=mesh, engine="torch", device="cpu",
              dtype=torch.float32)
    P, U = ("PER", "PER"), ("UNB", "UNB")
    out = {}
    for tag, names, comm in (("ppp_a2a", (P, P, P), CommConfig("a2a")),
                             ("upu_pipelined", (U, P, U),
                              CommConfig("pipelined", 2))):
        bcs = _bcs(names)
        s = DistributedPoissonSolver((n,) * 3, 1.0, bcs, comm=comm,
                                     verify="abft", **kw)
        want = s.solve(f).numpy()
        s_off = DistributedPoissonSolver((n,) * 3, 1.0, bcs, comm=comm,
                                         _green_cache=s._green_raw, **kw)
        res = {"clean_bits": bool(np.array_equal(want,
                                                 s_off.solve(f).numpy())),
               "clean_records": s.stats.get("integrity", [])}
        with faults.FaultPlan([dict(kind="flip", stage="fwd.0",
                                    count=2)]) as plan:
            got = s.solve(f).numpy()
        recs = s.stats["integrity"]
        res["fwd0"] = {"log": len(plan.log),
                       "stages": [(r["stage"], r["action"]) for r in recs],
                       "bits": bool(np.array_equal(got, want)),
                       "degradations": s.stats["degradations"]}
        s.stats["integrity"] = []
        with faults.FaultPlan([dict(kind="flip", stage="comm.wire.*",
                                    count=1)]) as plan:
            got = s.solve(f).numpy()
        res["wire"] = {"log": len(plan.log),
                       "stages": [r["stage"] for r in s.stats["integrity"]],
                       "bits": bool(np.array_equal(got, want))}
        out[tag] = res
    s = DistributedPoissonSolver((n,) * 3, 1.0, _bcs((P, P, P)),
                                 comm=CommConfig("a2a"),
                                 verify="abft-stages", **kw)
    want = s.solve(f).numpy()
    scale = float(np.max(np.abs(want)))
    with faults.FaultPlan([dict(kind="flip", stage="comm.wire.*",
                                count=1)]) as plan:
        got = s.solve(f).numpy()
    out["stages_wire"] = {
        "log": len(plan.log),
        "records": [(r["stage"], r["kind"], r["action"])
                    for r in s.stats["integrity"]],
        "retries": s.stats["retries"],
        "err": float(np.max(np.abs(got - want))) / scale}
    s = DistributedPoissonSolver((n,) * 3, 1.0, _bcs((P, P, P)),
                                 comm=CommConfig("a2a"),
                                 verify="abft-stages",
                                 _green_cache=s._green_raw, **kw)
    try:
        with faults.FaultPlan([dict(kind="flip", stage="green",
                                    count=-1)]):
            s.solve(f)
        out["persistent"] = None
    except SolveError as e:
        out["persistent"] = [e.stage, [r["action"] for r in e.degradations]]
    return out


def scenario_abft_slabs(rank, d, params):
    """Eight ranks on the slab meshes (1, 8) and (8, 1): the checked solve
    under a2a and overlap:2 -- its report names (a ``wire.<axis>`` entry
    for every switch, the one-rank axis's included), its collective
    census (a sidecar beside each payload of the non-unit axis only) and
    its result -- beside the verify-off census, which the byte predictor
    names."""
    import torch
    from repro_torch.core import comm as cm
    from repro_torch.core.comm import CommConfig
    from repro_torch.distributed.pencil import DistributedPoissonSolver
    from repro_torch.plan import predict_bytes
    f, want = _ref_case(d)
    out = {}
    green = None
    for ms in ((1, 8), (8, 1)):
        mesh = _mesh(ms, ("data", "model"))
        for lbl in ("a2a:1", "overlap:2"):
            ds = _solver(mesh, comm=cm.label_to_cfg(lbl),
                         verify="abft-stages", _green_cache=green)
            green = ds._green_raw
            x = ds.shard_input(torch.from_numpy(f))
            with cm.collective_census() as off:
                ds.solve_local(x)
            fn, names = ds.abft_jit_for()
            with cm.collective_census() as on:
                y, rep = fn(x)
            u = ds.solve(f)
            out[f"{ms[0]}x{ms[1]}/{lbl}"] = {
                "names": list(names),
                "report": rep.tolist(),
                "off": off.per_collective,
                "on": on.per_collective,
                "predicted": predict_bytes(ds.plan, ms[0], ms[1], ds.dtype,
                                           ds.comm),
                "err": _maxerr(u, want),
                "records": ds.stats.get("integrity", [])}
    return out


def scenario_abft_weight(rank, d, params):
    """Eight ranks: the distributed sandwich weight ``w`` (gathered over
    the mesh) against the reference's, written by the pytest process;
    ``verify="abft"`` on the "torch" engine (the sandwich) and on the
    "cuda" engine (no weight: the checked pipeline, counted), and both
    ABFT modes on the pod batch of mesh (2, 2, 2) with its report rows,
    each against the reference's solve."""
    import torch
    from repro_torch.distributed import pencil
    from repro_torch.runtime import abft
    f, want = _ref_case(d)
    w_ref = np.load(os.path.join(d, "w_ref.npy"))
    mesh = _mesh((2, 4), ("data", "model"))
    out = {}
    ds = _solver(mesh, engine="torch", verify="abft")
    green = ds._green_raw
    qs, w_loc, wn, _ = ds._lite_pair()
    w = ds.gather_output(w_loc).numpy()
    out["w_err"] = _maxerr(w, w_ref) / float(np.max(np.abs(w_ref)))
    out["w_norm"] = [wn, float(np.linalg.norm(w_ref))]
    out["qs"] = [q.tolist() for q in qs]
    out["torch_abft"] = [_maxerr(ds.solve(f), want),
                         ds.stats.get("integrity", [])]
    calls = []
    real = pencil.DistributedPoissonSolver.abft_jit_for

    def counted(self, *a, **kw):
        calls.append(self.engine.name)
        return real(self, *a, **kw)

    pencil.DistributedPoissonSolver.abft_jit_for = counted
    try:
        dc = _solver(mesh, engine="cuda", verify="abft", _green_cache=green)
        err = _maxerr(dc.solve(f), want)
        out["cuda_abft"] = [dc._lite_pair() is None, calls, err,
                            dc.stats.get("integrity", [])]
    finally:
        pencil.DistributedPoissonSolver.abft_jit_for = real
    mesh3 = _mesh((2, 2, 2), ("pod", "data", "model"))
    fb = np.stack([f, 2.0 * f])
    for verify in ("abft", "abft-stages"):
        dp = _solver(mesh3, engine="torch", verify=verify,
                     batch_axis="pod", _green_cache=green)
        got = dp.solve(fb)
        fn, names = dp.abft_jit_for()
        _, rep = fn(dp.shard_input(torch.from_numpy(fb)))
        out[f"pod/{verify}"] = {
            "err": max(_maxerr(got[0], want), _maxerr(got[1], 2.0 * want)),
            "report_shape": list(rep.shape), "n_names": len(names),
            "clean": max(rep.max().item(), 0.0) < abft.tol_for(
                torch.float64),
            "records": dp.stats.get("integrity", [])}
    return out


def _soak_spec(mesh, n):
    """The reference serve soak's spec (``tests/test_abft.py``): (P,P,P),
    ``comm`` a2a, float32 on ``mesh``; engine "torch" (the distributed
    sandwich weight comes from its autograd)."""
    from repro_torch.core.comm import CommConfig
    from repro_torch.serve import PlanSpec
    return PlanSpec(shape=(n, n, n), bcs=_bcs((("PER", "PER"),) * 3),
                    mesh=mesh, engine="torch", device="cpu",
                    solver_kw=(("comm", CommConfig("a2a")),))


def scenario_serve_one(rank, d, params):
    """One rank: the reference's serve soak on a (1, 1) mesh -- a clean
    baseline per field, one flip-armed tenant localized and repaired on
    its shadow solver, then six clean tenants x four fields bit-exact
    with no record; and the baseline against the reference's solve."""
    from repro_torch.runtime import faults
    from repro_torch.serve import PoissonServer

    spec = _soak_spec(_mesh((1, 1), ("data", "model")), params["n"])
    fields = np.load(os.path.join(d, "f.npy")).astype(np.float32)
    want = np.load(os.path.join(d, "want.npy"))
    out = {}
    sizes = set()
    with PoissonServer(max_batch=4, max_delay_ms=1.0, verify="abft") as srv:
        base = [srv.solve(f, spec, tenant="warm") for f in fields]
        out["base_records"] = sum(len(r.integrity) for r in base)
        plan = faults.FaultPlan([dict(kind="flip", stage="fwd.0", count=2)])
        bad = srv.submit(fields[0], spec, tenant="chaos",
                         fault_plan=plan).result(timeout=60)
        out["chaos_stages"] = [r["stage"] for r in bad.integrity]
        out["chaos_log"] = len(plan.log)
        out["chaos_bits"] = bool(np.array_equal(bad.u, base[0].u))
        soak = {"solves": 0, "bitexact": 0, "records": 0,
                "degradations": 0}
        for t in range(6):
            for i, f in enumerate(fields):
                r = srv.solve(f, spec, tenant=f"t{t}")
                soak["solves"] += 1
                soak["bitexact"] += int(np.array_equal(r.u, base[i].u))
                soak["records"] += len(r.integrity)
                soak["degradations"] += len(r.degradations)
                sizes.add(r.batch_size)
        out["soak"] = soak
    out["batch_sizes"] = sorted(sizes)
    u = np.stack([r.u for r in base])
    out["rel_vs_reference"] = _maxerr(u, want) / float(np.abs(want).max())
    return out


_SERVE_KEYS = {"UUU": (("UNB", "UNB"),) * 3, "PPP": (("PER", "PER"),) * 3}


def _mesh_spec(mesh, key, n, comm):
    """A served (U,U,U) or (P,P,P) key on ``mesh``: engine "cuda" (the
    kernels' plain versions on the CPU), float64, ``comm`` a label."""
    import torch
    from repro_torch.core.comm import label_to_cfg
    from repro_torch.serve import PlanSpec
    return PlanSpec(shape=(n, n, n), bcs=_bcs(_SERVE_KEYS[key]), mesh=mesh,
                    device="cpu",
                    solver_kw=(("comm", label_to_cfg(comm)),
                               ("dtype", torch.float64)))


def _served_err(d, key, results):
    want = np.load(os.path.join(d, f"want_{key}.npy"))
    return max(_maxerr(r.u, w) for r, w in zip(results, want))


def _follow(mesh, servers):
    """A follower rank: ``follow`` once per server the leader runs."""
    from repro_torch.serve import follow
    return [follow(mesh, device="cpu") for _ in range(servers)]


_SERVE_COMMS = ("a2a:1", "overlap:2")


def scenario_serve_mesh(rank, d, params):
    """Four ranks, mesh (2, 2): rank 0 serves (U,U,U) and (P,P,P) n=16
    float64 under each of ``_SERVE_COMMS``, three requests a key in one
    drain flush (padded to rank 4), then each alone (rank-1 batches);
    then ``run_harness`` on the two keys under overlap:2.  Ranks 1-3
    follow every server."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serve import PoissonServer
    mesh = _mesh((2, 2), ("data", "model"))
    f = np.load(os.path.join(d, "f.npy"))
    n = f.shape[-1]
    if rank != 0:
        return {"follow": _follow(mesh, 2 * len(_SERVE_COMMS) + 1)}
    out = {}
    for comm in _SERVE_COMMS:
        specs = {k: _mesh_spec(mesh, k, n, comm) for k in _SERVE_KEYS}
        srv = PoissonServer(max_batch=4, max_delay_ms=60_000).start()
        futs = {k: [srv.submit(x, spec, tenant=k) for x in f]
                for k, spec in specs.items()}
        srv.stop(drain=True)
        batch = {k: [fu.result() for fu in v] for k, v in futs.items()}
        with PoissonServer(max_batch=1, max_delay_ms=1.0) as srv:
            alone = {k: [srv.solve(x, spec, tenant=k) for x in f]
                     for k, spec in specs.items()}
            pool = srv.server_stats()["pool"]["size"]
        for k in specs:
            out[f"{comm}/{k}"] = {
                "err": _served_err(d, k, batch[k]),
                "bits": all(np.array_equal(a.u, b.u)
                            for a, b in zip(alone[k], batch[k])),
                "batch": sorted({(r.batch_size, r.padded_to)
                                 for r in batch[k]}),
                "alone": sorted({(r.batch_size, r.padded_to)
                                 for r in alone[k]}),
                "pool": pool}
    payload = launcher.run_harness(
        n=n, tenants=2, requests=2, max_batch=2,
        specs=[_mesh_spec(mesh, k, n, "overlap:2") for k in _SERVE_KEYS])
    out["harness"] = {k: payload["server"][k]
                      for k in ("admitted", "completed")}
    out["harness"]["dev"] = payload["max_abs_dev_vs_individual"]
    return out


def scenario_serve_mesh_chaos(rank, d, params):
    """Four ranks, mesh (2, 2), one server (``verify="abft"``): the
    reference's serve soak on the mesh; a batch whose solve raises on
    every rank (an error armed at ``dist.dispatch``), then a clean one;
    a (U,U,U) build that fails on rank 2 alone, then the same key again."""
    from repro_torch.core import solver as sv
    from repro_torch.runtime import SolveError, faults
    from repro_torch.serve import PoissonServer, follow
    mesh = _mesh((2, 2), ("data", "model"))
    n = params["n"]
    spec = _soak_spec(mesh, n)
    fields = np.load(os.path.join(d, "soak_f.npy")).astype(np.float32)
    f = np.load(os.path.join(d, "f.npy"))
    uuu = _mesh_spec(mesh, "UUU", n, "a2a:1")
    if rank == 2:
        real, refused = sv.get_solver, []

        def flaky(shape, L, bcs, *a, **kw):
            if kw.get("mesh") is not None and bcs == uuu.bcs \
                    and not refused:
                refused.append(1)
                raise RuntimeError("rank 2 refuses this build")
            return real(shape, L, bcs, *a, **kw)
        sv.get_solver = flaky
    if rank != 0:
        return {"follow": follow(mesh, device="cpu")}
    out = {}
    with PoissonServer(max_batch=4, max_delay_ms=1.0, verify="abft") as srv:
        base = [srv.solve(x, spec, tenant="warm") for x in fields]
        out["base_records"] = sum(len(r.integrity) for r in base)
        plan = faults.FaultPlan([dict(kind="flip", stage="fwd.0", count=2)])
        bad = srv.submit(fields[0], spec, tenant="chaos",
                         fault_plan=plan).result(timeout=60)
        out["chaos_stages"] = [r["stage"] for r in bad.integrity]
        out["chaos_log"] = len(plan.log)
        out["chaos_bits"] = bool(np.array_equal(bad.u, base[0].u))
        soak = {"solves": 0, "bitexact": 0, "records": 0,
                "degradations": 0}
        for t in range(6):
            for i, x in enumerate(fields):
                r = srv.solve(x, spec, tenant=f"t{t}")
                soak["solves"] += 1
                soak["bitexact"] += int(np.array_equal(r.u, base[i].u))
                soak["records"] += len(r.integrity)
                soak["degradations"] += len(r.degradations)
        out["soak"] = soak
        doomed = faults.FaultPlan([dict(kind="error", stage="dist.dispatch",
                                        count=-1)])
        try:
            srv.submit(fields[1], spec, tenant="doomed",
                       fault_plan=doomed).result(timeout=60)
            out["doomed"] = None
        except SolveError as e:
            out["doomed"] = f"{type(e).__name__}: {e}"
        after = srv.solve(fields[1], spec, tenant="after")
        out["after"] = [bool(np.array_equal(after.u, base[1].u)),
                        len(after.degradations), len(after.integrity)]
        try:
            srv.solve(f[0], uuu, tenant="refused")
            out["refused"] = None
        except RuntimeError as e:
            out["refused"] = f"{type(e).__name__}: {e}"
        again = srv.solve(f[0], uuu, tenant="again")
        out["again_err"] = _maxerr(
            again.u, np.load(os.path.join(d, "want_UUU.npy"))[0])
        st = srv.server_stats()
        out["pool"] = st["pool"]["size"]
        out["failed"] = st["failed"]
    return out


def scenario_serve_mesh_ops(rank, d, params):
    """Four ranks, mesh (2, 2), three servers of (U,U,U) and (P,P,P) n=16
    float64 overlap:2: two workers under concurrent traffic (and a second
    server refused meanwhile); a memory budget that evicts at every other
    admission; ``stop`` while a batch is stalled past the drain deadline.  Then one batch on the sub-mesh
    of ranks 0 and 1.  ``submit`` on a follower raises."""
    import time
    from concurrent.futures import ThreadPoolExecutor
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.runtime import faults
    from repro_torch.serve import PoissonServer, ServerClosed, follow
    mesh = _mesh((2, 2), ("data", "model"))
    # every rank builds the sub-mesh (its groups are collective over the
    # world); only ranks 0 and 1 serve on it
    sub = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("data", "model"))
    f = np.load(os.path.join(d, "f.npy"))
    n = f.shape[-1]
    specs = {k: _mesh_spec(mesh, k, n, "overlap:2") for k in _SERVE_KEYS}
    if rank != 0:
        out = {}
        try:
            PoissonServer().submit(f[0], specs["UUU"])
            out["submit"] = None
        except RuntimeError as e:
            out["submit"] = str(e)
        out["follow"] = _follow(mesh, 3)
        if rank == 1:
            out["sub"] = follow(sub, device="cpu")
        return out
    out = {}
    keys = list(specs)

    def client(t):
        k = keys[t % 2]
        return [(k, i, srv.submit(f[i % len(f)], specs[k], tenant=f"t{t}"))
                for i in range(6)]
    with PoissonServer(max_batch=4, max_delay_ms=2.0, workers=2) as srv:
        with ThreadPoolExecutor(4) as ex:
            subs = list(ex.map(client, range(4)))
        got = [(k, i, fu.result(timeout=60)) for s in subs for k, i, fu in s]
        st = srv.server_stats()
        # a second server on the same mesh meanwhile: refused, nothing sent
        with PoissonServer(max_batch=1) as other:
            try:
                other.solve(f[0], specs["UUU"], timeout=60)
                out["second"] = None
            except RuntimeError as e:
                out["second"] = str(e)
    wants = {k: np.load(os.path.join(d, f"want_{k}.npy")) for k in keys}
    out["workers"] = {"served": len(got), "completed": st["completed"],
                      "batches": st["batches"], "pool": st["pool"]["size"],
                      "err": max(_maxerr(r.u, wants[k][i % len(f)])
                                 for k, i, r in got)}
    with PoissonServer(max_batch=1, memory_budget_mb=1e-6) as srv:
        errs = [_maxerr(srv.solve(f[0], specs[keys[i % 2]]).u,
                        wants[keys[i % 2]][0]) for i in range(4)]
        pool = srv.server_stats()["pool"]
    out["evict"] = {"err": max(errs), **{k: pool[k] for k in
                                         ("size", "builds", "evictions")}}
    srv = PoissonServer(max_batch=1, max_delay_ms=1.0,
                        drain_timeout_s=0.3).start()
    plan = faults.FaultPlan([dict(kind="stall", stage="dist.dispatch",
                                  seconds=1.5)])
    fut = srv.submit(f[0], specs["PPP"], fault_plan=plan)
    time.sleep(0.2)
    t0 = time.perf_counter()
    srv.stop()
    out["stall"] = {"stop_s": time.perf_counter() - t0,
                    "pool": srv.server_stats()["pool"]["size"]}
    try:
        fut.result(timeout=0)
        out["stall"]["error"] = None
    except ServerClosed as e:
        out["stall"]["error"] = e.queue_position
    with PoissonServer(max_batch=1, max_delay_ms=1.0) as srv:
        r = srv.solve(f[0], _mesh_spec(sub, "UUU", n, "a2a:1"))
    out["sub"] = _maxerr(r.u, wants["UUU"][0])
    return out


def scenario_serve_mesh_lost(rank, d, params):
    """Four ranks, mesh (2, 2), a short group timeout: rank 0 never runs
    a server, and each follower raises at the timeout instead of
    hanging."""
    import time
    from repro_torch.serve import follow
    mesh = _mesh((2, 2), ("data", "model"))
    if rank == 0:
        time.sleep(2 * params["group_timeout"] + 1)
        return {}
    t0 = time.perf_counter()
    try:
        follow(mesh, device="cpu")
        out = {"error": None}
    except RuntimeError as e:
        out = {"error": type(e).__name__}
    out["waited_s"] = time.perf_counter() - t0
    return out


def _lm_model(d, tag, spec):
    """A smoke config with ``spec``'s overrides and the model loaded from
    the reference's parameters in ``<d>/model_<tag>.npz``."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import convert
    cfg = dataclasses.replace(get_smoke(spec["arch"]), **spec["over"])
    if "capacity_factor" in spec:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=spec["capacity_factor"]))
    flat = np.load(os.path.join(d, f"model_{tag}.npz"))
    tree = convert.nest({tuple(k.split("/")): flat[k] for k in flat.files})
    return cfg, convert.from_reference(tree, cfg, "cpu")


def scenario_lm_mesh(rank, d, params):
    """Eight ranks, mesh (2, 4) ("data", "model"): ring attention on each
    rank's (batch, sequence) block against the reference's attention; the
    expert-parallel ``moe_block`` under each of ``params["moe_comms"]``
    against the reference's ``_moe_local`` on the same block, also from
    a module holding only the rank's experts; under autograd, both
    paths' input and weight gradients (summed over "model") against the
    local paths' on the same rank; the model's forward with ring
    attention and
    its prefill with the expert-parallel MoE, each rank passing its data
    shard, against the reference's forward and prefill."""
    import copy

    import torch
    import torch.distributed as dist
    from repro_torch.core.comm import label_to_cfg
    from repro_torch.models import attention as attn
    from repro_torch.models import convert, moe
    from repro_torch.models import transformer as tf

    mesh = _mesh((2, 4), ("data", "model"))
    dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")

    def load(name):
        return np.load(os.path.join(d, name + ".npy"))

    def block(a, seq=True, axis=0):
        """This rank's batch shard of ``a`` (batch at ``axis``) and, with
        ``seq``, its sequence block over the model axis."""
        b = a.shape[axis] // 2
        a = np.take(a, range(dr * b, (dr + 1) * b), axis=axis)
        if seq:
            s = a.shape[axis + 1] // 4
            a = np.take(a, range(mr * s, (mr + 1) * s), axis=axis + 1)
        return a

    def rel(got, want):
        got = got.detach().float().numpy() if torch.is_tensor(got) else got
        return float(np.abs(got - want).max() /
                     max(float(np.abs(want).max()), 1e-30))

    def grad_err(mesh_fn, local_fn, module, x_mesh, x_local, blk):
        """The largest relative error of ``mesh_fn``'s input gradient
        block and weight gradients (summed over "model") against
        ``local_fn``'s (its input gradient's ``blk``; its weight
        gradients summed over "model" too when ``blk`` is None), each
        under the cotangent ``cos(arange)``."""
        errs, grads = [], []
        shape = x_local.shape
        ct = torch.cos(torch.arange(x_local.numel(),
                                    dtype=x_local.dtype)).view(shape)
        for fn, x, c in ((mesh_fn, x_mesh, ct if blk is None else
                          ct[:, blk]), (local_fn, x_local, ct)):
            x = x.clone().requires_grad_()
            (fn(x) * c).sum().backward()
            w = {n: q.grad for n, q in module.named_parameters()}
            for n, q in module.named_parameters():
                q.grad = None
            grads.append((x.grad, w))
        (gx, gw), (lx, lw) = grads
        errs.append(rel(gx, (lx if blk is None else lx[:, blk]).numpy()))
        for n in gw:
            dist.all_reduce(gw[n], group=mesh.get_group("model"))
            if blk is None:
                dist.all_reduce(lw[n], group=mesh.get_group("model"))
            errs.append(rel(gw[n], lw[n].numpy()))
        return max(errs)

    models = {tag: _lm_model(d, tag, spec)
              for tag, spec in params["models"].items()}
    out = {"ring": {}, "moe": {}}
    for tag, case in params["ring"].items():
        cfg, model = models[case["model"]]
        x = torch.from_numpy(block(load(f"ring_{tag}_x")))
        with torch.no_grad():
            got = attn.attention_ring(model.layers[0].attn, cfg, x, mesh,
                                      prefix_len=case["prefix_len"])
        out["ring"][tag] = rel(got, block(load(f"ring_{tag}_want")))
    # the gradient of the last case's ring against the whole attention's
    p = model.layers[0].attn
    shard = torch.from_numpy(block(load(f"ring_{tag}_x"), seq=False))
    s_loc = shard.shape[1] // 4
    pos = torch.arange(shard.shape[1]).expand(shard.shape[:2])
    out["ring_grad"] = grad_err(
        lambda x_: attn.attention_ring(p, cfg, x_, mesh,
                                       prefix_len=case["prefix_len"]),
        lambda x_: attn.attention(p, cfg, x_, pos,
                                  prefix_len=case["prefix_len"]),
        p, x, shard, slice(mr * s_loc, (mr + 1) * s_loc))

    cfg, model = models["moe"]
    x = torch.from_numpy(block(load("moe_x")))
    want = block(load("moe_want"))
    for label in params["moe_comms"]:
        with torch.no_grad():
            got, drop = moe.moe_block(model.layers[0].moe, cfg, x,
                                      label_to_cfg(label), mesh)
        out["moe"][label] = [rel(got, want), float(drop)]
    out["moe_grad"] = grad_err(
        lambda x_: moe.moe_block(model.layers[0].moe, cfg, x_, None,
                                 mesh)[0],
        lambda x_: moe._moe_local(model.layers[0].moe, cfg, x_)[0],
        model.layers[0].moe, x, x, None)
    # a module holding only this rank's experts (param_specs' layout)
    e_loc = cfg.moe.n_experts // 4
    own = copy.deepcopy(model.layers[0].moe)
    for name in ("w_in", "w_gate", "w_out"):
        if hasattr(own, name):
            setattr(own, name, torch.nn.Parameter(
                getattr(own, name)[mr * e_loc:(mr + 1) * e_loc].clone()))
    with torch.no_grad():
        got, drop = moe.moe_block(own, cfg, x, None, mesh)
    out["moe_own_experts"] = [rel(got, want), float(drop)]
    own.w_in = torch.nn.Parameter(own.w_in[:1].clone())
    try:
        with torch.no_grad():
            moe.moe_block(own, cfg, x, None, mesh)
        out["moe_bad_rows"] = "ran"
    except ValueError as e:
        out["moe_bad_rows"] = str(e)

    cfg, model = models["ring_model"]
    tokens = torch.from_numpy(block(load("fwd_tokens"), seq=False))
    with torch.no_grad():
        logits, _ = tf.forward(model, tokens, mesh=mesh)
    out["forward_ring"] = rel(logits, block(load("fwd_want"), seq=False))

    cfg, model = models["moe_model"]
    tokens = torch.from_numpy(block(load("pre_tokens"), seq=False))
    logits, caches = tf.prefill(model, tokens, mesh=mesh,
                                max_len=params["max_len"])
    out["prefill_moe"] = rel(logits, block(load("pre_want"), seq=False))
    want = np.load(os.path.join(d, "pre_caches.npz"))
    got = convert._flat(convert.caches_to_reference(caches))
    out["prefill_caches"] = {
        k: rel(got[tuple(k.split("/"))], block(want[k], seq=False, axis=1))
        for k in want.files}
    return out


def _params_crc(model, skip=()) -> int:
    """CRC32 over the bytes of ``model``'s parameters (but ``skip``), in
    order: equal CRCs on two ranks mean bit-equal parameters."""
    import zlib
    crc = 0
    for name, p in model.named_parameters():
        if name not in skip:
            crc = zlib.crc32(p.detach().contiguous().numpy().tobytes(), crc)
    return crc


def _flat_tree(tree) -> dict:
    """{"a/b/c": array} of a nested dict of arrays."""
    from repro_torch.models import convert
    return {"/".join(k): np.asarray(v)
            for k, v in convert._flat(tree).items()}


def scenario_train_mesh(rank, d, params):
    """Eight ranks: the gradients of ring attention and of the
    expert-parallel MoE on mesh (2, 4) (each rank's input gradient block,
    the weight gradients summed over "model"); the mesh train step of
    ``params["steps"]``' cases on (2, 4) (or the case's ``"mesh"``), each
    rank on its data shard;
    the same from a state cut by ``shard_state_`` by the ``"fsdp"``
    layout (FSDP and the own experts, no tensor parallelism) on each of
    ``params["fsdp"]``' meshes, each rank's first-step gradient blocks
    and held shapes recorded, and the state of ``params["int8_ckpt"]``'s
    case saved and restored onto (4, 2) as the rank's blocks (error
    feedback included); the elastic rescale, two steps on (2, 4),
    a checkpoint, a restore onto (4, 2) and two more steps, from a whole
    state and from a sharded one (its restored blocks recorded, its save
    compared byte for byte with that of the same state held whole); a
    MoE state holding the rank's own experts saved on (2, 4) and
    restored onto (4, 2).  Arrays go to ``<d>/rank<r>.npz``
    (``<d>/rank<r>_<case>.npz`` for the states, rank 0's only); the JSON
    holds the losses and per-step parameter CRCs."""
    import copy
    import zlib

    import torch
    import torch.distributed as dist
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.core.comm import label_to_cfg
    from repro_torch.models import attention as attn
    from repro_torch.models import convert, moe
    from repro_torch.models.common import replace_param_
    from repro_torch.models.transformer import Transformer
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    mesh = _mesh((2, 4), ("data", "model"))
    dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    model_group = mesh.get_group("model")

    def load(name):
        return np.load(os.path.join(d, name + ".npy"))

    def block(a):
        """This rank's (batch, sequence) block of ``a``."""
        b, s = a.shape[0] // 2, a.shape[1] // 4
        return a[dr * b:(dr + 1) * b, mr * s:(mr + 1) * s]

    arrays, out = {}, {"steps": {}}

    def grads_over_model(module, prefix):
        for name, q in module.named_parameters():
            if q.grad is not None:
                dist.all_reduce(q.grad, group=model_group)
                arrays[f"{prefix}/{name}"] = q.grad.numpy().copy()
                q.grad = None

    models = {tag: _lm_model(d, tag, spec)
              for tag, spec in params["models"].items()}
    for tag, case in params["ring"].items():
        cfg, model = models[case["model"]]
        p = model.layers[0].attn
        x = torch.from_numpy(block(load(f"ring_{tag}_x"))).requires_grad_()
        o = attn.attention_ring(p, cfg, x, mesh,
                                prefix_len=case["prefix_len"])
        (o * torch.from_numpy(block(load(f"ring_{tag}_ct")))).sum().backward()
        arrays[f"ring_{tag}/x"] = x.grad.numpy()
        grads_over_model(p, f"ring_{tag}")

    cfg, model = models["moe"]
    x0 = torch.from_numpy(block(load("moe_x")))
    ct = torch.from_numpy(block(load("moe_ct")))
    e_loc = cfg.moe.n_experts // 4
    for label in params["moe_comms"]:
        for layout in ("all", "own"):
            m = copy.deepcopy(model.layers[0].moe)
            if layout == "own":
                for name in ("w_in", "w_gate", "w_out"):
                    if hasattr(m, name):
                        replace_param_(m, name, getattr(m, name).detach()[
                            mr * e_loc:(mr + 1) * e_loc].clone())
            x = x0.clone().requires_grad_()
            o, _ = moe.moe_block(m, cfg, x, label_to_cfg(label), mesh)
            (o * ct).sum().backward()
            key = f"moe_{label}_{layout}"
            arrays[f"{key}/x"] = x.grad.numpy()
            dist.all_reduce(m.router.grad, group=model_group)
            arrays[f"{key}/router"] = m.router.grad.numpy()
            for name in ("w_in", "w_gate", "w_out"):
                if hasattr(m, name):
                    g = getattr(m, name).grad
                    if layout == "all":
                        dist.all_reduce(g, group=model_group)
                        g = g[mr * e_loc:(mr + 1) * e_loc]
                    arrays[f"{key}/{name}"] = g.numpy()

    def state_of(tag, compress):
        cfg, model = _lm_model(d, tag, params["models"][tag])
        named = dict(model.named_parameters())
        return cfg, ts.TrainState(model, opt.init_opt_state(named),
                                  opt.init_error_feedback(named)
                                  if compress else None)

    def batch(name):
        f = np.load(os.path.join(d, name + ".npz"))
        return {k: torch.from_numpy(f[k]) for k in f.files}

    def run(state, cfg, adam, on, batches, rec, on_grads=None):
        for i, name in enumerate(batches):
            step = ts.train_step_fn(cfg, adam, mesh=on,
                                    on_grads=on_grads if i == 0 else None)
            state, met = step(state, ts.data_shard(batch(name), on))
            rec["loss"].append(float(met["loss"]))
            rec["crc"].append(_params_crc(
                state.params, ts.model_blocks(state.params, on)))
        return state

    def save_rank0(case, tree):
        if rank == 0:
            np.savez(os.path.join(d, f"rank0_{case}.npz"), **_flat_tree(
                {"params": tree[0], "m": tree[1]["m"], "v": tree[1]["v"]}))

    meshes = {(2, 4): mesh, (4, 2): _mesh((4, 2), ("data", "model")),
              (2, 2, 2): _mesh((2, 2, 2), ("pod", "data", "model"))}
    mesh_b = meshes[(4, 2)]
    shape_b = {"data": 4, "model": 2}
    for case, spec in params["steps"].items():
        on = meshes[tuple(spec.get("mesh", (2, 4)))]
        cfg, state = state_of(spec["model"], spec["compress"])
        adam = opt.AdamWConfig(grad_compress="int8" if spec["compress"]
                               else "none")
        rec = out["steps"][case] = {"loss": [], "crc": []}
        state = run(state, cfg, adam, on, spec["batches"], rec)
        save_rank0(case, convert.to_reference(state, on))

    # FSDP: the same steps from a state of the rank's blocks
    out["fsdp"] = {}
    for case, spec in params["fsdp"].items():
        on = meshes[tuple(spec["mesh"])]
        cfg, state = state_of(spec["model"], spec["compress"])
        ts.shard_state_(state, on, "fsdp")
        rec = out["fsdp"][case] = {
            "loss": [], "crc": [], "data": on.get_local_rank("data"),
            "model": on.get_local_rank("model"),
            "held": {key: {n: list(t.shape) for n, t in tree.items()}
                     for key, tree in (
                         ("params", dict(state.params.named_parameters())),
                         ("m", state.opt_state["m"]),
                         ("v", state.opt_state["v"]),
                         ("err_fb", state.err_fb or {}))}}

        def keep(grads, case=case):
            for n, g in grads.items():
                arrays[f"{case}/{n}"] = g.numpy().copy()
        adam = opt.AdamWConfig(grad_compress="int8" if spec["compress"]
                               else "none")
        state = run(state, cfg, adam, on, spec["batches"], rec, keep)
        whole = convert.to_reference(state, on)
        rec["whole_crc"] = zlib.crc32(b"".join(
            a.tobytes() for a in _flat_tree(
                {"params": whole[0], "m": whole[1]["m"],
                 "v": whole[1]["v"]}).values()))
        save_rank0(case, whole)
        if case == params["int8_ckpt"]:
            # the sharded state, error feedback and all, saved and
            # restored onto (4, 2) as the rank's blocks
            ck_dir = os.path.join(d, "int8_ck")
            ck.save(ck_dir, 3, whole, mesh=on)
            if rank == 0:
                np.savez(os.path.join(d, "rank0_int8_ckpt.npz"),
                         **_flat_tree({"err_fb": whole[2]}))
            tree = ck.restore(ck_dir, 3,
                              ts.held_like(cfg, mesh_b, True, "fsdp"),
                              mesh=mesh_b, specs=ts.held_specs(cfg, shape_b))
            restored = convert.from_reference(tree, cfg)
            out["int8_ckpt"] = {key: {n: list(t.shape) for n, t in held}
                                for key, held in (
                ("params", restored.params.named_parameters()),
                ("err_fb", restored.err_fb.items()))}
            for key, t in (("params", tree[0]), ("m", tree[1]["m"]),
                           ("v", tree[1]["v"]), ("err_fb", tree[2])):
                for k, a in _flat_tree(t).items():
                    arrays[f"int8_ckpt/{key}/{k}"] = a

    # the elastic rescale: (2, 4) -> checkpoint -> (4, 2)
    el = params["elastic"]
    cfg, state = state_of(el["model"], False)
    rec = out["elastic"] = {"loss": [], "crc": []}
    adam = opt.AdamWConfig()
    state = run(state, cfg, adam, mesh, el["batches"][:2], rec)
    ck_dir = os.path.join(d, "elastic_ck")
    ck.save(ck_dir, 2, convert.to_reference(state, mesh), mesh=mesh)
    tree = ck.restore(ck_dir, 2, convert.reference_like(cfg), mesh=mesh_b,
                      specs=ts.state_specs(cfg, shape_b))
    state = run(convert.from_reference(tree, cfg), cfg, adam, mesh_b,
                el["batches"][2:], rec)
    save_rank0("elastic", convert.to_reference(state, mesh_b))

    # the same from a sharded state, restored onto (4, 2) as the rank's
    # blocks; its save against a save of the same state held whole
    cfg, state = state_of(el["model"], False)
    ts.shard_state_(state, mesh, "fsdp")
    rec = out["elastic_fsdp"] = {"loss": [], "crc": []}
    state = run(state, cfg, adam, mesh, el["batches"][:2], rec)
    tree = convert.to_reference(state, mesh)
    ck_dir = os.path.join(d, "elastic_fsdp_ck")
    ck.save(ck_dir, 2, tree, mesh=mesh)
    save_rank0("elastic_fsdp_saved", tree)
    if rank == 0:
        whole_dir = os.path.join(d, "elastic_whole_ck")
        ck.save(whole_dir, 2, convert.to_reference(
            convert.from_reference(tree, cfg)))
        files = sorted(os.listdir(os.path.join(ck_dir, "step_2")))
        rec["files"] = len(files)
        rec["save_identical"] = files == sorted(os.listdir(os.path.join(
            whole_dir, "step_2"))) and all(
            open(os.path.join(ck_dir, "step_2", f), "rb").read()
            == open(os.path.join(whole_dir, "step_2", f), "rb").read()
            for f in files)
    tree = ck.restore(ck_dir, 2, ts.held_like(cfg, mesh_b, layout="fsdp"),
                      mesh=mesh_b, specs=ts.held_specs(cfg, shape_b))
    for key, t in (("params", tree[0]), ("m", tree[1]["m"]),
                   ("v", tree[1]["v"])):
        for k, a in _flat_tree(t).items():
            arrays[f"elastic_fsdp/{key}/{k}"] = a
    state = run(convert.from_reference(tree, cfg), cfg, adam, mesh_b,
                el["batches"][2:], rec)
    rec["held"] = {n: list(p.shape)
                   for n, p in state.params.named_parameters()}
    save_rank0("elastic_fsdp", convert.to_reference(state, mesh_b))

    # a state holding the rank's own experts: saved on (2, 4), restored
    # onto (4, 2), each rank given its new experts' rows
    own = params["own_ckpt"]
    cfg, state = state_of(own["model"], False)
    ts.own_experts_(state, mesh)
    rec = out["own_ckpt"] = {"loss": [], "crc": []}
    state = run(state, cfg, adam, mesh, own["batches"], rec)
    ck_dir = os.path.join(d, "own_ck")
    whole = convert.to_reference(state, mesh)
    ck.save(ck_dir, 1, whole, mesh=mesh)
    save_rank0("own_ckpt", whole)
    with torch.device("meta"):
        like = ts.shard_params_(Transformer(cfg), mesh_b, "experts")
    tree = ck.restore(ck_dir, 1, convert.reference_like(like), mesh=mesh_b,
                      specs=ts.state_specs(cfg, shape_b))
    restored = convert.from_reference(tree, cfg)
    rows = ts.model_blocks(restored.params, mesh_b)
    out["own_ckpt"]["rows"] = {
        n: list(p.shape) for n, p in restored.params.named_parameters()
        if n in rows}
    for key, t in (("params", tree[0]), ("m", tree[1]["m"]),
                   ("v", tree[1]["v"])):
        for k, a in _flat_tree(t).items():
            if "/moe/w_" in "/" + k:
                arrays[f"own_ckpt/{key}/{k}"] = a
    np.savez(os.path.join(d, f"rank{rank}.npz"), **arrays)
    out["mesh_b"] = [mesh_b.get_local_rank("data"),
                     mesh_b.get_local_rank("model")]
    return out


def scenario_train_tp(rank, d, params):
    """Eight ranks: the mesh train step from a state cut by
    ``shard_state_`` (tensor parallelism over "model", FSDP over "data")
    for each case of ``params["cases"]`` on its mesh (int8-compressed
    where its ``"compress"``), each rank on its
    data shard of the global batches: per step the loss and a CRC of the
    parameters but the blocks over "model"; the held shapes, the first
    step's gradients (``<d>/rank<r>.npz``) and a CRC of the gathered
    state (rank 0's to ``<d>/rank0_<case>.npz``); the state of each case
    of ``params["ckpt"]`` saved and restored onto (4, 2) as the rank's
    blocks (``held_like``, ``held_specs``)."""
    import zlib

    import torch
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.models import convert
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    meshes = {tuple(m): _mesh(m, ("data", "model"))
              for m in ((2, 4), (4, 2))}
    arrays, out = {}, {}

    def batch(name):
        f = np.load(os.path.join(d, name + ".npz"))
        return {k: torch.from_numpy(f[k]) for k in f.files}

    def gathered(state, mesh):
        tree = convert.to_reference(state, mesh)
        flat = _flat_tree({"params": tree[0], "m": tree[1]["m"],
                           "v": tree[1]["v"]})
        return tree, flat, zlib.crc32(b"".join(a.tobytes()
                                               for a in flat.values()))

    for case, spec in params["cases"].items():
        mesh = meshes[tuple(spec["mesh"])]
        cfg, model = _lm_model(d, spec["model"],
                               params["models"][spec["model"]])
        named = dict(model.named_parameters())
        state = ts.shard_state_(ts.TrainState(
            model, opt.init_opt_state(named),
            opt.init_error_feedback(named) if spec["compress"] else None),
            mesh)
        adam = opt.AdamWConfig(grad_compress="int8" if spec["compress"]
                               else "none")
        rec = out[case] = {
            "loss": [], "crc": [], "data": mesh.get_local_rank("data"),
            "model": mesh.get_local_rank("model"),
            "held": {key: {n: list(t.shape) for n, t in tree.items()}
                     for key, tree in (
                         ("params", dict(state.params.named_parameters())),
                         ("m", state.opt_state["m"]),
                         ("v", state.opt_state["v"]))}}

        def keep(grads, case=case):
            for n, g in grads.items():
                arrays[f"{case}/{n}"] = g.numpy().copy()
        for i, name in enumerate(spec["batches"]):
            step = ts.train_step_fn(cfg, adam, mesh=mesh,
                                    on_grads=keep if i == 0 else None)
            state, met = step(state, ts.data_shard(batch(name), mesh))
            rec["loss"].append(float(met["loss"]))
            rec["crc"].append(_params_crc(
                state.params, ts.model_blocks(state.params, mesh)))
        tree, flat, rec["whole_crc"] = gathered(state, mesh)
        if rank == 0:
            np.savez(os.path.join(d, f"rank0_{case}.npz"), **flat)
        if case not in params["ckpt"]:
            continue
        # saved on the case's mesh, restored onto (4, 2) as the blocks
        to, shape_to = meshes[(4, 2)], {"data": 4, "model": 2}
        where = os.path.join(d, f"tp_ck_{case}")
        ck.save(where, 3, tree, mesh=mesh)
        back = ck.restore(where, 3, ts.held_like(cfg, to), mesh=to,
                          specs=ts.held_specs(cfg, shape_to))
        for key, t in (("params", back[0]), ("m", back[1]["m"]),
                       ("v", back[1]["v"])):
            for k, a in _flat_tree(t).items():
                arrays[f"ckpt/{case}/{key}/{k}"] = a
        out.setdefault("ckpt", {})[case] = {
            "mesh_b": [to.get_local_rank("data"),
                       to.get_local_rank("model")]}
    np.savez(os.path.join(d, f"rank{rank}.npz"), **arrays)
    return out


def _serve_from_blocks(rank, d, params, layout):
    """Each model of ``params["models"]`` served from its blocks by the
    layout rule ``layout`` (``shard_params_``) on each mesh of
    ``params["meshes"]``: ``prefill`` of the rank's data shard of the
    prompt (and frontend) on the mesh, then ``decode_step`` on each of
    the step tokens' shards; the logits of each call, the caches after
    prefill and after the last step (the reference's layout), the number
    of parameters held as blocks (and over "model" but an expert weight)
    and a CRC of the logits go to ``<d>/rank<r>.npz`` and the JSON.  Then
    the serving restore: a train state of ``params["restore"]["model"]``
    cut by ``shard_state_`` takes one step on (2, 4) and is saved, and
    its parameters are saved alone; each checkpoint is restored onto
    (4, 2) as serving blocks (``held_params_like`` by ``layout``,
    ``param_specs``) and served as above, beside the same trained
    parameters cut there by ``shard_params_``."""
    import zlib

    import torch
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.models import convert
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import DATA_AXES, mesh_coord
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as ts

    meshes = {tuple(m): _mesh(m, ("data", "model"))
              for m in params["meshes"]}
    arrays, out = {}, {}

    def load(name):
        f = np.load(os.path.join(d, name + ".npz"))
        return {k: torch.from_numpy(f[k]) for k in f.files}

    def serve(model, case, mesh, key):
        """Prefill and the decode steps on ``mesh``; records under
        ``key``."""
        inp = ts.data_shard(load(case["prompt"]), mesh)
        logits, caches = tf.prefill(model, inp["tokens"], inp.get("frontend"),
                                    mesh=mesh, max_len=case["max_len"])
        got = [logits]
        for k, a in _flat_tree(convert.caches_to_reference(caches)).items():
            arrays[f"{key}/caches_prefill/{k}"] = a
        n = logits.shape[1]
        for j, name in enumerate(case["steps"]):
            tok = ts.data_shard(load(name), mesh)["token"]
            lg, caches = tf.decode_step(model, tok, caches, n + j, mesh=mesh)
            got.append(lg)
        for k, a in _flat_tree(convert.caches_to_reference(caches)).items():
            arrays[f"{key}/caches/{k}"] = a
        crc = 0
        for j, lg in enumerate(got):
            arrays[f"{key}/logits{j}"] = lg.numpy()
            crc = zlib.crc32(lg.numpy().tobytes(), crc)
        held = tf.held_axes(model, mesh)
        out[key] = {"data": mesh_coord(mesh, DATA_AXES)[0],
                    "model": mesh.get_local_rank("model"), "crc": crc,
                    "blocks": len(held),
                    "tp_blocks": sum("model" in axes
                                     and not convert.expert_weight(n)
                                     for n, axes in held.items()),
                    "recurrent_blocks": sum(
                        "model" in axes and bool(
                            {"ssm", "rec"} & set(convert.ref_path(n)[0]))
                        for n, axes in held.items()),
                    "held": {name: list(p.shape)
                             for name, p in model.named_parameters()}}

    with torch.no_grad():
        for tag, spec in params["models"].items():
            for shape, mesh in meshes.items():
                cfg, model = _lm_model(d, tag, spec)
                ts.shard_params_(model, mesh, layout)
                serve(model, params["cases"][tag], mesh,
                      f"{tag}-{'x'.join(map(str, shape))}")

    # the serving restore: (2, 4) training -> checkpoint -> (4, 2)
    rs = params["restore"]
    tag, on, to = rs["model"], meshes[(2, 4)], meshes[(4, 2)]
    cfg, model = _lm_model(d, tag, params["models"][tag])
    named = dict(model.named_parameters())
    state = ts.shard_state_(ts.TrainState(model, opt.init_opt_state(named),
                                          None), on)
    state, _ = ts.train_step_fn(cfg, mesh=on)(state, ts.data_shard(
        load(rs["batch"]), on))
    whole = convert.to_reference(state, on)
    ck.save(os.path.join(d, "state_ck"), 1, whole, mesh=on)
    ck.save(os.path.join(d, "params_ck"), 1, whole[0], mesh=on)
    shape_to = {"data": 4, "model": 2}
    with torch.no_grad():
        for name in ("state_ck", "params_ck"):
            tree = ck.restore(os.path.join(d, name), 1,
                              ts.held_params_like(cfg, to, layout), mesh=to,
                              specs=tf.param_specs(cfg, shape_to))
            serve(convert.from_reference(tree, cfg), params["cases"][tag],
                  to, f"restore-{name}")
        serve(ts.shard_params_(convert.from_reference(whole[0], cfg), to,
                               layout),
              params["cases"][tag], to, "restore-cut")
    np.savez(os.path.join(d, f"rank{rank}.npz"), **arrays)
    return out


def scenario_serve_sharded(rank, d, params):
    """Eight ranks: ``_serve_from_blocks`` by the ``"fsdp"`` layout (the
    dense weights whole over "model")."""
    return _serve_from_blocks(rank, d, params, "fsdp")


def scenario_serve_tp(rank, d, params):
    """Eight ranks: ``_serve_from_blocks`` by the ``"train"`` layout
    (tensor parallelism over "model", FSDP over "data")."""
    return _serve_from_blocks(rank, d, params, "train")


def _run_rank(rank, scenario, d, world):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(d, "params.json")) as fh:
        params = json.load(fh)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, 'rendezvous')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(
            seconds=params.get("group_timeout", GROUP_TIMEOUT_S)))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = globals()[f"scenario_{scenario}"](rank, d, params)
        with open(os.path.join(d, f"rank{rank}.json"), "w") as fh:
            json.dump(res, fh)
        # a scenario that lets a collective time out leaves the group's
        # connections closed: its ranks end without the barrier
        if "group_timeout" not in params:
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
