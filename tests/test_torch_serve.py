"""The port's solve server (``repro_torch.serve``) == the reference's.

Counterparts of the tests of ``tests/test_serve.py`` (each named with
``torch_`` added), on ``device="cpu"`` at N=8, over the engines
``"torch"`` and ``"cuda"`` (the kernels' plain versions on CPU tensors)
where a case is quick.  The invariant is the reference's: serving
changes WHEN and HOW solves run, never WHAT they compute.  A fault-armed
batch takes the ladder's first rung: ``relayout:scheduled->baseline`` on
``"torch"`` (bit-exact), ``engine:cuda->torch`` on ``"cuda"`` (within
1e-10 in float64).

Beside them: the same traffic through ``repro.serve.PoissonServer``
(float64; x64 is on from ``tests/conftest.py``) and the port's server --
responses within 1e-10, batch sizes and ranks equal, the stats' keys
equal, degradation actions equal with the engine rung renamed; the
reference's serve soak (``tests/test_abft.py``) in process and on a
one-rank gloo mesh (``tests/test_torch_ranks.py``; meshes of several
ranks are ``tests/test_torch_serve_mesh.py``'s); ``PlanSpec``'s search
default and key; the default device without a card; the launcher.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import test_torch_ranks as ranks
from repro.core.bc import BCType as RBCType
from repro.runtime import faults as rfaults
from repro.serve import PlanSpec as RPlanSpec
from repro.serve import PoissonServer as RPoissonServer
from repro_torch.core.bc import BCType, DataLayout
from repro_torch.core.solver import (PoissonSolver, clear_solver_cache,
                                     get_solver, solver_cache_info)
from repro_torch.launch import serve as launcher
from repro_torch.runtime import faults, resilience
from repro_torch.serve import (AdmissionError, PlanSpec, PoissonServer,
                               ServerClosed, default_batch_ranks,
                               percentile)

E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB
N = 8
UNB3 = ((U, U),) * 3
PER3 = ((P, P),) * 3
ENGINES = ["torch", "cuda"]
# the first rung an injected solve.dispatch fault takes on each engine
FIRST_RUNG = {"torch": "relayout:scheduled->baseline",
              "cuda": "engine:cuda->torch"}


def _spec(bcs=UNB3, **kw):
    kw.setdefault("device", "cpu")
    return PlanSpec(shape=(N, N, N), bcs=bcs, **kw)


def _rhs(b, seed=0, grid=(N, N, N)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(grid) for _ in range(b)]


def _solve(spec, f):
    """An individual solve of ``spec``'s (cached) solver, on the host."""
    return spec.build().solve(f).cpu().numpy()


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    clear_solver_cache()
    resilience.reset_warn_once()
    yield
    assert not faults._ACTIVE, "a test left a FaultPlan armed"
    clear_solver_cache()
    resilience.reset_warn_once()


# -- coalescing correctness --------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_torch_coalesced_batch_bitexact_vs_individual(engine):
    spec = _spec(engine=engine)
    fs = _rhs(7, seed=1)                    # 7 -> one full 4-batch + 3->4 pad
    with PoissonServer(max_batch=4, max_delay_ms=2) as srv:
        futs = [srv.submit(f, spec, tenant=f"t{i % 3}")
                for i, f in enumerate(fs)]
        res = [f.result(timeout=120) for f in futs]
    assert any(r.batch_size > 1 for r in res), "nothing coalesced"
    s = get_solver((N, N, N), 1.0, UNB3, engine=engine, device="cpu")
    for f, r in zip(fs, res):
        # same plan, same pipeline, batch rows are independent: the
        # served (coalesced, possibly zero-padded) answer is BIT-exact
        np.testing.assert_array_equal(s.solve(f).numpy(), r.u)


def test_torch_cuda_engine_batch_bitexact_at_16_on_the_cpu():
    # the plain kernels on a batch large enough that PyTorch's CPU loops
    # split it among threads at the default thread count: a batched row
    # keeps the bits of the same row solved alone
    s = PoissonSolver((16,) * 3, 1.0, UNB3, engine="cuda", device="cpu")
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal(
        (8,) + s.input_shape).astype(np.float32))
    ub = s.solve(f)
    for i in range(8):
        assert torch.equal(ub[i], s.solve(f[i])), i


@pytest.mark.parametrize("engine", ENGINES)
def test_torch_padding_to_nearest_rank(engine):
    spec = _spec(bcs=PER3, engine=engine)
    with PoissonServer(max_batch=8, max_delay_ms=1) as srv:
        futs = [srv.submit(f, spec) for f in _rhs(3, seed=2)]
        res = [f.result(timeout=120) for f in futs]
    ranks_ = default_batch_ranks(8)
    for r in res:
        assert r.padded_to in ranks_
        assert r.padded_to >= r.batch_size
    # 3 live rhs either ran as one deadline batch padded 3->4, or split
    batch = [r for r in res if r.batch_size == 3]
    if batch:
        assert batch[0].padded_to == 4


@pytest.mark.parametrize("engine", ENGINES)
def test_torch_deadline_flush_releases_partial_batch(engine):
    spec = _spec(bcs=PER3, engine=engine)
    with PoissonServer(max_batch=64, max_delay_ms=5) as srv:
        [f] = _rhs(1, seed=3)
        fut = srv.submit(f, spec)
        r = fut.result(timeout=120)         # far below max_batch: only the
        assert r.batch_size == 1            # deadline can have flushed it
        assert srv.server_stats()["deadline_flushes"] >= 1


@pytest.mark.parametrize("engine", ENGINES)
def test_torch_mixed_plan_keys_never_coalesce(engine):
    spec_a = _spec(bcs=UNB3, engine=engine)
    spec_b = _spec(bcs=PER3, engine=engine)
    spec_c = _spec(bcs=((E, E), (O, E), (P, P)), layout=DataLayout.NODE,
                   engine=engine)
    grids = {spec_a.key(): (N, N, N), spec_b.key(): (N, N, N),
             spec_c.key(): (N + 1, N + 1, N + 1)}
    with PoissonServer(max_batch=8, max_delay_ms=10) as srv:
        futs = []
        for i, spec in enumerate([spec_a, spec_b, spec_c] * 3):
            [f] = _rhs(1, seed=10 + i, grid=grids[spec.key()])
            futs.append((spec, f, srv.submit(f, spec, tenant=f"t{i % 2}")))
        res = [(spec, f, fut.result(timeout=240)) for spec, f, fut in futs]
    for spec, f, r in res:
        np.testing.assert_array_equal(_solve(spec, f), r.u)  # no bleed
        assert r.batch_size <= 3                   # only same-key coalesce


# -- warm pool ---------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_torch_warm_pool_evicts_under_memory_pressure(engine):
    # three plan keys, budget sized to hold roughly one: serving all three
    # must evict (pool LRU + module LRU) yet keep answering correctly
    specs = [_spec(bcs=UNB3, engine=engine), _spec(bcs=PER3, engine=engine),
             _spec(bcs=((E, E), (O, O), (E, E)), engine=engine)]
    one_plan_mb = 0.02                      # 8^3 f64 green ~4-18KB
    with PoissonServer(max_batch=2, max_delay_ms=1,
                       memory_budget_mb=one_plan_mb) as srv:
        for rep in range(2):
            for i, spec in enumerate(specs):
                [f] = _rhs(1, seed=20 + i)
                r = srv.solve(f, spec, timeout=240)
                np.testing.assert_array_equal(_solve(spec, f), r.u)
        info = srv.server_stats()["pool"]
    assert info["evictions"] >= 1
    assert info["budget_bytes"] == int(one_plan_mb * 1e6)
    # eviction reached through to the module LRU too
    assert solver_cache_info()["evictions"] >= 1


@pytest.mark.parametrize("engine", ENGINES)
def test_torch_warm_pool_unbounded_keeps_plans_resident(engine):
    specs = [_spec(bcs=UNB3, engine=engine), _spec(bcs=PER3, engine=engine)]
    with PoissonServer(max_batch=2, max_delay_ms=1) as srv:
        for spec in specs * 2:
            [f] = _rhs(1, seed=31)
            srv.solve(f, spec, timeout=240)
        info = srv.server_stats()["pool"]
    assert info["evictions"] == 0
    assert info["size"] == 2
    assert info["hits"] >= 2                # second round hit warm plans


def test_torch_pool_estimate_counts_every_device_green_copy():
    """The footprint counts each dtype's device Green copy: a float32
    request adds the float32 copy, and the next rank re-counts it."""
    spec = _spec(bcs=PER3, engine="torch")
    with PoissonServer(max_batch=1, max_delay_ms=1) as srv:
        [f] = _rhs(1, seed=32)
        srv.solve(f, spec, timeout=240)
        est64 = srv.server_stats()["pool"]["total_bytes"]
        s = spec.build()
        g64 = s._green[torch.float64]
        assert est64 == g64.numel() * 8 + 3 * N ** 3 * 8
        with PoissonServer(max_batch=2, max_delay_ms=1) as srv32:
            futs = [srv32.submit(x.astype(np.float32), spec)
                    for x in _rhs(2, seed=33)]
            [fut.result(timeout=240) for fut in futs]
            info = srv32.server_stats()["pool"]
    ranks_ = info["keys"][0]["ranks"]
    assert set(s._green) == {torch.float64, torch.float32}
    assert info["total_bytes"] == (g64.numel() * (8 + 4)
                                   + 3 * N ** 3 * 8 * sum(ranks_))


# -- resilience --------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_torch_faulted_request_degrades_without_poisoning_cobatched(engine):
    """One tenant's request arms a hard fault at solve dispatch; the
    ladder takes its first rung (relayout scheduled->baseline on "torch",
    bit-exact; engine cuda->torch on "cuda"), the whole co-batched solve
    still returns the right answer for EVERY tenant, and only that batch
    carries degradation records."""
    spec = _spec(engine=engine)
    fs = _rhs(4, seed=4)
    plan = faults.FaultPlan([{"kind": "error", "stage": "solve.dispatch",
                              "count": 1}])
    with PoissonServer(max_batch=4, max_delay_ms=50) as srv:
        futs = [srv.submit(f, spec, tenant=f"t{i}",
                           fault_plan=plan if i == 2 else None)
                for i, f in enumerate(fs)]
        res = [f.result(timeout=240) for f in futs]
        tstats = srv.tenant_stats()
    assert [r.batch_size for r in res] == [4, 4, 4, 4]
    assert plan.log, "armed fault never fired"
    # the ladder downgraded exactly once and every tenant saw the record
    for r in res:
        assert len(r.degradations) == 1
        assert r.degradations[0]["action"] == FIRST_RUNG[engine]
    for i in range(4):
        assert len(tstats[f"t{i}"]["degradations"]) == 1
    # ...and nobody's answer was poisoned
    s = get_solver((N, N, N), 1.0, UNB3, engine=engine, device="cpu")
    for f, r in zip(fs, res):
        want = s.solve(f).numpy()
        if engine == "torch":               # baseline relayout: bit-exact
            np.testing.assert_array_equal(want, r.u)
        else:                               # torch.fft: another rounding
            assert np.abs(want - r.u).max() < 1e-10


@pytest.mark.parametrize("engine", ENGINES)
def test_torch_faulted_request_does_not_degrade_clean_warm_plan(engine):
    """The armed batch runs on a fault-token shadow solver: the clean warm
    plan keeps its config (engine and relayout) for later traffic."""
    spec = _spec(bcs=PER3, engine=engine)
    plan = faults.FaultPlan([{"kind": "error", "stage": "solve.dispatch",
                              "count": 1}])
    with PoissonServer(max_batch=1, max_delay_ms=1) as srv:
        [f0] = _rhs(1, seed=5)
        r_clean0 = srv.solve(f0, spec, timeout=240)
        r_faulted = srv.submit(f0, spec, fault_plan=plan).result(timeout=240)
        r_clean1 = srv.solve(f0, spec, timeout=240)
    assert r_faulted.degradations and not r_clean0.degradations \
        and not r_clean1.degradations
    assert r_faulted.degradations[0]["action"] == FIRST_RUNG[engine]
    if engine == "torch":
        np.testing.assert_array_equal(r_clean0.u, r_faulted.u)
    else:
        assert np.abs(r_clean0.u - r_faulted.u).max() < 1e-10
    np.testing.assert_array_equal(r_clean0.u, r_clean1.u)
    assert spec.build()._cfg["engine"] == engine


# -- admission + lifecycle ---------------------------------------------------

def test_torch_admission_rejects_bad_shape_and_counts_it():
    spec = _spec()
    with PoissonServer(max_batch=2, max_delay_ms=1) as srv:
        with pytest.raises(AdmissionError, match="does not match"):
            srv.submit(np.zeros((N, N)), spec, tenant="short")
        tstats = srv.tenant_stats()
    assert tstats["short"]["rejected"] == 1
    assert srv.server_stats()["rejected"] == 1


def test_torch_submit_after_stop_raises_server_closed():
    spec = _spec(bcs=PER3)
    srv = PoissonServer(max_batch=2, max_delay_ms=1).start()
    [f] = _rhs(1, seed=6)
    srv.solve(f, spec, timeout=240)
    srv.stop()
    with pytest.raises(ServerClosed):
        srv.submit(f, spec)


def test_torch_backpressure_rejects_beyond_max_pending():
    spec = _spec(bcs=PER3)
    srv = PoissonServer(max_batch=4, max_delay_ms=10_000, max_pending=3)
    srv.start()
    try:
        fs = _rhs(5, seed=7)
        futs = [srv.submit(f, spec) for f in fs[:3]]
        with pytest.raises(AdmissionError, match="backpressure"):
            srv.submit(fs[3], spec)
    finally:
        srv.stop()                          # drain flushes the 3 pending
    assert all(f.result(timeout=240).batch_size == 3 for f in futs)


def test_torch_stop_drain_serves_everything():
    spec = _spec(bcs=PER3)
    srv = PoissonServer(max_batch=8, max_delay_ms=10_000).start()
    futs = [srv.submit(f, spec) for f in _rhs(3, seed=8)]
    srv.stop(drain=True)                    # deadline far away: drain flush
    assert all(f.result(timeout=1).u.shape == (N, N, N) for f in futs)
    assert srv.server_stats()["completed"] == 3


def test_torch_drain_deadline_fails_wedged_requests():
    """One wedged solve (a stalled collective, modelled by a ``stall``
    fault sleeping inside dispatch, far longer than the drain deadline)
    must not hang ``stop(drain=True)``: the deadline expires, every
    unserved request fails with a position-stamped ``ServerClosed``, the
    wedged worker thread is abandoned, and shutdown returns in bounded
    time.  The stall is 8 s (the reference's 60 s): the abandoned worker
    disarms its plan when it wakes, and the test waits for that so no
    armed plan outlives it."""
    spec = _spec(bcs=PER3)
    plan = faults.FaultPlan([{"kind": "stall", "stage": "solve.dispatch",
                              "seconds": 8.0}])
    srv = PoissonServer(max_batch=1, max_delay_ms=1).start()
    fs = _rhs(3, seed=9)
    wedged = srv.submit(fs[0], spec, fault_plan=plan)
    # let the wedged batch reach the worker so the deadline is the only
    # way out, then pile clean requests behind it (workers=1)
    deadline = time.monotonic() + 10
    while not plan.log and time.monotonic() < deadline:
        time.sleep(0.01)
    stuck = [srv.submit(f, spec) for f in fs[1:]]
    t0 = time.monotonic()
    srv.stop(drain=True, timeout=1.0)
    assert time.monotonic() - t0 < 30, "drain deadline did not bound stop"
    positions = []
    for f in [wedged] + stuck:
        with pytest.raises(ServerClosed) as ei:
            f.result(timeout=1)
        assert "drain deadline" in str(ei.value)
        positions.append(ei.value.queue_position)
    # every victim got a distinct 1-based queue position, in-flight first
    assert sorted(positions) == [1, 2, 3], positions
    assert positions[0] == 1, "wedged in-flight request must rank first"
    st = srv.server_stats()
    assert st["drain_timeouts"] == 3
    assert st["failed"] >= 3 and st.get("abandoned_threads", 0) >= 1
    # a stopped server still refuses new work cleanly
    with pytest.raises(ServerClosed):
        srv.submit(fs[0], spec)
    deadline = time.monotonic() + 60
    while plan in faults._ACTIVE and time.monotonic() < deadline:
        time.sleep(0.05)


# -- stats -------------------------------------------------------------------

def test_torch_tenant_stats_percentiles_and_occupancy():
    spec = _spec(bcs=PER3)
    with PoissonServer(max_batch=2, max_delay_ms=2) as srv:
        futs = [srv.submit(f, spec, tenant="solo") for f in _rhs(6, seed=9)]
        [f.result(timeout=240) for f in futs]
        t = srv.tenant_stats()["solo"]
    assert t["served"] == 6
    assert t["p50_ms"] <= t["p95_ms"] <= t["p99_ms"]
    assert 1 <= t["mean_batch_occupancy"] <= 2


def test_torch_percentile_nearest_rank():
    from repro.serve import percentile as rpercentile
    xs = list(range(1, 101))
    assert percentile(xs, 50) == 50
    assert percentile(xs, 95) == 95
    assert percentile(xs, 99) == 99
    assert percentile([7.0], 99) == 7.0
    rng = np.random.default_rng(0)
    for _ in range(20):
        ys = list(rng.standard_normal(int(rng.integers(1, 50))))
        for q in (0, 1, 50, 95, 99, 100):
            assert percentile(ys, q) == rpercentile(ys, q)


# -- threaded multi-tenant soak (the acceptance harness in miniature) --------

@pytest.mark.parametrize("engine", ENGINES)
def test_torch_threaded_tenants_mixed_keys_all_bitexact(engine):
    specs = [_spec(bcs=UNB3, engine=engine), _spec(bcs=PER3, engine=engine)]
    n_tenants, per_tenant = 8, 3
    results = {}
    errors = []

    def tenant(i):
        try:
            rng = np.random.default_rng(100 + i)
            spec = specs[i % 2]
            out = []
            for k in range(per_tenant):
                f = rng.standard_normal((N, N, N))
                r = srv.solve(f, spec, tenant=f"t{i}", timeout=240)
                out.append((f, r))
            results[i] = out
        except Exception as e:  # noqa: BLE001 -- collected for the assert
            errors.append((i, e))

    with PoissonServer(max_batch=4, max_delay_ms=5) as srv:
        threads = [threading.Thread(target=tenant, args=(i,))
                   for i in range(n_tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
        assert not any(t.is_alive() for t in threads)
        stats = srv.server_stats()
    assert not errors, errors
    assert stats["completed"] == n_tenants * per_tenant
    for i, out in results.items():
        for f, r in out:
            np.testing.assert_array_equal(_solve(specs[i % 2], f), r.u)


# -- against the reference ---------------------------------------------------

def _serve_fixed(server_cls, spec, fs, plan_at, plan):
    """7 requests, max_batch=4, a far deadline, then a drain: a full
    flush of 4 and a drain flush of 3 padded to 4 (request ``plan_at``
    fault-armed); returns the responses and both stats views."""
    srv = server_cls(max_batch=4, max_delay_ms=10_000).start()
    futs = [srv.submit(f, spec, tenant=f"t{i % 3}",
                       fault_plan=plan if i == plan_at else None)
            for i, f in enumerate(fs)]
    srv.stop(drain=True)
    return ([f.result(timeout=240) for f in futs], srv.tenant_stats(),
            srv.server_stats())


@pytest.mark.parametrize("ref_engine,engine", [("xla", "torch"),
                                               ("pallas", "cuda")])
def test_torch_server_matches_reference_server(ref_engine, engine):
    """The same traffic through ``repro.serve.PoissonServer`` and the
    port's: the same batches, ranks, flushes and stats keys, responses
    within 1e-10, and the fault-armed drain batch's degradation actions
    equal with the engine rung renamed (``pallas->xla`` is
    ``cuda->torch``)."""
    RU = (RBCType.UNB, RBCType.UNB)
    fs = _rhs(7, seed=40)
    rres, rten, rsrv = _serve_fixed(
        RPoissonServer, RPlanSpec((N, N, N), (RU,) * 3, engine=ref_engine),
        fs, 5, rfaults.FaultPlan([{"kind": "error",
                                   "stage": "solve.dispatch", "count": 1}]))
    pres, pten, psrv = _serve_fixed(
        PoissonServer, _spec(engine=engine), fs, 5,
        faults.FaultPlan([{"kind": "error", "stage": "solve.dispatch",
                           "count": 1}]))
    rename = {"engine:pallas->xla": "engine:cuda->torch"}
    for r, p in zip(rres, pres):
        assert np.abs(np.asarray(r.u) - p.u).max() < 1e-10
        assert (p.batch_size, p.padded_to) == (r.batch_size, r.padded_to)
        assert ([d["action"] for d in p.degradations]
                == [rename.get(d["action"], d["action"])
                    for d in r.degradations])
    assert [p.batch_size for p in pres] == [4] * 4 + [3] * 3
    assert [len(p.degradations) for p in pres] == [0] * 4 + [1] * 3
    assert sorted(pten) == sorted(rten)
    for t in pten:
        assert sorted(pten[t]) == sorted(rten[t])
    assert sorted(psrv) == sorted(rsrv)
    assert sorted(psrv["pool"]) == sorted(rsrv["pool"])
    assert sorted(psrv["solver_cache"]) == sorted(rsrv["solver_cache"])
    for k in ("admitted", "completed", "batches", "full_flushes",
              "drain_flushes", "deadline_flushes", "padded_rhs"):
        assert psrv[k] == rsrv[k], k
    # the pool's estimate at the reference's formula: the float64 Green
    # plus three float64 fields per served rank
    assert psrv["pool"]["total_bytes"] == rsrv["pool"]["total_bytes"]


# -- the reference's serve soak ----------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_torch_serve_soak_flip_armed_tenant_isolated(engine):
    """``tests/test_abft.py``'s serve soak on the single-process solver:
    a flip-armed tenant (``fwd.0``, count 2) runs on a shadow solver, is
    localized (the sandwich, then ``fwd.0``) and repaired bit-exact; the
    clean tenants after it get the baseline bits, no record."""
    spec = _spec(bcs=PER3, engine=engine)
    rng = np.random.default_rng(0)
    fields = [rng.standard_normal((N, N, N)).astype(np.float32)
              for _ in range(4)]
    with PoissonServer(max_batch=4, max_delay_ms=1.0, verify="abft") as srv:
        base = [srv.solve(f, spec, tenant="warm") for f in fields]
        assert all(not r.integrity for r in base)
        plan = faults.FaultPlan([dict(kind="flip", stage="fwd.0", count=2)])
        bad = srv.submit(fields[0], spec, tenant="chaos",
                         fault_plan=plan).result(timeout=120)
        stages = [r["stage"] for r in bad.integrity]
        assert stages[0] == "solve.linearity", bad.integrity
        assert any(s.split("#")[0] == "fwd.0" for s in stages), bad.integrity
        assert len(plan.log) == 2
        np.testing.assert_array_equal(bad.u, base[0].u)
        for t in range(6):
            for i, f in enumerate(fields):
                r = srv.solve(f, spec, tenant=f"t{t}")
                assert not r.integrity, r.integrity
                assert not r.degradations, r.degradations
                np.testing.assert_array_equal(r.u, base[i].u)
    assert not spec.build().stats.get("integrity")


@pytest.fixture(scope="module")
def serve_ranks(tmp_path_factory):
    """``scenario_serve_one`` on one gloo rank (the soak on a (1, 1)
    mesh)."""
    from repro.core.solver import PoissonSolver as RPoissonSolver
    d1 = tmp_path_factory.mktemp("serve_one")
    rng = np.random.default_rng(0)
    fields = np.stack([rng.standard_normal((N, N, N)) for _ in range(4)])
    RP = (RBCType.PER, RBCType.PER)
    ref = RPoissonSolver((N, N, N), 1.0, (RP,) * 3, engine="xla")
    np.save(d1 / "f.npy", fields)
    np.save(d1 / "want.npy", np.stack([np.asarray(ref.solve(f))
                                       for f in fields]))
    return {"one": ranks.launch("serve_one", d1, 1, {"n": N})}


def test_torch_serve_soak_on_a_one_rank_mesh(serve_ranks):
    """The reference's serve soak verbatim (float32, ``comm`` a2a,
    ``verify="abft"``, engine "torch": the distributed sandwich needs its
    autograd) on a one-rank gloo mesh; the baseline within float32
    rounding of the reference's float64 single-process solve."""
    [res] = serve_ranks["one"]
    assert res["base_records"] == 0
    assert res["chaos_stages"][0] == "solve.linearity"
    assert "fwd.0" in [s.split("#")[0] for s in res["chaos_stages"]]
    assert res["chaos_log"] == 2 and res["chaos_bits"]
    assert res["soak"] == {"solves": 24, "bitexact": 24, "records": 0,
                           "degradations": 0}
    assert res["batch_sizes"] == [1]
    assert res["rel_vs_reference"] < 1e-5


# -- PlanSpec and the device -------------------------------------------------

def test_torch_plan_spec_search_default_and_key():
    """``search`` defaults to "guided" and separates keys, as in
    ``tests/test_plansearch.py``; so do the engine and the device."""
    assert PlanSpec.__dataclass_fields__["search"].default == "guided"
    assert PlanSpec.__dataclass_fields__["engine"].default == "cuda"
    assert PlanSpec.__dataclass_fields__["device"].default is None
    spec_g = PlanSpec((8, 8, 8), PER3)
    spec_b = PlanSpec((8, 8, 8), PER3, search="brute")
    assert spec_g.key() != spec_b.key()
    assert spec_g.key() != PlanSpec((8, 8, 8), PER3, device="cpu").key()
    assert spec_g.key() != PlanSpec((8, 8, 8), PER3, engine="torch").key()
    assert spec_g.key() == PlanSpec((8, 8, 8), PER3).key()


def test_torch_default_device_without_a_card_fails_the_future(monkeypatch):
    """A spec with no device means the card: without one its future fails
    with the solver's "no CUDA device" error (no CPU fallback), and the
    server keeps serving other specs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with PoissonServer(max_batch=2, max_delay_ms=1) as srv:
        [f] = _rhs(1, seed=50)
        fut = srv.submit(f, PlanSpec((N, N, N), PER3))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fut.result(timeout=120)
        r = srv.solve(f, _spec(bcs=PER3), timeout=120)
        stats = srv.server_stats()
        tstats = srv.tenant_stats()
    np.testing.assert_array_equal(_solve(_spec(bcs=PER3), f), r.u)
    assert stats["failed"] == 1 and stats["completed"] == 1
    assert tstats["default"]["failed"] == 1


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_torch_launcher_harness_bitexact(engine):
    payload = launcher.run_harness(n=8, tenants=2, requests=2, engine=engine,
                                   device="cpu")
    assert payload["max_abs_dev_vs_individual"] == 0.0
    assert payload["server"]["completed"] == payload["server"]["admitted"]
    assert set(payload["tenants_stats"]) == {"t0", "t1"}
    assert payload["device"] == "cpu"


def test_torch_launcher_main_writes_a_payload(tmp_path, capsys):
    out = tmp_path / "serve.json"
    payload = launcher.main(["--n", "8", "--tenants", "2", "--requests",
                             "2", "--max-batch", "2", "--seq", "--device",
                             "cpu", "--json", str(out)])
    text = capsys.readouterr().out
    assert "max |dev| vs per-request solves: 0.000e+00" in text
    assert "coalescing" in text
    with open(out) as fh:
        back = json.load(fh)
    assert back["max_abs_dev_vs_individual"] == 0.0
    assert back["sequential"]["max_batch"] == 1
    assert back["engine"] == "cuda" == payload["engine"]


def test_torch_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--n", "8", "--tenants", "1", "--requests", "1",
                       "--max-batch", "1"])
