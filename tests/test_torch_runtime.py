"""The port's resilient solve runtime (``repro_torch.runtime``) and plan
cache (``repro_torch.core.solver.get_solver``), on the CPU.

The single-process chaos scenarios of ``tests/test_faults.py`` and the
cache and single-flight tests of ``tests/test_batch.py``, against the
port: the reference's ``pallas.*`` fail points are the port's ``cuda.*``,
and its ``engine:pallas->xla`` rung is ``engine:cuda->torch``.  Where the
reference can run the same scenario, its trail, stats, retry delays and
residuals are compared with the port's; ``fd_residual`` is held to the
reference's within 1e-12.
"""
import json
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import solver as rsolver
from repro.core.bc import BCType
from repro.runtime import faults as rfaults
from repro.runtime import health as rhealth
from repro.runtime import resilience as rresilience
from repro_torch.core import bc as tbc
from repro_torch.core import solver as sv
from repro_torch.core.solver import (PoissonSolver, clear_solver_cache,
                                     evict_solver_instance, get_solver,
                                     set_solver_cache_capacity,
                                     solver_cache_info)
from repro_torch.runtime import SolveError, faults, health, resilience

E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB
BCS = ((E, E), (O, E), (P, P))


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    """A clean plan cache and warn-once state around every test, and no
    fault plan left armed behind it."""
    clear_solver_cache()
    old = solver_cache_info()["capacity"]
    resilience.reset_warn_once()
    yield
    assert not faults._ACTIVE, "a test left a FaultPlan armed"
    set_solver_cache_capacity(old)
    clear_solver_cache()
    resilience.reset_warn_once()


def _pb(bcs):
    return tuple((tbc.BCType(a.value), tbc.BCType(b.value)) for a, b in bcs)


def _port(shape, bcs, **kw):
    kw.setdefault("engine", "torch")
    return PoissonSolver(shape, 1.0, _pb(bcs), device="cpu", **kw)


def _rhs(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _renamed(trail):
    """A reference degradation trail in the port's names."""
    return [a.replace("pallas->xla", "cuda->torch") for a in trail]


# -- fault-plan semantics ----------------------------------------------------

def test_fault_spec_after_count():
    plan = faults.FaultPlan([
        dict(kind="error", stage="stage.a", after=1, count=2)])
    with plan:
        faults.fail_point("stage.a")                 # hit 1: skipped (after)
        for _ in range(2):                           # hits 2-3: fire
            with pytest.raises(faults.InjectedFault):
                faults.fail_point("stage.a")
        faults.fail_point("stage.a")                 # count exhausted
        faults.fail_point("stage.b")                 # wrong stage
    faults.fail_point("stage.a")                     # plan deactivated
    assert [e["hit"] for e in plan.log] == [2, 3]


def test_fault_plan_from_env(monkeypatch, tmp_path):
    spec = [dict(kind="error", stage="x")]
    monkeypatch.setenv("REPRO_FAULTS", json.dumps(spec))
    with faults.plan_from_env():
        with pytest.raises(faults.InjectedFault):
            faults.fail_point("x")
    pf = tmp_path / "plan.json"
    pf.write_text(json.dumps(spec))
    monkeypatch.setenv("REPRO_FAULTS", str(pf))
    with faults.plan_from_env():
        with pytest.raises(faults.InjectedFault):
            faults.fail_point("x")
    monkeypatch.delenv("REPRO_FAULTS")
    assert faults.plan_from_env() is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_taint_and_step_matching(dtype):
    x0 = torch.ones((2, 3), dtype=dtype)
    with faults.FaultPlan([dict(kind="nan", stage="green")]):
        x = faults.taint("green", x0)
        assert not bool(torch.isfinite(x).all())
        assert bool(torch.isfinite(faults.taint("green",
                                                torch.ones(3))).all())
    assert bool(torch.isfinite(x0).all()), "taint wrote the caller's tensor"
    with faults.FaultPlan([dict(kind="flip", stage="s")]):
        y = faults.taint("s", x0)
    assert bool(torch.isfinite(y).all())
    assert (y - x0).abs().max().item() == 9.0        # 8 * max|x| + 1
    with faults.FaultPlan([dict(kind="device_loss", step=3)]) as plan:
        assert not faults.should_fire("device_loss", step=2)
        assert faults.should_fire("device_loss", step=3)
        assert plan.log[0]["step"] == 3


def test_taint_host_suppressed_mangle_and_stall():
    a = np.ones(4)
    with faults.FaultPlan([dict(kind="inf", stage="ckpt.*")]):
        b = faults.taint_host("ckpt.leaf.0", a)
    assert np.isinf(b[0]) and np.isfinite(a).all()
    with faults.FaultPlan([dict(kind="error", stage="*", count=-1)]) as p:
        with faults.suppressed():
            faults.fail_point("x")                   # no-op on this thread
            assert faults.taint("x", torch.ones(2)).isfinite().all()
        with pytest.raises(faults.InjectedFault):
            faults.fail_point("x")
    assert len(p.log) == 1
    data = {"k": {"strategy": "a2a"}}
    with faults.FaultPlan([dict(kind="corrupt_cache")]):
        faults.mangle_cache_entry(data)
    assert data["k"]["strategy"] == "bogus-strategy"
    with faults.FaultPlan([dict(kind="stall", stage="w", seconds=0.05)]):
        t0 = time.perf_counter()
        faults.fail_point("w")                       # wedges, never raises
    assert time.perf_counter() - t0 >= 0.05


def test_plan_token_tracks_the_innermost_armed_plan():
    assert faults.plan_token() is None
    with faults.FaultPlan() as a:
        with faults.FaultPlan() as b:
            assert faults.plan_token() == b._token != a._token
        assert faults.plan_token() == a._token
    assert faults.plan_token() is None


# -- ladder unit behaviour ---------------------------------------------------

def test_ladder_rung_order():
    cfg = {"engine": "cuda", "relayout": "scheduled", "doubling": "deferred"}
    trail = []
    while True:
        step = resilience.next_rung(cfg)
        if step is None:
            break
        cfg, action = step
        trail.append(action)
    assert trail == ["engine:cuda->torch", "relayout:scheduled->baseline",
                     "doubling:deferred->upfront"]
    # the reference's single-process trail, and its distributed one: the
    # comm rungs sit between the engine and the relayout, and a config
    # without a comm knob skips them
    for comm in (None, "overlap", "fused"):
        ref = {"engine": "pallas", "relayout": "scheduled",
               "doubling": "deferred"}
        cfg = {"engine": "cuda", "relayout": "scheduled",
               "doubling": "deferred"}
        if comm:
            ref["comm"] = cfg["comm"] = comm
        ref_trail, port_trail = [], []
        while (step := rresilience.next_rung(ref)) is not None:
            ref, action = step
            ref_trail.append(action)
        while (step := resilience.next_rung(cfg)) is not None:
            cfg, action = step
            port_trail.append(action)
        assert _renamed(ref_trail) == port_trail
        assert (port_trail == trail) == (comm is None)
    cfg = {"engine": "torch", "relayout": "baseline", "doubling": "upfront"}
    assert resilience.next_rung(cfg) is None
    assert resilience.next_rung({"comm": "a2a"}) is None


def test_transient_retry_then_exhaust():
    calls = {"n": 0}
    cfg = {"engine": "torch", "relayout": "baseline", "doubling": "upfront"}

    def attempt():
        calls["n"] += 1
        raise faults.InjectedFault("s", "error", transient=True)

    stats = {"retries": 0, "degradations": []}
    with pytest.raises(SolveError) as ei:
        resilience.run_with_ladder(
            attempt, config=cfg, reconfigure=lambda c: None, stats=stats,
            policy=resilience._RetryPolicy(retries=3, base_delay=0),
            sleep=lambda s: None)
    assert calls["n"] == 4 and stats["retries"] == 3
    assert ei.value.stage == "s" and not ei.value.degradations


def _retry_delays(mod, policy, retries=6):
    """Drive ``mod.run_with_ladder`` (port or reference) with
    always-transient failures and capture the backoff delays it would
    have slept."""
    delays = []
    cfg = {"engine": "torch", "relayout": "baseline", "doubling": "upfront"}

    def attempt():
        raise faults.InjectedFault("s", "error", transient=True)

    with pytest.raises(Exception):
        mod.run_with_ladder(attempt, config=cfg, reconfigure=lambda c: None,
                            stats={"degradations": []}, policy=policy,
                            sleep=delays.append)
    return delays


def test_decorrelated_jitter_spreads_retry_storms():
    mk = lambda **kw: resilience._RetryPolicy(         # noqa: E731
        retries=6, base_delay=0.05, max_delay=1.0, **kw)
    fixed = [0.05, 0.1, 0.2, 0.4, 0.8, 1.0]            # plain doubling
    a = _retry_delays(resilience, mk(seed=1))
    assert a == _retry_delays(resilience, mk(seed=1))
    assert all(0.05 <= d <= 1.0 for d in a)
    assert a != fixed
    others = [_retry_delays(resilience, mk(seed=s)) for s in range(2, 8)]
    assert all(o != a for o in others)
    step1 = {round(d[1], 9) for d in [a] + others}
    assert len(step1) >= 5, f"retry storm not decorrelated: {step1}"
    # the same schedule as the reference for the same seed
    ref = _retry_delays(rresilience, rresilience.RetryPolicy(
        retries=6, base_delay=0.05, max_delay=1.0, seed=1))
    assert a == ref


def test_default_retry_budget_matches_reference():
    """A transient fault that never clears: the default policy's two
    retries, then the single-process rungs, as in the reference."""
    spec = dict(kind="error", stage="solve.dispatch", count=-1,
                transient=True)
    s = _port((8, 8, 8), BCS)
    f = _rhs(s.input_shape)
    with faults.FaultPlan([spec]):
        with pytest.raises(SolveError) as ei:
            s.solve(f)
    ref_e, rstats = _ref_scenario(spec, "xla", shape=(8, 8, 8), f=f)
    assert s.stats["retries"] == rstats["retries"] == 2
    assert [d["action"] for d in ei.value.degradations] == \
        [d["action"] for d in ref_e.degradations]


def test_is_transient_markers():
    assert resilience.is_transient(RuntimeError("UNAVAILABLE: link down"))
    assert not resilience.is_transient(RuntimeError("bad shape"))
    e = RuntimeError("UNAVAILABLE")
    e.transient = False
    assert not resilience.is_transient(e)


# -- solver-level recovery (single process) ----------------------------------

def _ref_scenario(spec, engine, verify=None, shape=(12, 12, 12), bcs=BCS,
                  f=None):
    """The reference's solver under the same armed spec: (output, stats)."""
    rfaults_plan = rfaults.FaultPlan([spec])
    s = rsolver.PoissonSolver(shape, 1.0, bcs, engine=engine,
                              verify=verify)
    f = _rhs(s.input_shape) if f is None else f
    with rfaults_plan:
        try:
            u = np.asarray(s.solve(f))
        except rresilience.SolveError as e:
            return e, s.stats
    return u, s.stats


def test_nan_injection_recovers_bit_exact():
    s0 = _port((12, 12, 12), BCS)
    f = _rhs(s0.input_shape)
    want = s0.solve(f)
    s = _port((12, 12, 12), BCS, verify="nan")
    spec = dict(kind="nan", stage="green")
    with faults.FaultPlan([spec]) as plan:
        got = s.solve(f)
    assert plan.log, "fault never fired"
    assert s.stats["verify_failures"] == 1
    assert len(s.stats["degradations"]) == 1
    assert s.stats["degradations"][0]["stage"].startswith("verify.nan@")
    assert torch.equal(got, want)
    _, rstats = _ref_scenario(spec, "xla", verify="nan", f=f)
    assert [(d["stage"], d["action"]) for d in s.stats["degradations"]] == \
        [(d["stage"], d["action"]) for d in rstats["degradations"]]
    assert s.stats["verify_failures"] == rstats["verify_failures"]


def test_cuda_build_failure_degrades_to_torch():
    st = _port((12, 12, 12), BCS)
    f = _rhs(st.input_shape)
    want = st.solve(f)
    sc = _port((12, 12, 12), BCS, engine="cuda")
    with faults.FaultPlan([dict(kind="pallas_lowering", stage="cuda.*",
                                count=-1)]) as plan:
        got = sc.solve(f)
    acts = [d["action"] for d in sc.stats["degradations"]]
    assert acts == ["engine:cuda->torch"]
    assert sc._cfg["engine"] == "torch"
    assert torch.equal(got, want)
    assert plan.log[0]["stage"].startswith("cuda.fwd.")
    _, rstats = _ref_scenario(dict(kind="pallas_lowering", stage="pallas.*",
                                   count=-1), "pallas", f=f)
    assert _renamed([d["action"] for d in rstats["degradations"]]) == acts


@pytest.mark.parametrize("stage", ["cuda.fwd.*", "cuda.bwd.*", "cuda.green"])
def test_cuda_fail_points_sit_on_the_cuda_engine_only(stage):
    """Every cuda.* fail point fires on the cuda engine (fused and unfused
    Green multiply alike) and never on the torch engine."""
    for bcs, layout in ((BCS, "CELL"), (((U, U),) * 3, "NODE")):
        kw = dict(layout=tbc.DataLayout[layout])
        spec = [dict(kind="error", stage=stage, count=-1)]
        st = _port((8, 8, 8), bcs, **kw)
        with faults.FaultPlan(spec) as plan:
            st.solve(_rhs(st.input_shape))
        assert not plan.log
        sc = _port((8, 8, 8), bcs, engine="cuda", **kw)
        with faults.FaultPlan(spec) as plan:
            sc.solve(_rhs(sc.input_shape))
        assert plan.log and [d["action"] for d in
                             sc.stats["degradations"]] == \
            ["engine:cuda->torch"]


def test_residual_verify_passes_healthy_and_catches_corruption():
    n = 16
    h = 1.0 / n
    pts = (np.arange(n) + 0.5) * h
    x, y, z = np.meshgrid(pts, pts, pts, indexing="ij")
    sol = np.sin(2 * np.pi * x) * np.sin(4 * np.pi * y) * \
        np.cos(2 * np.pi * z)
    rhs = (-(4 + 16 + 4) * np.pi ** 2 * sol).astype(np.float64)
    s = _port((n, n, n), ((P, P),) * 3, verify="residual")
    s.solve(rhs)
    assert s.stats["last_residual"] < 0.05
    ref = rsolver.PoissonSolver((n, n, n), 1.0, ((P, P),) * 3,
                                verify="residual")
    ref.solve(rhs)
    assert abs(s.stats["last_residual"] - ref.stats["last_residual"]) < \
        1e-12 * ref.stats["last_residual"]
    want = _port((n, n, n), ((P, P),) * 3).solve(rhs)
    with faults.FaultPlan([dict(kind="inf", stage="green")]):
        got = s.solve(rhs)
    assert s.stats["verify_failures"] == 1
    assert torch.equal(got, want)


def test_inf_at_green_on_the_cuda_engine_walks_one_rung():
    """The chip smoke's fault phase at a CPU size: the fused FFT x Green
    path taints its input, the guard trips, one rung to torch."""
    n = 16
    s = _port((n, n, n), ((P, P),) * 3, engine="cuda", verify="residual")
    f = _rhs(s.input_shape, dtype=np.float64)
    clean = _port((n, n, n), ((P, P),) * 3, engine="cuda").solve(f)
    with faults.FaultPlan([dict(kind="inf", stage="green")]) as plan:
        got = s.solve(f)
    assert len(plan.log) == 1
    assert [d["action"] for d in s.stats["degradations"]] == \
        ["engine:cuda->torch"]
    assert s.stats["verify_failures"] == 1
    assert (got - clean).abs().max() < 1e-12 * clean.abs().max()


def test_hard_fault_raises_structured_solve_error():
    spec = dict(kind="error", stage="solve.dispatch", count=-1)
    s = _port((8, 8, 8), BCS)
    f = _rhs(s.input_shape)
    with faults.FaultPlan([spec]):
        with pytest.raises(SolveError) as ei:
            s.solve(f)
    e = ei.value
    assert e.stage == "solve.dispatch"
    assert [d["action"] for d in e.degradations] == \
        ["relayout:scheduled->baseline", "doubling:deferred->upfront"]
    assert e.config["doubling"] == "upfront"
    ref_e, _ = _ref_scenario(spec, "xla", shape=(8, 8, 8), f=f)
    assert [d["action"] for d in ref_e.degradations] == \
        [d["action"] for d in e.degradations]
    # on the cuda engine the kernels go first
    sc = _port((8, 8, 8), BCS, engine="cuda")
    with faults.FaultPlan([spec]):
        with pytest.raises(SolveError) as ei:
            sc.solve(f)
    assert [d["action"] for d in ei.value.degradations] == \
        ["engine:cuda->torch", "relayout:scheduled->baseline",
         "doubling:deferred->upfront"]


def test_transient_fault_retries_without_degrading(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    s = _port((8, 8, 8), BCS, engine="cuda")
    f = _rhs(s.input_shape)
    want = _port((8, 8, 8), BCS, engine="cuda").solve(f)
    with faults.FaultPlan([dict(kind="error", stage="solve.dispatch",
                                transient=True)]):
        with pytest.warns(RuntimeWarning, match="transient"):
            got = s.solve(f)
    assert s.stats["retries"] == 1 and s.stats["degradations"] == []
    assert s._cfg["engine"] == "cuda"
    assert torch.equal(got, want)


PPP = ((P, P),) * 3


def _broken_kernel(monkeypatch, how):
    """Make the fused FFT x Green kernel of the cuda engine really fail:
    raise like a launch error, or return non-finite values.  No fault
    plan is armed, so nothing of it is injected."""
    from repro_torch.kernels import ops
    orig = ops.fft_stockham_scale

    def broken(*a, **kw):
        if how == "raise":
            raise RuntimeError("fft_stockham_scale: launch failed")
        out = orig(*a, **kw).clone()
        out.view(-1)[0] = float("nan")
        return out

    monkeypatch.setattr(ops, "fft_stockham_scale", broken)


@pytest.mark.parametrize("how", ["raise", "nan"])
def test_real_kernel_failure_raises_instead_of_degrading(monkeypatch, how):
    """A kernel that really fails never gives way to torch.fft: the solve
    raises SolveError, takes no rung and stays on the cuda engine."""
    s = _port((8, 8, 8), PPP, engine="cuda", verify="nan")
    f = _rhs(s.input_shape)
    _broken_kernel(monkeypatch, how)
    with pytest.raises(SolveError, match="engine:cuda->torch refused") as ei:
        s.solve(f)
    assert ei.value.degradations == [] and s.stats["degradations"] == []
    assert s._cfg["engine"] == "cuda" and ei.value.config["engine"] == "cuda"
    if how == "nan":
        assert ei.value.stage.startswith("verify.nan@")
        assert s.stats["verify_failures"] == 1


def test_injected_fault_beside_a_broken_kernel_still_degrades(monkeypatch):
    """The same broken kernel under an armed cuda.* fault: the injected
    fault fires first, so the engine rung is taken as in the reference."""
    s = _port((8, 8, 8), PPP, engine="cuda")
    f = _rhs(s.input_shape)
    _broken_kernel(monkeypatch, "raise")
    with faults.FaultPlan([dict(kind="pallas_lowering", stage="cuda.*",
                                count=-1)]):
        got = s.solve(f)
    assert [d["action"] for d in s.stats["degradations"]] == \
        ["engine:cuda->torch"]
    assert torch.equal(got, _port((8, 8, 8), PPP).solve(f))


def test_real_failure_on_the_torch_engine_walks_the_other_rungs(monkeypatch):
    """Only the engine rung is held back: a real failure of the scheduled
    pipeline on the torch engine steps down to the baseline one."""
    s = _port((8, 8, 8), PPP)
    f = _rhs(s.input_shape)
    want = s.solve(f)

    def broken(self, f):
        raise RuntimeError("relayout failed")

    monkeypatch.setattr(PoissonSolver, "_solve_scheduled", broken)
    with pytest.warns(RuntimeWarning, match="relayout:scheduled->baseline"):
        got = s.solve(f)
    assert [d["action"] for d in s.stats["degradations"]] == \
        ["relayout:scheduled->baseline"]
    assert torch.equal(got, want)


def test_degradation_warns_once_until_reset():
    spec = [dict(kind="pallas_lowering", stage="cuda.*", count=-1)]
    f = _rhs((8, 8, 8))
    for expect_warning in (True, False):
        s = _port((8, 8, 8), BCS, engine="cuda")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with faults.FaultPlan(spec):
                s.solve(f)
        assert bool([x for x in w if "degrading" in str(x.message)]) == \
            expect_warning
    clear_solver_cache()                       # THE runtime reset hook
    with pytest.warns(RuntimeWarning, match="degrading engine:cuda->torch"):
        with faults.FaultPlan(spec):
            _port((8, 8, 8), BCS, engine="cuda").solve(f)


def test_abft_modes_raise_until_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        _port((8, 8, 8), BCS, verify="abft")
    s = _port((8, 8, 8), BCS)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        s.solve(_rhs(s.input_shape), verify="abft-stages")
    with pytest.raises(ValueError):
        _port((8, 8, 8), BCS, verify="bogus")
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        _port((8, 8, 8), BCS, abft_rtol=1e-3)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        get_solver((8, 8, 8), 1.0, _pb(BCS), device="cpu", abft_rtol=1e-3)


def test_stats_count_solves():
    s = _port((8, 8, 8), BCS, verify="nan")
    f = _rhs(s.input_shape)
    s.solve(f)
    s.solve(f, verify="residual")
    assert s.stats["solves"] == 2 and s.stats["degradations"] == []
    assert "last_residual" in s.stats


# -- health guards -----------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("bcs,layout", [(BCS, "CELL"),
                                        (((U, U),) * 3, "NODE")])
def test_fd_residual_matches_reference(bcs, layout, batch):
    from repro.core.bc import DataLayout
    ref = rsolver.make_plan((8, 10, 12), (1.0, 1.5, 0.8), bcs,
                            DataLayout[layout])
    plan = sv.make_plan((8, 10, 12), (1.0, 1.5, 0.8), _pb(bcs),
                        tbc.DataLayout[layout])
    shape = ((batch,) if batch else ()) + plan.input_shape
    u, f = _rhs(shape, 1, np.float64), _rhs(shape, 2, np.float64)
    want = rhealth.fd_residual(jnp.asarray(u), jnp.asarray(f), ref)
    got = health.fd_residual(torch.from_numpy(u), torch.from_numpy(f), plan)
    assert abs(got - want) <= 1e-12 * want


@pytest.mark.parametrize("stage", ["fwd.0", "fwd.2", "green", "bwd.1"])
def test_locate_nonfinite_stage_matches_reference(stage):
    bcs = ((U, U), (P, P), (E, O))
    s = _port((8, 8, 8), bcs)
    ref = rsolver.PoissonSolver((8, 8, 8), 1.0, bcs)
    f = _rhs(s.input_shape, dtype=np.float64)
    spec = [dict(kind="nan", stage=stage, count=-1)]
    with faults.FaultPlan(spec):
        got = health.locate_nonfinite_stage(s.plan, s.schedule,
                                            torch.from_numpy(f),
                                            s._green_nat)
    with rfaults.FaultPlan(spec):
        want = rhealth.locate_nonfinite_stage(ref.plan, ref.schedule,
                                              jnp.asarray(f),
                                              ref._green_nat)
    assert got == want == stage
    assert health.locate_nonfinite_stage(
        s.plan, s.schedule, torch.from_numpy(f), s._green_nat) == "output"
    bad = f.copy()
    bad[0, 0, 0] = np.nan
    assert health.locate_nonfinite_stage(
        s.plan, s.schedule, torch.from_numpy(bad), s._green_nat) == "input"


def test_check_solution_raises_health_error():
    plan = sv.make_plan((8, 8, 8), 1.0, _pb(BCS))
    u = torch.zeros(plan.input_shape, dtype=torch.float64)
    stats = {}
    u[1, 1, 1] = float("inf")
    with pytest.raises(health.HealthError) as ei:
        health.check_solution(u, torch.ones_like(u), plan, stats=stats,
                              locate=lambda: "green")
    assert ei.value.stage == "verify.nan@green"
    assert stats["verify_failures"] == 1
    with pytest.raises(health.HealthError, match="FD residual"):
        health.check_solution(torch.zeros_like(u), torch.ones_like(u), plan,
                              mode="residual", stats=stats)
    assert stats["verify_failures"] == 2
    with pytest.raises(health.HealthError):
        health.check_finite("fwd.0", u)


# -- the plan cache (tests/test_batch.py) ------------------------------------

def _get(shape, bcs=((E, E),) * 3, L=1.0, **kw):
    return get_solver(shape, L, _pb(bcs), device="cpu", **kw)


def test_fault_token_isolates_get_solver_cache():
    s_clean = _get((8, 8, 8), BCS)
    with faults.FaultPlan([dict(kind="nan", stage="green")]):
        s_armed = _get((8, 8, 8), BCS)
    assert s_armed is not s_clean
    assert _get((8, 8, 8), BCS) is s_clean


def test_plan_cache_hit_returns_same_instance():
    s1 = _get((8, 8, 8))
    s2 = _get((8, 8, 8))
    assert s1 is s2
    info = solver_cache_info()
    assert info["hits"] == 1 and info["misses"] == 1 and info["size"] == 1


def test_plan_cache_distinct_keys_miss():
    from repro_torch.core.bc import DataLayout
    from repro_torch.core.green import GreenKind
    s0 = _get((8, 8, 8))
    variants = [
        _get((8, 8, 9)),
        _get((8, 8, 8), L=2.0),
        _get((8, 8, 8), bcs=((O, O), (E, E), (E, E))),
        _get((8, 8, 8), layout=DataLayout.NODE),
        _get((8, 8, 8), green_kind=GreenKind.HEJ2),
        _get((8, 8, 8), eps_factor=3.0),
        _get((8, 8, 8), engine="torch"),
        _get((8, 8, 8), verify="nan"),
    ]
    assert all(v is not s0 for v in variants)
    assert len({id(v) for v in variants}) == len(variants)
    assert solver_cache_info()["misses"] == 1 + len(variants)
    assert solver_cache_info()["hits"] == 0


def test_plan_cache_lru_eviction():
    set_solver_cache_capacity(2)
    s_a = _get((8, 8, 8))
    s_b = _get((8, 8, 9))
    assert _get((8, 8, 8)) is s_a                 # B is now the LRU
    s_c = _get((8, 8, 10))                        # evicts B
    info = solver_cache_info()
    assert info["size"] == 2 and info["evictions"] == 1
    assert _get((8, 8, 8)) is s_a
    assert _get((8, 8, 10)) is s_c
    assert _get((8, 8, 9)) is not s_b


def test_plan_cache_capacity_shrink_evicts():
    set_solver_cache_capacity(4)
    for k in range(4):
        _get((8, 8, 8 + k))
    assert solver_cache_info()["size"] == 4
    set_solver_cache_capacity(1)
    info = solver_cache_info()
    assert info["size"] == 1 and info["evictions"] == 3
    assert solver_cache_info()["hits"] == 0
    _get((8, 8, 11))
    assert solver_cache_info()["hits"] == 1
    with pytest.raises(ValueError):
        set_solver_cache_capacity(0)


def test_plan_cache_solver_still_correct():
    s_cached = _get((8, 8, 8), BCS)
    s_cached2 = _get((8, 8, 8), BCS)
    fresh = _port((8, 8, 8), BCS, engine="cuda")
    f = _rhs(fresh.input_shape, 3, np.float64)
    assert torch.equal(s_cached2.solve(f), fresh.solve(f))
    assert s_cached is s_cached2


def test_evict_instance_and_entries():
    s = _get((8, 8, 8))
    t = _get((8, 8, 9))
    assert evict_solver_instance(s) == 1
    assert _get((8, 8, 8)) is not s
    assert _get((8, 8, 9)) is t
    assert evict_solver_instance(object()) == 0
    assert solver_cache_info()["size"] == 2
    assert evict_solver_instance(t) == 1
    assert solver_cache_info()["size"] == 1
    # mesh eviction drops only distributed entries planned on that mesh
    assert sv.evict_solver_entries(object()) == 0
    assert solver_cache_info()["size"] == 1


def test_get_solver_refuses_a_mesh_and_unknown_kwargs():
    # a mesh builds the distributed solver, which takes only a DeviceMesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        get_solver((8, 8, 8), 1.0, _pb(BCS), device="cpu", mesh=object())
    with pytest.raises(TypeError):
        get_solver((8, 8, 8), 1.0, _pb(BCS), device="cpu", comm="a2a")


def test_get_solver_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_solver((8, 8, 8), 1.0, _pb(BCS))
    assert solver_cache_info()["misses"] == 0


def test_single_flight_one_construction_per_key(monkeypatch):
    """16 threads missing the same key concurrently construct the solver
    exactly once; the others park on the builder and get the same
    instance."""
    built = []
    gate = threading.Barrier(16, timeout=60)
    real = sv.PoissonSolver

    class Counting(real):
        def __init__(self, *a, **kw):
            built.append(threading.get_ident())
            time.sleep(0.05)                 # widen the in-flight window
            super().__init__(*a, **kw)

    monkeypatch.setattr(sv, "PoissonSolver", Counting)
    out, errors = [], []

    def worker():
        try:
            gate.wait()
            out.append(_get((8, 8, 8), BCS))
        except Exception as e:  # noqa: BLE001 -- surfaced by the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(built) == 1, f"{len(built)} constructions for one key"
    assert len(out) == 16 and all(s is out[0] for s in out)
    info = solver_cache_info()
    assert info["misses"] == 1
    assert info["coalesced"] + info["hits"] == 15


def test_single_flight_failed_build_reraises_everywhere(monkeypatch):
    calls = []
    real = sv.PoissonSolver

    class Flaky(real):
        def __init__(self, *a, **kw):
            calls.append(1)
            if len(calls) == 1:
                time.sleep(0.05)
                raise RuntimeError("flaky plan-time failure")
            super().__init__(*a, **kw)

    monkeypatch.setattr(sv, "PoissonSolver", Flaky)
    gate = threading.Barrier(4, timeout=60)
    failures = []

    def worker():
        gate.wait()
        try:
            _get((8, 8, 8))
        except RuntimeError:
            failures.append(1)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert failures, "no thread observed the injected build failure"
    assert solver_cache_info()["build_failures"] == 1
    s = _get((8, 8, 8))                      # clean retry after the failure
    assert s is _get((8, 8, 8))
