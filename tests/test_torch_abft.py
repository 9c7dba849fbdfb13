"""The port's algorithm-based fault tolerance == the reference's.

``repro_torch.runtime.abft`` and the ABFT modes of the port's solvers
against ``repro.runtime.abft`` on the same numpy inputs: the invariant
arithmetic (probes bit-equal, tolerances, mismatches, wire checksums,
report verification, the Parseval weights of every direction), the
checked pipeline's report names, the sandwich weight ``w = S^T r``, and
the single-process chaos cases of ``tests/test_abft.py`` -- each case's
integrity records (stage, kind, action) equal to the reference's on the
same case, its output within 1e-10 in float64.  The port runs the
``"torch"`` engine, the reference ``engine="xla"`` (x64, as
``tests/conftest.py`` sets it).

The distributed cases run on 8 gloo CPU ranks (``tests/test_torch_
ranks.py``): the assertions of ``tests/test_abft.py``'s distributed SDC
script one by one on mesh (2, 4), the checksum sidecar's names and census
on the one-rank-axis meshes (1, 8) and (8, 1), the distributed ``w``
against the reference's single-process adjoint, the ``"cuda"`` engine's
checked branch, and the pod batch's report rows.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import test_torch_ranks as ranks
from repro.core.bc import BCType, DataLayout
from repro.core import solver as rsolver
from repro.runtime import abft as rabft
from repro.runtime import faults as rfaults
from repro.runtime.resilience import SolveError as RSolveError
from repro_torch.core import bc as tbc
from repro_torch.core import solver as tsolver
from repro_torch.core.engine import build_schedule, fwd_1d
from repro_torch.core.solver import (PoissonSolver, clear_solver_cache,
                                     get_solver)
from repro_torch.runtime import SolveError, abft, faults, resilience

E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB
BCS = ((E, E), (O, E), (P, P))


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    clear_solver_cache()
    resilience.reset_warn_once()
    yield
    assert not faults._ACTIVE, "a test left a FaultPlan armed"
    clear_solver_cache()
    resilience.reset_warn_once()


def _pb(bcs):
    return tuple((tbc.BCType(a.value), tbc.BCType(b.value)) for a, b in bcs)


def _rhs(shape, seed=0, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _ref(shape, bcs=BCS, **kw):
    return rsolver.PoissonSolver(shape, 1.0, bcs, engine="xla", **kw)


def _port(shape, bcs=BCS, **kw):
    kw.setdefault("engine", "torch")
    return PoissonSolver(shape, 1.0, _pb(bcs), device="cpu", **kw)


def _records(stats):
    return [(r["stage"], r["kind"], r["action"])
            for r in stats.get("integrity", [])]


# -- invariant arithmetic ----------------------------------------------------

@pytest.mark.parametrize("shape", [(12, 12, 12), (2, 16, 8, 12), (5,)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lite_probes_bit_equal(shape, dtype):
    assert np.array_equal(abft.lite_probe(shape, dtype),
                          rabft.lite_probe(shape, dtype))
    assert abft.lite_probe(shape, dtype).dtype == dtype
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    assert np.array_equal(abft.lite_probe(shape, tdt),
                          rabft.lite_probe(shape, dtype))
    for a, b in zip(abft.lite_probe_axes(shape, dtype),
                    rabft.lite_probe_axes(shape, dtype)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tol_for_equal():
    for dt in (np.float32, np.float64, np.complex64, np.complex128):
        assert abft.tol_for(dt) == rabft.tol_for(dt)
    assert abft.tol_for(torch.float32) == rabft.tol_for(np.float32)
    assert abft.tol_for(torch.float64) == rabft.tol_for(np.float64)
    assert abft.DEFAULT_RETRIES == rabft.DEFAULT_RETRIES
    assert abft.LITE_HEADROOM == rabft.LITE_HEADROOM


LITE_TRIPLES = [(1.0, 1.0, 1.0), (1.0, 1.1, 0.0), (1e-9, 2e-9, 1.0),
                (np.nan, 1.0, 1.0), (1.0, 1.0, np.inf),
                [[1.0, 1.0, 1.0], [2.0, 3.0, 4.0]], (0.0, 0.0, 0.0)]


@pytest.mark.parametrize("triple", LITE_TRIPLES)
def test_lite_mismatch_equal(triple):
    assert abft.lite_mismatch(triple) == rabft.lite_mismatch(triple)


LITE_AB = [(1.0, 1.0, 0.0), (1.0, 1.1, 0.0), (1e-9, 2e-9, 1.0),
           (np.nan, 1.0, 0.0), ([1.0, np.inf], [1.0, 1.0], 0.0),
           ([1.0, 2.0], [1.0, 3.0], 0.0), ([1.0, 2.0], [1.5, 2.0],
                                           [0.5, 4.0])]


@pytest.mark.parametrize("a,b,floor", LITE_AB)
def test_lite_mismatch_ab_equal(a, b, floor):
    assert abft.lite_mismatch_ab(a, b, floor) == \
        rabft.lite_mismatch_ab(a, b, floor)


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("split", [0, 1, 2])
def test_wire_checksums_and_verify_agree(split, complex_):
    rng = np.random.default_rng(3 + split)
    x = rng.standard_normal((8, 12, 4))
    if complex_:
        x = x + 1j * rng.standard_normal(x.shape)
    parts = 4 if split != 2 else 2
    got = abft.wire_checksums(torch.from_numpy(x), split, parts).numpy()
    want = np.asarray(rabft.wire_checksums(jnp.asarray(x), split, parts))
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))
    bad = x.copy()
    bad[5, 3, 1] += 8.0 * np.abs(x).max()
    for y in (x, bad):
        for concat in range(3):
            if y.shape[concat] % parts:
                continue
            col, rcol = abft.Collector(), rabft.Collector()
            out = abft.wire_verify(torch.from_numpy(y),
                                   torch.from_numpy(want), concat, parts,
                                   col, "wire.t", 1e-6)
            assert out.shape == y.shape
            rabft.wire_verify(jnp.asarray(y), jnp.asarray(want), concat,
                              parts, rcol, "wire.t", 1e-6)
            m, rm = float(col.stacked()[0]), float(rcol.stacked()[0])
            assert col.names == rcol.names
            assert abs(m - rm) <= 1e-6 * max(rm, 1e-6), (m, rm)


REPORTS = [
    (["fwd.0", "fwd.0.post"], [1.0, 0.0]),
    (["green", "green.post"], [1.0, 1.0]),
    (["wire.comm.a2a"], [1.0]),
    (["wire.comm.a2a", "green", "green.post"], [1.0, 1.0, 1.0]),
    (["fwd.1", "fwd.1.post", "fwd.1.energy"], [0.0, 0.0, 1e-3]),
    (["fwd.1", "fwd.1.post", "fwd.1.energy"], [0.0, 0.0, 1e-9]),
    (["bwd.2", "bwd.2.post", "wire.data"], [np.nan, 0.0, 0.0]),
    (["fwd.0", "fwd.0.post", "wire.model"],
     [[0.0, 0.0, 0.0], [5.0, 0.0, 1e-12]]),
    (["bwd.0"], [np.inf]),
]


@pytest.mark.parametrize("names,report", REPORTS)
def test_verify_report_equal(names, report):
    tol = 1e-8
    stats, rstats = {}, {}
    err = rerr = None
    try:
        got = abft.verify_report(names, np.asarray(report), tol=tol,
                                 stats=stats)
    except abft.IntegrityError as e:
        err = e
    try:
        want = rabft.verify_report(names, np.asarray(report), tol=tol,
                                   stats=rstats)
    except rabft.IntegrityError as e:
        rerr = e
    assert (err is None) == (rerr is None)
    if err is None:
        assert _clean_nan(got) == _clean_nan(want)
    else:
        assert (err.stage, err.transient, str(err)) == \
            (rerr.stage, rerr.transient, str(rerr))
    assert _clean_nan(stats) == _clean_nan(rstats)
    # a report tensor is read like its numpy copy
    stats2 = {}
    try:
        abft.verify_report(names, torch.tensor(report, dtype=torch.float64),
                           tol=tol, stats=stats2)
    except abft.IntegrityError:
        pass
    assert _clean_nan(stats2) == _clean_nan(stats)


def _clean_nan(v):
    """``v`` with every float NaN replaced by a marker (NaN != NaN)."""
    if isinstance(v, dict):
        return {k: _clean_nan(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_clean_nan(x) for x in v]
    if isinstance(v, float) and np.isnan(v):
        return "nan"
    return v


def _pairs():
    out = [(P, P)]
    for a in (E, O, U):
        for b in (E, O, U):
            out.append((a, b))
    return out


@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
def test_parseval_weights_equal_every_direction(layout, doubling):
    """Every direction of every BC pair (and the three pairs of a mixed
    plan) on both layouts and doublings."""
    checked = 0
    for pair in _pairs():
        bcs = (pair, (P, P), (U, U))
        try:
            rp = rsolver.make_plan((8, 8, 8), 1.0, bcs,
                                   DataLayout[layout], doubling=doubling)
        except Exception as e:  # noqa: BLE001 -- the port must refuse alike
            with pytest.raises(type(e)):
                tsolver.make_plan((8, 8, 8), 1.0, _pb(bcs),
                                  tbc.DataLayout[layout], doubling=doubling)
            continue
        tp = tsolver.make_plan((8, 8, 8), 1.0, _pb(bcs),
                               tbc.DataLayout[layout], doubling=doubling)
        for rd, td in zip(rp.dirs, tp.dirs):
            want = rabft._parseval_weights(rd)
            got = abft._parseval_weights(td)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if w is None or np.isscalar(w):
                    assert g == w
                else:
                    assert np.array_equal(g, w)
            checked += 1
    assert checked >= 30


# -- the stage API carries the collector -------------------------------------

def test_stage_api_threads_the_checker():
    """Each stage method of ``TransformSchedule`` takes ``col, tol``: with
    a collector it runs the checked stage (its names in the report, its
    output the plain stage's bits); with ``col=None`` it is the plain
    stage."""
    s = _port((12, 12, 12))
    sched = build_schedule(s.plan, s.engine)
    x = torch.from_numpy(_rhs(s.input_shape))
    tol = abft.tol_for(torch.float64)
    d0 = s.plan.order[0]
    p0 = s.plan.dirs[d0]
    col = abft.Collector()
    y = sched.fwd_chunk(x, d0, col, tol)
    assert torch.equal(y, sched.fwd_chunk(x, d0))
    assert torch.equal(y, fwd_1d(x, p0, sched))
    x_last = torch.movedim(x, d0, -1).contiguous()
    y_last = sched.fwd_last(x_last, d0, col, tol)
    assert torch.equal(y_last, sched.fwd_last(x_last, d0))
    assert torch.equal(sched.bwd_last(y_last, d0, col, tol),
                       sched.bwd_last(y_last, d0))
    assert torch.equal(sched.bwd_chunk(y, d0, col, tol),
                       sched.bwd_chunk(y, d0))
    g = torch.rand(tuple(y_last.shape), dtype=torch.float64)
    assert torch.equal(sched.green_multiply(y_last, g, col, tol),
                       sched.green_multiply(y_last, g))
    green_last = sched.fwd_last_green(x_last, d0, g, col, tol)
    assert torch.equal(green_last, sched.fwd_last_green(x_last, d0, g))
    n = f"fwd.{p0.dim}"
    b = f"bwd.{p0.dim}"
    assert col.names == [
        n, n + ".post", n + ".energy",
        n + "#1", n + "#1.post", n + "#1.energy",
        b, b + ".post", b + "#1", b + "#1.post",
        "green", "green.post",
        n + "#2", n + "#2.post", n + "#2.energy", "green#1",
        "green#1.post"]
    assert float(col.stacked().max()) < tol
    assert abft.Collector().stacked().tolist() == [0.0]


def test_abft_rtol_takes_the_reference_default():
    s = _port((8, 8, 8), abft_rtol=0.0)
    assert s.abft_rtol == 0.0 and s._abft_tol(torch.float32) == 3e-4
    assert _port((8, 8, 8), abft_rtol=1e-5)._abft_tol(torch.float32) == 1e-5
    assert get_solver((8, 8, 8), 1.0, _pb(BCS), device="cpu",
                      abft_rtol=0.0).abft_rtol == 0.0


# -- names and the sandwich weight -------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("relayout", ["scheduled", "baseline"])
def test_checked_report_names_equal_reference(relayout, layout, batched):
    rs = _ref((12, 12, 12), layout=DataLayout[layout], relayout=relayout)
    ps = _port((12, 12, 12), layout=tbc.DataLayout[layout],
               relayout=relayout)
    shape = ((2,) if batched else ()) + rs.input_shape
    f = _rhs(shape, seed=4)
    fn, holder = rs._abft_jitted()
    ru, rrep = fn(jnp.asarray(f))
    u, rep, names = ps._checked_dispatch(torch.from_numpy(f))
    assert names == list(holder)
    assert tuple(rep.shape) == tuple(np.asarray(rrep).shape)
    assert float(np.max(np.abs(u.numpy() - np.asarray(ru)))) < 1e-10


@pytest.mark.parametrize("case", [
    dict(bcs=BCS, shape=(12, 12, 12)),
    dict(bcs=BCS, shape=(2, 12, 12, 12)),
    dict(bcs=((U, U), (P, P), (U, U)), shape=(8, 8, 8)),
    dict(bcs=((U, E), (U, U), (O, U)), shape=(8, 8, 8), layout="NODE"),
], ids=["EOP", "EOP-batched", "UPU", "semi-NODE"])
def test_sandwich_weight_equals_reference(case):
    layout = case.get("layout", "CELL")
    grid = case["shape"][-3:]
    rs = _ref(grid, case["bcs"], layout=DataLayout[layout])
    ps = _port(grid, case["bcs"], layout=tbc.DataLayout[layout])
    shape = tuple(case["shape"])
    if layout == "NODE":
        shape = shape[:-3] + rs.input_shape
    want = np.asarray(rs._lite_pair(shape, np.float64)[1])
    r, w = ps._lite_pair(shape, torch.float64)
    assert np.array_equal(r.numpy(), rabft.lite_probe(shape, np.float64))
    err = float(np.max(np.abs(w.numpy() - want)))
    assert err <= 1e-10 * float(np.max(np.abs(want))), err


# -- the single-process chaos cases of tests/test_abft.py ---------------------

STAGES = ["fwd.0", "fwd.1", "fwd.2", "green", "bwd.0", "bwd.1", "bwd.2"]
MATRIX = ([dict(stage=st, relayout=rl)
           for st in STAGES for rl in ("scheduled", "baseline")]
          + [dict(stage=st, layout="NODE")
             for st in ("fwd.0", "green", "bwd.2")]
          + [dict(stage=st, batched=True)
             for st in ("fwd.1", "green", "bwd.0")])


def _case_id(c):
    return "-".join(str(v) if not isinstance(v, bool) else k
                    for k, v in c.items())


def _trial(solver, f, verify, spec, plan_cls):
    with plan_cls([spec]) as plan:
        got = solver.solve(f, verify=verify)
    return np.asarray(got), len(plan.log)


@pytest.mark.parametrize("case", MATRIX, ids=_case_id)
def test_sdc_detection_matrix(case):
    """One flip (``count=1``) under ``verify="abft-stages"``: fired,
    detected and attributed to the armed stage, repaired to the clean
    checked run without a degradation -- and the port's records and
    output equal the reference's on the same case."""
    stage = case["stage"]
    relayout = case.get("relayout", "scheduled")
    layout = case.get("layout", "CELL")
    rkw = dict(layout=DataLayout[layout], relayout=relayout)
    tkw = dict(layout=tbc.DataLayout[layout], relayout=relayout)
    rs = _ref((12, 12, 12), **rkw)
    shape = ((2,) if case.get("batched") else ()) + rs.input_shape
    f = _rhs(shape, seed=7)
    spec = dict(kind="flip", stage=stage, count=1)
    clean = _port((12, 12, 12), **tkw)
    want = clean.solve(f, verify="abft-stages").numpy()
    ps = _port((12, 12, 12), **tkw)
    got, fired = _trial(ps, f, "abft-stages", spec, faults.FaultPlan)
    rgot, rfired = _trial(rs, jnp.asarray(f), "abft-stages", spec,
                          rfaults.FaultPlan)
    recs = _records(ps.stats)
    assert fired == rfired == 1
    assert recs == _records(rs.stats), (recs, _records(rs.stats))
    assert any(r[0].split("#")[0] == stage for r in recs), recs
    assert all(r[0].split("#")[0] == stage for r in recs), recs
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= 1e-5 * scale
    assert float(np.max(np.abs(got - rgot))) <= 1e-10 * scale
    assert not ps.stats["degradations"]


def test_two_phase_guard_localizes_then_repairs():
    """``verify="abft"``: a ``count=2`` flip at ``fwd.1`` trips the
    sandwich (hit 1), the checked re-dispatch localizes it (hit 2) and
    the retry repairs it (no third firing); records equal the
    reference's."""
    f = _rhs((12, 12, 12))
    spec = dict(kind="flip", stage="fwd.1", count=2)
    want = _port((12, 12, 12)).solve(f, verify="abft-stages").numpy()
    ps = _port((12, 12, 12), verify="abft")
    rs = _ref((12, 12, 12), verify="abft")
    got, fired = _trial(ps, f, None, spec, faults.FaultPlan)
    rgot, rfired = _trial(rs, jnp.asarray(f), None, spec, rfaults.FaultPlan)
    assert fired == rfired == 2
    recs = _records(ps.stats)
    assert recs == _records(rs.stats)
    assert recs[0] == ("solve.linearity", "linearity", "localize")
    assert ("fwd.1", "compute", "recompute") in recs[1:]
    assert ps.stats["verify_failures"] == rs.stats["verify_failures"] == 1
    assert not ps.stats["degradations"]
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= 1e-5 * scale
    assert float(np.max(np.abs(got - rgot))) <= 1e-10 * scale


@pytest.mark.parametrize("verify", ["abft", "abft-stages"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_clean_soak_zero_false_positives(verify, dtype):
    """Clean solves under both guards: no record, no verify failure, no
    degradation; "abft" returns the bits of ``verify=None``."""
    ps = _port((16, 16, 16), verify=verify)
    plain = _port((16, 16, 16))
    rs = _ref((16, 16, 16))
    for seed in range(4):
        f = _rhs(ps.input_shape, seed=seed, dtype=dtype)
        got = ps.solve(f)
        want = plain.solve(f)
        if verify == "abft":
            assert torch.equal(got, want)
        assert np.allclose(got.numpy(), np.asarray(rs.solve(jnp.asarray(f))),
                           atol=1e-4, rtol=1e-4)
    assert ps.stats["verify_failures"] == 0
    assert not ps.stats.get("integrity")
    assert not ps.stats["degradations"]


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_persistent_corruption_escalates_to_solve_error(engine):
    """``count=-1`` at ``green``: every recompute and rung re-fires, the
    ladder walks its rungs (on "cuda" first ``engine:cuda->torch``, the
    reference's ``pallas->xla``) and ``SolveError`` carries the ABFT
    stage; the escalation records equal the reference's."""
    rengine = {"torch": "xla", "cuda": "pallas"}[engine]
    f = _rhs((12, 12, 12))
    spec = dict(kind="flip", stage="green", count=-1)
    ps = _port((12, 12, 12), engine=engine, verify="abft-stages")
    rs = rsolver.PoissonSolver((12, 12, 12), 1.0, BCS, engine=rengine,
                               verify="abft-stages")
    with faults.FaultPlan([spec]):
        with pytest.raises(SolveError) as ei:
            ps.solve(f)
    with rfaults.FaultPlan([spec]):
        with pytest.raises(RSolveError) as rei:
            rs.solve(jnp.asarray(f))
    assert ei.value.stage == rei.value.stage == "verify.abft@green"
    trail = [d["action"] for d in ei.value.degradations]
    rtrail = [d["action"].replace("pallas->xla", "cuda->torch")
              for d in rei.value.degradations]
    assert trail == rtrail
    assert trail[-2:] == ["relayout:scheduled->baseline",
                          "doubling:deferred->upfront"]
    assert _records(ps.stats) == _records(rs.stats)
    assert ("green", "compute", "escalate") in _records(ps.stats)


def test_green_checksum_equals_the_product_sum():
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    g = rng.standard_normal((6, 5))
    for fhat in (rng.standard_normal((3, 6, 5))
                 + 1j * rng.standard_normal((3, 6, 5)),
                 rng.standard_normal((6, 5))):
        got = ops.green_checksum(torch.from_numpy(fhat),
                                 torch.from_numpy(g)).numpy()
        want = np.asarray(rops.green_checksum(jnp.asarray(fhat),
                                              jnp.asarray(g)))
        assert abs(got - want) <= 1e-12 * np.abs(fhat).sum()


# -- distributed (8 gloo ranks) ----------------------------------------------

@pytest.fixture(scope="module")
def sdc_run(tmp_path_factory):
    """``scenario_abft_sdc``: the distributed SDC script's cases on mesh
    (2, 4), n=16, float32."""
    d = tmp_path_factory.mktemp("abft_sdc")
    f = np.random.default_rng(0).standard_normal((16, 16, 16))
    np.save(d / "f.npy", f.astype(np.float32))
    return ranks.launch("abft_sdc", d, 8, {"n": 16}, timeout=240)


DIST_CASES = ["ppp_a2a", "upu_pipelined"]


@pytest.mark.parametrize("case", DIST_CASES)
def test_dist_sdc_clean_guard_is_the_verify_off_bits(sdc_run, case):
    for res in sdc_run:
        assert res[case]["clean_bits"]
        assert not res[case]["clean_records"]


@pytest.mark.parametrize("case", DIST_CASES)
def test_dist_sdc_stage_flip_localized_and_repaired_bit_exact(sdc_run,
                                                              case):
    for res in sdc_run:
        r = res[case]["fwd0"]
        assert r["log"] == 2
        assert r["stages"][0] == ["solve.linearity", "localize"]
        assert any(st.split("#")[0] == "fwd.0" and a == "recompute"
                   for st, a in r["stages"][1:]), r["stages"]
        assert r["bits"], "selective recompute not bit-exact"
        assert not r["degradations"]


@pytest.mark.parametrize("case", DIST_CASES)
def test_dist_sdc_wire_flip_trips_the_sandwich(sdc_run, case):
    for res in sdc_run:
        r = res[case]["wire"]
        assert r["log"] >= 1, "wire flip never fired"
        assert "solve.linearity" in r["stages"]
        assert r["bits"]


def test_dist_sdc_wire_flip_attributed_to_the_wire(sdc_run):
    for res in sdc_run:
        r = res["stages_wire"]
        assert r["log"] >= 1
        wire = [rec for rec in r["records"] if rec[1] == "wire"]
        assert wire and all(st.startswith("wire.") for st, _, _ in wire)
        assert r["retries"] == 1
        assert r["err"] <= 1e-5


def test_dist_sdc_persistent_corruption_raises(sdc_run):
    for res in sdc_run:
        stage, trail = res["persistent"]
        assert stage == "verify.abft@green"
        assert trail == ["relayout:scheduled->baseline",
                         "doubling:deferred->upfront"]
    assert all(res == sdc_run[0] for res in sdc_run)


@pytest.fixture(scope="module")
def weight_runs(tmp_path_factory):
    """``scenario_abft_weight`` and ``scenario_abft_slabs`` on the CELL
    (E,E),(O,E),(P,P) n=16 case, float64; the reference's weight is one
    vector-Jacobian product of its ``_lite_reference_impl()`` with the
    rank-1 probe as the cotangent.  Each launch gets a directory of its
    own (the ranks' file rendezvous is not reused)."""
    rs = rsolver.PoissonSolver((16,) * 3, 1.0, BCS, engine="xla")
    f = np.random.default_rng(0).standard_normal(rs.input_shape)
    want = np.asarray(rs.solve(jnp.asarray(f)))
    qs = rabft.lite_probe_axes(rs.input_shape, np.float64)
    r = jnp.asarray(np.einsum("i,j,k->ijk", *qs))
    with rfaults.suppressed():
        w = jax.vjp(rs._lite_reference_impl(),
                    jnp.zeros(rs.input_shape))[1](r)[0]
    out = {"qs": qs}
    for scenario in ("abft_weight", "abft_slabs"):
        d = tmp_path_factory.mktemp(scenario)
        np.save(d / "f.npy", f)
        np.save(d / "want.npy", want)
        np.save(d / "w_ref.npy", np.asarray(w))
        out[scenario.split("_")[1]] = ranks.launch(scenario, d, 8,
                                                   timeout=240)
    return out


def test_dist_sandwich_weight_equals_reference(weight_runs):
    for res in weight_runs["weight"]:
        assert res["w_err"] <= 1e-10
        wn, want = res["w_norm"]
        assert abs(wn - want) <= 1e-10 * want
        for q, rq in zip(res["qs"], weight_runs["qs"]):
            assert np.array_equal(np.asarray(q), rq)
        err, recs = res["torch_abft"]
        assert err < 1e-10 and not recs


def test_dist_cuda_engine_abft_runs_the_checked_pipeline(weight_runs):
    for res in weight_runs["weight"]:
        no_weight, calls, err, recs = res["cuda_abft"]
        assert no_weight and calls == ["cuda"]
        assert err < 1e-10 and not recs


@pytest.mark.parametrize("verify", ["abft", "abft-stages"])
def test_dist_pod_batch_keeps_a_report_row_per_element(weight_runs, verify):
    for res in weight_runs["weight"]:
        r = res[f"pod/{verify}"]
        assert r["err"] < 1e-10
        assert r["report_shape"] == [2, r["n_names"]]
        assert r["clean"] and not r["records"]


SLABS = ["1x8/a2a:1", "1x8/overlap:2", "8x1/a2a:1", "8x1/overlap:2"]


@pytest.mark.parametrize("tag", SLABS)
def test_dist_sidecar_names_and_census_on_one_rank_axes(weight_runs, tag):
    """Every switch records its ``wire.<axis>`` check, the one-rank
    axis's too; only the non-unit axis issues collectives, each payload
    with its sidecar (``P`` checksums); the verify-off census is the
    predictor's."""
    tol = abft.tol_for(torch.float64)
    for res in weight_runs["slabs"]:
        r = res[tag]
        chunks = 2 if "overlap" in tag else 1
        wires = [n for n in r["names"] if n.startswith("wire.")]
        assert sorted({w.split("#")[0] for w in wires}) == \
            ["wire.data", "wire.model"]
        assert len(wires) == 4 * chunks
        assert [e["bytes"] for e in r["off"]] == r["predicted"]
        assert not any(e.get("sidecar") for e in r["off"])
        payload = [e for e in r["on"] if not e.get("sidecar")]
        side = [e for e in r["on"] if e.get("sidecar")]
        assert payload == r["off"]
        assert len(side) == len(payload)
        assert all(e["bytes"] == 8 * 8 for e in side)   # 8 float64 sums
        assert max(r["report"]) < tol
        assert r["err"] < 1e-10 and not r["records"]
