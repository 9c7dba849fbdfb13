"""The port's plan space, cost model and guided search == the reference's.

``repro_torch.plan`` against ``repro.plan`` (``tests/test_plansearch.py``'s
counterpart), on the same arguments:

* the space: enumeration, validity rules, ``mesh_shapes_for`` order and
  the label/dict round trip equal to the reference's (the port's engine
  ``"cuda"`` stands where the reference's ``"pallas"`` does, ``"torch"``
  where ``"xla"`` does);
* the predictor: ``predict_bytes`` (and the cost model's seconds) equal
  to the reference's on every case of the reference's predictor list,
  and equal bit for bit to the bytes the port's comm layer hands to
  ``all_to_all_single`` on 8 gloo ranks (``collective_census``), the
  counterpart of the reference's HLO measurement;
* the guided shortlist, label for label with its census, and a
  guided-versus-brute oracle under an injected deterministic time
  function (timing-based oracles flake under parallel workers);
* ``search_plan`` on a one-rank group and on 4 ranks over (2, 2), (1, 4)
  and (4, 1), against the reference's ranking of the same space;
* a one-rank mesh axis issues no ``all_to_all_single`` and gives the bits
  of the collective path.

The ranks run in a subprocess that never imports JAX
(``tests/test_torch_ranks.py``); each group is one spawn per module.
"""
import zlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import test_torch_ranks as ranks
import repro.plan as rplan
from repro.core import comm as rcomm
from repro.core.bc import BCType as RBC
from repro.core.bc import DataLayout as RLayout
from repro.core.solver import make_plan as ref_make_plan
from repro.plan import costmodel as rcost
from repro_torch.core import comm as cm
from repro_torch.core.bc import BCType, DataLayout
from repro_torch.core.comm import CommConfig, cfg_label, label_to_cfg
from repro_torch.core.solver import clear_solver_cache, make_plan
from repro_torch.plan import (CostModel, PlanPoint, PlanSpace,
                              SHORTLIST_DIVISOR, guided_comm_candidates,
                              mesh_shapes_for, predict_bytes)
from repro_torch.plan import costmodel as tcost

ENGINES = (("cuda", "pallas"), ("torch", "xla"))


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    clear_solver_cache()
    cm.clear_autotune_cache()
    cm.reset_warn_once()
    yield
    clear_solver_cache()
    cm.clear_autotune_cache()


def _bcs(names, mod):
    return tuple(tuple(getattr(mod, b) for b in pair) for pair in names)


def _plans(n, names, layout="CELL", **kw):
    """The port's and the reference's plan of one case."""
    return (make_plan((n,) * 3, 1.0, _bcs(names, BCType),
                      DataLayout[layout], "chat2", **kw),
            ref_make_plan((n,) * 3, 1.0, _bcs(names, RBC), RLayout[layout],
                          "chat2", **kw))


def _pts(points):
    return [p.asdict() for p in points]


# -- the space ----------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shapes_for_matches_reference(n):
    for slabs in (True, False):
        assert mesh_shapes_for(n, slabs) == rplan.mesh_shapes_for(n, slabs)
    assert mesh_shapes_for(8) == ((2, 4), (4, 2), (1, 8), (8, 1))


@pytest.mark.parametrize("max_chunks", (2, 4, 8))
@pytest.mark.parametrize("batched", (False, True))
@pytest.mark.parametrize("relayout", ("scheduled", "baseline"))
def test_comm_space_matches_reference(max_chunks, batched, relayout):
    for folds in (("pack",), ("pack", "unpack")):
        ours = PlanSpace.comm(max_chunks, folds, batched, relayout)
        ref = rplan.PlanSpace.comm(max_chunks, folds, batched, relayout)
        assert _pts(ours.points()) == _pts(ref.points())
        assert len(ours) == len(ref)
        assert ([cfg_label(c) for c in ours.comm_configs()]
                == [rcomm.cfg_label(c) for c in ref.comm_configs()])


def test_comm_space_is_the_brute_grid():
    cfgs = PlanSpace.comm(4, ("pack", "unpack")).comm_configs()
    brute = cm.autotune_candidates(4, folds=("pack", "unpack"))
    assert set(map(cfg_label, cfgs)) == set(map(cfg_label, brute))
    assert len(cfgs) == 12


@pytest.mark.parametrize("engine,ref_engine", ENGINES)
@pytest.mark.parametrize("batched", (False, True))
def test_full_space_matches_reference(engine, ref_engine, batched):
    for n_dev in (1, 4, 8):
        ours = PlanSpace.full(n_dev, engine=engine, batched=batched)
        ref = rplan.PlanSpace.full(n_dev, engine=ref_engine, batched=batched)
        assert _pts(ours.points()) == _pts(ref.points())
        assert [p.label() for p in ours.points()] == \
            [p.label() for p in ref.points()]
    # 3 meshes x 2 orders x radixes x (12 scheduled + 6 baseline)
    assert len(PlanSpace.full(4, engine=engine)) == \
        (216 if engine == "cuda" else 108)


def test_space_validity_constraints():
    for pt in PlanSpace.comm(folds=("pack",), batched=True).points():
        if pt.strategy in ("a2a", "fused"):
            assert pt.n_chunks == 1 and pt.chunk_axis == "auto"
    assert all(pt.chunk_axis == "auto"
               for pt in PlanSpace.comm(folds=("pack",)).points())
    assert any(pt.chunk_axis == "grid"
               for pt in PlanSpace.comm(folds=("pack",),
                                        batched=True).points())
    # radix 2 is a "cuda"-engine dimension
    assert all(pt.radix == 4
               for pt in PlanSpace.full(8, engine="torch").points())
    assert any(pt.radix == 2
               for pt in PlanSpace.full(8, engine="cuda").points())
    for pt in PlanSpace.full(8, engine="torch").points():
        if pt.relayout == "baseline":
            assert pt.fold == "pack"


def test_plan_point_label_and_dict_round_trip():
    for pt in PlanSpace.full(8, engine="cuda", batched=True).points():
        assert PlanPoint.fromdict(pt.asdict()) == pt
        ref = rplan.PlanPoint.fromdict(pt.asdict())
        assert ref.label() == pt.label() and ref.asdict() == pt.asdict()
    for cfg in PlanSpace.comm(folds=("pack", "unpack"),
                              batched=True).comm_configs():
        assert label_to_cfg(cfg_label(cfg)) == cfg


# -- the predictor ----------------------------------------------------------

# tests/test_plansearch.py's _PREDICT_SCRIPT cases: (n, bcs, layout, mesh,
# comm, batch, doubling, relayout, order, dtype) -- every strategy, both
# folds, both relayouts, both doubling modes, CELL and NODE, 2-D and slab
# meshes, dividing and non-dividing batch/chunk combinations
_PPP = (("PER", "PER"),) * 3
_UUU = (("UNB", "UNB"),) * 3
PREDICT_CASES = [
    (16, _PPP, "CELL", (2, 4), ("a2a", 1), None,
     "deferred", "scheduled", "layout", "float64"),
    (16, _PPP, "CELL", (2, 4), ("fused", 1), None,
     "deferred", "scheduled", "layout", "float32"),
    (16, _UUU, "CELL", (2, 4), ("pipelined", 2), None,
     "deferred", "scheduled", "layout", "float64"),
    (16, _UUU, "CELL", (2, 4), ("pipelined", 2), None,
     "upfront", "scheduled", "layout", "float64"),
    (12, (("EVEN", "EVEN"), ("ODD", "EVEN"), ("PER", "PER")), "NODE",
     (4, 2), ("overlap", 4, "unpack"), None,
     "deferred", "scheduled", "layout", "float32"),
    (16, (("UNB", "UNB"), ("PER", "PER"), ("UNB", "UNB")), "CELL", (1, 8),
     ("overlap", 2), None, "upfront", "baseline", "natural", "float64"),
    (16, _UUU, "NODE", (8, 1), ("a2a", 1), None,
     "deferred", "scheduled", "natural", "float64"),
    (16, _PPP, "CELL", (2, 4), ("pipelined", 4), 3,
     "deferred", "scheduled", "layout", "float64"),   # B does not divide
    (16, _PPP, "CELL", (2, 4), ("overlap", 2), 4,
     "deferred", "scheduled", "layout", "float64"),   # B divides: free axis
    (16, _PPP, "CELL", (2, 4), ("pipelined", 4, "pack", "grid"), 4,
     "deferred", "scheduled", "layout", "float64"),   # pinned grid axis
    (17, _PPP, "CELL", (2, 4), ("pipelined", 2), None,
     "deferred", "scheduled", "layout", "float32"),   # prime extents
    (16, _UUU, "NODE", (2, 4), ("overlap", 4, "unpack"), 2,
     "deferred", "scheduled", "layout", "float64"),
]


def _case_id(c):
    n, bcs, lay, ms, comm, b, dbl, rel, op, dt = c
    return (f"n{n}-{bcs[0][0][0]}{bcs[1][0][0]}{bcs[2][0][0]}-{lay}-"
            f"{ms[0]}x{ms[1]}-{':'.join(map(str, comm))}-B{b}-{dbl}-{rel}-"
            f"{op}-{dt}")


CASE_IDS = [_case_id(c) for c in PREDICT_CASES]


def _case_plans(case):
    n, bcs, lay, ms, comm, b, dbl, rel, op, dt = case
    ours, ref = _plans(n, bcs, lay, doubling=dbl, order_policy=op)
    return ours, ref, ms, CommConfig(*comm), rcomm.CommConfig(*comm), b, dt


@pytest.mark.parametrize("case", PREDICT_CASES, ids=CASE_IDS)
def test_predict_bytes_matches_reference(case):
    ours, ref, (p1, p2), cfg, rcfg, b, dt = _case_plans(case)
    got = predict_bytes(ours, p1, p2, getattr(torch, dt), cfg, batch=b)
    assert got == rcost.predict_bytes(ref, p1, p2, getattr(jnp, dt), rcfg,
                                      batch=b)
    assert len(got) >= 2 and all(v > 0 for v in got)
    assert tcost.switch_traces(ours, p1, p2) == \
        tuple(tcost.SwitchTrace(*(getattr(t, f) for f in (
            "index", "axis_size", "dims", "split_dim", "chunk_dim",
            "is_complex"))) for t in rcost.switch_traces(ref, p1, p2))
    for radix in (4, 2):
        assert CostModel().comm_cost(ours, p1, p2, getattr(torch, dt), cfg,
                                     batch=b, max_radix=radix) == \
            rcost.CostModel().comm_cost(ref, p1, p2, dt, rcfg, batch=b,
                                        max_radix=radix)


def test_itemsize_takes_torch_numpy_and_names():
    for dt, size in ((torch.float32, 4), (torch.float64, 8),
                     (np.float32, 4), ("float64", 8), (jnp.float32, 4)):
        assert tcost._itemsize(dt) == size
    with pytest.raises(TypeError):
        np.dtype(torch.float32)


@pytest.mark.parametrize("radix", (4, 2))
def test_stage_count_matches_reference(radix):
    for lg in range(1, 25):
        assert tcost._stages(2 ** lg, radix) == rcost._stages(2 ** lg, radix)


def test_predict_bytes_slab_mesh_skips_unit_axis():
    ours, _ = _plans(16, _PPP)
    full = predict_bytes(ours, 2, 4, torch.float32, CommConfig("a2a", 1))
    slab = predict_bytes(ours, 1, 8, torch.float32, CommConfig("a2a", 1))
    assert len(full) == 4
    assert len(slab) == 2           # only the p2-axis switches ship bytes
    assert predict_bytes(ours, 1, 1, torch.float32, CommConfig("a2a")) == []


def test_predictor_prefers_fewer_collectives_at_small_scale():
    ours, _ = _plans(16, _UUU)
    m = CostModel()
    mono, _ = m.comm_cost(ours, 2, 4, "float32", CommConfig("a2a", 1))
    chunk, _ = m.comm_cost(ours, 2, 4, "float32", CommConfig("pipelined", 4))
    assert mono < chunk
    _, meta_p = m.comm_cost(ours, 2, 4, "float32",
                            CommConfig("overlap", 2, "pack"))
    _, meta_u = m.comm_cost(ours, 2, 4, "float32",
                            CommConfig("overlap", 2, "unpack"))
    assert meta_p["bytes"] == meta_u["bytes"]


@pytest.fixture(scope="module")
def census_run(tmp_path_factory):
    """Every predictor case solved once on 8 gloo ranks under
    ``collective_census()``."""
    cases = [dict(id=cid, n=c[0], bcs=c[1], layout=c[2], mesh=c[3],
                  comm=c[4], batch=c[5], doubling=c[6], relayout=c[7],
                  order=c[8], dtype=c[9])
             for cid, c in zip(CASE_IDS, PREDICT_CASES)]
    return ranks.launch("census", tmp_path_factory.mktemp("census"), 8,
                        {"cases": cases})


@pytest.mark.parametrize("case", PREDICT_CASES, ids=CASE_IDS)
def test_census_matches_predict_bytes_bit_for_bit(census_run, case):
    """The bytes each rank's comm layer hands to ``all_to_all_single``
    equal the prediction, collective for collective, in program order;
    slab meshes issue only the non-unit axis's switches."""
    ours, _, (p1, p2), cfg, _, b, dt = _case_plans(case)
    want = predict_bytes(ours, p1, p2, getattr(torch, dt), cfg, batch=b)
    for res in census_run:
        got = res[_case_id(case)]
        assert got["bytes"] == want
        assert got["issued"] == len(want)
        st = got["stats"]
        assert st["total_bytes"] == sum(want)
        assert (st["first_bytes"], st["last_bytes"]) == (want[0], want[-1])
        assert all(e["op"] == "all-to-all" for e in st["per_collective"])


# -- the guided shortlist ---------------------------------------------------

# (n, bcs, mesh, dtype, batch): the reference's shortlist tests and its
# oracle cases
GUIDED_CASES = [
    (16, _PPP, (2, 4), "float32", None),
    (17, _PPP, (2, 4), "float32", None),      # prime extent: padding prune
    (17, _PPP, (2, 4), "float32", 8),         # batch 8 restores "auto"
    (16, _UUU, (1, 8), "float32", None),
    (16, _PPP, (4, 2), "float32", None),
    (24, _UUU, (2, 4), "float32", None),
    (16, _UUU, (2, 4), "float64", 3),
    (128, _UUU, (2, 2), "float32", None),     # the smoke's DIST4 case
    (256, _UUU, (1, 1), "float32", None),     # the smoke's DIST1 case
]


@pytest.mark.parametrize("case", GUIDED_CASES,
                         ids=lambda c: f"n{c[0]}-{c[1][0][0]}-{c[2]}-"
                                       f"{c[3]}-B{c[4]}")
@pytest.mark.parametrize("radix", (4, 2))
def test_guided_shortlist_matches_reference(case, radix):
    n, bcs, (p1, p2), dt, b = case
    ours, ref = _plans(n, bcs)
    folds = ("pack", "unpack")
    census, rcensus = {}, {}
    short = guided_comm_candidates(ours, p1, p2, getattr(torch, dt),
                                   batch=b, folds=folds, max_radix=radix,
                                   census=census)
    rshort = rplan.guided_comm_candidates(ref, p1, p2, getattr(jnp, dt),
                                          batch=b, folds=folds,
                                          max_radix=radix, census=rcensus)
    assert [cfg_label(c) for c in short] == \
        [rcomm.cfg_label(c) for c in rshort]
    assert census == rcensus
    assert census["shortlist"] == [cfg_label(c) for c in short]
    live = census["space"] - len(census["pruned_padding"])
    assert len(short) == max(1, -(-live // SHORTLIST_DIVISOR))


def test_padding_prune_prime_extent():
    ours, _ = _plans(17, _PPP)
    census = {}
    guided_comm_candidates(ours, 2, 4, "float32", folds=("pack", "unpack"),
                           census=census)
    assert census["pruned_padding"], census
    assert not set(census["shortlist"]) & set(census["pruned_padding"])
    assert all(label_to_cfg(lbl).n_chunks == 1
               for lbl in census["shortlist"]), census["shortlist"]
    census_b = {}
    guided_comm_candidates(ours, 2, 4, "float32", batch=8,
                           folds=("pack", "unpack"), census=census_b)
    assert all("ca=grid" in lbl for lbl in census_b["pruned_padding"])
    assert census_b["space"] > census["space"]


# -- guided versus brute under an injected time function -------------------

# a machine the cost model was not fitted to: half its latency, 1.5x its
# wire rate, 0.6x its transform rate, other overlap factors, and a
# deterministic +-3% per-candidate wobble
_TRUTH = CostModel(alpha_s=20e-6, bytes_per_s=12e9, flops_per_s=3e9,
                   overlap_eff=0.5, pipeline_eff=0.3)


def _true_seconds(plan, p1, p2, dtype, batch):
    def time_fn(cfg):
        t, _ = _TRUTH.comm_cost(plan, p1, p2, dtype, cfg, batch=batch)
        wobble = zlib.crc32(cfg_label(cfg).encode()) % 2001 / 1000 - 1
        return t * (1 + 0.03 * wobble)
    return time_fn


@pytest.mark.parametrize("case", GUIDED_CASES,
                         ids=lambda c: f"n{c[0]}-{c[1][0][0]}-{c[2]}-"
                                       f"{c[3]}-B{c[4]}")
def test_guided_within_10pct_of_brute_oracle(case):
    """Both searches through ``autotune_comm`` on the same deterministic
    times: guided times at least 5x fewer candidates, and its winner is
    within 10% of the exhaustive sweep's."""
    n, bcs, (p1, p2), dt, b = case
    ours, _ = _plans(n, bcs)
    dtype = getattr(torch, dt)
    folds = ("pack", "unpack")
    time_fn = _true_seconds(ours, p1, p2, dtype, b)
    brute = cm.autotune_candidates(4, folds=folds)
    if b is not None:
        brute = PlanSpace.comm(folds=folds, batched=True).comm_configs()
    guided = guided_comm_candidates(ours, p1, p2, dtype, batch=b,
                                    folds=folds)
    got_b, got_g = {}, {}
    wb = cm.autotune_comm(("oracle", "brute"), time_fn, candidates=brute,
                          cache_path="", results=got_b)
    wg = cm.autotune_comm(("oracle", "guided"), time_fn, candidates=guided,
                          cache_path="", results=got_g)
    assert 5 * len(got_g) <= len(got_b), (len(got_g), len(got_b))
    assert time_fn(wg) <= 1.10 * time_fn(wb), (cfg_label(wg),
                                               cfg_label(wb))


# -- search_plan ------------------------------------------------------------

def _ref_search_census(n, bcs, n_dev, engine, monkeypatch):
    """The reference's ``search_plan`` account of the same space, its
    timing stubbed out (nothing is compiled): what it predicts, prunes and
    shortlists."""
    monkeypatch.setattr(rcomm, "_timed_call", lambda fn, pt, budget: (
        1.0, None))
    census = {}
    rplan.search_plan((n,) * 3, 1.0, _bcs(bcs, RBC), engine=engine,
                      devices=[None] * n_dev, cache_path="",
                      mesh_shapes=((1, 1),) if n_dev == 1 else None,
                      census=census)
    return {k: census[k] for k in ("space", "predicted", "pruned_padding",
                                   "shortlist")}


@pytest.fixture(scope="module")
def plan_one(tmp_path_factory):
    d = tmp_path_factory.mktemp("plan_one")
    _write_spec_reference(d)
    return ranks.launch("plan_one", d, 1)[0]


@pytest.fixture(scope="module")
def plan_four(tmp_path_factory):
    return ranks.launch("plan_four", tmp_path_factory.mktemp("plan_four"), 4)


def _write_spec_reference(d):
    """The reference's float64 solve of the ranks' ``_SPEC`` case."""
    from repro.core.solver import PoissonSolver as RefSolver
    names, n = ranks._SPEC
    ref = RefSolver((n,) * 3, 1.0, _bcs(names, RBC), layout=RLayout.CELL,
                    green_kind="chat2")
    f = np.random.default_rng(0).standard_normal(ref.input_shape)
    np.save(d / "f.npy", f)
    np.save(d / "want.npy", np.asarray(ref.solve(jnp.asarray(f))))


def test_search_plan_one_rank_times_only_the_frontier_and_caches(plan_one):
    s = plan_one["search"]
    assert not s["cached"]
    assert s["census"]["space"] > len(s["census"]["shortlist"])
    assert not s["failed"]
    assert s["timed"] == sorted(s["census"]["shortlist"])
    assert s["point"] in s["timed"]
    assert s["schema"] == 2 and s["entries"] == 1
    # replayed from the cache; a different dtype is a different family
    assert s["again"] == [True, True, True]
    assert s["f64_cached"] is False


def test_search_plan_one_rank_ranks_as_the_reference(plan_one, monkeypatch):
    assert plan_one["search"]["census"] == _ref_search_census(
        8, _PPP, 1, "pallas", monkeypatch)


def test_search_plan_four_ranks_agree_and_rank_0_writes(plan_four):
    assert len({res["point"] for res in plan_four}) == 1
    assert len({res["seconds"] for res in plan_four}) == 1
    for r, res in enumerate(plan_four):
        assert not res["failed"]
        assert res["timed"] == sorted(res["census"]["shortlist"])
        assert res["stores"] == (1 if r == 0 else 0)
        assert res["again"] == [False, True, True]


def test_search_plan_four_ranks_ranks_as_the_reference(plan_four,
                                                       monkeypatch):
    want = _ref_search_census(8, _UUU, 4, "pallas", monkeypatch)
    assert want["space"] == 144
    labels = want["shortlist"]
    assert {lbl.split("mesh=")[1] for lbl in labels} <= {"2x2", "1x4", "4x1"}
    assert any("|r=2" in lbl for lbl in want["predicted"])
    for res in plan_four:
        assert res["census"] == want


def test_search_plan_slab_meshes_issue_only_the_non_unit_axis(plan_four):
    for res in plan_four:
        for ms, (got, want) in res["slabs"].items():
            assert got == want and len(got) == 2, ms


def test_search_plan_needs_a_process_group():
    import torch.distributed as dist
    from repro_torch.plan import search_plan
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    with pytest.raises(RuntimeError, match="init_process_group"):
        search_plan((8,) * 3, 1.0, _bcs(_PPP, BCType), device="cpu")


# -- one-rank mesh axes ------------------------------------------------------

def test_one_rank_axes_issue_no_collective(plan_one):
    """On the (1, 1) mesh every switch of every strategy, fold, relayout
    and engine is the identity: the census is empty and
    ``all_to_all_single`` is never called (the collective path issues 4
    or 8), and ``solve_local`` gives the collective path's bits."""
    runs = plan_one["one_rank"]
    assert len(runs) == 24
    for tag, (n_census, n_called, n_old, same, err) in runs.items():
        assert (n_census, n_called) == (0, 0), tag
        assert n_old == 4 * label_to_cfg(tag.split("/")[2]).n_chunks, tag
        assert same, tag
        assert err < 1e-10, (tag, err)
