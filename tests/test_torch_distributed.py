"""The port's pencil-distributed solver == the reference solver.

``repro_torch.distributed.pencil.DistributedPoissonSolver`` on 8 gloo CPU
ranks (mesh (2, 4), and (2, 2, 2) for the pod batch) against the
single-process ``repro.core.solver.PoissonSolver`` in float64, computed
here and handed to the ranks through ``tmp_path``: the reference's
distributed path is red on this box, so the comparison is the one
``tests/test_distributed.py`` itself makes.  The ranks run in a
subprocess that never imports JAX (``tests/test_torch_ranks.py``); each
run is bounded by its group timeout and a subprocess timeout.

Covered: the reference's five ``CASES`` x the four strategies
(``n_chunks=2``) x engines "torch" and "cuda" (the kernels' plain
versions on the CPU) within 1e-10, the local batch (B=4, 1e-9) and the
pod batch, ``comm="auto"`` (brute, and the default guided search) with
the cache and agreed winners,
the ladder on every rank (an armed ``comm.overlap`` fault walks
``overlap -> pipelined``), ``rebuild`` from (2, 4) onto the 4-rank (2, 2)
mesh of the survivors (``tests/test_elastic.py``'s counterpart), and
``get_solver(mesh=...)`` with ``evict_solver_entries``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import test_torch_ranks as ranks
from repro.core.bc import BCType, DataLayout
from repro.core import comm as rcm
from repro.core.green import GreenKind
from repro.core.solver import PoissonSolver as RefSolver
from repro.core.solver import make_plan as ref_make_plan
from repro.plan.search import guided_comm_candidates as ref_guided
from repro_torch.core import comm as cm
from repro_torch.core.solver import clear_solver_cache, get_solver
from repro_torch.distributed.pencil import DistributedPoissonSolver

STRATEGIES = ("a2a", "pipelined", "fused", "overlap")
ENGINES = ("torch", "cuda")

# tests/test_distributed.py's CASES
CASES = [
    dict(bcs=[("EVEN", "EVEN"), ("ODD", "EVEN"), ("PER", "PER")],
         layout="NODE", n=16, green="chat2", batch=True),
    dict(bcs=[("EVEN", "EVEN"), ("ODD", "EVEN"), ("PER", "PER")],
         layout="CELL", n=16, green="chat2", auto=True, local_batch=True),
    dict(bcs=[("UNB", "UNB"), ("UNB", "UNB"), ("UNB", "UNB")],
         layout="NODE", n=16, green="chat2", local_batch=True),
    dict(bcs=[("UNB", "EVEN"), ("UNB", "UNB"), ("ODD", "UNB")],
         layout="CELL", n=16, green="hej2"),
    dict(bcs=[("ODD", "ODD"), ("EVEN", "ODD"), ("PER", "PER")],
         layout="NODE", n=12, green="chat2"),
]


def _case_id(c):
    return f"{c['layout']}-{c['bcs'][0][0]}{c['bcs'][2][0]}-n{c['n']}"


@pytest.fixture(autouse=True)
def _fresh_port_runtime():
    clear_solver_cache()
    cm.clear_autotune_cache()
    yield
    clear_solver_cache()
    cm.clear_autotune_cache()


def _write_reference(d, cfg):
    """The reference's float64 solve of a seeded field, for the ranks."""
    bcs = [tuple(getattr(BCType, b) for b in pair) for pair in cfg["bcs"]]
    n = cfg["n"]
    ref = RefSolver((n, n, n), 1.0, bcs, layout=DataLayout[cfg["layout"]],
                    green_kind=cfg["green"])
    f = np.random.default_rng(0).standard_normal(ref.input_shape)
    np.save(d / "f.npy", f)
    np.save(d / "want.npy", np.asarray(ref.solve(jnp.asarray(f))))


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def case_run(request, tmp_path_factory):
    cfg = request.param
    d = tmp_path_factory.mktemp("case")
    _write_reference(d, cfg)
    return cfg, ranks.launch("cases", d, 8, {"case": cfg})


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_distributed_matches_reference(case_run, strategy, engine):
    cfg, runs = case_run
    for res in runs:
        errs = res["errs"]
        tag = f"{engine}/{strategy}"
        assert errs[tag] < 1e-10, (tag, errs[tag])
        if cfg.get("local_batch"):
            assert errs[tag + "/local_batch"] < 1e-9
        if cfg.get("batch"):
            assert errs[tag + "/pod_batch"] < 1e-10


@pytest.fixture(scope="module")
def misc_runs(tmp_path_factory):
    """``scenario_auto``, ``scenario_faults`` and ``scenario_rebuild`` on
    8 ranks, on the CELL (E,E),(O,E),(P,P) n=16 case."""
    out = {}
    for scenario in ("auto", "faults", "rebuild"):
        d = tmp_path_factory.mktemp(scenario)
        _write_reference(d, CASES[1])
        out[scenario] = ranks.launch(scenario, d, 8)
    return out


def test_comm_auto_agrees_on_one_winner(misc_runs):
    runs = misc_runs["auto"]
    winners = {res["winner"] for res in runs}
    assert len(winners) == 1, winners
    for res in runs:
        # brute force: both fold sides of the 6-candidate grid
        assert res["n_timed"] == 12
        assert res["err"] < 1e-10
        assert res["second"] == [res["winner"], 0], "must hit the cache"


def test_comm_auto_guided_by_default_matches_reference(misc_runs):
    """The default search (guided): the cost model's shortlist, the
    reference's label for label, timed on every rank; one winner, and the
    solve within 1e-10 of the reference in float64."""
    runs = misc_runs["auto"]
    assert len({res["guided"]["winner"] for res in runs}) == 1
    names, n = ranks._SPEC          # the misc runs' case, CASES[1]
    bcs = [tuple(getattr(BCType, b) for b in pair) for pair in names]
    plan = ref_make_plan((n,) * 3, 1.0, bcs, DataLayout.CELL,
                         GreenKind.CHAT2)
    want = [rcm.cfg_label(c) for c in ref_guided(
        plan, 2, 4, jnp.float64, folds=("pack", "unpack"),
        relayout="scheduled")]
    for res in runs:
        g = res["guided"]
        assert g["shortlist"] == want
        assert g["space"] == 12 and 5 * len(want) <= g["space"]
        assert g["timed"] == sorted(want)
        assert g["winner"] in want
        assert g["err"] < 1e-10, g["err"]


def test_comm_auto_agrees_despite_rank_dependent_timings(misc_runs):
    runs = misc_runs["auto"]
    assert len({res["alone"] for res in runs}) > 1
    assert len({res["agreed"] for res in runs}) == 1


def test_comm_auto_json_cache_round_trip_and_mangled_entry(misc_runs):
    for res in misc_runs["auto"]:
        assert res["json_hit"] and res["json_schema"] == 2
        same, n_timed = res["mangled"]
        assert same and n_timed == len(cm.autotune_candidates())


def test_autotune_key_and_cache_split_by_doubling(misc_runs):
    for res in misc_runs["auto"]:
        pruned_key, dense_key, n_dense, n_pruned, entries = res["doubling"]
        assert pruned_key and dense_key
        assert n_dense == 1 and n_pruned == 1, "pruned replayed dense"
        assert entries == [False, True]


def test_comm_fault_walks_overlap_to_pipelined_on_every_rank(misc_runs):
    for res in misc_runs["faults"]:
        trail, fired, err, strategy, n_chunks = res["overlap"]
        assert trail == ["comm:overlap->pipelined"]
        assert fired >= 1 and err < 1e-12
        assert (strategy, n_chunks) == ("pipelined", 2)
        assert res["pipelined"][0] == ["comm:pipelined->a2a"]
        assert res["pipelined"][1] < 1e-12


def test_verify_nan_and_transient_retries_on_every_rank(misc_runs):
    for res in misc_runs["faults"]:
        trail, failures, stage, err = res["nan"]
        assert trail == ["engine:cuda->torch"] and failures == 1
        assert stage.startswith("verify.nan@") and err < 1e-12
        assert res["transient"] == [2, [], 0.0]
        stage, trail = res["exhausted"]
        assert stage == "dist.dispatch"
        assert trail == ["engine:cuda->torch", "relayout:scheduled->baseline",
                         "doubling:deferred->upfront"]


def test_real_switch_failure_raises_without_a_rung(misc_runs):
    for res in misc_runs["faults"]:
        stage, degradations, trail, strategy = res["real"]
        assert degradations == [] and trail == []
        assert strategy == "pipelined"


def test_not_ported_entry_points_raise(misc_runs):
    """Ported since: ``lower`` (the dry run) runs on the gloo ranks; its
    eight all-to-alls (4 switches x 2 chunks) are the byte predictor's,
    every rank records the same kernel calls, and the output pencil is
    the input's."""
    runs = misc_runs["faults"]
    for res in runs:
        got, predicted, kernels, (out_shape,) = res["lowered"]
        assert got == predicted and len(got) == 8
        assert kernels == runs[0]["lowered"][2]
        assert kernels["fft_stockham"] > 0
        assert len(out_shape) == 3


def test_rebuild_onto_the_survivors_mesh(misc_runs):
    runs = misc_runs["rebuild"]
    for r, res in enumerate(runs):
        assert res["err_a"] < 1e-10
        if r < 4:
            vs_base, vs_ref, shared_green, sizes = res["rebuilt"]
            assert vs_base < 1e-12 and vs_ref < 1e-10
            assert shared_green, "Green reassembled on rebuild"
            assert sizes == [2, 2]


def test_get_solver_mesh_hits_and_eviction(misc_runs):
    for res in misc_runs["rebuild"]:
        assert res["hit"] and res["info"] == [1, 1]
        assert res["evicted_again"] == 0
        assert res["fresh"] == [True, 1]


# -- in-process: what raises before any collective --------------------------

def test_entry_points_need_a_card_unless_told_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    U = (BCType.UNB, BCType.UNB)
    with pytest.raises(RuntimeError, match="GPU"):
        DistributedPoissonSolver((8,) * 3, 1.0, (U, U, U), mesh=object())
    with pytest.raises(RuntimeError, match="GPU"):
        get_solver((8,) * 3, 1.0, (U, U, U), mesh=object())


@pytest.mark.parametrize("kw,item", [(dict(verify="abft"), "DeviceMesh"),
                                     (dict(verify="abft-stages"),
                                      "DeviceMesh"),
                                     (dict(abft_rtol=1e-6), "DeviceMesh")])
def test_abft_modes_are_not_ported(kw, item):
    """Ported since: the ABFT arguments pass the constructor's checks and
    it stops only at the mesh (the ABFT cases run in
    ``test_torch_abft.py``); an unknown verify mode is still refused."""
    U = (BCType.UNB, BCType.UNB)
    with pytest.raises(TypeError, match=item):
        DistributedPoissonSolver((8,) * 3, 1.0, (U, U, U), mesh=object(),
                                 device="cpu", **kw)
    with pytest.raises(ValueError, match="verify"):
        DistributedPoissonSolver((8,) * 3, 1.0, (U, U, U), mesh=object(),
                                 device="cpu", verify="bogus")
