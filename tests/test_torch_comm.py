"""The port's comm layer (``repro_torch.core.comm``): the unit tests of
``tests/test_comm.py`` against the port, the reference's answers where
both can compute one, and the tiled exchange itself on 8 gloo CPU ranks
(mesh (2, 4), ``tests/test_torch_ranks.py``; no JAX in the ranks)."""
import json
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import test_torch_ranks as ranks
from repro.core import comm as rcm
from repro.core.bc import BCType
from repro.core.solver import PoissonSolver as RefSolver
from repro_torch.core import comm as cm
from repro_torch.core.comm import (CommConfig, as_comm, autotune_candidates,
                                   autotune_comm, clear_autotune_cache,
                                   make_strategy)
from repro_torch.core.solver import clear_solver_cache
from repro_torch.runtime import faults


@pytest.fixture(autouse=True)
def _fresh_port_comm():
    """The port's warn-once and autotune state, fresh around each test."""
    clear_solver_cache()
    clear_autotune_cache()
    yield
    assert not faults._ACTIVE, "a test left a FaultPlan armed"
    clear_autotune_cache()
    clear_solver_cache()


# -- config parsing ---------------------------------------------------------

def test_strategies_registry_complete():
    assert set(cm.STRATEGIES) == set(rcm.STRATEGIES)
    for name in cm.STRATEGIES:
        strat = make_strategy(CommConfig(name, 3))
        assert strat.name == name
        assert strat.n_chunks == 3


def test_comm_config_rejects_unknown_strategy():
    with pytest.raises(AssertionError):
        CommConfig("allgather")
    with pytest.raises(AssertionError):
        CommConfig("a2a", 0)


def test_as_comm_accepts_name_config_and_none():
    assert as_comm(None) == CommConfig()
    assert as_comm("overlap") == CommConfig("overlap")
    cfg = CommConfig("pipelined", 8)
    assert as_comm(cfg) is cfg


@pytest.mark.parametrize("cfg", [CommConfig("a2a", 1),
                                 CommConfig("overlap", 4, "unpack"),
                                 CommConfig("pipelined", 2, "pack", "grid"),
                                 CommConfig("fused", 1, "unpack", "grid")])
def test_labels_round_trip_as_the_reference(cfg):
    ref = rcm.CommConfig(cfg.strategy, cfg.n_chunks, cfg.fold,
                         cfg.chunk_axis)
    assert cm.cfg_label(cfg) == rcm.cfg_label(ref)
    assert cm.label_to_cfg(cm.cfg_label(cfg)) == cfg
    labels = [cm.cfg_label(c) for c in autotune_candidates(
        folds=("pack", "unpack"))]
    assert labels == [rcm.cfg_label(c) for c in rcm.autotune_candidates(
        folds=("pack", "unpack"))]


def test_abft_sidecar_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 6"):
        make_strategy(CommConfig("a2a"), abft=(object(), 1e-6))


# -- chunk padding ----------------------------------------------------------

def test_split_chunks_pads_non_dividing_axis_and_warns_once():
    x = torch.arange(2 * 7 * 3, dtype=torch.float32).reshape(2, 7, 3)
    with pytest.warns(RuntimeWarning, match="zero-padding"):
        chunks, ln = cm._split_chunks(x, 1, 2)
    assert ln == 7
    assert [tuple(c.shape) for c in chunks] == [(2, 4, 3), (2, 4, 3)]
    merged = torch.cat(chunks, dim=1)
    np.testing.assert_array_equal(merged[:, :7].numpy(), x.numpy())
    np.testing.assert_array_equal(merged[:, 7:].numpy(), 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cm._split_chunks(x, 1, 2)


def test_split_chunks_exact_division_no_pad():
    x = torch.ones((2, 8, 3))
    chunks, ln = cm._split_chunks(x, 1, 4)
    assert ln == 8 and len(chunks) == 4
    assert all(tuple(c.shape) == (2, 2, 3) for c in chunks)
    # views of the input: the chunking itself copies nothing
    assert all(c.data_ptr() >= x.data_ptr() for c in chunks)


# -- autotuner --------------------------------------------------------------

def test_autotune_candidates_sweep():
    cands = autotune_candidates(max_chunks=4)
    labels = {(c.strategy, c.n_chunks) for c in cands}
    assert ("a2a", 1) in labels and ("fused", 1) in labels
    assert ("pipelined", 2) in labels and ("overlap", 4) in labels


def test_autotune_picks_fastest_and_caches_in_memory():
    calls = []

    def fake_time(cfg):
        calls.append(cfg)
        return 0.001 if cfg == CommConfig("overlap", 4) else 0.01

    res = {}
    best = autotune_comm(("k1",), fake_time, cache_path="", results=res)
    assert best == CommConfig("overlap", 4)
    assert len(calls) == len(autotune_candidates())
    assert res and min(res.values()) == 0.001
    res2 = {}
    assert autotune_comm(("k1",), fake_time, cache_path="",
                         results=res2) == best
    assert len(calls) == len(autotune_candidates())
    assert res2 == {}


def test_autotune_persists_to_json_cache_as_the_reference(tmp_path):
    """The port writes the reference's schema-2 file, and each side reads
    the other's winner back without timing."""
    path = str(tmp_path / "comm_cache.json")

    def timer(cfg):
        return 0.002 if cfg.strategy == "fused" else 0.02

    best = autotune_comm(("k2",), timer, cache_path=path)
    assert best == CommConfig("fused", 1)
    with open(path) as fh:
        data = json.load(fh)
    assert data["schema"] == rcm.CACHE_SCHEMA == cm.CACHE_SCHEMA
    clear_autotune_cache()
    assert autotune_comm(("k2",), lambda c: pytest.fail("must hit the disk"),
                         cache_path=path) == best
    rcm.clear_autotune_cache()
    got = rcm.autotune_comm(("k2",), lambda c: pytest.fail("must hit"),
                            cache_path=path)
    assert (got.strategy, got.n_chunks, got.fold) == ("fused", 1, "pack")
    rcm.clear_autotune_cache()


def test_autotune_does_not_persist_when_told_not_to(tmp_path):
    path = tmp_path / "comm_cache.json"
    autotune_comm(("k2b",), lambda c: 1.0, cache_path=str(path),
                  persist=False)
    assert not path.exists()


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_autotune_skips_failing_candidates():
    def flaky(cfg):
        if cfg.strategy != "pipelined":
            raise RuntimeError("no collective")
        return 0.5 / cfg.n_chunks

    best = autotune_comm(("k3",), flaky, cache_path="")
    assert best.strategy == "pipelined"
    assert best.n_chunks == max(
        c.n_chunks for c in autotune_candidates() if c.strategy == "pipelined")

    def always_fails(cfg):
        raise RuntimeError("nope")

    assert autotune_comm(("k4",), always_fails, cache_path="") == CommConfig()


@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_autotune_budget_applies_after_each_candidate():
    """A candidate over budget is timed to its end (a collective in flight
    is never abandoned) and then skipped."""
    times = {"a2a": 2.0, "overlap": 9.0, "pipelined": 1.0}
    cands = [CommConfig("a2a", 1), CommConfig("overlap", 2),
             CommConfig("pipelined", 2)]
    calls = []

    def timer(cfg):
        calls.append(cfg.strategy)
        return times[cfg.strategy]

    census = {}
    best = autotune_comm(("kb",), timer, candidates=cands, cache_path="",
                         budget_s=5.0, census=census)
    assert calls == ["a2a", "overlap", "pipelined"]
    assert best.strategy == "pipelined"
    assert census["skipped_budget"] == ["overlap:2"]
    assert set(census["timed"]) == {"a2a:1", "pipelined:2"}


def test_autotune_agreement_takes_the_max_over_ranks():
    """``agree`` stands in for the mesh's MAX reduction: another rank's
    slower time decides, and another rank's failure fails the candidate
    here too."""
    cands = [CommConfig("a2a", 1), CommConfig("fused", 1),
             CommConfig("pipelined", 2)]
    other = {"a2a:1": [5.0, 0.0], "fused:1": [0.5, 1.0],
             "pipelined:2": [3.0, 0.0]}
    mine = {"a2a": 1.0, "fused": 0.1, "pipelined": 2.0}
    calls = []

    def agree(vals):
        calls.append(list(vals))
        if len(calls) == 1:          # the in-memory cache-hit agreement
            return vals
        lbl = cm.cfg_label(cands[len(calls) - 2])
        return [max(a, b) for a, b in zip(vals, other[lbl])]

    census = {}
    with pytest.warns(RuntimeWarning, match="failed on another rank"):
        best = autotune_comm(("ka",), lambda c: mine[c.strategy],
                             candidates=cands, cache_path="", agree=agree,
                             census=census)
    assert best == CommConfig("pipelined", 2)
    assert census["timed"] == {"a2a:1": 5.0, "pipelined:2": 3.0}
    assert list(census["failed"]) == ["fused:1"]
    assert calls[0] == [-1.0, 1.0] and len(calls) == 1 + len(cands)


def test_corrupt_autotune_cache_falls_through_to_sweep(tmp_path):
    path = str(tmp_path / "comm.json")
    times = {"a2a:1": 3.0, "pipelined:2": 1.0, "pipelined:4": 2.0}

    def timer(cfg):
        return times[f"{cfg.strategy}:{cfg.n_chunks}"]

    cands = [CommConfig("a2a", 1), CommConfig("pipelined", 2),
             CommConfig("pipelined", 4)]
    best = autotune_comm(("kc",), timer, candidates=cands, cache_path=path)
    assert best == CommConfig("pipelined", 2)
    clear_autotune_cache()
    with faults.FaultPlan([dict(kind="corrupt_cache", count=-1)]):
        census = {}
        best2 = autotune_comm(("kc",), timer, candidates=cands,
                              cache_path=path, census=census)
    assert best2 == best
    assert len(census["timed"]) == 3


def test_legacy_flat_cache_is_migrated(tmp_path):
    path = tmp_path / "legacy.json"
    key = repr((("kl",), ("a2a:1", "fused:1")))
    path.write_text(json.dumps({key: {"strategy": "fused", "n_chunks": 1}}))
    census = {}
    with pytest.warns(RuntimeWarning, match="legacy flat"):
        got = autotune_comm(("kl",), lambda c: pytest.fail("must hit"),
                            candidates=[CommConfig("a2a", 1),
                                        CommConfig("fused", 1)],
                            cache_path=str(path), census=census)
    assert got == CommConfig("fused", 1)
    assert census["migrated"] == 1


# -- valid-extent stage API -------------------------------------------------

def test_stage_valid_extent_crops_and_repads():
    """_prepare: crop the split axis to its live extent, re-pad to the
    equal-split multiple of the axis size, as the reference does."""
    strat = make_strategy(CommConfig("a2a"), axis_sizes={"ax": 4})
    ref = rcm.make_strategy(rcm.CommConfig("a2a"), axis_sizes={"ax": 4})
    x = torch.ones((10, 3), dtype=torch.float64)
    y = strat._prepare(x, "ax", 0, 7)
    assert tuple(y.shape) == (8, 3)
    np.testing.assert_array_equal(y[:7].numpy(), 1.0)
    np.testing.assert_array_equal(y[7:].numpy(), 0.0)
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(ref._prepare(jnp.ones((10, 3)), "ax", 0, 7)))
    assert strat._prepare(x, "ax", 0, None) is x
    strat2 = make_strategy(CommConfig("a2a"))
    assert tuple(strat2._prepare(x, "ax", 0, 7).shape) == (7, 3)


@pytest.mark.parametrize("fold", ["pack", "unpack"])
def test_pack_frames_match_the_reference(fold):
    strat = make_strategy(CommConfig("a2a", fold=fold))
    ref = rcm.make_strategy(rcm.CommConfig("a2a", fold=fold))
    x = torch.zeros((2, 3, 4, 5))
    perm = (0, 3, 1, 2)
    got = strat._pack(x, 1, 3, 0, perm)
    want = ref._pack(jnp.zeros((2, 3, 4, 5)), 1, 3, 0, perm)
    assert tuple(got[0].shape) == want[0].shape
    assert got[1:] == tuple(want[1:])


# -- the tiled exchange on 8 gloo ranks -------------------------------------

@pytest.fixture(scope="module")
def switch_run(tmp_path_factory):
    """One 8-rank run of ``scenario_switch``: the exchange, the prime
    chunk axis, fold="unpack" solves against the reference, and
    all_reduce_mean."""
    d = tmp_path_factory.mktemp("switch")
    bcs = ((BCType.EVEN, BCType.EVEN), (BCType.ODD, BCType.EVEN),
           (BCType.PER, BCType.PER))
    ref = RefSolver((16,) * 3, 1.0, bcs)
    f = np.random.default_rng(0).standard_normal(ref.input_shape)
    np.save(d / "f.npy", f)
    np.save(d / "want.npy", np.asarray(ref.solve(jnp.asarray(f))))
    return ranks.launch("switch", d, 8)


@pytest.mark.parametrize("strategy", cm.STRATEGIES)
def test_tiled_exchange_on_an_asymmetric_block(switch_run, strategy):
    """Chunk k of the split axis goes to the axis's rank k and lands at
    block k of the concat axis: on a block that is not symmetric under
    transposition every rank holds exactly its global row."""
    for res in switch_run:
        shape, err = res["tiled"][strategy]
        assert shape == [1, 12, 3]
        assert err == 0.0


def test_tiled_exchange_complex_permuted(switch_run):
    for res in switch_run:
        assert res["tiled_permuted_shape"] == [12, 1, 3]
        assert res["tiled_permuted"] == 0.0
        assert res["tiled_permuted_overlap"] == 0.0


def test_prime_chunk_axis_pads_and_warns(switch_run):
    for res in switch_run:
        assert res["prime_warned"]
        pip, ov, shape = res["prime"]
        assert pip == 0.0 and ov == 0.0
        assert shape == [2, 12, 7]


@pytest.mark.parametrize("strategy", cm.STRATEGIES)
def test_fold_unpack_solves_match_reference(switch_run, strategy):
    for res in switch_run:
        assert res["unpack"][strategy] < 1e-10


def test_all_reduce_mean_over_an_axis(switch_run):
    for r, res in enumerate(switch_run):
        assert res["mean"] == (1.5 if r < 4 else 5.5)
