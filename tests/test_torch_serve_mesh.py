"""The port's solve server on a mesh of four gloo ranks, mesh (2, 2).

Rank 0 runs ``repro_torch.serve.PoissonServer``; ranks 1-3 call
``repro_torch.serve.follow`` and enter every batched solve.  The
scenarios run in ``tests/test_torch_ranks.py`` subprocesses (no JAX
there); the reference answers come from ``repro.core.solver.
PoissonSolver`` (``"xla"``, float64) in this process, the comparison
``tests/test_distributed.py`` makes.  The reference's own mesh-served
soak is red on this box, so its answers are compared, not its verdict.
"""
import numpy as np
import pytest

import test_torch_ranks as ranks
from repro.core.bc import BCType as RBCType
from repro.core.solver import PoissonSolver as RPoissonSolver

N = 16
RU, RP = (RBCType.UNB, RBCType.UNB), (RBCType.PER, RBCType.PER)
COMMS = ranks._SERVE_COMMS
KEYS = tuple(ranks._SERVE_KEYS)
# the harness's short group timeout for the follower left waiting
LOST_TIMEOUT_S = 3


def _write_inputs(d):
    """Three n=16 fields and the reference's float64 solves of each under
    (U,U,U) and (P,P,P); the soak's four fields."""
    rng = np.random.default_rng(0)
    f = np.stack([rng.standard_normal((N,) * 3) for _ in range(3)])
    np.save(d / "f.npy", f)
    for key, bc in (("UUU", RU), ("PPP", RP)):
        ref = RPoissonSolver((N,) * 3, 1.0, (bc,) * 3, engine="xla")
        np.save(d / f"want_{key}.npy",
                np.stack([np.asarray(ref.solve(x)) for x in f]))
    np.save(d / "soak_f.npy",
            np.stack([rng.standard_normal((N,) * 3) for _ in range(4)]))


def _launch(tmp_path_factory, scenario, params=None):
    d = tmp_path_factory.mktemp(scenario)
    _write_inputs(d)
    return ranks.launch(scenario, d, 4, dict(params or {}, n=N))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return _launch(tmp_path_factory, "serve_mesh")


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    return _launch(tmp_path_factory, "serve_mesh_chaos")


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    return _launch(tmp_path_factory, "serve_mesh_ops")


# -- answers -----------------------------------------------------------------

@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("comm", COMMS)
def test_torch_serve_mesh_rows_match_the_reference(served, comm, key):
    """Three requests coalesced into one batch (padded to rank 4): every
    row within 1e-10 of the reference's single-process solve and
    bit-equal to the same request served alone (a rank-1 batch)."""
    res = served[0][f"{comm}/{key}"]
    assert res["err"] < 1e-10, res
    assert res["bits"], res
    assert res["batch"] == [[3, 4]] and res["alone"] == [[1, 1]], res


def test_torch_serve_mesh_followers_enter_every_batch(served):
    """Each follower returns from every server's stop, having entered
    each of its batches, with as many warm solvers as rank 0's pool."""
    pool = served[0][f"{COMMS[0]}/{KEYS[0]}"]["pool"]
    follows = [res["follow"] for res in served[1:]]
    assert all(f == follows[0] for f in follows)
    assert [f["batches"] for f in follows[0][:4]] == [2, 6, 2, 6]
    assert all(not f["failed"] and f["solvers"] == pool
               for f in follows[0])


def test_torch_run_harness_on_mesh_specs_is_bitexact(served):
    """``run_harness(specs=<mesh specs>)``: every response equal to the
    same request served alone through the followers."""
    h = served[0]["harness"]
    assert h["dev"] == 0.0
    assert h["completed"] == h["admitted"] == 10


# -- faults and failures -----------------------------------------------------

def test_torch_serve_soak_on_a_mesh_of_four_ranks(chaos):
    """The reference's serve soak (``tests/test_abft.py``) on mesh
    (2, 2): the flip-armed tenant localized at ``fwd.0`` and repaired to
    the baseline's bits on a shadow solver every rank built; 24 clean
    solves after it bit-exact, no record."""
    res = chaos[0]
    assert res["base_records"] == 0
    assert res["chaos_stages"][0] == "solve.linearity"
    assert "fwd.0" in [s.split("#")[0] for s in res["chaos_stages"]]
    assert res["chaos_log"] == 2 and res["chaos_bits"]
    assert res["soak"] == {"solves": 24, "bitexact": 24, "records": 0,
                           "degradations": 0}


def test_torch_serve_mesh_failed_solve_fails_every_rank_alike(chaos):
    """A batch whose solve raises (an error armed at ``dist.dispatch``
    on every rank): the same SolveError on every rank, after the same
    rungs; the next batch is served clean with the baseline's bits."""
    res = chaos[0]
    assert res["doomed"].startswith("SolveError: ")
    assert all(f["follow"]["failed"][0] == res["doomed"]
               for f in chaos[1:])
    assert res["after"] == [True, 0, 0]


def test_torch_serve_mesh_build_failing_on_one_rank(chaos):
    """A build that fails on rank 2 alone is agreed before any rank
    enters the solve: every rank raises the same error naming rank 2,
    the build is void everywhere, and the key builds again on every rank
    at its next batch (within 1e-10 of the reference)."""
    res = chaos[0]
    assert res["refused"] == ("RuntimeError: building the batch's solver "
                              "failed on rank 2: RuntimeError('rank 2 "
                              "refuses this build')")
    assert all(f["follow"]["failed"][1] == res["refused"]
               for f in chaos[1:])
    assert res["again_err"] < 1e-10
    assert res["failed"] == 2
    assert all(f["follow"]["solvers"] == res["pool"] == 2
               for f in chaos[1:])
    assert len({f["follow"]["batches"] for f in chaos[1:]}) == 1


# -- operations --------------------------------------------------------------

def test_torch_serve_mesh_two_workers(ops):
    """``workers=2`` with two mesh keys under four concurrent clients:
    every request served, within 1e-10 of the reference; the followers
    met every batch."""
    w = ops[0]["workers"]
    assert w["served"] == w["completed"] == 24
    assert w["err"] < 1e-10
    for res in ops[1:]:
        f = res["follow"][0]
        assert f["batches"] == w["batches"] and not f["failed"]
        assert f["solvers"] == w["pool"] == 2


def test_torch_serve_mesh_second_server_is_refused(ops):
    """A second server on a mesh another server is serving fails its
    batch before sending anything: the followers follow one server."""
    assert ops[0]["second"] == ("another PoissonServer serves the mesh "
                                "over ranks (0, 1, 2, 3): its followers "
                                "follow one server at a time")


def test_torch_serve_mesh_eviction_keeps_the_followers_in_step(ops):
    """A budget that evicts at every other admission: four builds, three
    evictions on rank 0, and each follower ends with the one solver rank
    0's pool keeps."""
    e = ops[0]["evict"]
    assert (e["size"], e["builds"], e["evictions"]) == (1, 4, 3)
    assert e["err"] < 1e-10
    for res in ops[1:]:
        f = res["follow"][1]
        assert (f["batches"], f["solvers"], f["failed"]) == (4, 1, [])


def test_torch_serve_mesh_stop_with_a_stalled_batch(ops):
    """``stop`` while a batch stalls past the drain deadline: the request
    fails with ``ServerClosed`` at queue position 1, ``stop`` returns,
    and each follower leaves at the stop sentinel sent once the batch
    ends (its shadow solver evicted)."""
    s = ops[0]["stall"]
    assert s["error"] == 1
    assert s["stop_s"] < 2.5 and s["pool"] == 0
    for res in ops[1:]:
        assert res["follow"][2] == {"batches": 1, "failed": [],
                                    "solvers": 0}


def test_torch_serve_mesh_submit_on_a_follower_raises(ops):
    for r, res in enumerate(ops[1:], 1):
        assert res["submit"] == (
            f"rank {r} follows the server of this mesh: call "
            "repro_torch.serve.follow(mesh) here and submit on rank 0")


def test_torch_serve_on_a_sub_mesh(ops):
    """A mesh of ranks 0 and 1 of the four: the header travels on a group
    of its own; rank 1 follows, ranks 2 and 3 take no part."""
    assert ops[0]["sub"] < 1e-10
    assert ops[1]["sub"] == {"batches": 1, "failed": [], "solvers": 1}
    assert all("sub" not in res for res in ops[2:])


def test_torch_follower_raises_at_the_group_timeout(tmp_path_factory):
    """A leader that never serves: every follower raises at the group's
    timeout instead of hanging."""
    res = _launch(tmp_path_factory, "serve_mesh_lost",
                  {"group_timeout": LOST_TIMEOUT_S})
    for r in res[1:]:
        assert r["error"] == "RuntimeError"
        assert LOST_TIMEOUT_S <= r["waited_s"] < 2 * LOST_TIMEOUT_S
