"""The port's solve launcher (``repro_torch.launch.solve``) against the
reference's (``repro.launch.solve``) and the single-process reference
solve, on the CPU in float64.

One rank runs in the test's process on a (1, 1) gloo mesh: every BC mix
and layout at n=16 on both engines (``"cuda"`` runs the kernels' plain
versions here), E_inf within 1e-10 of the reference launcher's at
p1=p2=1 and the field within 1e-10 of ``repro.core.solver.PoissonSolver``.
More ranks are spawned by the launcher from a subprocess: the
reference's 2x2 launcher test (``tests/test_system.py``) and its
device-loss steps loop (``tests/test_faults.py``) on gloo ranks, each
held to the one-rank or single-process result.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.bc import BCType as RBCType
from repro.core.bc import DataLayout as RDataLayout
from repro.core.solver import PoissonSolver as RPoissonSolver
from repro.launch import solve as rlauncher
from repro_torch.core.bc import DataLayout
from repro_torch.core.solver import clear_solver_cache
from repro_torch.launch import cases
from repro_torch.launch import solve as launcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RE, RO, RP, RU = (RBCType.EVEN, RBCType.ODD, RBCType.PER, RBCType.UNB)
REF_BCS = {"unb": ((RU, RU),) * 3, "per": ((RP, RP),) * 3,
           "mix": ((RE, RE), (RO, RE), (RP, RP))}
LOSS_FAULTS = '[{"kind": "device_loss", "stage": "driver", "step": 3}]'
CHAOS_KEYS = {"steps", "final_mesh", "device_losses", "err_inf",
              "fault_log", "retries", "degradations", "integrity"}


@pytest.fixture(autouse=True)
def _fresh_port_runtime(monkeypatch):
    for k in ("REPRO_FAULTS", "REPRO_COMM_CACHE", "REPRO_CHAOS_LOG"):
        monkeypatch.delenv(k, raising=False)
    clear_solver_cache()
    yield
    clear_solver_cache()


def _port_main(argv, monkeypatch):
    """``launcher.main(argv)`` on the CPU; returns (E_inf, the record)."""
    got = []
    monkeypatch.setattr(launcher, "report", got.append)
    err = launcher.main(list(argv) + ["--device", "cpu"])
    [rec] = got
    assert rec["err"] == err
    return err, rec


def _case(bcs, n, layout):
    """The launcher's ``(rhs, sol)`` for ``--layout`` ``layout``."""
    return cases.validation_case(bcs, n, DataLayout[layout.upper()])


def _reference_field(bcs, n, layout, scales=(1.0,)):
    """The single-process reference solve of the launcher's field, summed
    over the right-hand sides ``rhs * s`` for ``s`` in ``scales``."""
    rhs, _ = _case(bcs, n, layout)
    s = RPoissonSolver((n,) * 3, 1.0, REF_BCS[bcs],
                       layout=RDataLayout[layout.upper()])
    return sum(np.asarray(s.solve(rhs * k)) for k in scales)


@pytest.fixture(scope="module")
def reference_einf():
    """E_inf of the reference launcher at p1=p2=1, n=16, per (bcs,
    layout), computed once."""
    memo = {}

    def get(bcs, layout):
        if (bcs, layout) not in memo:
            # the reference launcher sets XLA_FLAGS for the process when
            # it is unset; later subprocesses must not inherit it
            saved = os.environ.get("XLA_FLAGS")
            try:
                memo[bcs, layout] = rlauncher.main(
                    ["--n", "16", "--bcs", bcs, "--layout", layout,
                     "--repeats", "1"])
            finally:
                if saved is None:
                    os.environ.pop("XLA_FLAGS", None)
                else:
                    os.environ["XLA_FLAGS"] = saved
        return memo[bcs, layout]
    return get


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("layout", ["node", "cell"])
@pytest.mark.parametrize("bcs", ["unb", "per", "mix"])
def test_one_rank_matches_the_reference_launcher(bcs, layout, engine,
                                                 reference_einf,
                                                 monkeypatch, capsys):
    err, rec = _port_main(["--n", "16", "--bcs", bcs, "--layout", layout,
                           "--engine", engine, "--repeats", "1"],
                          monkeypatch)
    out = capsys.readouterr().out
    assert f"engine={engine}" in out and "(1x1) pencils" in out
    assert "gloo on cpu" in out and "E_inf=" in out
    assert abs(err - reference_einf(bcs, layout)) < 1e-10
    want = _reference_field(bcs, 16, layout)
    assert rec["u"].shape == want.shape and rec["u"].dtype == np.float64
    assert float(np.max(np.abs(rec["u"] - want))) < 1e-10
    assert rec["solves"] == 2 and rec["backend"] == "gloo"
    assert rec["cache"] == {"hits": 1, "misses": 1}


def test_one_rank_batch_auto_and_steps(monkeypatch, capsys):
    err, rec = _port_main(["--n", "8", "--bcs", "unb", "--layout", "cell",
                           "--batch", "2", "--comm", "auto", "--steps", "4",
                           "--repeats", "1"], monkeypatch)
    out = capsys.readouterr().out
    assert "[solve] guided search: 12 candidates ->" in out
    assert "[solve] comm=auto -> " in out and "batch=2" in out
    assert rec["solves"] == 5 and rec["cache"] == {"hits": 4, "misses": 1}
    assert rec["autotune"] and rec["comm"] in rec["autotune"]
    sol = _case("unb", 8, "cell")[1]
    assert err == float(np.max(np.abs(rec["u"] - sol)))
    want = _reference_field("unb", 8, "cell")
    assert float(np.max(np.abs(rec["u"] - want))) < 1e-10


@pytest.mark.parametrize("layout", ["NODE", "CELL"])
def test_validation_fields_are_the_references(layout):
    import test_poisson as tp
    for port, ref in ((cases.case_a, tp.case_a), (cases.case_b, tp.case_b)):
        got = port(12, DataLayout[layout])
        want = ref(12, RDataLayout[layout])
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--n", "8"])


_SCRIPT = r"""
import json, sys
import numpy as np
from repro_torch.launch import solve
out = sys.argv[1]
def keep(rec):
    np.save(out + "/u.npy", rec["u"])
    with open(out + "/rec.json", "w") as fh:
        json.dump({k: rec[k] for k in ("err", "backend", "devices",
                                       "launches")}, fh)
solve.report = keep
err = solve.main(sys.argv[2:])
print("OK launcher", err)
"""


def _run(tmp_path, *argv, env_extra=None, check=True):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for k in ("REPRO_FAULTS", "REPRO_COMM_CACHE", "REPRO_CHAOS_LOG",
              "XLA_FLAGS"):
        env.pop(k, None)
    env.update(env_extra or {})
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path),
                          *argv, "--device", "cpu"],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    if check:
        assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
        with open(tmp_path / "rec.json") as fh:
            rec = json.load(fh)
        return out, rec, np.load(tmp_path / "u.npy")
    return out


def test_four_gloo_ranks_match_one_rank(tmp_path, monkeypatch):
    args = ["--n", "24", "--bcs", "unb", "--comm", "pipelined",
            "--repeats", "1"]
    out, rec, u = _run(tmp_path, "--p1", "2", "--p2", "2", *args)
    assert "(2x2) pencils" in out.stdout and "gloo on cpu" in out.stdout
    assert rec["backend"] == "gloo" and rec["devices"] == ["cpu"] * 4
    err = float(out.stdout.split("E_inf=")[1].split(",")[0])
    assert err < 5e-2 and rec["err"] < 5e-2
    one, rec1 = _port_main(args, monkeypatch)
    assert abs(rec["err"] - one) < 1e-10
    assert float(np.max(np.abs(u - rec1["u"]))) < 1e-10


def test_survivable_loop_loses_a_device_on_eight_ranks(tmp_path):
    # the reference's device-loss steps loop (tests/test_faults.py), its
    # arguments and REPRO_FAULTS verbatim, on eight gloo ranks
    ckpt = str(tmp_path / "ck")
    chaos = str(tmp_path / "chaos.json")
    args = ["--n", "16", "--p1", "2", "--p2", "4", "--bcs", "per",
            "--steps", "6", "--ckpt", ckpt, "--ckpt-every", "2",
            "--verify", "nan"]
    env = {"REPRO_FAULTS": LOSS_FAULTS, "REPRO_CHAOS_LOG": chaos}
    out, rec, acc = _run(tmp_path, *args, env_extra=env)
    assert "device loss at step 3" in out.stdout
    assert "(1x4) surviving mesh" in out.stdout
    assert "[solve] resumed at step 2" in out.stdout
    assert rec["err"] < 1e-5
    want = _reference_field("per", 16, "node",
                            [1.0 / (1 + k) for k in range(6)])
    assert float(np.max(np.abs(acc - want))) < 1e-10
    with open(chaos) as fh:
        report = json.load(fh)
    assert set(report) == CHAOS_KEYS
    assert report["final_mesh"] == [1, 4] and report["device_losses"] == 1
    assert report["fault_log"] == [{"stage": "driver", "kind": "device_loss",
                                    "step": 3, "hit": 1}]
    assert report["err_inf"] == rec["err"]
    # a rerun on the same checkpoints resumes past the last step
    out = _run(tmp_path, *args, env_extra=env, check=False)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resuming from checkpoint step 5" in out.stdout
    assert "device loss at" not in out.stdout


def test_a_failing_rank_fails_the_launcher(tmp_path):
    out = _run(tmp_path, "--n", "8", "--p1", "2", "--green", "nope",
               "--repeats", "1", check=False)
    assert out.returncode != 0
    assert "OK launcher" not in out.stdout
    assert "ProcessRaisedException" in out.stderr
