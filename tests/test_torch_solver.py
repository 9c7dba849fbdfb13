"""The port's PoissonSolver (device="cpu", float64) against the reference
``repro.core.solver.PoissonSolver`` on the same numpy inputs.

On the CPU the "cuda" engine runs the kernels' plain versions (the
Stockham algorithm in torch), so these tests hold the kernels' algorithm
and every wrapper's reshaping, padding and cropping against the reference
end to end.  Bound: max |u_port - u_ref| < 1e-10 (the reference's own
distributed-vs-single bound in tests/test_distributed.py).
"""
import subprocess
import sys
import textwrap
from functools import lru_cache

import numpy as np
import pytest
import torch

from repro.core import solver as rsolver
from repro.core.bc import BCType, DataLayout
from repro.core.green import GreenKind
from repro_torch.core import bc as tbc
from repro_torch.core.solver import PoissonSolver
from repro_torch.kernels import ops

from test_poisson import case_b

E, O, P, U = BCType.EVEN, BCType.ODD, BCType.PER, BCType.UNB
MIXES = {"UUU": ((U, U), (U, U), (U, U)),
         "UPU": ((U, U), (P, P), (U, U)),
         "PPP": ((P, P), (P, P), (P, P))}
N = 8


def _port_bcs(bcs):
    return tuple((tbc.BCType(a.value), tbc.BCType(b.value)) for a, b in bcs)


def _rhs(shape, batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(((batch,) if batch else ()) + shape)


@lru_cache(maxsize=None)
def _reference(mix, layout, doubling, relayout, batch, engine="xla",
               n=N, kind=GreenKind.CHAT2):
    s = rsolver.PoissonSolver((n,) * 3, 1.0, MIXES[mix],
                              layout=DataLayout[layout], green_kind=kind,
                              engine=engine, doubling=doubling,
                              relayout=relayout)
    f = _rhs(s.input_shape, batch)
    return f, np.asarray(s.solve(f)), s._green_nat


def _port(mix, layout, engine, doubling="deferred", relayout="scheduled",
          n=N, kind=GreenKind.CHAT2, **kw):
    return PoissonSolver((n,) * 3, 1.0, _port_bcs(MIXES[mix]),
                         layout=tbc.DataLayout[layout], green_kind=kind,
                         engine=engine, doubling=doubling,
                         relayout=relayout, device="cpu", **kw)


@pytest.mark.parametrize("engine", ["torch", "cuda"])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("relayout", ["scheduled", "baseline"])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(MIXES))
def test_solve_matches_reference_xla(mix, layout, doubling, relayout, batch,
                                     engine):
    f, want, _ = _reference(mix, layout, doubling, relayout, batch)
    s = _port(mix, layout, engine, doubling, relayout)
    got = s.solve(f)
    assert got.dtype == torch.float64 and tuple(got.shape) == f.shape
    assert np.abs(got.numpy() - want).max() < 1e-10


@pytest.mark.parametrize("mix,layout", [("UUU", "CELL"), ("UPU", "CELL"),
                                        ("PPP", "NODE"), ("UUU", "NODE")])
def test_cuda_engine_matches_reference_pallas(mix, layout):
    f, want, _ = _reference(mix, layout, "deferred", "scheduled", None,
                            engine="pallas")
    got = _port(mix, layout, "cuda").solve(f).numpy()
    assert np.abs(got - want).max() < 1e-10


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("doubling", ["deferred", "upfront"])
@pytest.mark.parametrize("layout", ["CELL", "NODE"])
@pytest.mark.parametrize("mix", list(MIXES))
def test_scheduled_equals_baseline_bit_for_bit_on_torch(mix, layout,
                                                        doubling, batch):
    a = _port(mix, layout, "torch", doubling, "scheduled", n=16)
    b = _port(mix, layout, "torch", doubling, "baseline", n=16)
    f = _rhs(a.input_shape, batch, seed=1)
    assert torch.equal(a.solve(f), b.solve(f))


def test_analytic_unbounded_case_b_matches_reference_error():
    """Fully unbounded bump (tests/test_poisson.py CASES["B"]), CELL,
    CHAT2: the port's error equals the reference's, which converges at
    second order (the reference test asserts an order above 1.55)."""
    errs = []
    for n in (16, 32):
        rhs, sol = case_b(n, DataLayout.CELL)
        ref = rsolver.PoissonSolver((n,) * 3, 1.0, MIXES["UUU"])
        e_ref = np.abs(np.asarray(ref.solve(rhs)) - sol).max()
        u = _port("UUU", "CELL", "cuda", n=n).solve(rhs).numpy()
        e = np.abs(u - sol).max()
        assert abs(e - e_ref) < 1e-12, (e, e_ref)
        errs.append(e)
    assert np.log(errs[0] / errs[1]) / np.log(2.0) > 1.55, errs


@pytest.mark.parametrize("relayout", ["scheduled", "baseline"])
@pytest.mark.parametrize("mix,layout", [("UUU", "CELL"), ("UPU", "NODE")])
def test_green_carried_from_reference(mix, layout, relayout):
    f, want, green = _reference(mix, layout, "deferred", relayout, None)
    own = _port(mix, layout, "cuda", relayout=relayout)
    carried = _port(mix, layout, "cuda", relayout=relayout, green=green)
    np.testing.assert_array_equal(carried._green_nat, own._green_nat)
    assert torch.equal(carried.solve(f), own.solve(f))


def test_green_with_wrong_shape_raises():
    with pytest.raises(ValueError):
        _port("UUU", "CELL", "cuda", green=np.zeros((4, 4, 4)))


@pytest.mark.parametrize("bcs", [((E, E), (O, E), (P, P)),
                                 ((U, E), (U, U), (O, U))])
def test_symmetric_or_semi_plan_raises_not_implemented(bcs):
    with pytest.raises(NotImplementedError, match="next slice"):
        PoissonSolver((8, 8, 8), 1.0, _port_bcs(bcs), device="cpu")


def test_float32_solve_keeps_precision_and_matches_float64():
    s = _port("UUU", "CELL", "cuda")
    f = _rhs(s.input_shape, None)
    u32 = s.solve(f.astype(np.float32))
    assert u32.dtype == torch.float32
    u64 = s.solve(f).numpy()
    assert np.abs(u32.numpy() - u64).max() < 1e-5 * np.abs(u64).max()
    # the Green's function was cast once per working dtype
    assert set(s._green) == {torch.float64, torch.float32}


def test_solve_rejects_wrong_shape():
    s = _port("PPP", "CELL", "torch")
    with pytest.raises(ValueError):
        s.solve(np.zeros((4, 4, 4)))


# launches per CELL solve the reference's structure gives (8 + 1, 7 + 1,
# 5 + 1) and the NODE (U,U,U) path that does not fuse the Green multiply
@pytest.mark.parametrize("mix,layout,want", [
    ("UUU", "CELL", (8, 1, 0)), ("UPU", "CELL", (7, 1, 0)),
    ("PPP", "CELL", (5, 1, 0)), ("UUU", "NODE", (6, 0, 1)),
])
def test_cuda_engine_kernel_calls_per_solve(monkeypatch, mix, layout, want):
    calls = {"fft_stockham": 0, "fft_stockham_scale": 0,
             "spectral_scale": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    s = _port(mix, layout, "cuda")
    s.solve(_rhs(s.input_shape, None))
    assert tuple(calls.values()) == want


def test_torch_engine_calls_no_kernel(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("the torch engine must not reach a kernel")
    for name in ("fft_stockham", "fft_stockham_scale", "spectral_scale"):
        monkeypatch.setattr(ops, name, boom)
    for layout in ("CELL", "NODE"):
        s = _port("UUU", layout, "torch")
        s.solve(_rhs(s.input_shape, None))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PoissonSolver((8, 8, 8), 1.0, _port_bcs(MIXES["PPP"]))


def test_port_imports_neither_jax_nor_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro."))
        assert not loaded, loaded
        print(len([m for m in sys.modules if m.startswith("repro_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12
